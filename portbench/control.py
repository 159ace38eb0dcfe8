"""The control of a cell's ``correct``, at the cell's own size.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

For each seed: the cell's corpus and traffic pool, as a run makes them;
the plain reference put in the program's place for as many batches of
each cycle entry as a run checks, with the configuration's guarantee
broken (exactness: a candidate is accepted on its first
``reference.KEY_BYTES`` bytes); then the run's comparison.  It prints one
JSON line a seed with the numbers compared and their limits, and exits 0
when the control came out not correct on every seed.  The benchmark's
runs do not run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import typing

import numpy as np

from . import check, reference, spec
from .corpus import make_corpus
from .traffic import make_pool


def control_numbers(cell: dict, config: dict, mix: dict, seed: int,
                    device=None) -> typing.Dict[str, int]:
    """The run's comparison of the control's answers, counted on line ids
    (the control's answers can run to tens of millions of lines, too many
    to make strings of; lines of random words do not repeat, so the counts
    are the run's): ``wrong_patterns``, ``missing_lines``,
    ``extra_lines``, ``patterns_checked``."""
    corpus = make_corpus(config['corpus'], seed)
    pool = make_pool(mix, corpus, seed)
    keep = int(cell['check_batches'])
    picked = []
    for k in range(len(mix['cycle'])):
        picked += [j for j, e in enumerate(pool.entries) if e == k][:keep]
    batches = [pool.batches[j] for j in picked]
    distinct = sorted({p for b in batches for p in b})
    encoded = [p.encode('utf-8') for p in distinct]
    exact = reference.find_lines(corpus.data, corpus.newlines, encoded,
                                 device=device)
    loose = reference.find_lines(corpus.data, corpus.newlines, encoded,
                                 device=device, whole_pattern=False)
    per = {}
    for p, want, got in zip(distinct, exact, loose):
        per[p] = (np.setdiff1d(want, got).size, np.setdiff1d(got, want).size)
    numbers = {'wrong_patterns': 0, 'missing_lines': 0, 'extra_lines': 0,
               'patterns_checked': 0, 'failed_batches': 0}
    for b in batches:
        numbers['patterns_checked'] += len(b)
        for p in b:
            missing, extra = per[p]
            numbers['missing_lines'] += missing
            numbers['extra_lines'] += extra
            numbers['wrong_patterns'] += bool(missing or extra)
    return numbers


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', type=int, nargs='+', required=True)
    args = ap.parse_args(argv)
    cell, config, mix = spec.cell(args.workload)
    lims = check.limits(int(cell['check_batches']), mix)
    all_failed = True
    for seed in args.seeds:
        t0 = time.perf_counter()
        numbers = control_numbers(cell, config, mix, seed)
        correct = check.verdict(numbers, lims)
        all_failed &= not correct
        print(json.dumps({
            'workload': args.workload, 'seed': seed, 'control': 'prefix',
            'correct': correct, 'seconds': time.perf_counter() - t0,
            'check': {k: {'value': numbers[k], 'limit': lims[k][1],
                          'side': lims[k][0]} for k in lims}}), flush=True)
    return 0 if all_failed else 1


if __name__ == '__main__':
    sys.exit(main())
