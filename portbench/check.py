"""The comparison that decides ``correct``.

Every answer ``search_multiple`` gave for the sampled batches of the
window is held against the plain reference (``reference.py``), which
works from the corpus bytes alone.  The configuration's guarantee is
exactness: each pattern's answer is every line that holds it, once, and
no other line.  So each number compared is a count of departures, and its
limit is 0, except the count of patterns checked, which has a floor so
that a run cannot pass by checking nothing.
"""

from __future__ import annotations

import collections
import typing

import numpy as np

from . import reference


def compare(data: np.ndarray, newlines: np.ndarray,
            batches: typing.Sequence[typing.Sequence[str]],
            answers: typing.Sequence[typing.Sequence[str]], *,
            device=None) -> typing.Dict[str, int]:
    """Counts of departures of ``answers`` (each ``search_multiple``'s flat
    list for the batch beside it) from the reference: ``wrong_patterns``,
    the patterns whose block of the answer, split by the reference's
    counts, is not the reference's lines as a multiset; ``missing_lines``
    and ``extra_lines``, the multiset differences of each whole answer;
    ``patterns_checked``."""
    distinct = sorted({p for b in batches for p in b})
    ids = reference.find_lines(data, newlines,
                               [p.encode('utf-8') for p in distinct],
                               device=device)
    by_pattern = dict(zip(distinct, ids))
    wrong = missing = extra = checked = 0
    for batch, got in zip(batches, answers):
        want = [reference.line_strings(data, newlines, by_pattern[p])
                for p in batch]
        checked += len(batch)
        flat = collections.Counter(line for lines in want for line in lines)
        have = collections.Counter(got)
        missing += sum((flat - have).values())
        extra += sum((have - flat).values())
        pos = 0
        for lines in want:
            block = got[pos: pos + len(lines)]
            if sorted(block) != sorted(lines):
                wrong += 1
            pos += len(lines)
    return {'wrong_patterns': wrong, 'missing_lines': missing,
            'extra_lines': extra, 'patterns_checked': checked}


def limits(check_batches: int, mix: typing.Mapping[str, typing.Any]
           ) -> typing.Dict[str, typing.Tuple[str, int]]:
    """Each compared number's limit: (``max`` or ``min``, value).  A run
    checks ``check_batches`` batches of each entry of the mix's cycle, so
    it has to check at least that many batches' patterns.
    ``failed_batches`` counts the batches whose call raised."""
    least = check_batches * sum(int(e['batch']) for e in mix['cycle'])
    return {'wrong_patterns': ('max', 0), 'missing_lines': ('max', 0),
            'extra_lines': ('max', 0), 'patterns_checked': ('min', least),
            'failed_batches': ('max', 0)}


def verdict(numbers: typing.Mapping[str, int],
            lims: typing.Mapping[str, typing.Tuple[str, int]]) -> bool:
    ok = True
    for name, (side, bound) in lims.items():
        value = numbers[name]
        ok &= value <= bound if side == 'max' else value >= bound
    return bool(ok)
