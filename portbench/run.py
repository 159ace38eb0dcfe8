"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cell's CUDA cards.  A
run makes its corpus from the seed, builds it with the port's ``Writer`` at
its defaults, opens it with ``Reader`` and waits until the card answers,
warms the cell's own route, then drives a closed loop of
``Reader.search_multiple`` batches for ``--seconds``.  After the window it
reads the card's peak memory (the run's, and the Reader's from its open
to the window's close: the end-to-end ``reader_peak_gib``), frees the
program, holds the sampled answers against the plain reference, deletes
its files and prints one JSON line (the last of standard output).
``--trace 1`` traces the window with ``torch.profiler`` and prints the
per-layer metrics in place of the end-to-end ones.  Every file goes
under ``$TMPDIR``; the port builds its kernels into its own ``_build/``
directory in the checkout.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import typing  # noqa: E402

import numpy as np  # noqa: E402

from . import check, roofline, spec  # noqa: E402
from .corpus import make_corpus, seed_sequence  # noqa: E402
from .traffic import make_pool  # noqa: E402

#: Top-level module names that no process of the benchmark may hold.
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'pysubstringsearch_tpu')
#: The probe kernel's launch counter (``ops/kernels.LAUNCHES``) and the
#: name its CUDA kernels carry in a trace.
K4 = 'probe_phased'


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def forbidden_modules() -> typing.List[str]:
    return sorted({m for m in list(sys.modules)
                   if m.split('.')[0] in FORBIDDEN})


@dataclasses.dataclass
class Context:
    """What a per-layer metric's reader may read of one run."""
    #: Batches in the window.
    batches: int
    #: Program phases over the window: name -> (seconds, count).
    phases: typing.Dict[str, typing.Tuple[float, int]]
    #: Program phases from ``Reader(path)`` to the window.
    load_phases: typing.Dict[str, typing.Tuple[float, int]]
    #: Batches in which the probe kernel launched.
    device_route_batches: int
    #: Each batch's ``search_multiple`` wall, seconds.
    batch_walls: typing.List[float]
    #: ``Reader(path)`` to ``wait_device_ready()`` True, seconds.
    ready_s: float
    #: The Writer's wall and the corpus bytes it indexed.
    writer_s: float
    corpus_bytes: int
    #: Least bytes of the probes of the device-route batches
    #: (``roofline.probe_bytes``).
    probe_bytes: int
    device_name: str
    #: Patterns answered in the window and the window's seconds.
    patterns: int = 0
    window_s: float = 0.0
    #: Card memory allocated once the index was ready, bytes (None off
    #: the card).
    index_resident_bytes: typing.Optional[int] = None
    #: The traced window's reduction (``devtrace.Reduction``), or None.
    trace: typing.Any = None

    def phase(self, name: str) -> typing.Tuple[float, int]:
        return self.phases.get(name, (0.0, 0))


def _snapshot(prof) -> typing.Dict[str, typing.Tuple[float, int]]:
    return {k: (prof.totals[k], prof.counts[k]) for k in list(prof.totals)}


def _delta(after, before):
    out = {}
    for k, (s, c) in after.items():
        s0, c0 = before.get(k, (0.0, 0))
        if c > c0:
            out[k] = (s - s0, c - c0)
    return out


def _feed(path: str, data: np.ndarray, errors: list) -> None:
    try:
        with open(path, 'wb') as f:
            view = memoryview(data)
            for start in range(0, len(view), 8 << 20):
                f.write(view[start: start + (8 << 20)])
    except BrokenPipeError as exc:
        errors.append(exc)


def build_index(pss, data: np.ndarray, workdir: str) -> typing.Tuple[str, float]:
    """Index ``data`` with ``pss.Writer`` at its defaults, through
    ``add_entries_from_file_lines`` on a FIFO (the corpus is never written
    to disk).  Returns the container's path and the Writer's wall."""
    fifo = os.path.join(workdir, 'corpus.fifo')
    path = os.path.join(workdir, 'corpus.idx')
    os.mkfifo(fifo)
    errors: list = []
    feeder = threading.Thread(target=_feed, args=(fifo, data, errors),
                              name='portbench-feed', daemon=True)
    feeder.start()
    try:
        t0 = time.perf_counter()
        with pss.Writer(path) as writer:
            writer.add_entries_from_file_lines(fifo)
        writer_s = time.perf_counter() - t0
    finally:
        feeder.join(timeout=5)
        if feeder.is_alive():  # the Writer stopped before reading it all
            with open(fifo, 'rb') as f:
                while f.read(8 << 20):
                    pass
            feeder.join()
        os.remove(fifo)
    if errors:
        raise RuntimeError('the Writer stopped reading the corpus')
    return path, writer_s


def card_info() -> typing.Dict[str, str]:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return {'nvidia_smi': f'unavailable: {exc}'}
    name, limit = (s.strip() for s in out.split(',', 1))
    return {'name': name, 'power_limit': limit}


def run(name: str, seed: int, seconds: float, trace: bool, *,
        cell: dict, config: dict, mix: dict, device: str = 'cuda',
        t_start: float = _T_START) -> typing.Tuple[dict, typing.List[str]]:
    """One run of a cell; returns the result line and the check's lines.
    ``device='cpu'`` runs the program's plain kernels, for tests of the
    harness: such a run reports no device metric."""
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels

    on_card = device != 'cpu'
    steps = {'imports': time.perf_counter() - t_start}
    workdir = tempfile.mkdtemp(prefix='portbench-')
    try:
        t0 = time.perf_counter()
        corpus = make_corpus(config['corpus'], seed)
        steps['corpus'] = time.perf_counter() - t0
        log(f'{name}: corpus {corpus.data.size} bytes, '
            f'{len(corpus.newlines)} lines, made in '
            f'{time.perf_counter() - t0:.2f} s')
        idx_path, writer_s = build_index(pss, corpus.data, workdir)
        steps['writer'] = writer_s
        log(f'Writer: {writer_s:.3f} s, '
            f'{corpus.data.size / 1e6 / writer_s:.1f} MB/s')
        t0 = time.perf_counter()
        pool = make_pool(mix, corpus, seed)
        pool_bytes = [roofline.probe_bytes(x) for x in pool.distinct_lengths]
        steps['traffic'] = time.perf_counter() - t0
        log(f'traffic: {len(pool.batches)} batches, '
            f'{sum(map(len, pool.batches))} patterns, in '
            f'{time.perf_counter() - t0:.2f} s')

        # The Writer's peak is the run's until here; from here on the
        # allocator's peak is the Reader's: its load and its serving.
        writer_peak = None
        if on_card:
            writer_peak = int(torch.cuda.max_memory_allocated(device))
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        reader = pss.Reader(idx_path, device=device)
        if not reader.wait_device_ready():
            raise RuntimeError('the device index did not load')
        ready_s = steps['ready'] = time.perf_counter() - t0
        resident = (int(torch.cuda.memory_allocated(device)) if on_card
                    else None)
        prof = reader.profiler
        log(f'ready: {ready_s:.3f} s; ' + prof.report().replace('\n', ' | '))

        # Warm-up: one pass over the pool, so that every route and shape of
        # the cell has run and the pages of the index that its batches read
        # are mapped before the window.  It also counts the lines and
        # characters of each batch's answer: the window's work, logged for
        # every run.
        t0 = time.perf_counter()
        P = len(pool.batches)
        pool_out = []
        for batch in pool.batches:
            answer = reader.search_multiple(batch)
            pool_out.append((len(answer), sum(map(len, answer))))
        load_phases = _snapshot(prof)
        steps['warm'] = time.perf_counter() - t0

        # A reservoir of `keep` batches of each cycle entry, drawn from
        # the seed: the answers the reference checks.
        keep = int(cell['check_batches'])
        pick = np.random.default_rng(seed_sequence(seed, 3))
        entries = len(mix['cycle'])
        kept: typing.List[typing.List[typing.Tuple[int, list]]] = [
            [] for _ in range(entries)]
        seen = [0] * entries
        walls: typing.List[float] = []
        spans: typing.List[typing.Tuple[float, float]] = []
        device_batches = probe_bytes = failed = 0
        launches = kernels.LAUNCHES

        def window() -> float:
            nonlocal device_batches, probe_bytes, failed
            w0 = time.perf_counter()
            deadline = w0 + seconds
            i = 0
            while True:
                j = i % P
                before = launches[K4]
                t0 = time.perf_counter()
                try:
                    answer = reader.search_multiple(pool.batches[j])
                except Exception as exc:  # counted; the run is not correct
                    log(f'batch {i} failed: {exc!r}')
                    failed += 1
                    answer = None
                t1 = time.perf_counter()
                walls.append(t1 - t0)
                spans.append((t0, t1))
                if launches[K4] != before:
                    device_batches += 1
                    probe_bytes += pool_bytes[j]
                if answer is not None:
                    k = pool.entries[j]
                    if len(kept[k]) < keep:
                        kept[k].append((j, answer))
                    else:
                        r = int(pick.integers(0, seen[k] + 1))
                        if r < keep:
                            kept[k][r] = (j, answer)
                    seen[k] += 1
                i += 1
                if t1 >= deadline:
                    return w0

        trace_red = None
        if trace:
            from . import devtrace

            phase_log = devtrace.PhaseLog(prof)
            before = _snapshot(prof)
            try:
                with devtrace.traced_window(workdir) as info:
                    w0 = window()
            finally:
                phase_log.close()
            w1 = info['t1']
        else:
            before = _snapshot(prof)
            w0 = window()
            w1 = spans[-1][1]
        phases = _delta(_snapshot(prof), before)
        setup_s = w0 - t_start
        window_s = w1 - w0
        batches = len(walls)
        patterns = sum(len(pool.batches[i % P]) for i in range(batches))
        lines_out = sum(pool_out[i % P][0] for i in range(batches))
        chars_out = sum(pool_out[i % P][1] for i in range(batches))
        log(f'window: {batches} batches, {patterns} patterns, {lines_out} '
            f'lines ({chars_out} characters) answered in {window_s:.3f} s; '
            f'setup {setup_s:.3f} s: '
            + ', '.join(
                f'{k} {v:.3f}' for k, v in steps.items()))

        if on_card:
            reader_peak = int(torch.cuda.max_memory_allocated(device))
            peak = max(writer_peak, reader_peak)
            device_name = torch.cuda.get_device_name(0)
            card = card_info()
            log(f'card memory: Writer peak {writer_peak}, Reader peak '
                f'{reader_peak}, index resident {resident} bytes')
        else:
            reader_peak, peak, device_name, card = None, None, 'cpu', {}
        if trace:
            t0 = time.perf_counter()
            trace_red = devtrace.reduce_trace(info['path'], phase_log.spans,
                                              spans, info['t0'], w1)
            log(f'trace reduced in {time.perf_counter() - t0:.2f} s')

        ctx = Context(
            batches=batches, phases=phases, load_phases=load_phases,
            device_route_batches=device_batches, batch_walls=walls,
            ready_s=ready_s, writer_s=writer_s,
            corpus_bytes=int(corpus.data.size), probe_bytes=probe_bytes,
            device_name=device_name, patterns=patterns, window_s=window_s,
            index_resident_bytes=resident, trace=trace_red,
        )
        log('phases in the window: ' + json.dumps(
            {k: [round(s, 6), c] for k, (s, c) in phases.items()}))

        # The program's state goes before the reference runs on the card.
        del reader
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t0 = time.perf_counter()
        kept_all = [item for per in kept for item in per]
        numbers = check.compare(
            corpus.data, corpus.newlines,
            [pool.batches[j] for j, _ in kept_all],
            [answer for _, answer in kept_all], device=device)
        numbers['failed_batches'] = failed
        lims = check.limits(int(cell['check_batches']), mix)
        correct = check.verdict(numbers, lims)
        log(f'reference check of {len(kept_all)} batches in '
            f'{time.perf_counter() - t0:.2f} s')

        if trace:
            metrics = {}
            for metric, reader_mod in spec.readers().items():
                value = reader_mod.read(ctx)
                if value is not None:
                    metrics[metric] = {'value': float(value),
                                       'unit': reader_mod.UNIT}
        else:
            metrics = {'setup_s': {'value': setup_s, 'unit': 's'}}
            if reader_peak is not None:
                metrics['reader_peak_gib'] = {'value': reader_peak / 2**30,
                                              'unit': 'GiB'}
        dev = {'platform': 'gpu' if on_card else 'cpu', 'kind': device_name,
               'count': int(cell['chips']), 'memory_peak_bytes': peak}
        result: typing.Dict[str, typing.Any] = {
            'correct': correct, 'attempted': batches, 'failed': failed,
            'metrics': metrics, 'device': dev, 'card': card,
            'window': {'batches': batches, 'patterns': patterns,
                       'lines': lines_out, 'characters': chars_out,
                       'seconds': window_s},
        }
        if trace_red is not None:
            dev['busy_s'] = trace_red.busy_s
            dev['window_s'] = trace_red.window_s
            result['breakdown'] = {
                'device_ops': [[n, s] for n, s in trace_red.device_ops],
                'idle_gaps': [[n, s] for n, s in trace_red.idle_gaps],
            }
        result['check'] = {k: {'value': numbers[k], 'limit': lims[k][1],
                               'side': lims[k][0]} for k in lims}
        lines = [f'check {k}: {numbers[k]} ({lims[k][0]} {lims[k][1]})'
                 for k in lims]
        return result, lines
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv: typing.Optional[typing.Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell, config, mix = spec.cell(args.workload)

    import torch

    if not torch.cuda.is_available():
        log('no CUDA device: the benchmark measures the card only')
        return 2
    if torch.cuda.device_count() < int(cell['chips']):
        log(f'{args.workload} needs {cell["chips"]} CUDA devices, found '
            f'{torch.cuda.device_count()}')
        return 2
    result, lines = run(args.workload, args.seed, args.seconds,
                        bool(args.trace), cell=cell, config=config, mix=mix)
    bad = forbidden_modules()
    if bad:
        log('modules of JAX or the JAX package were loaded: ' + ', '.join(bad))
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
