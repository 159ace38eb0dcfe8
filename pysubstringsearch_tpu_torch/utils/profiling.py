"""Structured per-phase wall-clock timing.

Usage:

    prof = PhaseProfiler()
    with prof.phase('ingest'):
        ...
    print(prof.report())

Timings are host wall clock.  A phase that launches device work must end
in ``torch.cuda.synchronize()`` (or a host readback) inside the phase, or it
measures only the enqueue.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
import typing


class PhaseProfiler:
    def __init__(self) -> None:
        self.totals: typing.Dict[str, float] = collections.defaultdict(float)
        self.counts: typing.Dict[str, int] = collections.defaultdict(int)
        # Phases are recorded from the serving thread and the background
        # device-load thread at once.
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            lines.append(
                f'{name:24s} {self.totals[name] * 1e3:10.2f} ms'
                f'  x{self.counts[name]}'
            )
        return '\n'.join(lines)
