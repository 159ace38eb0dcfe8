"""Structured per-phase wall-clock timing, and device traces.

Usage:

    prof = PhaseProfiler()
    with prof.phase('ingest'):
        ...
    print(prof.report())

Timings are host wall clock.  A phase that launches device work must end
in ``torch.cuda.synchronize()`` (or a host readback) inside the phase, or it
measures only the enqueue.

``with trace_to(log_dir): ...`` records a block with ``torch.profiler``
and writes its Chrome trace into ``log_dir``.
"""

from __future__ import annotations

import collections
import contextlib
import os
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


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace the block with ``torch.profiler`` (the JAX package's
    ``jax.profiler`` trace): CPU activity always, CUDA kernels too when a
    CUDA device is present.  On exit, also after an error, it writes one
    Chrome trace file (``chrome://tracing``, Perfetto) into ``log_dir``,
    made if missing, and yields the profiler for ``key_averages()``.
    Kernels that are still running at exit are recorded only if the block
    ends in ``torch.cuda.synchronize()``.  In a long process the profiler
    can drop the kernels of its later sessions (G7): trace early, or read
    device time from CUDA events."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    # acc_events: the profiler may flush its buffers mid-block and would
    # then keep only the events after the last flush.
    prof = profile(activities=activities, acc_events=True)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            log_dir, f'trace-{os.getpid()}-{time.time_ns()}.json'))
