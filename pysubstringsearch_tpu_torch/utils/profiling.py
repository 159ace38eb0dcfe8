"""Structured per-phase wall-clock timing, counters, and device traces.

Usage:

    prof = PhaseProfiler()
    with prof.phase('ingest'):
        ...
    prof.count('rows', 12)
    print(prof.report())

Timings are host wall clock.  A phase that launches device work must end
in ``torch.cuda.synchronize()`` (or a host readback) inside the phase, or it
measures only the enqueue.

While a ``torch.profiler`` session records on the thread that runs a
phase (``trace_to``, or any ``torch.profiler.profile``), the phase is also
a ``record_function`` range of its name: it lands in the same trace as the
kernels and copies, as a ``user_annotation`` event on that thread, nested
as the phases ran.  With no session recording, a phase reads one flag and
opens no range.

A counter (``count``) is a phase of no time: it adds to ``counts`` and
leaves ``totals`` at 0.0, so a reader of both tables sees its key, and it
never reaches ``add``.

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

import torch
from torch._C._autograd import _profiler_enabled


class _Phase:
    """One span of :meth:`PhaseProfiler.phase`."""

    __slots__ = ('_prof', '_name', '_t0', '_range')

    def __init__(self, prof: 'PhaseProfiler', name: str) -> None:
        self._prof = prof
        self._name = name

    def __enter__(self) -> None:
        # True only on a thread whose profiler session records.
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = time.perf_counter()

    def __exit__(self, *exc) -> None:
        try:
            # Through the instance: a wrapper of ``add`` sees every span.
            self._prof.add(self._name, time.perf_counter() - self._t0)
        finally:
            if self._range is not None:
                self._range.__exit__(*exc)


class PhaseProfiler:
    def __init__(self) -> None:
        self.totals: typing.Dict[str, float] = collections.defaultdict(float)
        self.counts: typing.Dict[str, int] = collections.defaultdict(int)
        self._counters: typing.Set[str] = set()
        # Phases are recorded from the serving thread and the background
        # device-load thread at once.
        self._lock = threading.Lock()

    def phase(self, name: str) -> _Phase:
        """A context manager that times its block and ends in
        ``self.add(name, seconds)``."""
        return _Phase(self, name)

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``counts[name]``; ``totals[name]`` stays 0.0."""
        with self._lock:
            self._counters.add(name)
            self.totals[name] += 0.0
            self.counts[name] += n

    def report(self) -> str:
        timed = [k for k in self.totals if k not in self._counters]
        lines = []
        for name in sorted(timed, key=self.totals.get, reverse=True):
            lines.append(
                f'{name:24s} {self.totals[name] * 1e3:10.2f} ms'
                f'  x{self.counts[name]}'
            )
        for name in sorted(self._counters):
            lines.append(f'{name:24s} {self.counts[name]}')
        return '\n'.join(lines)


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Trace the block with ``torch.profiler`` (the JAX package's
    ``jax.profiler`` trace): CPU activity always, CUDA kernels too when a
    CUDA device is present.  The program's phases that run on this thread
    (``PhaseProfiler.phase``: the Reader's ``batch``, ``probe``, ...)
    appear in the trace as ``user_annotation`` ranges beside the kernels.
    On exit, also after an error, it writes one Chrome trace file
    (``chrome://tracing``, Perfetto) into ``log_dir``, made if missing, and
    yields the profiler for ``key_averages()``.  Kernels that are still
    running at exit are recorded only if the block ends in
    ``torch.cuda.synchronize()``.  In a long process the profiler can drop
    the kernels of its later sessions (G7): trace early, or read device
    time from CUDA events."""
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
