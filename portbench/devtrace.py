"""The traced window: ``torch.profiler`` over the measured window, reduced
to device intervals, the busy and idle time, device time by operation,
and the idle gaps tagged with the program phase the host was in.

The program's phases come from its ``PhaseProfiler`` (the Reader's public
``profiler``): :class:`PhaseLog` wraps the instance's ``add`` so that
every phase also leaves its (start, end) on the host clock.  The window is
marked by a ``record_function`` span, which puts the host clock and the
trace's clock on one axis.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import time
import typing

#: Trace categories of work on the device.
DEVICE_CATEGORIES = ('kernel', 'gpu_memcpy', 'gpu_memset')
WINDOW_MARK = 'portbench.window'
#: Host time inside a batch and in none of the program's phases.
OUTSIDE_PHASES = 'search_multiple (no phase)'
BETWEEN_BATCHES = 'harness (between batches)'


class PhaseLog:
    """Every phase the profiler records, with its host-clock interval."""

    def __init__(self, profiler) -> None:
        self.spans: typing.List[typing.Tuple[float, float, str]] = []
        self._add = profiler.add

        def add(name: str, seconds: float) -> None:
            end = time.perf_counter()
            self.spans.append((end - seconds, end, name))
            self._add(name, seconds)

        profiler.add = add
        self._profiler = profiler

    def close(self) -> None:
        del self._profiler.add  # the class's method again


def union(intervals: typing.Iterable[typing.Tuple[float, float]],
          lo: float, hi: float) -> typing.List[typing.Tuple[float, float]]:
    """The union of ``intervals`` clipped to [lo, hi], sorted."""
    out: typing.List[typing.List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def label_segments(spans, batches, lo: float, hi: float):
    """[(start, end, label)] covering [lo, hi]: the innermost program phase
    at each instant, else ``OUTSIDE_PHASES`` inside a batch, else
    ``BETWEEN_BATCHES``.  Phases of one thread nest."""
    events = []
    for a, b, name in spans:
        events.append((a, 1, -(b - a), name))
        events.append((b, 0, 0.0, name))
    for a, b in batches:
        events.append((a, 1, float('-inf'), OUTSIDE_PHASES))
        events.append((b, 0, 0.0, OUTSIDE_PHASES))
    events.sort(key=lambda e: (e[0], e[1], e[2]))
    stack: typing.List[str] = []
    segs = []
    t = lo
    for when, opening, _, name in events:
        when = min(max(when, lo), hi)
        if when > t:
            segs.append((t, when, stack[-1] if stack else BETWEEN_BATCHES))
            t = when
        if opening:
            stack.append(name)
        elif name in stack:
            stack.reverse()
            stack.remove(name)
            stack.reverse()
    if t < hi:
        segs.append((t, hi, stack[-1] if stack else BETWEEN_BATCHES))
    return segs


def idle_by_label(gaps, segs) -> typing.Dict[str, float]:
    """Seconds of each label's segments that fall in the idle ``gaps``."""
    starts = [s[0] for s in segs]
    out: typing.Dict[str, float] = collections.defaultdict(float)
    for a, b in gaps:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            s, e, name = segs[i]
            overlap = min(b, e) - max(a, s)
            if overlap > 0:
                out[name] += overlap
            i += 1
    return dict(out)


def short_name(name: str) -> str:
    """A kernel's name without its argument list (the last parenthesised
    group, where it follows the name directly)."""
    if not name.endswith(')'):
        return name
    depth = 0
    for i in range(len(name) - 1, -1, -1):
        depth += {')': 1, '(': -1}.get(name[i], 0)
        if depth == 0:
            return name[:i] if i and not name[i - 1].isspace() else name
    return name


class Reduction(typing.NamedTuple):
    window_s: float
    busy_s: float
    device_ops: typing.List[typing.Tuple[str, float]]
    idle_gaps: typing.List[typing.Tuple[str, float]]
    kernel_s: typing.Dict[str, float]


def reduce_trace(path: str, phase_spans, batch_spans, host_t0: float,
                 host_t1: float) -> Reduction:
    """Reduce the Chrome trace at ``path``: the window is the
    ``WINDOW_MARK`` span, whose start is ``host_t0`` on the host clock."""
    with open(path) as f:
        events = json.load(f)['traceEvents']
    mark = [e for e in events
            if e.get('name') == WINDOW_MARK and e.get('ph') == 'X'
            and e.get('cat') == 'user_annotation']
    if not mark:
        raise RuntimeError('the trace lost the window mark')
    w0 = float(mark[0]['ts']) * 1e-6
    w1 = w0 + (host_t1 - host_t0)
    intervals = []
    by_name: typing.Dict[str, float] = collections.defaultdict(float)
    for e in events:
        if e.get('ph') != 'X' or e.get('cat') not in DEVICE_CATEGORIES:
            continue
        a = float(e['ts']) * 1e-6
        b = a + float(e.get('dur', 0.0)) * 1e-6
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        intervals.append((a, b))
        by_name[short_name(e['name'])] += b - a
    busy = union(intervals, w0, w1)
    busy_s = sum(b - a for a, b in busy)
    gaps, t = [], w0
    for a, b in busy:
        if a > t:
            gaps.append((t, a))
        t = b
    if t < w1:
        gaps.append((t, w1))
    shift = w0 - host_t0  # host clock -> trace clock
    segs = label_segments(
        [(a + shift, b + shift, n) for a, b, n in phase_spans],
        [(a + shift, b + shift) for a, b in batch_spans], w0, w1)
    idle = idle_by_label(gaps, segs)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps_top = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return Reduction(window_s=w1 - w0, busy_s=busy_s, device_ops=top,
                     idle_gaps=gaps_top, kernel_s=dict(by_name))


@contextlib.contextmanager
def traced_window(out_dir: str):
    """Profile the block (CPU and CUDA activity) inside a ``WINDOW_MARK``
    span; yields a dict that, after the block, holds ``path`` (the Chrome
    trace), ``t0`` and ``t1`` (the mark's host-clock ends)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    os.makedirs(out_dir, exist_ok=True)
    info: typing.Dict[str, typing.Any] = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   acc_events=True)
    prof.start()
    try:
        with record_function(WINDOW_MARK):
            info['t0'] = time.perf_counter()
            yield info
            torch.cuda.synchronize()
            info['t1'] = time.perf_counter()
    finally:
        prof.stop()
    info['path'] = os.path.join(out_dir, 'window.trace.json')
    prof.export_chrome_trace(info['path'])
