"""The port's tracing: ``PhaseProfiler``'s spans, counters and their
``record_function`` ranges, and the spans the Reader, ``DeviceIndex`` and
``HostServing`` leave in a ``torch.profiler`` trace, on the CPU."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN
from pysubstringsearch_tpu_torch.utils import profiling
from pysubstringsearch_tpu_torch.utils.profiling import PhaseProfiler

torch.set_num_threads(1)

CHUNK = 16 << 10

#: The Reader's spans on a device-route batch of the ranked kind.
SEARCH_SPANS = ('batch', 'encode', 'dedup', 'route', 'pack', 'probe',
                'probe-upload', 'probe-kernel', 'probe-readback', 'extract',
                'flatten')
#: The direct children of ``batch``.
BATCH_CHILDREN = ('encode', 'dedup', 'route', 'pack', 'probe', 'extract',
                  'flatten', 'host-serve', 'host-route')


def _lines(kind: str, seed: int):
    rng = np.random.default_rng(seed)
    lo, hi = (97, 123) if kind == 'ranked' else (33, 127)
    words = [bytes(rng.integers(lo, hi, size=int(n), dtype=np.uint8))
             for n in rng.integers(3, 9, size=300)]
    return [b' '.join(words[i] for i in rng.integers(0, len(words),
                                                     size=int(k)))
            for k in rng.integers(2, 7, size=2500)]


@pytest.fixture(scope='module')
def containers(tmp_path_factory):
    d = tmp_path_factory.mktemp('tracing')
    out = {}
    for kind, seed in (('ranked', 1), ('raw', 2)):
        lines = _lines(kind, seed)
        path = str(d / f'{kind}.idx')
        with tpss.Writer(path, max_chunk_len=CHUNK,
                         sa_backend='numpy') as w:
            for ln in lines:
                w.add_entry(ln.decode('latin-1'))
        out[kind] = (path, lines)
    return out


def _patterns(lines, count: int, seed: int):
    """``count`` distinct substrings of the lines, as str."""
    rng = np.random.default_rng(seed)
    pats = {}
    while len(pats) < count:
        ln = lines[int(rng.integers(0, len(lines)))]
        o = int(rng.integers(0, max(len(ln) - 4, 1)))
        p = ln[o: o + int(rng.integers(3, 9))]
        pats[p] = None
    return [p.decode('latin-1') for p in pats]


def _reader(path):
    """A CPU Reader whose index is loaded (on the CPU it loads at the
    first query)."""
    r = tpss.Reader(path, device='cpu')
    r.search('a')
    assert r.device_ready
    return r


def _annotations(prof, tmp_path):
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    return [e for e in events
            if e.get('ph') == 'X' and e.get('cat') == 'user_annotation']


def _inside(e, outer):
    a, b = float(e['ts']), float(e['ts']) + float(e['dur'])
    a0, b0 = float(outer['ts']), float(outer['ts']) + float(outer['dur'])
    return e['tid'] == outer['tid'] and a0 <= a and b <= b0


def test_phase_calls_the_instance_add_once_a_span():
    """A wrapper put on the instance's ``add`` (as the benchmark's phase
    log does) sees every span once, nested ones too."""
    prof = PhaseProfiler()
    seen = []
    inner = prof.add

    def add(name, seconds):
        seen.append(name)
        inner(name, seconds)

    prof.add = add
    with prof.phase('outer'):
        with prof.phase('inner'):
            pass
        with prof.phase('inner'):
            pass
    assert seen == ['inner', 'inner', 'outer']
    assert dict(prof.counts) == {'outer': 1, 'inner': 2}


def test_phase_records_after_an_error():
    prof = PhaseProfiler()
    with pytest.raises(KeyError):
        with prof.phase('fails'):
            raise KeyError('x')
    assert prof.counts['fails'] == 1


def test_count_is_a_phase_of_no_time():
    prof = PhaseProfiler()
    prof.add = lambda name, seconds: pytest.fail(f'add({name!r}) called')
    prof.count('lines', 7)
    prof.count('lines')
    prof.count('none', 0)
    assert (prof.totals['lines'], prof.counts['lines']) == (0.0, 8)
    assert (prof.totals['none'], prof.counts['none']) == (0.0, 0)


def test_report_lists_counters_apart():
    prof = PhaseProfiler()
    prof.add('slow', 0.5)
    prof.add('fast', 0.001)
    prof.count('lines', 42)
    lines = prof.report().splitlines()
    assert [ln.split()[0] for ln in lines] == ['slow', 'fast', 'lines']
    assert lines[-1].split() == ['lines', '42']
    assert lines[0].split()[1:] == ['500.00', 'ms', 'x1']


def test_nested_phases_keep_their_totals():
    prof = PhaseProfiler()
    for _ in range(3):
        with prof.phase('outer'):
            with prof.phase('inner'):
                sum(range(20000))
            sum(range(20000))
    assert prof.counts['outer'] == prof.counts['inner'] == 3
    assert 0 < prof.totals['inner'] < prof.totals['outer']


def test_no_range_without_a_recording_profiler(monkeypatch):
    def boom(*args, **kwargs):
        raise AssertionError('record_function entered with no profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', boom)
    prof = PhaseProfiler()
    with prof.phase('quiet'):
        pass
    assert prof.counts['quiet'] == 1


def test_ranges_while_a_profiler_records(tmp_path):
    prof = PhaseProfiler()
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        with prof.phase('outer'):
            with prof.phase('inner'):
                pass
    with prof.phase('after'):
        pass
    names = [e['name'] for e in _annotations(tp, tmp_path)]
    assert sorted(names) == ['inner', 'outer']
    assert prof.counts['after'] == 1


def test_trace_to_holds_the_phases(tmp_path):
    prof = PhaseProfiler()
    with profiling.trace_to(str(tmp_path / 'log')):
        with prof.phase('traced'):
            pass
    (path,) = (tmp_path / 'log').iterdir()
    events = json.loads(path.read_text())['traceEvents']
    assert any(e.get('name') == 'traced'
               and e.get('cat') == 'user_annotation' for e in events)


@pytest.mark.parametrize('kind', ['ranked', 'raw'])
def test_search_multiple_spans_in_the_trace(containers, kind, tmp_path):
    """Every span of a device-route batch is a ``user_annotation`` range
    inside a ``batch`` range of the same thread; the raw kind adds its
    NUL check."""
    path, lines = containers[kind]
    r = _reader(path)
    pats = _patterns(lines, 40, 5)
    want = r.search_multiple(pats)
    with profile(activities=[ProfilerActivity.CPU]) as tp:
        got = r.search_multiple(pats + pats[:3])
    assert len(got) == len(want) + sum(
        len(r.search(p)) for p in pats[:3])
    ann = _annotations(tp, tmp_path)
    names = {e['name'] for e in ann}
    spans = SEARCH_SPANS + (('probe-nul',) if kind == 'raw' else ())
    assert set(spans) <= names
    if kind == 'ranked':
        assert 'probe-nul' not in names
    batches = [e for e in ann if e['name'] == 'batch']
    assert len(batches) == 1
    for e in ann:
        if e['name'] in spans:
            assert _inside(e, batches[0]), e['name']
    probes = [e for e in ann if e['name'] == 'probe']
    for e in ann:
        if e['name'].startswith('probe-'):
            assert any(_inside(e, p) for p in probes), e['name']
    # The fan-back of a batch with duplicates is a second dedup span.
    assert sum(e['name'] == 'dedup' for e in ann) == 2


@pytest.mark.parametrize('kind', ['ranked', 'raw'])
def test_batch_children_cover_the_batch(containers, kind):
    """A batch's direct children are the listed spans; their counts follow
    the batch's path and the probe's sub-spans nest inside ``probe``."""
    path, lines = containers[kind]
    r = _reader(path)
    prof = r.profiler
    before = dict(prof.counts)
    r.search_multiple(_patterns(lines, 30, 6))
    taken = {k: v - before.get(k, 0) for k, v in prof.counts.items()
             if v != before.get(k, 0)}
    for name in ('batch', 'encode', 'dedup', 'route', 'pack', 'probe',
                 'probe-upload', 'probe-kernel', 'probe-readback',
                 'extract', 'flatten', 'hs-spans', 'hs-fanout'):
        assert taken[name] == 1, name
    assert taken.get('probe-nul', 0) == (kind == 'raw')
    assert 'host-serve' not in prof.counts
    assert 'host-route' not in taken
    children = sum(prof.totals[k] for k in BATCH_CHILDREN)
    assert children <= prof.totals['batch']
    subs = sum(prof.totals[k] for k in prof.totals
               if k.startswith('probe-'))
    assert subs <= prof.totals['probe']


def test_hs_lines_counts_the_answer(containers):
    """``hs-lines`` is the (pattern, line) pairs of a batch of distinct
    patterns: the length of ``search_multiple``'s answer."""
    path, lines = containers['ranked']
    r = _reader(path)
    pats = _patterns(lines, 50, 7)
    before = r.profiler.counts['hs-lines']
    got = r.search_multiple(pats)
    assert len(got) > 50
    assert r.profiler.counts['hs-lines'] - before == len(got)
    assert r.profiler.totals['hs-lines'] == 0.0
    assert 'hs-lines' in r.profiler.report()


def test_long_patterns_take_the_host_route_span(containers):
    path, lines = containers['ranked']
    r = _reader(path)
    long_pat = 'q' * (PAD_MARGIN + 10)  # past the device rows: a miss
    before = dict(r.profiler.counts)
    got = r.search_multiple([long_pat, 'ab'])
    taken = {k: v - before.get(k, 0) for k, v in r.profiler.counts.items()}
    assert got == r.search(long_pat) + r.search('ab')
    assert taken['host-route'] == 1 and taken['hs-pack'] == 1
    assert taken['probe'] == 1 and taken['batch'] == 1


def test_tiny_batches_take_the_host_route_span(containers, monkeypatch):
    from pysubstringsearch_tpu_torch import api

    path, lines = containers['ranked']
    r = _reader(path)
    monkeypatch.setattr(api, 'device_rtt_estimate', lambda *a, **k: 1.0)
    before = dict(r.profiler.counts)
    pats = _patterns(lines, 3, 8)
    got = r.search_multiple(pats)
    assert len(got) >= 3
    taken = {k: v - before.get(k, 0) for k, v in r.profiler.counts.items()}
    assert taken['host-route'] == 1 and taken['hs-pack'] == 1
    assert taken.get('probe', 0) == 0 and taken.get('pack', 0) == 0
