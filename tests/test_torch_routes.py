"""The port's serving routes and routing constants on the CPU, against the
JAX package under the same env knobs: the Reader's device route, its
per-row host route, the whole-batch ``HostServing.search`` route and the
tiny-batch route over merged derive rows of the ranked, raw and digit
kinds; the Writer's build rule; the link and round-trip constants;
``DeviceIndex.plan``, ``cover_bytes``, ``probe_class_keys``,
``warm_probe`` and ``probe_device_parts``; and the options
``TPUSS_INDEX_MODE``, ``TPUSS_BG_LOAD``, ``TPUSS_MERGE`` and
``TPUSS_MERGE_CAP``."""

import collections
import functools
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu import api as japi
from pysubstringsearch_tpu import container as jcontainer
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu.ops import native as jnative
from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops import suffix_array as jsa
from pysubstringsearch_tpu.parallel import mesh as jmesh
from pysubstringsearch_tpu_torch import api as tapi
from pysubstringsearch_tpu_torch import container as tcontainer
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import native as tnative
from pysubstringsearch_tpu_torch.ops import search as tsearch
from pysubstringsearch_tpu_torch.ops import suffix_array as tsa
from pysubstringsearch_tpu_torch.parallel.reader import ShardedIndex

torch.set_num_threads(1)

#: Merge cap of the tests' derive rows: 5 bodies of 1.1-1.6 KB in 2-3 rows.
MERGE_CAP = 3500

KINDS = ('ranked', 'raw', 'digit')
ROUTES = ('device', 'host_rows', 'whole_batch', 'tiny')


def _alphabet(kind):
    if kind == 'ranked':
        return np.arange(97, 123, dtype=np.uint8)  # 26 letters
    if kind == 'raw':
        return np.arange(33, 127, dtype=np.uint8)  # 94 bytes, no NUL
    return np.concatenate(([0], np.arange(33, 127))).astype(np.uint8)


def _bodies(kind, seed=5):
    """Five newline-terminated bodies of random words over the kind's
    alphabet (space-separated, ASCII, so str and bytes agree); the third
    holds one line longer than ``PAD_MARGIN``."""
    rng = np.random.default_rng(seed)
    alpha = _alphabet(kind)
    words = [alpha[rng.integers(0, alpha.size, size=int(n))].tobytes()
             for n in rng.integers(2, 6, size=40)]
    bodies = []
    for c in range(5):
        lines = [b' '.join(words[i] for i in rng.integers(0, 40, size=4))
                 for _ in range(60 + 20 * c)]
        if c == 2:
            lines[7] = b' '.join(words[i % 40] for i in range(320))
            assert len(lines[7]) > tsearch.PAD_MARGIN + 40
        bodies.append(b'\n'.join(lines) + b'\n')
    return bodies, words


def _write(path, bodies):
    with open(path, 'wb') as f:
        for body in bodies:
            data = np.frombuffer(body, dtype=np.uint8)
            tcontainer.write_chunk(f, data, tsa.suffix_array_numpy(data))
    return path


@pytest.fixture(scope='module', params=KINDS)
def corpus(request, tmp_path_factory):
    kind = request.param
    bodies, words = _bodies(kind)
    path = _write(str(tmp_path_factory.mktemp(kind) / 'c.idx'), bodies)
    long_line = bodies[2].split(b'\n')[7]
    pats = [w for w in words[:12]] + [words[3][:2], words[5] + b' ']
    pats += [bodies[c][-4:] + bodies[c + 1][:4] for c in range(4)]  # \n across a boundary
    pats += [bodies[1].split(b'\n')[3][-3:] + b'\n'
             + bodies[1].split(b'\n')[4][:3]]  # \n inside a chunk
    pats += [b'', b'\n', words[0] + b'\x00', b'\x00' + words[1][:2],
             long_line[5: 5 + tsearch.PAD_MARGIN + 30],  # past PAD_MARGIN
             b'~~~~~~~~']
    return kind, path, bodies, pats


@pytest.fixture(autouse=True)
def _fresh_constants(monkeypatch):
    """Each test starts with no cached link rates or round trip on either
    side, the merge cap of the tests and no route knob set."""
    monkeypatch.setattr(jsa, '_LINK_RATES', None)
    monkeypatch.setattr(tsa, '_LINK_RATES', None)
    monkeypatch.setattr(tsa, '_DEVICE_RTT', None)
    for name in ('TPUSS_LINK_MBPS', 'TPUSS_DEVICE_RTT', 'TPUSS_BG_LOAD',
                 'TPUSS_INDEX_MODE', 'TPUSS_MERGE', 'TPUSS_MERGE_CAP'):
        monkeypatch.delenv(name, raising=False)


def _force(route, monkeypatch):
    """Set the JAX knobs that force ``route`` on both Readers, under one
    host unit on both sides."""
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    monkeypatch.setenv('TPUSS_INDEX_MODE', 'derive')  # from_chunks' mode
    monkeypatch.setattr(japi, 'HOST_PROBE_UNIT_S', 5e-6)
    monkeypatch.setattr(tapi, 'HOST_PROBE_UNIT_S', 5e-6)
    cap = 0 if route in ('host_rows', 'whole_batch') else 4 << 20
    monkeypatch.setattr(japi.Reader, '_READBACK_CAP', cap)
    monkeypatch.setattr(tapi.Reader, '_READBACK_CAP', cap)
    if route == 'tiny':
        # The CPU's round trip is 0 on both sides whatever the env says,
        # so the estimate itself is raised.
        monkeypatch.setenv('TPUSS_DEVICE_RTT', '1')
        monkeypatch.setattr(jsa, 'device_rtt_estimate', lambda *a: 1.0)
        monkeypatch.setattr(tapi, 'device_rtt_estimate', lambda *a: 1.0)


def _readers(path, route):
    """(port Reader, JAX Reader) over the container in derive mode; for
    the per-row host route both are built from parsed chunks, so neither
    has ``HostServing`` and no batch takes the whole-batch route."""
    if route == 'host_rows':
        t = tpss.Reader.from_chunks(tcontainer.read_container(path).chunks,
                                    device='cpu')
        j = japi.Reader.from_chunks(jcontainer.read_container(path).chunks)
        return t, j
    return (tpss.Reader(path, device='cpu', index_mode='derive'),
            jpss.Reader(path, index_mode='derive'))


def _route_counts(prof):
    return {k: prof.counts.get(k, 0) for k in (
        'probe', 'x-dev-gather', 'x-host-probe', 'x-host-lines')}


@pytest.mark.parametrize('route', ROUTES)
def test_routes_match_jax_reader(corpus, route, monkeypatch):
    kind, path, bodies, pats = corpus
    _force(route, monkeypatch)
    t, j = _readers(path, route)
    assert t._index.merged and j._index.merged
    assert t._index.kind == j._index.kind == kind
    assert t._index.groups == j._index.groups and len(t._index.groups) > 1
    short = [p for p in pats if len(p) <= tsearch.PAD_MARGIN]
    before_t, before_j = _route_counts(t.profiler), _route_counts(j.profiler)
    got = [sorted(x) for x in t._search_batch(short)]
    want = [sorted(x) for x in j._search_batch(short)]
    assert got == want
    assert sum(map(len, got)) > 100
    taken_t = {k: v - before_t[k] for k, v in _route_counts(t.profiler).items()}
    taken_j = {k: v - before_j[k] for k, v in _route_counts(j.profiler).items()}
    assert taken_t == taken_j
    expect = {
        'device': (1, True, False), 'host_rows': (1, False, True),
        'whole_batch': (1, False, False), 'tiny': (0, False, False),
    }[route]
    assert (taken_t['probe'], taken_t['x-dev-gather'] > 0,
            taken_t['x-host-probe'] > 0) == expect
    strs = [p.decode('latin-1') for p in pats]
    assert collections.Counter(t.search_multiple(strs)) == \
        collections.Counter(j.search_multiple(strs))
    for p in (strs[0], strs[-4], strs[14], '', strs[-2][:40]):
        assert sorted(t.search(p)) == sorted(j.search(p)), p


def test_routes_keep_a_failed_load_visible(corpus, monkeypatch):
    """No route hides the card: after a failed background load, every
    forced route still raises on the next search."""
    _, path, _, pats = corpus
    for route in ROUTES[1:]:
        _force(route, monkeypatch)
        r = tpss.Reader(path, device='cpu', index_mode='derive')

        def fail():
            raise MemoryError('device full')

        r._build_device_index = fail
        import threading

        r._bg_thread = threading.Thread(target=r._bg_load)
        r._bg_thread.start()
        r._bg_thread.join(timeout=60)
        with pytest.raises(RuntimeError, match='load failed'):
            r._search_batch(pats[:3])


@pytest.mark.parametrize('rates', [(25.0, 8.0), (1000.0, 10.0), (5.0, 100.0),
                                   (60.0, 50.0)])
@pytest.mark.parametrize('link', ['50,20', '4000,3000', '2,1'])
def test_device_build_worthwhile_matches_jax(rates, link, monkeypatch):
    monkeypatch.setenv('TPUSS_LINK_MBPS', link)
    for mod in (jsa, tsa):
        monkeypatch.setattr(mod, '_DEVICE_BUILD_MBPS', rates[0])
        monkeypatch.setattr(mod, '_NATIVE_BUILD_MBPS', rates[1])
    for n in (1, 1 << 16, 8 << 20, 512 << 20):
        assert tsa._device_build_worthwhile(n) == \
            jsa._device_build_worthwhile(n), n


@pytest.mark.parametrize('rates', [(1000.0, 10.0), (5.0, 100.0)])
def test_auto_backend_choice_matches_jax(rates, monkeypatch):
    """``build_suffix_array('auto')`` picks the card or native SA-IS as the
    JAX rule picks its device or native SA-IS, on an accelerator (the JAX
    backend made to report one, CUDA made available) and without one."""
    import jax

    monkeypatch.setenv('TPUSS_LINK_MBPS', '1000,400')
    calls = []

    def spy(tag, fn):
        def run(data, **kw):
            calls.append((tag, data.size))
            return fn(data)
        return run

    for mod, card in ((jsa, 'suffix_array_jax'), (tsa, 'suffix_array_torch')):
        monkeypatch.setattr(mod, '_DEVICE_BUILD_MBPS', rates[0])
        monkeypatch.setattr(mod, '_NATIVE_BUILD_MBPS', rates[1])
        monkeypatch.setattr(mod, card, spy('card', tsa.suffix_array_numpy))
    monkeypatch.setattr(jnative, 'suffix_array_native',
                        spy('native', tsa.suffix_array_numpy))
    monkeypatch.setattr(tnative, 'suffix_array_native',
                        spy('native', tsa.suffix_array_numpy))
    rng = np.random.default_rng(3)
    for accel in (False, True):
        monkeypatch.setattr(jax, 'default_backend',
                            lambda a=accel: 'gpu' if a else 'cpu')
        monkeypatch.setattr(torch.cuda, 'is_available', lambda a=accel: a)
        for n in (100, (1 << 16) - 1, 1 << 16, 1 << 18):
            data = rng.integers(97, 100, size=n, dtype=np.uint8)
            calls.clear()
            want = jsa.build_suffix_array(data)
            jcall = list(calls)
            calls.clear()
            got = tsa.build_suffix_array(data)
            assert calls == jcall, (accel, n)
            np.testing.assert_array_equal(got, want)
            assert calls[0][0] == ('card' if accel and n >= 1 << 16
                                   and rates == (1000.0, 10.0)
                                   else 'native')


def test_link_mbps_parse_and_cache(monkeypatch):
    monkeypatch.setenv('TPUSS_LINK_MBPS', '12.5,3.25')
    assert tsa.host_device_link_mbps('cpu') == jsa.host_device_link_mbps() \
        == (12.5, 3.25)
    assert tsa._LINK_RATES == jsa._LINK_RATES == (12.5, 3.25)
    monkeypatch.setenv('TPUSS_LINK_MBPS', '1,1')
    # Cached: a later override is not read.
    assert tsa.host_device_link_mbps('cuda', probe=False) == \
        jsa.host_device_link_mbps(probe=False) == (12.5, 3.25)


def test_link_mbps_without_override(monkeypatch):
    """A CPU device moves nothing (as the JAX CPU backend); on CUDA with
    nothing cached, ``probe=False`` returns the card's measured default
    without touching the card."""
    inf = float('inf')
    assert tsa.host_device_link_mbps('cpu') == jsa.host_device_link_mbps() \
        == (inf, inf)
    assert tsa._LINK_RATES is None
    assert tsa.host_device_link_mbps('cuda', probe=False) == \
        tsa.LINK_MBPS_DEFAULT
    assert all(0 < x < inf for x in tsa.LINK_MBPS_DEFAULT)


def test_device_rtt_estimate(monkeypatch):
    monkeypatch.setenv('TPUSS_DEVICE_RTT', '0.5')
    assert tsa.device_rtt_estimate('cpu') == jsa.device_rtt_estimate() == 0.0
    assert tsa.device_rtt_estimate('cuda') == 0.5
    monkeypatch.delenv('TPUSS_DEVICE_RTT')
    assert tsa.device_rtt_estimate('cuda') == tsa.DEVICE_RTT_DEFAULT_S > 0
    calls = []

    class Stub:
        def probe(self, pats, lens):
            calls.append((pats.shape, lens.tolist()))

    rtt = tsa.device_rtt_estimate('cuda', Stub())
    assert calls == [((1, 4), [4])] * 3
    assert tsa._DEVICE_RTT == rtt and 0 <= rtt < 1
    assert tsa.device_rtt_estimate('cuda', Stub()) == rtt  # measured once
    assert len(calls) == 3


def test_native_probe_available_matches_jax():
    assert tnative.probe_batch_available() == jnative.probe_batch_available()
    assert tapi.native_available_for_probe() == \
        japi.native_available_for_probe()


def test_host_unit_and_readback_cap_env():
    """``TPUSS_HOST_PROBE_US`` and ``TPUSS_READBACK_CAP`` are read at
    import, as in the JAX package (a fresh process of the port alone)."""
    code = ('from pysubstringsearch_tpu_torch import api; '
            'print(api.HOST_PROBE_UNIT_S, api.Reader._READBACK_CAP)')
    env = dict(os.environ, TPUSS_HOST_PROBE_US='7.5',
               TPUSS_READBACK_CAP='12345')
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=os.path
                         .dirname(os.path.dirname(os.path.abspath(__file__))),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    unit, cap = out.stdout.split()
    assert float(unit) == pytest.approx(7.5e-6) and int(cap) == 12345


def _chunk_pair(bodies):
    t, j = [], []
    for body in bodies:
        data = np.frombuffer(body, dtype=np.uint8)
        sa = tsa.suffix_array_numpy(data)
        t.append(tcontainer.Chunk(data=data, suffix_array=sa))
        j.append(jcontainer.Chunk(data=data, suffix_array=sa))
    return t, j


PLAN_ATTRS = ('kind', 'mode', 'groups', 'num_limbs', 'n_pad', '_base',
              '_depth', 'num_chunks', 'merged', 'num_source_chunks',
              'cover_bytes')


@pytest.mark.parametrize('mode', ['derive', 'upload'])
@pytest.mark.parametrize('kind', KINDS)
def test_plan_matches_jax(kind, mode, monkeypatch):
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    tch, jch = _chunk_pair(_bodies(kind)[0])
    p = DeviceIndex.plan(tch, device='cpu', mode=mode)
    q = JIndex.plan(jch, mode=mode)
    for name in PLAN_ATTRS:
        assert getattr(p, name) == getattr(q, name), name
    assert p.merged == (mode == 'derive')
    for a, b in zip(p.boundaries + p.group_offsets,
                    q.boundaries + q.group_offsets):
        np.testing.assert_array_equal(a, b)
    # Nothing placed on a device.
    assert not any(isinstance(v, torch.Tensor) for v in vars(p).values())
    assert not hasattr(p, 'text') and not hasattr(p, 'rank')
    p.warm_probe(np.array([4, 9], dtype=np.int32))  # CPU: nothing to warm
    idx = DeviceIndex(tch, device='cpu', mode=mode)
    assert idx.cover_bytes == p.cover_bytes
    assert idx.groups == p.groups and idx.n_pad == p.n_pad


def test_plan_takes_the_constructor_arguments():
    import inspect

    init = inspect.signature(DeviceIndex.__init__).parameters
    plan = inspect.signature(DeviceIndex.plan).parameters
    assert list(plan) == [p for p in init if p != 'self']
    with pytest.raises(TypeError):
        DeviceIndex.plan([], device='cpu', sharding=None)


@pytest.mark.parametrize('kind', KINDS)
def test_probe_class_keys(kind):
    tch, jch = _chunk_pair(_bodies(kind)[0])
    p = DeviceIndex.plan(tch, device='cpu', mode='upload')
    q = JIndex.plan(jch, mode='upload')
    lengths = np.array([3, 4, 9, 30, 200], dtype=np.int32)
    jkeys = q.probe_class_keys(lengths)
    keys = p.probe_class_keys(lengths)
    if kind == 'digit':
        assert keys == jkeys == []
        return
    assert jkeys and keys == [('probe_phased', 'probe_phased_kernel')]
    wide = np.full(tsearch.PHASED_PAIRS_WIDE // p.num_chunks + 1, 5,
                   dtype=np.int32)
    assert p.probe_class_keys(wide) == [('probe_phased',
                                         'probe_phased_wide_kernel')]
    assert p.probe_class_keys(wide[:-1]) == [('probe_phased',
                                              'probe_phased_kernel')]
    assert p.probe_class_keys(lengths[:0]) == []


def test_probe_class_keys_of_an_empty_index():
    assert DeviceIndex.plan([], device='cpu').probe_class_keys(
        np.array([4], np.int32)) == JIndex.plan([]).probe_class_keys(
            np.array([4], np.int32)) == []


def test_phased_split_matches_the_kernel_source():
    src = os.path.join(os.path.dirname(tsearch.__file__), '..', 'csrc',
                       'search_kernels.cu')
    with open(src) as f:
        m = re.search(r'kPhasedPairsWide = 1 << (\d+);', f.read())
    assert m and tsearch.PHASED_PAIRS_WIDE == 1 << int(m.group(1))


@pytest.mark.parametrize('kind', KINDS)
def test_probe_device_parts(kind, monkeypatch):
    """The parts read back equal ``probe`` (the raw kind's NUL patterns
    aside, which ``probe`` zeroes on the host), and equal the JAX parts on
    patterns without NUL."""
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    bodies, words = _bodies(kind)
    tch, jch = _chunk_pair(bodies)
    t = DeviceIndex(tch, device='cpu', mode='derive')
    j = JIndex(jch, mode='derive')
    clean = words[:10] + [b'', b'\n', bodies[0][-3:] + bodies[1][:3],
                          bodies[2][100:140], b'~~~~']
    nul = [words[0] + b'\x00', b'\x00']
    packed, lengths = tsearch.pack_patterns(clean + nul)
    parts = t.probe_device_parts(packed, lengths)
    assert len(parts) == 1
    members, lo_d, cnt_d = parts[0]
    np.testing.assert_array_equal(members, np.arange(len(clean + nul)))
    assert isinstance(lo_d, torch.Tensor) and lo_d.device == t.device
    lo, cnt = t.probe(packed, lengths)
    keep = slice(0, len(clean)) if kind == 'raw' else slice(None)
    np.testing.assert_array_equal(cnt_d.numpy()[:, keep], cnt[:, keep])
    np.testing.assert_array_equal(lo_d.numpy()[:, keep], lo[:, keep])
    if kind == 'raw':
        assert not cnt[:, len(clean):].any()
    jp, jl = jsearch.pack_patterns(clean)
    jlo = np.zeros((j.num_chunks, len(clean)), np.int32)
    jcnt = np.zeros_like(jlo)
    for idx, lo_k, cnt_k in j.probe_device_parts(jp, jl):
        jlo[:, idx] = np.asarray(lo_k)[:, : idx.size]
        jcnt[:, idx] = np.asarray(cnt_k)[:, : idx.size]
    tlo, tcnt = (x.numpy()[:, : len(clean)] for x in
                 t.probe_device_parts(*tsearch.pack_patterns(clean))[0][1:])
    np.testing.assert_array_equal(tcnt, jcnt)
    hit = jcnt > 0
    np.testing.assert_array_equal(tlo[hit], jlo[hit])
    assert hit.sum() > 20


def test_probe_device_parts_edges():
    t = DeviceIndex(_chunk_pair(_bodies('ranked')[0])[0][:2], device='cpu',
                    mode='upload')
    wide = np.zeros((2, t.n_pad + 1), np.uint8)
    (_, lo, cnt), = t.probe_device_parts(wide, np.array([3, 4], np.int32))
    assert lo.shape == cnt.shape == (2, 2) and not cnt.any()
    empty = DeviceIndex([], device='cpu', mode='upload')
    (_, lo, cnt), = empty.probe_device_parts(*tsearch.pack_patterns([b'ab']))
    assert lo.shape == (0, 1)


@functools.lru_cache(maxsize=None)
def _jax_sharded_bounds(kind, mode, pats):
    """(lower, count) int32 [C, B] of the JAX ``DeviceIndex`` with
    ``sharding=chunk_sharding(mesh)`` on conftest's 8-device CPU mesh, its
    parts (one a length class) joined by their member indices; called with
    ``TPUSS_MERGE_CAP`` at ``MERGE_CAP``."""
    mesh = jmesh.make_mesh()
    assert mesh.devices.size == 8
    j = JIndex(_chunk_pair(_bodies(kind)[0])[1], mode=mode,
               sharding=jmesh.chunk_sharding(mesh))
    jp, jl = jsearch.pack_patterns(list(pats))
    lo = np.zeros((j.num_chunks, len(pats)), np.int32)
    cnt = np.zeros_like(lo)
    for idx, lo_k, cnt_k in j.probe_device_parts(jp, jl):
        lo[:, idx] = np.asarray(lo_k)[:, : idx.size]
        cnt[:, idx] = np.asarray(cnt_k)[:, : idx.size]
    return lo, cnt


@pytest.mark.parametrize('devices', [2, 3])
@pytest.mark.parametrize('mode', ['derive', 'upload'])
@pytest.mark.parametrize('kind', KINDS)
def test_sharded_index_device_parts_match_jax(kind, mode, devices,
                                              monkeypatch):
    """``ShardedIndex.probe_device_parts`` over 2 and 3 CPU placements
    (3 leaves padding rows) returns one part on the first device whose
    counts equal the JAX sharded index's everywhere and whose lowers equal
    them where the count is positive; ``probe`` (inherited) equals a
    one-device ``DeviceIndex.probe`` on the real rows, zeroes the padding
    rows and, for the raw kind, the NUL patterns."""
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    bodies, words = _bodies(kind)
    tch, _ = _chunk_pair(bodies)
    s = ShardedIndex(tch, ['cpu'] * devices, mode=mode)
    one = DeviceIndex(tch, device='cpu', mode=mode)
    real = one.num_chunks
    assert 'probe' not in vars(ShardedIndex)
    assert s.num_chunks % devices == 0 and s.num_chunks >= real
    clean = tuple(words[:10] + [b'', b'\n', bodies[0][-3:] + bodies[1][:3],
                                bodies[2][100:140], b'~~~~'])
    nul = [words[0] + b'\x00', b'\x00', b'\n\x00']
    packed, lengths = tsearch.pack_patterns(list(clean) + nul)
    parts = s.probe_device_parts(packed, lengths)
    assert len(parts) == 1
    members, lo_d, cnt_d = parts[0]
    np.testing.assert_array_equal(members, np.arange(len(clean) + len(nul)))
    assert lo_d.device == s.device and lo_d.dtype == torch.int32
    assert lo_d.shape == cnt_d.shape == (s.num_chunks, len(clean) + len(nul))
    tlo, tcnt = lo_d.numpy(), cnt_d.numpy()
    assert not tlo[real:].any() and not tcnt[real:].any()
    jlo, jcnt = _jax_sharded_bounds(kind, mode, clean)
    C = max(s.num_chunks, jlo.shape[0])
    jlo, jcnt, tlo, tcnt = (np.pad(a[:, : len(clean)],
                                   ((0, C - a.shape[0]), (0, 0)))
                            for a in (jlo, jcnt, tlo, tcnt))
    np.testing.assert_array_equal(tcnt, jcnt)
    hit = jcnt > 0
    np.testing.assert_array_equal(tlo[hit], jlo[hit])
    assert hit.sum() > 20
    lo, cnt = s.probe(packed, lengths)
    want_lo, want_cnt = one.probe(packed, lengths)
    np.testing.assert_array_equal(lo[:real], want_lo)
    np.testing.assert_array_equal(cnt[:real], want_cnt)
    assert not lo[real:].any() and not cnt[real:].any()
    keep = slice(0, len(clean)) if kind == 'raw' else slice(None)
    np.testing.assert_array_equal(cnt[:, keep], cnt_d.numpy()[:, keep])
    np.testing.assert_array_equal(lo[:, keep], lo_d.numpy()[:, keep])
    if kind == 'raw':
        assert not cnt[:, len(clean):].any()


def test_sharded_index_device_parts_edges():
    """No rows, an empty batch and patterns wider than ``n_pad``: one part
    of zeros [C, B] on the first device, as ``DeviceIndex`` answers."""
    tch, _ = _chunk_pair(_bodies('ranked')[0])
    s = ShardedIndex(tch, ['cpu'] * 3, mode='upload')
    wide = np.zeros((2, s.n_pad + 1), np.uint8)
    (_, lo, cnt), = s.probe_device_parts(wide, np.array([3, 4], np.int32))
    assert lo.shape == cnt.shape == (6, 2) and not cnt.any()
    (_, lo, cnt), = s.probe_device_parts(np.zeros((0, 4), np.uint8),
                                         np.zeros(0, np.int32))
    assert lo.shape == (6, 0)
    empty = ShardedIndex([], ['cpu', 'cpu'], mode='upload')
    (_, lo, cnt), = empty.probe_device_parts(*tsearch.pack_patterns([b'ab']))
    assert lo.shape == (0, 1)
    lo, cnt = empty.probe(*tsearch.pack_patterns([b'ab']))
    assert lo.shape == cnt.shape == (0, 1)


def test_index_mode_env_overrides_argument(corpus, monkeypatch):
    _, path, _, _ = corpus
    monkeypatch.setenv('TPUSS_INDEX_MODE', 'derive')
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    t = tpss.Reader(path, device='cpu', index_mode='upload')
    j = jpss.Reader(path, index_mode='upload')
    assert t._index.mode == j._index.mode == 'derive'
    assert t._index.groups == j._index.groups
    monkeypatch.setenv('TPUSS_INDEX_MODE', 'upload')
    t = tpss.Reader(path, device='cpu', index_mode='derive')
    j = jpss.Reader(path, index_mode='derive')
    assert t._index.mode == j._index.mode == 'upload'


def test_merge_env_options_match_jax(monkeypatch):
    tch, jch = _chunk_pair(_bodies('raw')[0])
    monkeypatch.setenv('TPUSS_MERGE', '0')
    t = DeviceIndex(tch, device='cpu', mode='derive')
    j = JIndex(jch, mode='derive')
    assert not t.merged and not j.merged
    assert t.groups == j.groups == [[i] for i in range(len(tch))]
    # An explicit argument wins over the env.
    assert DeviceIndex.plan(tch, device='cpu', mode='derive',
                            merge=True).merged
    monkeypatch.delenv('TPUSS_MERGE')
    # The cap from the env alone, the class attribute untouched.
    for cap in (2000, 4000, 9000):
        monkeypatch.setenv('TPUSS_MERGE_CAP', str(cap))
        assert DeviceIndex.plan(tch, device='cpu', mode='derive').groups \
            == JIndex.plan(jch, mode='derive').groups
    monkeypatch.delenv('TPUSS_MERGE_CAP')
    assert DeviceIndex.MERGE_CAP_DEFAULT == JIndex.MERGE_CAP_DEFAULT
    assert DeviceIndex.plan(tch, device='cpu', mode='derive').groups == \
        [list(range(len(tch)))]


@pytest.mark.parametrize('flag', ['0', 'false', 'no', '1', 'yes'])
def test_bg_load_env_matches_jax(corpus, flag, monkeypatch):
    _, path, _, pats = corpus
    monkeypatch.setenv('TPUSS_BG_LOAD', flag)
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(MERGE_CAP))
    t = tpss.Reader(path, device='cpu', index_mode='derive')
    j = jpss.Reader(path, index_mode='derive')
    background = flag not in ('0', 'false', 'no')
    assert (t._bg_thread is not None) == (j._bg_thread is not None) \
        == background
    # A synchronous load builds at the first query.
    assert t.wait_device_ready(60) == j.wait_device_ready(60) == background
    short = [p for p in pats if len(p) <= tsearch.PAD_MARGIN]
    assert [sorted(x) for x in t._search_batch(short)] == \
        [sorted(x) for x in j._search_batch(short)]
    for r in (t, j):
        assert r.profiler.counts.get('device-warm', 0) == int(background)
        assert r.profiler.counts['device-load'] == 1


def test_device_warm_after_background_load(corpus, monkeypatch):
    """A background load records ``device-warm`` after ``device-load``, and
    on the CPU it measures no round trip and caches no link rates."""
    _, path, _, _ = corpus
    monkeypatch.setenv('TPUSS_BG_LOAD', '1')
    r = tpss.Reader(path, device='cpu')
    assert r.wait_device_ready(60)
    assert r.profiler.counts['device-load'] == 1
    assert r.profiler.counts['device-warm'] == 1
    assert tsa._DEVICE_RTT is None and tsa._LINK_RATES is None
    assert r.search('') and r.profiler.counts['probe'] == 1
