"""Derive mode over merged rows in the port, on the CPU, against the JAX
package's derive index and Reader: grouping under the merge cap, exact
counts with boundary crossings removed, state carried over with
``from_arrays``, and result multisets end to end."""

import collections
import os

import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu.container import Chunk as JChunk
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu_torch.container import Chunk
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops.hostserve import HostServing
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN, pack_patterns
from pysubstringsearch_tpu_torch.ops.suffix_array import suffix_array_numpy
from pysubstringsearch_tpu_torch.utils.profiling import PhaseProfiler

torch.set_num_threads(1)

RNG = np.random.default_rng(77)
WORDS = [bytes(RNG.integers(97, 107, size=int(l)).astype(np.uint8))
         for l in RNG.integers(3, 8, size=30)]


def _body(nlines: int, seed: int) -> bytes:
    r = np.random.default_rng(seed)
    lines = [b' '.join(WORDS[i] for i in r.integers(0, 30, size=4))
             for _ in range(nlines)]
    return b'\n'.join(lines) + b'\n'


def _chunks(bodies, cls=Chunk):
    out = []
    for body in bodies:
        data = np.frombuffer(body, dtype=np.uint8)
        out.append(cls(data=data, suffix_array=suffix_array_numpy(data)))
    return out


def _count(haystack: bytes, needle: bytes) -> int:
    if not needle:
        return len(haystack)
    n, i = 0, haystack.find(needle)
    while i != -1:
        n += 1
        i = haystack.find(needle, i + 1)
    return n


def _derive(bodies, **kw):
    return DeviceIndex(_chunks(bodies), device='cpu', mode='derive', **kw)


def test_grouping_matches_jax_under_cap(monkeypatch):
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 3000)
    monkeypatch.setenv('TPUSS_MERGE_CAP', '3000')
    bodies = [_body(40 + 7 * i, i) for i in range(6)]
    idx = _derive(bodies)
    plan = JIndex.plan(_chunks(bodies, JChunk), mode='derive')
    assert idx.merged and idx.groups == plan.groups
    assert len(idx.groups) > 1
    sizes = [len(b) for b in bodies]
    for r, g in enumerate(idx.groups):
        assert idx.row_data[r].size == sum(sizes[i] for i in g)
        assert idx.row_data[r].size <= max(3000, max(sizes[i] for i in g))
        np.testing.assert_array_equal(idx.boundaries[r], plan.boundaries[r])
        np.testing.assert_array_equal(idx.group_offsets[r],
                                      plan.group_offsets[r])
    assert b''.join(d.tobytes() for d in idx.row_data) == b''.join(bodies)


def test_merged_counts_match_per_chunk_truth():
    bodies = [_body(60, 1), _body(60, 2), _body(60, 3)]
    idx = _derive(bodies, merge=True)
    assert idx.merged and idx.num_chunks == 1
    pats = [WORDS[0], WORDS[1][:2], b'zz', b'', WORDS[2] + b' ' + WORDS[3],
            b'\n' + WORDS[4][:2]]
    cnt = idx.count_matches(*pack_patterns(pats))
    for b, p in enumerate(pats):
        assert cnt[:, b].sum() == sum(_count(x, p) for x in bodies), p


def test_boundary_crossing_newline_patterns():
    a, b = b'alpha\nbravo\n', b'bravo\ncharlie\n'
    idx = _derive([a, b], merge=True)
    assert idx.merged
    pats = [b'bravo\nbravo', b'alpha\nbravo', b'bravo\ncharlie', b'bravo']
    packed, lengths = pack_patterns(pats)
    _, raw = idx.probe(packed, lengths)
    # The raw merged count sees the occurrence across the boundary ...
    assert raw[0, 0] == _count(a + b, pats[0]) == 1
    # ... the exact count does not; within-chunk newline patterns stay.
    assert list(idx.count_matches(packed, lengths)[0]) == [0, 1, 1, 2]


def test_multi_boundary_crossing_attributed_once():
    idx = _derive([b'x\n', b'y\n', b'z\n'], merge=True)
    cnt = idx.count_matches(*pack_patterns([b'x\ny\nz', b'x\ny', b'y\nz',
                                            b'\n']))
    assert list(cnt[0]) == [0, 0, 0, 3]


def _jax_derive(bodies):
    return JIndex(_chunks(bodies, JChunk), mode='derive', merge=True)


def test_carry_over_from_jax_derive_index(monkeypatch):
    monkeypatch.setenv('TPUSS_MERGE_CAP', '3500')
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 3500)
    bodies = [_body(50 + 9 * i, 20 + i) for i in range(5)]
    j = _jax_derive(bodies)
    assert j.merged and j.num_chunks > 1
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind=j.kind, bits=j._bits, base=j._base, depth=j._depth,
                num_limbs=j.num_limbs, mode=j.mode, groups=j.groups,
                boundaries=j.boundaries)
    t = DeviceIndex.from_arrays(arrays, meta, 'cpu')
    assert t.merged and t.groups == j.groups
    assert t.num_source_chunks == len(bodies)
    pats = [WORDS[0], WORDS[5][:3], b'', b'zz', b'\n', WORDS[1] + b'\n',
            b'\n' + WORDS[7][:2], WORDS[2] + b' ' + WORDS[3]]
    for body in bodies[:-1]:
        pats.append(body[-6:] + b'x')  # up to the boundary
    tails = [bodies[i][-4:] + bodies[i + 1][:4] for i in range(4)]
    pats += tails  # straddle each boundary
    packed, lengths = pack_patterns(pats)
    lo_j, cnt_j = j.probe(packed, lengths)
    lo_t, cnt_t = t.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    hit = cnt_j > 0
    np.testing.assert_array_equal(lo_t[hit], lo_j[hit])
    crossings = t.boundary_crossings(packed, lengths)
    np.testing.assert_array_equal(crossings,
                                  j.boundary_crossings(packed, lengths))
    interior = sum(len(g) - 1 for g in j.groups)
    assert interior > 0 and crossings.sum() >= interior
    # The port's own derive over the same chunks builds the same index.
    own = _derive(bodies)
    assert own.groups == j.groups and own.n_pad == j.n_pad
    for r, d in enumerate(own.row_data):
        np.testing.assert_array_equal(own.sa[r, : d.size].numpy(),
                                      arrays['sa'][r, : d.size])
    for name in ('text', 'sa', 'tables', 'limbs'):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      arrays[name], name)


def _corpus_lines():
    rng = np.random.default_rng(11)
    words = [bytes(rng.integers(97, 123, size=int(l), dtype=np.uint8))
             for l in rng.integers(3, 9, size=200)]
    lines = [b' '.join(words[i] for i in rng.integers(0, 200, size=5))
             for _ in range(1500)]
    lines[700] = b' '.join(words[i % 200] for i in range(250))
    assert len(lines[700]) > PAD_MARGIN + 100
    return lines


@pytest.fixture(scope='module')
def container(tmp_path_factory):
    lines = _corpus_lines()
    path = str(tmp_path_factory.mktemp('merged') / 'c.idx')
    with tpss.Writer(path, max_chunk_len=6 << 10) as w:
        for ln in lines:
            w.add_entry(ln.decode())
    return lines, path


def _reader_patterns(lines, chunks):
    rng = np.random.default_rng(5)
    text = b'\n'.join(lines)
    pats = [text[o: o + int(l)] for o, l in zip(
        rng.integers(0, len(text) - 30, size=60), rng.integers(2, 12, 60))]
    c0 = chunks[0].data.tobytes()
    c1 = chunks[1].data.tobytes()
    pats += [
        c0[-5:] + c1[:4],  # straddles the first chunk boundary
        lines[3][-3:] + b'\n' + lines[4][:3],  # newline within a chunk
        b'zzqqzzqq', b'', b'\n',
        lines[700][10: 10 + PAD_MARGIN + 40],  # host route
    ]
    pats += pats[:10]  # duplicates
    return pats


def test_reader_derive_matches_jax_reader(container, monkeypatch):
    lines, path = container
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(20 << 10))
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 20 << 10)
    # The JAX Reader's readback cap on both, so both take the device route.
    monkeypatch.setattr(tpss.api.Reader, '_READBACK_CAP',
                        jpss.api.Reader._READBACK_CAP)
    tr = tpss.Reader(path, device='cpu', index_mode='derive')
    jr = jpss.Reader(path, index_mode='derive')
    idx = tr._index
    assert idx.mode == 'derive' and idx.merged and idx.num_chunks > 1
    assert idx.groups == jr._index.groups
    pats = _reader_patterns(lines, tr._chunks)
    want = [sorted(x) for x in jr._search_batch(pats)]
    got = [sorted(x) for x in tr._search_batch(pats)]
    assert got == want
    assert want[60] == [] and sum(map(len, got)) > 500
    strs = [p.decode() for p in pats]
    assert collections.Counter(tr.search_multiple(strs)) == \
        collections.Counter(jr.search_multiple(strs))
    assert tr.profiler.counts['x-dev-gather'] > 0


def test_merged_rows_never_use_hostserving_extract(container, monkeypatch):
    lines, path = container
    r = tpss.Reader(path, device='cpu', index_mode='derive')
    pats = _reader_patterns(lines, r._chunks)[:62]  # no host-route pattern
    want = [sorted(x) for x in r._search_host_chunks(pats)]

    def forbidden(*_):
        raise AssertionError('HostServing.extract on merged rows')

    monkeypatch.setattr(HostServing, 'extract', forbidden)
    assert r._host_serving is not None and r._index.merged
    assert [sorted(x) for x in r._search_batch(pats)] == want


def test_auto_mode_on_cpu_is_upload(container):
    _, path = container
    r = tpss.Reader(path, device='cpu')
    assert r._index.mode == 'upload' and not r._index.merged
    assert r._index.num_chunks == len(r._chunks) > 1
    idx = DeviceIndex(_chunks([_body(20, 1), _body(20, 2)]), device='cpu')
    assert idx.mode == 'upload' and idx.groups == [[0], [1]]


def test_single_chunk_derive_equals_container_sa(container):
    lines, path = container
    one = str(os.path.join(os.path.dirname(path), 'one.idx'))
    with tpss.Writer(one) as w:
        for ln in lines[:200]:
            w.add_entry(ln.decode())
    r = tpss.Reader(one, device='cpu', index_mode='derive')
    idx = r._index
    assert idx.mode == 'derive' and not idx.merged and idx.num_chunks == 1
    n = r._chunks[0].data.size
    np.testing.assert_array_equal(idx.sa[0, :n].numpy(),
                                  r._chunks[0].suffix_array)
    assert sorted(r.search(lines[5][:7].decode())) == sorted(
        ln.decode() for ln in lines[:200] if lines[5][:7] in ln)


def test_derive_phases_recorded():
    prof = PhaseProfiler()
    idx = DeviceIndex(_chunks([_body(30, i) for i in range(3)]),
                      device='cpu', mode='derive', profiler=prof)
    C = idx.num_chunks
    assert dict(prof.counts) == {
        'index-alphabet': 1, 'index-merge': 1, 'index-alloc': 1,
        'index-h2d': C, 'index-sa': C, 'index-aux': 1,
    }
    assert len(idx.sa_ties) == C
