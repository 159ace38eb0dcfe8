"""The port's scale-out path on the CPU against the JAX package: B15 (the
byte-window probe, the bucket table, the capped gather), the chunk-parallel
programs at world 1 against the JAX mesh programs on the 8-device CPU
mesh, ShardedReader over several CPU placements against the JAX
ShardedReader, state carried over from it, and the default device of
``DeviceIndex.from_arrays``."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.parallel import mesh as jmesh
from pysubstringsearch_tpu.parallel import sharded as jsharded
from pysubstringsearch_tpu.parallel.reader import ShardedReader as JSharded
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import search as tsearch
from pysubstringsearch_tpu_torch.ops.suffix_array import (
    _pad_len,
    suffix_array_numpy,
)
from pysubstringsearch_tpu_torch.parallel import mesh as tmesh
from pysubstringsearch_tpu_torch.parallel import sharded as tsharded
from pysubstringsearch_tpu_torch.parallel.reader import (
    ShardedIndex,
    ShardedReader,
)

torch.set_num_threads(1)

WORDS = [b'alpha', b'beta', b'gamma', b'delta', b'epsilon', b'zeta']


def _corpus_chunks(num_chunks, seed=0):
    """``tests/test_sharded.py``'s chunks of word lines."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(num_chunks):
        lines = []
        for _ in range(int(rng.integers(5, 30))):
            k = int(rng.integers(1, 5))
            lines.append(b' '.join(WORDS[i] for i in rng.choice(6, size=k)))
        chunks.append(b'\n'.join(lines) + b'\n')
    return chunks


def _stack(raw):
    n_pad = _pad_len(max(len(c) for c in raw) + tsearch.PAD_MARGIN)
    text = np.zeros((len(raw), n_pad), dtype=np.uint8)
    n = np.array([len(c) for c in raw], dtype=np.int32)
    for i, c in enumerate(raw):
        text[i, : len(c)] = np.frombuffer(c, dtype=np.uint8)
    return text, n


def _row(data: np.ndarray, N: int):
    """A padded (text, head-aligned SA) row of ``data``."""
    text = np.zeros(N, np.uint8)
    text[: data.size] = data
    sa = np.zeros(N, np.int32)
    sa[: data.size] = suffix_array_numpy(data)
    return text, sa


def _odd_row(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    data = rng.integers(97, 101, size=n, dtype=np.uint8)
    if n > 20:
        data[::7] = 0  # NUL
        data[::13] = 0xFF  # a high byte
        data[::29] = 0x0A
    return data


def _patterns(data: np.ndarray, seed: int):
    rng = np.random.default_rng(seed)
    pats = [b'', b'a', b'ab', b'\x00', b'\xff', b'\x00a', b'a\xff',
            b'abcd' * 20, b'x']
    for _ in range(40):
        if data.size < 2:
            break
        l = int(rng.integers(1, min(30, data.size) + 1))
        i = int(rng.integers(0, data.size - l + 1))
        pats.append(data[i: i + l].tobytes())
    return pats


def _t(a):
    return torch.from_numpy(np.array(a))


def _edge_case(case: str):
    """(row, patterns) at the edges of the port's wide byte compare:
    lengths around 16 and 32 (and near misses), a row of repeated blocks
    whose suffixes share hundreds of bytes with 100-300-byte patterns,
    0x00 and 0xFF at the row's end with patterns that run into it, and one
    pattern many times."""
    rng = np.random.default_rng(7)
    if case == 'long':
        block = rng.integers(97, 100, size=311, dtype=np.uint8)
        data = np.tile(block, 7)
        data[rng.integers(0, data.size, size=5)] = 0x7a
    else:
        data = _odd_row(1501, 13)
    if case == 'row_ends':
        data[-2:] = [0xFF, 0x00]
    pats = [b'', b'\x00', b'\xff']
    if case == 'repeated':
        return data, [b''] + [data[200: 233].tobytes()] * 64
    lengths = {'lengths': (15, 16, 17, 31, 32, 33), 'long': (100, 200, 300),
               'row_ends': (1, 2, 16, 17)}[case]
    for l in lengths:
        for o in rng.integers(0, data.size - l + 1, size=5):
            p = data[o: o + l].tobytes()
            pats += [p, p[:-1] + bytes([p[-1] ^ 1])]
        if case == 'row_ends':
            tail = data[data.size - l:].tobytes()
            pats += [tail, tail + b'\x00', tail + b'\x01', tail + b'\xff']
    return data, pats


@pytest.mark.parametrize('case', [0, 1, 2, 37, 1500, 'lengths', 'long',
                                  'row_ends', 'repeated'])
def test_probe_matches_jax_probe_bounds(case):
    """B15's plain version equals the JAX unrolled and loop forms on one
    row: empty pattern (count n), empty row (count 0), patterns longer than
    the row, NUL and high bytes, near misses; and at the edges of the
    kernel's wide compare (``_edge_case``)."""
    if isinstance(case, int):
        n = case
        data = _odd_row(n, n)
        pats = _patterns(data, n)
    else:
        data, pats = _edge_case(case)
        n = data.size
    N = _pad_len(n + 64)
    text, sa = _row(data, N)
    packed, lengths = jsearch.pack_patterns(pats)
    jargs = (jnp.asarray(text), n, jnp.asarray(sa), jnp.asarray(packed),
             jnp.asarray(lengths))
    lo_u, cnt_u = map(np.asarray, jsearch.probe_bounds(*jargs))
    lo_l, cnt_l = map(np.asarray, jsearch.probe_bounds_loop(*jargs))
    targs = (_t(text), n, _t(sa), _t(packed), _t(lengths))
    for fn in (tsearch.probe_bounds, tsearch.probe_bounds_loop):
        lo, cnt = fn(*targs)
        np.testing.assert_array_equal(lo.numpy(), lo_u)
        np.testing.assert_array_equal(cnt.numpy(), cnt_u)
    np.testing.assert_array_equal(lo_l, lo_u)
    np.testing.assert_array_equal(cnt_l, cnt_u)
    assert cnt_u[0] == n  # the empty pattern
    if not isinstance(case, int):
        for b, p in enumerate(pats):
            assert cnt_u[b] == sum(data[s: s + len(p)].tobytes() == p
                                   for s in range(n)), p


def test_probe_rows_match_vmapped_jax_on_sharded_corpus():
    """B15 over [C, N] rows (one call) equals the JAX probe row by row on
    the corpus of tests/test_sharded.py, with a pattern longer than its
    row and an empty row beside full ones."""
    raw = _corpus_chunks(6, seed=1) + [b'']
    text, n = _stack(raw)
    sa = np.zeros(text.shape, np.int32)
    for i, c in enumerate(raw):
        sa[i, : len(c)] = suffix_array_numpy(np.frombuffer(c, np.uint8))
    pats = [b'alpha', b'beta beta', b'zeta', b'nope', b'', b'a',
            raw[0] + b'alpha', raw[1][:40], b'\n', b'a\nb']
    packed, lengths = jsearch.pack_patterns(pats)
    lo, cnt = tsearch.probe_bytes(_t(text), _t(n), _t(sa), _t(packed),
                                  _t(lengths))
    for i in range(len(raw)):
        lj, cj = jsearch.probe_bounds_loop(
            jnp.asarray(text[i]), int(n[i]), jnp.asarray(sa[i]),
            jnp.asarray(packed), jnp.asarray(lengths))
        np.testing.assert_array_equal(lo[i].numpy(), np.asarray(lj))
        np.testing.assert_array_equal(cnt[i].numpy(), np.asarray(cj))
        for b, p in enumerate(pats):
            want = len(raw[i]) if not p else sum(
                raw[i][s: s + len(p)] == p for s in range(len(raw[i])))
            assert cnt[i, b] == want, (i, p)
    assert cnt[-1].eq(0).all()


@pytest.mark.parametrize('depth', [2, 3])
@pytest.mark.parametrize('n', [0, 1, 300, 2500])
def test_bucket_table_matches_jax(depth, n):
    """``build_bucket_table`` equals the JAX function on a padded row (pad
    slots of the SA hold garbage; the last entry is n)."""
    data = _odd_row(n, 3 + n)
    N = _pad_len(n + 16)
    text, sa = _row(data, N)
    sa[n:] = np.arange(N - n, dtype=np.int32)[::-1] + 7  # pad-slot garbage
    want = np.asarray(jsearch.build_bucket_table(
        jnp.asarray(text), n, jnp.asarray(sa), depth))
    got = tsearch.build_bucket_table(_t(text), n, _t(sa), depth).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[-1] == n


def test_bucket_table_needs_margin():
    text, sa = _row(_odd_row(16, 1), 16)
    with pytest.raises(ValueError):
        tsearch.build_bucket_table(_t(text), 16, _t(sa), 3)


@pytest.mark.parametrize('cap', [1, 7, 64, 4096])
def test_gather_hit_positions_matches_jax(cap):
    data = _odd_row(1200, 5)
    N = _pad_len(1200 + 16)
    text, sa = _row(data, N)
    packed, lengths = jsearch.pack_patterns(_patterns(data, 9))
    lo, cnt = map(np.asarray, jsearch.probe_bounds_loop(
        jnp.asarray(text), 1200, jnp.asarray(sa), jnp.asarray(packed),
        jnp.asarray(lengths)))
    want = np.asarray(jsearch.gather_hit_positions(
        jnp.asarray(sa), jnp.asarray(lo), jnp.asarray(cnt), cap))
    got = tsearch.gather_hit_positions(_t(sa), _t(lo), _t(cnt), cap)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('B, cap, edge', [
    (0, 64, 'none'), (40, 1, 'zeros'), (40, 64, 'tail'), (40, 5000, 'tail'),
    (40, 63, 'zeros')])
def test_gather_hit_positions_edges_match_jax(B, cap, edge):
    """The capped gather at B = 0, cap 1, 64 and above N, a row width that
    is no multiple of 4, zero counts, and bounds near N - 1 whose counts
    run past the row (clipped to N - 1)."""
    rng = np.random.default_rng(B + cap)
    N = 1024
    sa = rng.permutation(N).astype(np.int32)
    lo = rng.integers(0, N, B).astype(np.int32)
    cnt = rng.integers(0, 90, B).astype(np.int32)
    if edge == 'zeros':
        cnt[::2] = 0
    if edge == 'tail':
        lo[-4:] = [N - 1, N - 2, N - 3, N - 70]
        cnt[-4:] = [5, 80, 1, 90]
    want = np.asarray(jsearch.gather_hit_positions(
        jnp.asarray(sa), jnp.asarray(lo), jnp.asarray(cnt), cap))
    got = tsearch.gather_hit_positions(_t(sa), _t(lo), _t(cnt), cap)
    assert got.shape == (B, min(cap, N)) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture(scope='module')
def jax_mesh():
    import jax

    if len(jax.devices()) < 8:
        pytest.skip('needs the 8-device CPU mesh of tests/conftest.py')
    return jmesh.make_mesh()


def _cpu_mesh():
    mesh = tmesh.make_mesh('cpu')
    assert mesh.world == 1 and not mesh.distributed
    return mesh


def test_sharded_build_matches_jax(jax_mesh):
    raw = _corpus_chunks(8) + [b'', b'x']
    raw += _corpus_chunks(6, seed=4)
    text, n = _stack(raw)
    want = np.asarray(jsharded.make_sharded_build(jax_mesh)(text, n))
    got = tsharded.make_sharded_build(_cpu_mesh())(text, n)
    assert got.dtype == torch.int32 and got.shape == want.shape
    N = text.shape[1]
    for i, c in enumerate(raw):
        # Slots [0, n) are the row's SA in both; the pad suffixes behind it
        # tie in their last rounds, and the JAX sort is not stable.
        np.testing.assert_array_equal(got[i, : len(c)].numpy(),
                                      want[i, : len(c)])
        np.testing.assert_array_equal(
            got[i, : len(c)].numpy(),
            suffix_array_numpy(np.frombuffer(c, np.uint8)))
        assert sorted(got[i, len(c):].tolist()) == list(range(len(c), N))


def test_sharded_probe_matches_jax(jax_mesh):
    raw = _corpus_chunks(8, seed=1)
    text, n = _stack(raw)
    sa = jsharded.make_sharded_build(jax_mesh)(text, n)
    pats = [b'alpha', b'beta beta', b'zeta', b'nope', b'', b'\n', b'a']
    packed, lengths = jsearch.pack_patterns(pats)
    want = np.asarray(jsharded.make_sharded_probe(jax_mesh)(
        text, n, sa, packed, lengths))
    mesh = _cpu_mesh()
    sa_host = np.asarray(sa)
    got = tsharded.make_sharded_probe(mesh)(text, n, sa_host, packed,
                                            lengths)
    assert got.shape == want.shape == (8, len(pats), 2)
    np.testing.assert_array_equal(got.numpy(), want)
    local = tsharded.make_sharded_probe(mesh, gather=False)(
        text, n, sa_host, packed, lengths)
    np.testing.assert_array_equal(local.numpy(), want)


def test_full_step_matches_jax(jax_mesh):
    raw = _corpus_chunks(16, seed=2)
    text, n = _stack(raw)
    pats = [b'alpha', b'qqq', b'', b'a b']
    packed, lengths = jsearch.pack_patterns(pats)
    jb, jt = jsharded.make_full_step(jax_mesh)(text, n, packed, lengths)
    tb, tt = tsharded.make_full_step(_cpu_mesh())(text, n, packed, lengths)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    assert tt.dtype == torch.int32
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    assert tt[0] == sum(c.count(b'alpha') for c in raw) and tt[1] == 0


def test_mesh_padding_and_blocks():
    mesh = tmesh.make_mesh(['cpu'] * 3)
    assert mesh.size == 3 and tmesh.pad_chunk_count(7, mesh) == 9
    assert tmesh.rank_rows(9, mesh) == slice(0, 9)
    with pytest.raises(ValueError):
        mesh.device  # several placements: not a program mesh
    x = torch.arange(6).reshape(3, 2)
    assert tmesh.all_gather_rows(x, _cpu_mesh()) is x


@pytest.fixture(scope='module')
def index_path(tmp_path_factory):
    """``tests/test_sharded_reader.py``'s container, written by the port."""
    path = str(tmp_path_factory.mktemp('sharded_reader') / 'index.idx')
    with tpss.Writer(path, max_chunk_len=64) as w:
        for i in range(50):
            w.add_entry(f'entry number {i} of the corpus')
        for e in ['shared token alpha'] * 3 + ['unique omega']:
            w.add_entry(e)
    return path


PATS = ['entry', 'number 7 ', 'alpha', 'omega', 'missing', '', 'corpus',
        'the corpus', 'r 1']


@pytest.mark.parametrize('mode', ['upload', 'derive', 'merged'])
def test_sharded_reader_matches_jax(index_path, monkeypatch, mode):
    """The same groups, padding and result multisets as the JAX
    ShardedReader over the same container: upload, derive, and derive over
    merged rows (merge cap 512)."""
    index_mode = 'upload' if mode == 'upload' else 'derive'
    if mode == 'merged':
        monkeypatch.setenv('TPUSS_MERGE_CAP', '512')
        monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 512)
    j = JSharded(index_path, index_mode=index_mode)
    t = ShardedReader(index_path, ['cpu'] * 8, index_mode=index_mode)
    idx = t._index
    assert isinstance(idx, ShardedIndex) and len(idx.parts) == 8
    assert idx.mode == j._index.mode == index_mode
    # Derive merges every chunk into one row under the default cap, into
    # several under the 512-byte one.
    assert idx.merged == j._index.merged == (mode != 'upload')
    assert idx.groups == j._index.groups
    assert t._C == j._C and t._C % 8 == 0
    assert t._num_real == j._num_real < t._C
    assert (t._num_real > 1) == (mode != 'derive')
    assert idx.num_limbs == j._index.num_limbs
    assert (idx._base, idx._depth, idx.n_pad) == (
        j._index._base, j._index._depth, j._index.n_pad)
    plain = tpss.Reader(index_path, device='cpu')
    for pat in PATS:
        got = collections.Counter(t.search(pat))
        assert got == collections.Counter(j.search(pat)), pat
        assert got == collections.Counter(plain.search(pat)), pat
    assert collections.Counter(t.search_multiple(PATS)) == \
        collections.Counter(j.search_multiple(PATS))


def test_sharded_index_carries_jax_state(index_path):
    """The JAX ShardedReader's index, read back as numpy and loaded with
    ``from_arrays``, probes as the JAX sharded index does: padding rows
    included."""
    j = JSharded(index_path, index_mode='upload')._index
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind=j.kind, bits=j._bits, base=j._base, depth=j._depth,
                num_limbs=j.num_limbs, mode=j.mode, groups=j.groups,
                boundaries=j.boundaries)
    t = DeviceIndex.from_arrays(arrays, meta, 'cpu')
    assert t.num_chunks == j.num_chunks and t.groups == j.groups
    packed, lengths = tsearch.pack_patterns(
        [p.encode() for p in PATS] + [b'entry number 4', b'\x00'])
    lo_j, cnt_j = j.probe(packed, lengths)
    lo_t, cnt_t = t.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    hit = cnt_j > 0
    np.testing.assert_array_equal(lo_t[hit], lo_j[hit])
    assert cnt_t[len(j.groups) - 1].sum() == 0  # a padding row


def test_from_arrays_defaults_to_cuda(monkeypatch):
    """Without ``device``, ``from_arrays`` targets the CUDA card: here, with
    no card, it raises instead of building on the CPU."""
    import inspect

    sig = inspect.signature(DeviceIndex.from_arrays)
    assert sig.parameters['device'].default == 'cuda'
    j = JIndex([], mode='upload')
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind='digit', bits=None, base=258, depth=2, num_limbs=3)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        DeviceIndex.from_arrays(arrays, meta)
    assert DeviceIndex.from_arrays(arrays, meta, 'cpu').num_chunks == 0


def test_jax_and_port_readers_agree_on_plain_reader(index_path):
    """The JAX plain Reader over the port-written container answers as the
    port's ShardedReader on one CPU placement (a world of one)."""
    t = ShardedReader(index_path, ['cpu'])
    assert len(t._index.parts) == 1 and t._C == t._num_real
    j = jpss.Reader(index_path)
    for pat in PATS:
        assert collections.Counter(t.search(pat)) == \
            collections.Counter(j.search(pat)), pat
