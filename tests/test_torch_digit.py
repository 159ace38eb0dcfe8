"""The digit kind in the port (an alphabet of more than 62 bytes that holds
NUL), as its plain PyTorch versions run it on the CPU, against the JAX
package on the same numpy inputs: the base-258 limb planes and bucket
tables (B12d), the digit-limb probe (B11), the digit index in derive and
upload mode, and the Reader over a UTF-16 corpus.  Integers compare
exactly.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu.container import Chunk as JChunk
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu_torch.container import Chunk
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import search as tsearch
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN, pack_patterns
from pysubstringsearch_tpu_torch.ops.suffix_array import suffix_array_numpy

torch.set_num_threads(1)

#: One padded row length for every case, so each JAX program compiles once.
N = 4096

_jlimbs = jax.jit(jsearch.build_limbs_device, static_argnums=3)
_jbucket = jax.jit(jsearch.build_bucket_table_device, static_argnums=3)


def _nul_heavy() -> np.ndarray:
    data = np.random.default_rng(1).integers(0, 256, size=3000)
    data[::3] = 0
    return data.astype(np.uint8)


def _utf16(seed: int, nlines: int) -> bytes:
    """Lines of printable words encoded as UTF-16LE, newline included:
    every second byte of ASCII text is NUL."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 7, size=40)]
    lines = [b' '.join(words[i] for i in rng.integers(0, 40, size=5))
             for _ in range(nlines)]
    return ''.join(ln.decode() + '\n' for ln in lines).encode('utf-16-le')


CASES = {
    'nul_heavy': _nul_heavy,
    # every byte value, NUL and 0xff included
    'all_bytes': lambda: np.random.default_rng(2).permutation(
        np.tile(np.arange(256, dtype=np.uint8), 11)),
    'utf16': lambda: np.frombuffer(_utf16(3, 60), dtype=np.uint8)[:3000],
    'short': lambda: np.frombuffer(b'\x00a\xff', dtype=np.uint8).copy(),
    'empty': lambda: np.zeros(0, dtype=np.uint8),
}


def _row(case: str):
    """(data, padded text [N], SA [N] in the derive layout: the text's SA
    in slots [0, n), the pad positions N - 1, ..., n after it)."""
    data = CASES[case]()
    n = data.size
    text = np.zeros(N, dtype=np.uint8)
    text[:n] = data
    sa = np.empty(N, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    sa[n:] = np.arange(N - 1, n - 1, -1)
    return data, text, sa


@pytest.mark.parametrize('case', ['nul_heavy', 'all_bytes', 'utf16',
                                  'short', 'empty'])
@pytest.mark.parametrize('K', [1, 2, 3, 4, 5])
def test_digit_limb_planes_match_jax(case, K):
    data, text, sa = _row(case)
    n = data.size
    limbs = tsearch.digit_limb_planes(torch.from_numpy(text),
                                      torch.from_numpy(sa), n, K)
    want = np.asarray(_jlimbs(jnp.asarray(text), n, jnp.asarray(sa), K))
    np.testing.assert_array_equal(limbs.numpy(), want)
    host = tsearch.build_limbs_host(data, sa[:n], K)
    np.testing.assert_array_equal(host,
                                  jsearch.build_limbs_host(data, sa[:n], K))
    np.testing.assert_array_equal(limbs.numpy(),
                                  tsearch.pad_limbs_host(host, N))


@pytest.mark.parametrize('case', ['nul_heavy', 'all_bytes', 'utf16'])
@pytest.mark.parametrize('K', [1, 5])
def test_digit_limbs_are_k7_at_depth_3_from_offset_2_stride_3(case, K):
    """The limbs are K7's values (identity rank, base 258, depth 3)
    gathered at offset 2, stride 3: the stream the JAX program gathers,
    which the card's kernel reads the text for instead."""
    data, text, sa = _row(case)
    n = data.size
    ident = torch.from_numpy(tsearch.identity_rank()[0])
    pv = tsearch.seed_prefix_plain(torch.from_numpy(text), n, ident, 258, 3)
    composed = tsearch._limb_planes_plain(
        pv, torch.from_numpy(sa), n, tsearch.DIGIT_LIMB_OFFSET,
        tsearch.DIGIT_LIMB_STRIDE, K)
    plain = tsearch.digit_limb_planes_plain(torch.from_numpy(text),
                                            torch.from_numpy(sa), n, K)
    assert torch.equal(composed, plain)


#: A row length that is not a multiple of 16, and true lengths at its end:
#: windows of the last suffixes cross n, and at n = N - 1 and N the row's
#: end, where a digit is 0.
N_EDGE = 4099
EDGE_NS = (N_EDGE, N_EDGE - 1, N_EDGE - PAD_MARGIN, N_EDGE - 7)


@pytest.mark.parametrize('n', EDGE_NS)
@pytest.mark.parametrize('case, K', [('all_bytes', 5), ('utf16', 2)])
def test_digit_limb_planes_at_row_edges(case, K, n):
    """B12d's plain version (and the wrapper's CPU path) equals the JAX
    ``build_limbs_device`` and the host builder at true lengths up to the
    row's end; K7's depth-3 values gathered at offset 2, stride 3 agree
    below n = N (at n = N the gather's clamp to N - 1 would read a digit)."""
    data = np.resize(CASES[case](), n)
    text = np.zeros(N_EDGE, dtype=np.uint8)
    text[:n] = data
    text[n:] = 0xff  # bytes past n must not count
    sa = np.empty(N_EDGE, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    sa[n:] = np.arange(N_EDGE - 1, n - 1, -1)
    t, s = torch.from_numpy(text), torch.from_numpy(sa)
    plain = tsearch.digit_limb_planes_plain(t, s, n, K)
    assert torch.equal(tsearch.digit_limb_planes(t, s, n, K), plain)
    want = np.asarray(_jlimbs(jnp.asarray(text), n, jnp.asarray(sa), K))
    np.testing.assert_array_equal(plain.numpy(), want)
    np.testing.assert_array_equal(plain.numpy(), tsearch.pad_limbs_host(
        tsearch.build_limbs_host(data, sa[:n], K), N_EDGE))
    if n < N_EDGE:
        ident = torch.from_numpy(tsearch.identity_rank()[0])
        pv = tsearch.seed_prefix_plain(t, n, ident, 258, 3)
        assert torch.equal(plain, tsearch._limb_planes_plain(
            pv, s, n, tsearch.DIGIT_LIMB_OFFSET, tsearch.DIGIT_LIMB_STRIDE,
            K))


@pytest.mark.parametrize('case', ['nul_heavy', 'all_bytes', 'utf16',
                                  'empty'])
@pytest.mark.parametrize('depth', [2, 3])
def test_digit_bucket_table_matches_jax(case, depth):
    data, text, sa = _row(case)
    n = data.size
    table = tsearch.digit_bucket_table(torch.from_numpy(text),
                                       torch.from_numpy(sa), n, depth)
    assert table.shape == (258 ** depth + 1,)
    want = np.asarray(_jbucket(jnp.asarray(text), n, jnp.asarray(sa), depth))
    np.testing.assert_array_equal(table.numpy(), want)
    host = tsearch.build_bucket_table_host(data, sa[:n], depth)
    np.testing.assert_array_equal(
        host, jsearch.build_bucket_table_host(data, sa[:n], depth))
    np.testing.assert_array_equal(table.numpy(), host)
    # The same table from K7 and K3, the card's route.
    ident = torch.from_numpy(tsearch.identity_rank()[0])
    pv = tsearch.seed_prefix_plain(torch.from_numpy(text), n, ident, 258,
                                   depth)
    np.testing.assert_array_equal(
        tsearch.seed_table_from_prefix_plain(pv, torch.from_numpy(sa), n,
                                             258, depth).numpy(), host)


def test_digit_bucket_table_rejects_other_depths():
    text = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match='2 or 3'):
        tsearch.digit_bucket_table(text, torch.zeros(16, dtype=torch.int32),
                                   4, 4)
    with pytest.raises(ValueError, match='bucket table length'):
        tsearch.bucket_depth(258 ** 4 + 1)


# ---------------------------------------------------------------------------
# B11 against limbs_loop_batch_jit
# ---------------------------------------------------------------------------

def _count(haystack: bytes, needle: bytes) -> int:
    if not needle:
        return len(haystack)
    n, i = 0, haystack.find(needle)
    while i != -1:
        n += 1
        i = haystack.find(needle, i + 1)
    return n


def _probe_rows():
    """Two rows of the derive layout; row 1 is the concatenation of two
    UTF-16 chunks, so some patterns straddle their boundary."""
    a = np.frombuffer(_utf16(5, 25), dtype=np.uint8)
    b = np.frombuffer(_utf16(6, 25), dtype=np.uint8)
    rows = [_nul_heavy()[:2500], np.concatenate([a, b])[:3000]]
    text = np.zeros((2, N), dtype=np.uint8)
    sa = np.zeros((2, N), dtype=np.int32)
    for i, d in enumerate(rows):
        n = d.size
        text[i, :n] = d
        sa[i, :n] = suffix_array_numpy(d)
        sa[i, n:] = np.arange(N - 1, n - 1, -1)
    return rows, text, sa, a.size


def _probe_patterns(rows, boundary):
    rng = np.random.default_rng(9)
    pats = [b'', b'\x00', b'\x00\x00', b'a', b'a\x00', b'\xff', b'\x01\x02',
            b'zz\xfe\xfd']
    for i, (o, l) in enumerate(zip(rng.integers(0, 2400, size=160),
                                   rng.integers(1, 45, size=160))):
        pats.append(rows[i % 2][o: o + l].tobytes())
    for l in (16, 17, 18, 19):  # around 2 + 3 * 5 bytes of key coverage
        pats.append(rows[1][100: 100 + l].tobytes())
        pats.append(rows[0][700: 700 + l].tobytes())
    pats += [rows[1][boundary - 5: boundary + 6].tobytes(),
             rows[1][boundary - 12: boundary + 12].tobytes()]
    pats += [p[:-1] + bytes([p[-1] ^ 1]) for p in pats[20:60]]  # near misses
    return pats


def _edge_patterns(rows, case, cover):
    """Patterns at the edges of the port's B11 kernel: lengths around 16
    and 32 and past the key cover, 100-300 bytes, each row's last bytes
    (0x00 and 0xFF end row 0) with a byte after them, near misses; or one
    deep pattern and one short one many times."""
    if case == 'repeated':
        return ([rows[1][500: 500 + cover + 30].tobytes()] * 40
                + [b'\x00'] * 20)
    rng = np.random.default_rng(17)
    pats = [b'', b'\x00', b'\xff', b'\x00\xff']
    for l in (15, 16, 17, cover, cover + 1, 31, 32, 33, 100, 300):
        for r in rows:
            for o in rng.integers(0, r.size - l + 1, size=3):
                p = r[o: o + l].tobytes()
                pats += [p, p[:-1] + bytes([p[-1] ^ 1])]
    for r in rows:
        for l in (1, 2, 3, cover, cover + 2):
            tail = r[r.size - l:].tobytes()
            pats += [tail, tail + b'\x00', tail + b'\x01']
    return pats


@pytest.mark.parametrize('depth', [2, 3])
@pytest.mark.parametrize('K', [5, 2])
@pytest.mark.parametrize('deep', [False, True, 'edges', 'repeated'])
def test_probe_limbs_matches_jax(depth, K, deep):
    """B11's plain version equals the JAX ``limbs_loop_batch_jit``, lower
    bounds included, on two UTF-16 rows: the line patterns within the key
    cover or past it, and the edges of the port's kernel
    (``_edge_patterns``)."""
    rows, text, sa, boundary = _probe_rows()
    if not isinstance(deep, bool):
        rows[0][-2:] = [0xFF, 0x00]
        text[0, rows[0].size - 2: rows[0].size] = [0xFF, 0x00]
        sa[0, :rows[0].size] = suffix_array_numpy(rows[0])
    n = np.array([d.size for d in rows], dtype=np.int32)
    tables = np.stack([np.asarray(_jbucket(jnp.asarray(text[i]), int(n[i]),
                                           jnp.asarray(sa[i]), depth))
                       for i in range(2)])
    limbs = np.stack([np.asarray(_jlimbs(jnp.asarray(text[i]), int(n[i]),
                                         jnp.asarray(sa[i]), K))
                      for i in range(2)])
    cover = tsearch.key_cover_bytes(K)
    if isinstance(deep, bool):
        pats = [p for p in _probe_patterns(rows, boundary)
                if deep or len(p) <= cover]
    else:
        pats = _edge_patterns(rows, deep, cover)
    packed, lengths = pack_patterns(pats)
    assert (packed.shape[1] > cover) == bool(deep)
    jlo, jcnt = (np.asarray(x) for x in jsearch.limbs_loop_batch_jit(
        bool(deep), K)(jnp.asarray(text), jnp.asarray(n), jnp.asarray(sa),
                 jnp.asarray(tables), jnp.asarray(limbs),
                 jnp.asarray(packed), jnp.asarray(lengths)))
    lo, cnt = tsearch.probe_limbs(
        torch.from_numpy(text), torch.from_numpy(n), torch.from_numpy(sa),
        torch.from_numpy(tables), torch.from_numpy(limbs),
        torch.from_numpy(packed), torch.from_numpy(lengths), K)
    np.testing.assert_array_equal(cnt.numpy(), jcnt)
    # Per-lane limb counts give the JAX program's lower bound everywhere.
    np.testing.assert_array_equal(lo.numpy(), jlo)
    for b, p in enumerate(pats):
        want = [_count(d.tobytes(), p) for d in rows]
        assert list(cnt[:, b].numpy()) == want, p
    assert (jcnt > 0).sum() > 30


def test_probe_limbs_rejects_bad_tables():
    text = torch.zeros((1, 64), dtype=torch.uint8)
    sa = torch.zeros((1, 64), dtype=torch.int32)
    with pytest.raises(ValueError, match='bucket table length'):
        tsearch.probe_limbs(text, torch.tensor([3], dtype=torch.int32), sa,
                            torch.zeros((1, 100), dtype=torch.int32),
                            torch.zeros((1, 64), dtype=torch.int32),
                            torch.zeros((2, 8), dtype=torch.uint8),
                            torch.zeros(2, dtype=torch.int32), 1)


# ---------------------------------------------------------------------------
# The digit index
# ---------------------------------------------------------------------------

def _bodies(count: int, seed: int):
    bodies = [_utf16(seed + i, 18 + 5 * i) for i in range(count)]
    # One chunk with every byte value, so the union alphabet is wide.
    bodies.insert(1, bytes(range(256)) + b'\n')
    return bodies


def _chunks(bodies, cls=Chunk):
    return [cls(data=np.frombuffer(b, dtype=np.uint8),
                suffix_array=suffix_array_numpy(np.frombuffer(b, np.uint8)))
            for b in bodies]


def _index_patterns(bodies):
    rng = np.random.default_rng(11)
    text = b''.join(bodies)
    pats = [text[o: o + int(l)] for o, l in zip(
        rng.integers(0, len(text) - 50, size=80), rng.integers(1, 30, 80))]
    pats += [b'', b'\x00', b'\n\x00', b'\xfe\xff', b'q\x00q\x00q\x00q',
             bodies[0][-6:] + bodies[1][:6]]
    pats += [bodies[i][-4:] + bodies[i + 1][:4]
             for i in range(len(bodies) - 1)]  # straddle each boundary
    return pats


@pytest.mark.parametrize('mode, deep_min', [('derive', None),
                                            ('derive', 1024),
                                            ('upload', None)])
def test_digit_index_matches_jax(monkeypatch, mode, deep_min):
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 4000)
    monkeypatch.setenv('TPUSS_MERGE_CAP', '4000')
    if deep_min is not None:  # rows this long get the 3-digit table
        monkeypatch.setattr(DeviceIndex, 'DEEP_TABLE_MIN_CHUNK', deep_min)
        monkeypatch.setattr(JIndex, 'DEEP_TABLE_MIN_CHUNK', deep_min)
    bodies = _bodies(5, 40)
    j = JIndex(_chunks(bodies, JChunk), mode=mode)
    t = DeviceIndex(_chunks(bodies), device='cpu', mode=mode)
    assert j.kind == t.kind == 'digit' and t.mode == mode
    assert t.groups == j.groups and t.n_pad == j.n_pad
    assert (t._base, t._depth, t.num_limbs) == (j._base, j._depth,
                                                j.num_limbs) == (
        258, 3 if deep_min else 2, 5)
    assert t.merged == (mode == 'derive') and t.merged == j.merged
    for name in ('text', 'lengths', 'sa', 'tables', 'limbs', 'rank',
                 'present'):
        np.testing.assert_array_equal(getattr(t, name).numpy(),
                                      np.asarray(getattr(j, name)), name)
    pats = _index_patterns(bodies)
    packed, lengths = pack_patterns(pats)
    lo_j, cnt_j = j.probe(packed, lengths)
    lo_t, cnt_t = t.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(t.count_matches(packed, lengths),
                                  j.count_matches(packed, lengths))
    assert cnt_t.sum() > 200
    # The JAX index read back carries over into the port.
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind=j.kind, bits=j._bits, base=j._base, depth=j._depth,
                num_limbs=j.num_limbs, mode=j.mode, groups=j.groups,
                boundaries=j.boundaries)
    carried = DeviceIndex.from_arrays(arrays, meta, 'cpu')
    assert carried.kind == 'digit' and carried.groups == j.groups
    lo_c, cnt_c = carried.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_c, cnt_j)
    np.testing.assert_array_equal(lo_c, lo_j)


def test_digit_upload_builds_aux_on_device_as_the_host_builders(monkeypatch):
    chunks = _chunks(_bodies(2, 50))

    def forbidden(*_a, **_k):
        raise AssertionError('host builder called by the index')

    monkeypatch.setattr(tsearch, 'build_limbs_host', forbidden)
    monkeypatch.setattr(tsearch, 'build_bucket_table_host', forbidden)
    before = dict(kernels.LAUNCHES)
    idx = DeviceIndex(chunks, device='cpu', mode='upload')
    monkeypatch.undo()
    assert kernels.LAUNCHES == before  # plain versions on the CPU
    assert idx.kind == 'digit' and not idx.merged and idx._depth == 2
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(
            idx.tables[i].numpy(),
            tsearch.build_bucket_table_host(c.data, c.suffix_array, 2))
        np.testing.assert_array_equal(
            idx.limbs[i].numpy(),
            tsearch.pad_limbs_host(tsearch.build_limbs_host(
                c.data, c.suffix_array, idx.num_limbs), idx.n_pad))


# ---------------------------------------------------------------------------
# The Reader over a UTF-16 corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def utf16_container(tmp_path_factory):
    d = tmp_path_factory.mktemp('digit')
    src = d / 'corpus.txt'
    body = _utf16(70, 900)
    # One long line past the device margin, for the host route.
    long_line = ('w' * (PAD_MARGIN + 200) + '\n').encode('utf-16-le')
    src.write_bytes(body[:20000] + long_line + body[20000:])
    path = str(d / 'c.idx')
    with tpss.Writer(path, max_chunk_len=6 << 10) as w:
        w.add_entries_from_file_lines(str(src))
    return body, long_line, path


@pytest.mark.parametrize('index_mode', ['derive', 'auto'])
def test_digit_reader_matches_jax_reader(utf16_container, monkeypatch,
                                         index_mode):
    body, long_line, path = utf16_container
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(24 << 10))
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 24 << 10)
    tr = tpss.Reader(path, device='cpu', index_mode=index_mode)
    jr = jpss.Reader(path, index_mode=index_mode)
    idx = tr._index
    assert idx.kind == jr._index.kind == 'digit'
    assert idx.mode == ('derive' if index_mode == 'derive' else 'upload')
    assert idx.merged == (index_mode == 'derive') and idx.num_chunks > 1
    rng = np.random.default_rng(13)
    pats = [body[o: o + int(l)] for o, l in zip(
        rng.integers(0, len(body) - 40, size=70), rng.integers(1, 16, 70))]
    c0, c1 = tr._chunks[0].data.tobytes(), tr._chunks[1].data.tobytes()
    pats += [
        b'', b'\x00', 'é'.encode('utf-16-le'),  # a miss
        c0[-5:] + c1[:5],  # straddles the first chunk boundary
        long_line[40: 40 + PAD_MARGIN + 30],  # host route
    ]
    pats += pats[:8]  # duplicates
    want = [sorted(x) for x in jr._search_batch(pats)]
    got = [sorted(x) for x in tr._search_batch(pats)]
    assert got == want
    assert want[72] == [] and want[74] and sum(map(len, got)) > 500
    strs = [p.decode('latin-1') for p in pats[:40]]
    assert collections.Counter(tr.search_multiple(strs)) == \
        collections.Counter(jr.search_multiple(strs))
