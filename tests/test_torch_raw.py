"""Raw-kind derive in the port (an alphabet of more than 62 bytes without
NUL), as its plain PyTorch versions run it on the CPU, against the JAX
package on the same numpy inputs: the 6-byte init (B1b) and the derive
built on it, the raw pack (K5), raw limb planes (K6), seed prefix (K7) with
the seed table (K3), the raw derive index over merged rows and the Reader.
Integers compare exactly.

The JAX sorts are unstable and the port's are stable, so inside a tie group
the ``sa`` of one init may differ; ``rank``, ``gs`` and the finished SA may
not.
"""

import collections
import functools

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
from pysubstringsearch_tpu.ops.suffix_array import _init_round_anchored
from pysubstringsearch_tpu_torch.container import Chunk
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import search as tsearch
from pysubstringsearch_tpu_torch.ops import suffix_array as tsa
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN, pack_patterns
from pysubstringsearch_tpu_torch.ops.suffix_array import suffix_array_numpy

torch.set_num_threads(1)

#: One padded row length for every case, so each JAX program compiles once.
N = 4096

_jinit = jax.jit(_init_round_anchored)
_jbucket = jax.jit(jsearch.build_bucket_table_device, static_argnums=3)


def _raw_words(seed: int, size: int, vocab: int = 15) -> np.ndarray:
    """Printable words (bytes 33-126) from a small vocabulary, so suffixes
    stay tied for several doubling rounds past the init's 6 bytes."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 6, size=vocab)]
    text = b' '.join(words[i] for i in rng.integers(0, vocab, size=size))
    return np.frombuffer(text[:size], dtype=np.uint8).copy()


def _nul_text() -> np.ndarray:
    data = np.random.default_rng(3).integers(0, 256, size=3000)
    data[::50] = 0
    return data.astype(np.uint8)


CASES = {
    # sigma = 94 printable bytes: the raw kind at seed base 128
    'printable': lambda: np.random.default_rng(1).integers(
        33, 127, size=3000).astype(np.uint8),
    # every byte but NUL: digit 256 and bytes >= 0x80
    'fullbyte': lambda: np.random.default_rng(2).integers(
        1, 256, size=3000).astype(np.uint8),
    # NUL bytes: digits are byte + 1, so the digit kind can reuse B1b
    'nul': _nul_text,
    'short': lambda: np.frombuffer(b'a~!', dtype=np.uint8).copy(),
    'repeat': lambda: np.full(2000, 200, dtype=np.uint8),
    'empty': lambda: np.zeros(0, dtype=np.uint8),
    'one': lambda: np.array([250], dtype=np.uint8),
    'words': lambda: _raw_words(4, 3000, vocab=6),
}


def _padded(data: np.ndarray) -> np.ndarray:
    out = np.zeros(N, dtype=np.uint8)
    out[: data.size] = data
    return out


def _within_groups(sa: np.ndarray, gs: np.ndarray) -> np.ndarray:
    """sa with each tie group's members sorted: the order-free content."""
    return sa[np.lexsort((sa, gs))]


@pytest.mark.parametrize('case', ['printable', 'fullbyte', 'nul', 'short',
                                  'repeat', 'empty', 'one'])
def test_byte_init_matches_jax(case):
    data = CASES[case]()
    padded, n = _padded(data), data.size
    sa, rk, gs = tsa.sa_init_bytes(torch.from_numpy(padded), n)
    jsa, jrk, jgs = (np.asarray(a) for a in _jinit(jnp.asarray(padded),
                                                   jnp.int32(n)))
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    npad = N - n
    np.testing.assert_array_equal(sa.numpy()[:npad], jsa[:npad])
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))


@pytest.mark.parametrize('case', list(CASES))
def test_raw_derive_sa_matches_jax_and_numpy(case):
    data = CASES[case]()
    padded, n = _padded(data), data.size
    sa, ties, tpois = tsa.derive_sa(torch.from_numpy(padded), n)
    jsa, poisoned = jsearch.derive_sa(jnp.asarray(padded), jnp.int32(n))
    assert not poisoned and not tpois
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sa.numpy()[:n],
                                  tsa.suffix_array_numpy(data))
    plain, pties, _ = tsa.derive_sa_plain(torch.from_numpy(padded), n)
    assert torch.equal(plain, sa) and pties == ties
    if case == 'repeat':
        # Every round stays fully tied until k passes the run length.
        assert len(ties) >= 8 and ties[0] == n - 6 + 1
    if case == 'words':
        assert len(ties) >= 3  # ties outlive several rounds
    if case in ('empty', 'one', 'short'):
        assert ties == []


def test_raw_derive_ranks_nothing_and_launches_nothing_on_cpu():
    data = _raw_words(5, 2500)
    stack = torch.full((2, N), -7, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    sa, _, _ = tsa.derive_sa(torch.from_numpy(_padded(data)), data.size,
                             out=stack[1])
    assert sa.data_ptr() == stack[1].data_ptr() and (stack[0] == -7).all()
    np.testing.assert_array_equal(stack[1, : data.size].numpy(),
                                  suffix_array_numpy(data))
    assert kernels.LAUNCHES == before
    with pytest.raises(ValueError, match='rank map'):
        tsa.derive_sa(torch.from_numpy(_padded(data)), data.size, None, 5)


@pytest.mark.parametrize('n', [N - 5, N + 1, -1])
def test_byte_pad_contract_enforced(n):
    text = torch.zeros(N, dtype=torch.uint8)
    with pytest.raises(ValueError, match=r'pad contract: need n \+ 6'):
        tsa.derive_sa(text, n)
    with pytest.raises(ValueError, match='pad contract'):
        tsa.sa_init_bytes(text, n)


def _aux_row(case: str):
    """(data, padded text, padded SA) of a case."""
    data = CASES[case]()
    sa = np.zeros(N, dtype=np.int32)
    sa[: data.size] = suffix_array_numpy(data)
    return data, _padded(data), sa


@pytest.mark.parametrize('case', ['printable', 'fullbyte', 'nul', 'short',
                                  'empty'])
@pytest.mark.parametrize('depth, K', [(3, 3), (2, 1)])
def test_raw_pack_and_limb_planes_match_jax(case, depth, K):
    data, text, sa = _aux_row(case)
    n = data.size
    packed = tsearch.raw_pack(torch.from_numpy(text), n)
    jpacked = jsearch.raw_pack_jit(depth)(jnp.asarray(text), jnp.int32(n))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    # Past n every byte is 0, so the biased pack is INT32_MIN.
    assert (packed.numpy()[n:] == np.iinfo(np.int32).min).all()
    limbs = tsearch.raw_limb_planes(torch.from_numpy(text),
                                    torch.from_numpy(sa), n, depth, K)
    np.testing.assert_array_equal(
        limbs.numpy(), tsearch.raw_limb_planes_plain(
            packed, torch.from_numpy(sa), n, depth, K).numpy())
    plane = jsearch.derive_limb_raw_jit(depth)
    buf = jnp.zeros((1, K * N), jnp.int32)
    for j in range(K):
        buf = plane(buf, jnp.int32(0), jnp.int32(j), jpacked, jnp.int32(n),
                    jnp.asarray(sa))
    np.testing.assert_array_equal(limbs.numpy(), np.asarray(buf)[0])
    host = jsearch.pad_limbs_host(
        jsearch.build_raw_limbs_host(data, sa[:n], K, depth), N)
    np.testing.assert_array_equal(limbs.numpy(), host)
    np.testing.assert_array_equal(
        limbs.numpy(),
        np.asarray(jsearch.build_raw_limbs_device(
            jnp.asarray(text), n, jnp.asarray(sa), K, depth)))


#: A row length that is not a multiple of 16, and true lengths at its end
#: (windows of the last suffixes cross n, and at n = N - 1 and N the row's
#: end: a plane past N - 1 takes the pack's value at N - 1).
N_EDGE = 4099
EDGE_NS = (N_EDGE, N_EDGE - 1, N_EDGE - PAD_MARGIN, N_EDGE - 7)


@pytest.mark.parametrize('n', EDGE_NS)
@pytest.mark.parametrize('case, depth, K', [('printable', 3, 3),
                                            ('fullbyte', 2, 1)])
def test_raw_limb_planes_from_text_at_row_edges(case, depth, K, n):
    """K6's text twin (and the wrapper's CPU path) equals the plain version
    on K5's pack and the JAX programs (``raw_pack_jit`` and
    ``derive_limb_raw_jit``) at true lengths up to the row's end; the host
    builder and ``build_raw_limbs_device``, which never clamp, agree below
    n = N."""
    data = np.resize(CASES[case](), n)
    text = np.zeros(N_EDGE, dtype=np.uint8)
    text[:n] = data
    text[n:] = 0x7e  # bytes past n must not count
    sa = np.empty(N_EDGE, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    sa[n:] = np.arange(N_EDGE - 1, n - 1, -1)
    t, s = torch.from_numpy(text), torch.from_numpy(sa)
    packed = tsearch.raw_pack_plain(t, n)
    spec = tsearch.raw_limb_planes_plain(packed, s, n, depth, K)
    twin = tsearch.raw_limb_planes_text_plain(t, s, n, depth, K)
    wrapped = tsearch.raw_limb_planes(t, s, n, depth, K)
    assert torch.equal(twin, spec) and torch.equal(wrapped, spec)
    jpacked = jsearch.raw_pack_jit(depth)(jnp.asarray(text), jnp.int32(n))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jpacked))
    plane = jsearch.derive_limb_raw_jit(depth)
    buf = jnp.zeros((1, K * N_EDGE), jnp.int32)
    for j in range(K):
        buf = plane(buf, jnp.int32(0), jnp.int32(j), jpacked, jnp.int32(n),
                    jnp.asarray(sa))
    np.testing.assert_array_equal(spec.numpy(), np.asarray(buf)[0])
    if n < N_EDGE:
        np.testing.assert_array_equal(spec.numpy(), np.asarray(
            jsearch.build_raw_limbs_device(jnp.asarray(text), n,
                                           jnp.asarray(sa), K, depth)))
        np.testing.assert_array_equal(spec.numpy(), jsearch.pad_limbs_host(
            jsearch.build_raw_limbs_host(data, sa[:n], K, depth), N_EDGE))


def _rank_of(data: np.ndarray):
    pres = np.bincount(data, minlength=256)[:256] > 0
    return tsearch.alphabet_rank(pres)


@pytest.mark.parametrize('case, base, depth', [
    ('printable', 128, 2), ('printable', 128, 3), ('fullbyte', 258, 2),
    ('nul', 258, 2), ('empty', 128, 3), ('short', 128, 2),
])
def test_seed_prefix_table_matches_jax(case, base, depth):
    data, text, sa = _aux_row(case)
    n = data.size
    rank, _ = _rank_of(data)
    pv = tsearch.seed_prefix(torch.from_numpy(text), n,
                             torch.from_numpy(rank), base, depth)
    table = tsearch.seed_table_from_prefix(pv, torch.from_numpy(sa), n,
                                           base, depth)
    jtable = jsearch.derive_table_raw_jit(base, depth)(
        jnp.zeros((1, base ** depth + 1), jnp.int32), jnp.int32(0),
        jnp.asarray(text), jnp.int32(n), jnp.asarray(sa), jnp.asarray(rank))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable)[0])
    np.testing.assert_array_equal(
        table.numpy(),
        tsearch.build_seed_table_host(data, sa[:n], rank, base, depth))
    # pv never decreases in SA order: the bisection's premise.
    assert (np.diff(pv.numpy()[sa[:n]].astype(np.int64)) >= 0).all()


@pytest.mark.parametrize('case, depth', [('nul', 2), ('fullbyte', 3),
                                         ('empty', 2)])
def test_seed_prefix_with_identity_rank_is_the_bucket_table(case, depth):
    data, text, sa = _aux_row(case)
    n = data.size
    ident, _ = tsearch.identity_rank()
    pv = tsearch.seed_prefix(torch.from_numpy(text), n,
                             torch.from_numpy(ident), 258, depth)
    table = tsearch.seed_table_from_prefix(pv, torch.from_numpy(sa), n, 258,
                                           depth)
    want = _jbucket(jnp.asarray(text), n, jnp.asarray(sa), depth)
    np.testing.assert_array_equal(table.numpy(), np.asarray(want))


#: Row lengths at the port's pack tiles (16 positions a thread): a whole
#: number of tiles, one position into the next, one short of it.
TILE_NS = (4096, 4097, 4111)


def _tile_row(N: int, n: int, base: int, seed: int):
    """(text, rank) of N random bytes with a rank map of the table's base:
    an alphabet of base - 2 bytes (the pads take the other two digits), or
    every byte with ``identity_rank()`` at base 258."""
    rng = np.random.default_rng(seed)
    if base == 258:
        return (rng.integers(0, 256, size=N, dtype=np.uint8),
                tsearch.identity_rank()[0])
    alphabet = rng.choice(256, size=base - 2, replace=False).astype(np.uint8)
    text = alphabet[rng.integers(0, alphabet.size, size=N)]
    rank, _ = tsearch.alphabet_rank(
        np.bincount(alphabet, minlength=256)[:256] > 0)
    return text, rank


@functools.lru_cache(maxsize=None)
def _jax_prefix(base: int, depth: int):
    """The prefix values of ``build_seed_table_device``, line for line
    (the JAX function keeps them inside; its table is held below)."""
    def f(text, n, rank):
        N = text.shape[0]
        iota = jax.lax.broadcasted_iota(jnp.int32, (N,), 0)
        d = jnp.where(iota < n, jnp.take(rank, text.astype(jnp.int32)), 0)
        pv = jnp.zeros((N,), jnp.int32)
        for j in range(depth):
            pv = pv * base + jnp.where(iota + j < n, jnp.roll(d, -j), 0)
        return pv
    return jax.jit(f)


@pytest.mark.parametrize('N', TILE_NS)
@pytest.mark.parametrize('at', ['0', '1', 'N-D', 'N-1', 'N'])
@pytest.mark.parametrize('base, depth', tsearch._TABLE_COMBOS)
def test_seed_prefix_matches_jax_at_tile_edges(N, at, base, depth):
    """K7's plain version (and the wrapper's CPU path) against the JAX
    prefix values at every table combination, at rows that end in a
    partial tile and true lengths 0, 1 and up to the row's end; bytes past
    n must not count."""
    n = {'0': 0, '1': 1, 'N-D': N - depth, 'N-1': N - 1, 'N': N}[at]
    text, rank = _tile_row(N, n, base, N + n + base + depth)
    t, r = torch.from_numpy(text), torch.from_numpy(rank)
    plain = tsearch.seed_prefix_plain(t, n, r, base, depth).numpy()
    np.testing.assert_array_equal(
        plain, np.asarray(_jax_prefix(base, depth)(
            jnp.asarray(text), jnp.int32(n), jnp.asarray(rank))))
    np.testing.assert_array_equal(
        tsearch.seed_prefix(t, n, r, base, depth).numpy(), plain)
    assert not plain[n:].any()


@pytest.mark.parametrize('N', TILE_NS)
@pytest.mark.parametrize('at', ['0', '1', 'N-D', 'N-1', 'N'])
@pytest.mark.parametrize('base, depth', [
    (b, d) for b, d in tsearch._TABLE_COMBOS if b ** d <= 48 << 20])
def test_seed_prefix_table_matches_jax_at_tile_edges(N, at, base, depth):
    """The table of K7's plain values over the row's SA equals
    ``build_seed_table_device``'s (through ``derive_table_raw_jit``) at the
    same tile edges as the values above: rows of a whole number of tiles,
    one past and one short, and n = 0, 1, N - depth, N - 1 and N.  Every
    table an index can pick (``pick_table_params`` caps them at 48 Mi
    entries); the values of the larger combinations are held above."""
    n = {'0': 0, '1': 1, 'N-D': N - depth, 'N-1': N - 1, 'N': N}[at]
    text, rank = _tile_row(N, n, base, n + base + depth)
    sa = np.zeros(N, dtype=np.int32)
    sa[:n] = suffix_array_numpy(text[:n])
    pv = tsearch.seed_prefix_plain(torch.from_numpy(text), n,
                                   torch.from_numpy(rank), base, depth)
    table = tsearch.seed_table_from_prefix_plain(pv, torch.from_numpy(sa), n,
                                                 base, depth)
    jtable = jsearch.derive_table_raw_jit(base, depth)(
        jnp.zeros((1, base ** depth + 1), jnp.int32), jnp.int32(0),
        jnp.asarray(text), jnp.int32(n), jnp.asarray(sa), jnp.asarray(rank))
    np.testing.assert_array_equal(table.numpy(), np.asarray(jtable)[0])


def test_seed_prefix_rejects_unknown_tables():
    text = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match='258'):
        tsearch.seed_prefix(text, 4, torch.ones(256, dtype=torch.int32),
                            258, 4)


# ---------------------------------------------------------------------------
# The raw derive index over merged rows
# ---------------------------------------------------------------------------

RNG = np.random.default_rng(78)
WORDS = [bytes(RNG.integers(33, 127, size=int(l)).astype(np.uint8))
         for l in RNG.integers(3, 8, size=30)]
#: Every printable byte once, so any body set holds a raw-kind alphabet.
ALPHABET = bytes(range(33, 127)) + b'\n'


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
    idx = DeviceIndex(_chunks(bodies), device='cpu', mode='derive', **kw)
    assert idx.kind == 'raw' and idx._bits is None
    return idx


def test_raw_grouping_matches_jax_under_cap(monkeypatch):
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 3000)
    monkeypatch.setenv('TPUSS_MERGE_CAP', '3000')
    bodies = [ALPHABET] + [_body(40 + 7 * i, i) for i in range(6)]
    idx = _derive(bodies)
    plan = JIndex.plan(_chunks(bodies, JChunk), mode='derive')
    assert plan.kind == 'raw' and idx.merged and idx.groups == plan.groups
    assert len(idx.groups) > 1
    for r in range(idx.num_chunks):
        np.testing.assert_array_equal(idx.boundaries[r], plan.boundaries[r])
        np.testing.assert_array_equal(
            idx.sa[r, : idx.row_data[r].size].numpy(),
            suffix_array_numpy(idx.row_data[r]))
    assert b''.join(d.tobytes() for d in idx.row_data) == b''.join(bodies)


def test_raw_merged_counts_match_per_chunk_truth():
    bodies = [_body(60, 1), ALPHABET, _body(60, 2), _body(60, 3)]
    idx = _derive(bodies, merge=True)
    assert idx.merged and idx.num_chunks == 1
    pats = [WORDS[0], WORDS[1][:2], b'\x7f\x7f', b'', b'a\x00',
            WORDS[2] + b' ' + WORDS[3], b'\n' + WORDS[4][:2], b'\xc3\xa9',
            WORDS[5] + b' ' + WORDS[6] + b' ' + WORDS[7] + b' ' + WORDS[8]]
    cnt = idx.count_matches(*pack_patterns(pats))
    for b, p in enumerate(pats):
        assert cnt[:, b].sum() == sum(_count(x, p) for x in bodies), p


def test_raw_boundary_crossing_newline_patterns():
    a, b = b'al~ha\nbr@vo\n', b'br@vo\nch#rlie\n'
    idx = _derive([a, b, ALPHABET], merge=True)
    pats = [b'br@vo\nbr@vo', b'al~ha\nbr@vo', b'br@vo\nch#rlie', b'br@vo',
            b'\n!"#']
    packed, lengths = pack_patterns(pats)
    _, raw = idx.probe(packed, lengths)
    assert raw[0, 0] == _count(a + b, pats[0]) == 1
    assert raw[0, 4] == 1  # b's last newline runs into the alphabet chunk
    assert list(idx.count_matches(packed, lengths)[0]) == [0, 1, 1, 2, 0]


def test_raw_carry_over_from_jax_derive_index(monkeypatch):
    monkeypatch.setenv('TPUSS_MERGE_CAP', '3500')
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 3500)
    bodies = [ALPHABET] + [_body(50 + 9 * i, 20 + i) for i in range(5)]
    j = JIndex(_chunks(bodies, JChunk), mode='derive', merge=True)
    assert j.kind == 'raw' and j.merged and j.num_chunks > 1
    arrays = {name: np.asarray(getattr(j, name)) for name in (
        'text', 'lengths', 'sa', 'tables', 'limbs', 'rank', 'present')}
    meta = dict(kind=j.kind, bits=j._bits, base=j._base, depth=j._depth,
                num_limbs=j.num_limbs, mode=j.mode, groups=j.groups,
                boundaries=j.boundaries)
    t = DeviceIndex.from_arrays(arrays, meta, 'cpu')
    assert t.merged and t.groups == j.groups and t.kind == 'raw'
    pats = [WORDS[0], WORDS[5][:3], b'', b'\x7f\x7f', b'\n', WORDS[1] + b'\n',
            b'\n' + WORDS[7][:2], WORDS[2] + b' ' + WORDS[3], b'x\x00y',
            b'\xff', WORDS[9] * 5]
    tails = [bodies[i][-4:] + bodies[i + 1][:4] for i in range(5)]
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
    assert crossings.sum() > 0
    # The port's own raw derive over the same chunks builds the same index.
    own = _derive(bodies)
    assert own.groups == j.groups and own.n_pad == j.n_pad
    assert (own._base, own._depth, own.num_limbs) == (j._base, j._depth,
                                                      j.num_limbs)
    for r, d in enumerate(own.row_data):
        n = d.size
        np.testing.assert_array_equal(own.sa[r, :n].numpy(),
                                      arrays['sa'][r, :n])
        for p in range(own.num_limbs):
            row = slice(p * own.n_pad, p * own.n_pad + n)
            np.testing.assert_array_equal(own.limbs[r, row].numpy(),
                                          arrays['limbs'][r, row])
    for name in ('text', 'tables', 'limbs'):
        np.testing.assert_array_equal(getattr(own, name).numpy(),
                                      arrays[name], name)


def test_raw_upload_builds_aux_on_device_as_the_host_builders(monkeypatch):
    bodies = [_body(70, 30), ALPHABET, _body(40, 31)]
    chunks = _chunks(bodies)

    def forbidden(*_a, **_k):
        raise AssertionError('host builder called by the index')

    monkeypatch.setattr(tsearch, 'build_raw_limbs_host', forbidden)
    monkeypatch.setattr(tsearch, 'build_seed_table_host', forbidden)
    idx = DeviceIndex(chunks, device='cpu', mode='upload')
    monkeypatch.undo()
    assert idx.kind == 'raw' and idx.mode == 'upload' and not idx.merged
    rank = idx.rank.numpy()
    for i, c in enumerate(chunks):
        np.testing.assert_array_equal(
            idx.tables[i].numpy(),
            tsearch.build_seed_table_host(c.data, c.suffix_array, rank,
                                          idx._base, idx._depth))
        np.testing.assert_array_equal(
            idx.limbs[i].numpy(),
            tsearch.pad_limbs_host(tsearch.build_raw_limbs_host(
                c.data, c.suffix_array, idx.num_limbs, idx._depth),
                idx.n_pad))


def test_auto_mode_on_cpu_is_upload_for_every_ported_kind():
    raw = DeviceIndex(_chunks([_body(20, 1), ALPHABET]), device='cpu')
    assert raw.kind == 'raw' and raw.mode == 'upload'
    ranked = DeviceIndex(_chunks([b'abc\nabd\n', b'bcd\n']), device='cpu')
    assert ranked.kind == 'ranked' and ranked.mode == 'upload'
    digit = DeviceIndex(_chunks([bytes(range(256)) + b'\n', b'a\x00b\n']),
                        device='cpu')
    assert digit.kind == 'digit' and digit.mode == 'upload'


# ---------------------------------------------------------------------------
# The Reader end to end
# ---------------------------------------------------------------------------

def _corpus_lines():
    rng = np.random.default_rng(12)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(3, 9, size=200)]
    lines = [b' '.join(words[i] for i in rng.integers(0, 200, size=5))
             for _ in range(1500)]
    lines[700] = b' '.join(words[i % 200] for i in range(250))
    assert len(lines[700]) > PAD_MARGIN + 100
    return lines


@pytest.fixture(scope='module')
def container(tmp_path_factory):
    lines = _corpus_lines()
    path = str(tmp_path_factory.mktemp('raw') / 'c.idx')
    with tpss.Writer(path, max_chunk_len=6 << 10) as w:
        for ln in lines:
            w.add_entry(ln.decode())
    return lines, path


def test_raw_reader_derive_matches_jax_reader(container, monkeypatch):
    lines, path = container
    monkeypatch.setenv('TPUSS_MERGE_CAP', str(20 << 10))
    monkeypatch.setattr(DeviceIndex, 'MERGE_CAP_DEFAULT', 20 << 10)
    # The JAX Reader's readback cap on both, so both take the device route.
    monkeypatch.setattr(tpss.api.Reader, '_READBACK_CAP',
                        jpss.api.Reader._READBACK_CAP)
    tr = tpss.Reader(path, device='cpu', index_mode='derive')
    jr = jpss.Reader(path, index_mode='derive')
    idx = tr._index
    assert idx.kind == jr._index.kind == 'raw'
    assert idx.mode == 'derive' and idx.merged and idx.num_chunks > 1
    assert idx.groups == jr._index.groups
    rng = np.random.default_rng(6)
    text = b'\n'.join(lines)
    pats = [text[o: o + int(l)] for o, l in zip(
        rng.integers(0, len(text) - 30, size=60), rng.integers(2, 12, 60))]
    c0, c1 = tr._chunks[0].data.tobytes(), tr._chunks[1].data.tobytes()
    pats += [
        b'qq\x7f\x7fqq',  # a miss
        b'', lines[3][:3] + b'\x00', b'\xc3\xa9',
        c0[-5:] + c1[:4],  # straddles the first chunk boundary
        lines[3][-3:] + b'\n' + lines[4][:3],  # newline within a chunk
        lines[700][10: 10 + PAD_MARGIN + 40],  # host route
    ]
    pats += pats[:10]  # duplicates
    want = [sorted(x) for x in jr._search_batch(pats)]
    got = [sorted(x) for x in tr._search_batch(pats)]
    assert got == want
    assert want[60] == want[62] == want[63] == [] and want[61]
    assert want[66] and sum(map(len, got)) > 300
    strs = [p.decode('latin-1') for p in pats]
    assert collections.Counter(tr.search_multiple(strs)) == \
        collections.Counter(jr.search_multiple(strs))
    assert tr.profiler.counts['x-dev-gather'] > 0
