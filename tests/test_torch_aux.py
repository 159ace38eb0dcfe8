"""Aux builders of the PyTorch port (K1 ranked pack, K2 limb planes, K3 seed
table) against the JAX package: its host builders and its device programs,
on the same numpy-seeded rows.  Every comparison is exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops.suffix_array import suffix_array_numpy
from pysubstringsearch_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)

#: One padded row width for every case, so JAX compiles each program once.
N_PAD = 4096


def _corpus(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == 'empty':
        return np.zeros(0, dtype=np.uint8)
    if name == 'skew':  # one seed bucket holds most of the row
        data = np.where(rng.random(3000) < 0.9, 97,
                        rng.integers(98, 123, size=3000)).astype(np.uint8)
    elif name == 'one':  # n = 1: a table far longer than the row
        return np.array([98], dtype=np.uint8)
    elif name == 's27':  # sigma <= 30: 5-bit digits, 6 per limb
        data = rng.integers(97, 123, size=3000, dtype=np.uint8)
    elif name == 's60':  # sigma <= 62: 6-bit digits, 5 per limb
        data = rng.integers(40, 99, size=3000, dtype=np.uint8)
    else:  # 'nul': NUL text bytes, which rank digits encode exactly
        data = rng.integers(97, 110, size=2900, dtype=np.uint8)
        data[::97] = 0
    data[::37] = 0x0A
    return data


#: (corpus, seed depth, limb planes)
CASES = [
    ('s27', 2, 3), ('s27', 4, 2), ('s60', 2, 3), ('s60', 3, 1),
    ('nul', 3, 3), ('empty', 2, 3), ('skew', 3, 2), ('one', 4, 1),
]


def _row(name: str, depth: int, K: int):
    data = _corpus(name)
    n = data.size
    text = np.zeros(N_PAD, dtype=np.uint8)
    text[:n] = data
    sa = np.zeros(N_PAD, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = jsearch.alphabet_rank(pres)
    bits = jsearch.ranked_bits(sigma)
    base = 1 << bits
    return data, text, sa, rank, bits, base, depth, K


def _jax_pack(text, n, rank, bits):
    return np.asarray(
        jsearch.ranked_pack_jit(bits)(jnp.asarray(text), jnp.int32(n),
                                      jnp.asarray(rank))
    )


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}-d{c[1]}-k{c[2]}')
def test_ranked_pack_matches_jax(case):
    data, text, sa, rank, bits, base, depth, K = _row(*case)
    n = data.size
    D = jsearch.ranked_limb_bytes(bits)
    plain = tsearch.ranked_pack_plain(
        torch.from_numpy(text), n, torch.from_numpy(rank), bits
    ).numpy()
    wrapped = tsearch.ranked_pack(
        torch.from_numpy(text), n, torch.from_numpy(rank), bits
    ).numpy()
    ref = _jax_pack(text, n, rank, bits)
    # The JAX roll wraps around in the last D-1 padding slots.
    np.testing.assert_array_equal(plain[: N_PAD - D], ref[: N_PAD - D])
    np.testing.assert_array_equal(wrapped, plain)
    assert not plain[max(n, N_PAD - D):].any()


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}-d{c[1]}-k{c[2]}')
def test_limb_planes_match_jax(case):
    data, text, sa, rank, bits, base, depth, K = _row(*case)
    n = data.size
    packed = tsearch.ranked_pack_plain(
        torch.from_numpy(text), n, torch.from_numpy(rank), bits
    )
    plain = tsearch.ranked_limb_planes_plain(
        packed, torch.from_numpy(sa), n, depth, bits, K
    ).numpy()
    wrapped = tsearch.ranked_limb_planes(
        torch.from_numpy(text), torch.from_numpy(sa), n,
        torch.from_numpy(rank), depth, bits, K
    ).numpy()
    twin = tsearch.ranked_limb_planes_text_plain(
        torch.from_numpy(text), torch.from_numpy(sa), n,
        torch.from_numpy(rank), depth, bits, K
    ).numpy()
    host = jsearch.pad_limbs_host(
        jsearch.build_ranked_limbs_host(data, sa[:n], rank, K, depth, bits),
        N_PAD,
    )
    plane = jsearch.derive_limb_ranked_jit(depth, bits)
    buf = jnp.zeros((1, K * N_PAD), jnp.int32)
    jpacked = jnp.asarray(_jax_pack(text, n, rank, bits))
    for j in range(K):
        buf = plane(buf, jnp.int32(0), jnp.int32(j), jpacked, jnp.int32(n),
                    jnp.asarray(sa))
    np.testing.assert_array_equal(plain, host)
    np.testing.assert_array_equal(plain, np.asarray(buf)[0])
    np.testing.assert_array_equal(twin, plain)
    np.testing.assert_array_equal(wrapped, plain)


#: A row length that is not a multiple of 16, and true lengths at its end:
#: every window of the last suffixes crosses n, and at n = N - 1 and N the
#: row's end too (a plane past N - 1 takes the pack's value at N - 1).
N_EDGE = 4099
EDGE_NS = (N_EDGE, N_EDGE - 1, N_EDGE - tsearch.PAD_MARGIN, N_EDGE - 7)


@pytest.mark.parametrize('n', EDGE_NS)
@pytest.mark.parametrize('name, depth, K', [('s27', 2, 3), ('s60', 3, 3),
                                            ('s27', 6, 1)])
def test_ranked_limb_planes_from_text_at_row_edges(name, depth, K, n):
    """K2's text twin (and the wrapper's CPU path) equals the plain version
    on K1's pack, and the JAX plane program on the same pack, at true
    lengths up to the row's end; the JAX pack, whose roll wraps in the last
    D - 1 positions, and the host builder, which never clamps, agree where
    no window reaches those positions."""
    data = _corpus(name)
    data = np.resize(data, n)
    text = np.zeros(N_EDGE, dtype=np.uint8)
    text[:n] = data
    # Bytes past n must not count: the kernel and its twin mask them.
    text[n:] = 0x61
    sa = np.empty(N_EDGE, dtype=np.int32)
    sa[:n] = suffix_array_numpy(data)
    sa[n:] = np.arange(N_EDGE - 1, n - 1, -1)
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = jsearch.alphabet_rank(pres)
    bits = jsearch.ranked_bits(sigma)
    D = jsearch.ranked_limb_bytes(bits)
    depth = min(depth, D)
    t, s, r = (torch.from_numpy(a) for a in (text, sa, rank))
    packed = tsearch.ranked_pack_plain(t, n, r, bits)
    spec = tsearch.ranked_limb_planes_plain(packed, s, n, depth, bits, K)
    twin = tsearch.ranked_limb_planes_text_plain(t, s, n, r, depth, bits, K)
    wrapped = tsearch.ranked_limb_planes(t, s, n, r, depth, bits, K)
    assert torch.equal(twin, spec) and torch.equal(wrapped, spec)
    plane = jsearch.derive_limb_ranked_jit(depth, bits)
    buf = jnp.zeros((1, K * N_EDGE), jnp.int32)
    for j in range(K):
        buf = plane(buf, jnp.int32(0), jnp.int32(j),
                    jnp.asarray(packed.numpy()), jnp.int32(n),
                    jnp.asarray(sa))
    np.testing.assert_array_equal(spec.numpy(), np.asarray(buf)[0])
    if n + depth + D * K <= N_EDGE - D:
        jpacked = _jax_pack(text, n, rank, bits)
        np.testing.assert_array_equal(jpacked[: N_EDGE - D],
                                      packed.numpy()[: N_EDGE - D])
        host = jsearch.pad_limbs_host(jsearch.build_ranked_limbs_host(
            data, sa[:n], rank, K, depth, bits), N_EDGE)
        np.testing.assert_array_equal(spec.numpy(), host)


#: Row lengths at the port's pack tiles (16 positions a thread): a whole
#: number of tiles, one position into the next, one short of it.
TILE_NS = (4096, 4097, 4111)


@pytest.mark.parametrize('N', TILE_NS)
@pytest.mark.parametrize('at', ['0', '1', 'N-D', 'N-1', 'N'])
@pytest.mark.parametrize('bits', [5, 6])
def test_ranked_pack_matches_jax_at_tile_edges(N, at, bits):
    """K1's plain version (and the wrapper's CPU path) against
    ``ranked_pack_jit`` at rows that end in a partial tile and true lengths
    0, 1 and up to the row's end, where windows cross n and N; bytes past
    n must not count.  The JAX roll wraps into the last D - 1 positions,
    so those are compared only with the port's own zeros."""
    D = jsearch.ranked_limb_bytes(bits)
    n = {'0': 0, '1': 1, 'N-D': N - D, 'N-1': N - 1, 'N': N}[at]
    rng = np.random.default_rng(N * 8 + n + bits)
    lo, hi = (97, 123) if bits == 5 else (40, 99)
    text = rng.integers(lo, hi, size=N, dtype=np.uint8)
    rank, sigma = jsearch.alphabet_rank(
        np.bincount(text, minlength=256)[:256] > 0)
    assert jsearch.ranked_bits(sigma) == bits
    t, r = torch.from_numpy(text), torch.from_numpy(rank)
    plain = tsearch.ranked_pack_plain(t, n, r, bits).numpy()
    ref = _jax_pack(text, n, rank, bits)
    np.testing.assert_array_equal(plain[: N - D], ref[: N - D])
    np.testing.assert_array_equal(tsearch.ranked_pack(t, n, r, bits).numpy(),
                                  plain)
    assert not plain[n:].any()


@pytest.mark.parametrize('case', CASES, ids=lambda c: f'{c[0]}-d{c[1]}-k{c[2]}')
def test_seed_table_matches_jax(case):
    data, text, sa, rank, bits, base, depth, K = _row(*case)
    n = data.size
    packed = tsearch.ranked_pack_plain(
        torch.from_numpy(text), n, torch.from_numpy(rank), bits
    )
    plain = tsearch.seed_table_plain(
        packed, torch.from_numpy(sa), n, base, depth, bits
    ).numpy()
    wrapped = tsearch.seed_table(
        packed, torch.from_numpy(sa), n, base, depth, bits
    ).numpy()
    host = jsearch.build_seed_table_host(data, sa[:n], rank, base, depth)
    table = jsearch.derive_table_from_pack_jit(base, depth, bits)
    buf = table(
        jnp.zeros((1, base ** depth + 1), jnp.int32), jnp.int32(0),
        jnp.asarray(_jax_pack(text, n, rank, bits)), jnp.int32(n),
        jnp.asarray(sa),
    )
    np.testing.assert_array_equal(plain, host)
    np.testing.assert_array_equal(plain, np.asarray(buf)[0])
    np.testing.assert_array_equal(wrapped, plain)


def test_host_builders_are_the_jax_ones():
    """The port's copies of the numpy builders give the JAX package's
    arrays (raw limbs included, which the raw-kind index uploads)."""
    data, text, sa, rank, bits, base, depth, K = _row('s60', 3, 3)
    n = data.size
    for fn_t, fn_j, args in (
        (tsearch.build_seed_table_host, jsearch.build_seed_table_host,
         (data, sa[:n], rank, base, depth)),
        (tsearch.build_ranked_limbs_host, jsearch.build_ranked_limbs_host,
         (data, sa[:n], rank, K, depth, bits)),
        (tsearch.build_raw_limbs_host, jsearch.build_raw_limbs_host,
         (data, sa[:n], K, depth)),
    ):
        np.testing.assert_array_equal(fn_t(*args), fn_j(*args))
    for sigma, max_n in ((13, 2000), (27, 8 << 20), (60, 8 << 20), (200, 99)):
        assert tsearch.pick_table_params(sigma, max_n) == \
            jsearch.pick_table_params(sigma, max_n)
    pats = [b'', b'ab', b'x' * 20, b'hello world']
    for a, b in zip(tsearch.pack_patterns(pats), jsearch.pack_patterns(pats)):
        np.testing.assert_array_equal(a, b)
