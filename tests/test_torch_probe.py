"""The port's phased probe (K4, plain version on the CPU) against the JAX
package's ``probe_bounds_phased`` and brute force: raw and ranked limb
kinds, every phase count, deep patterns past the packed coverage,
exact-depth patterns, absent bytes, the empty pattern and an empty chunk.

Counts must be equal to each other and to brute force; ``lower`` must be
equal wherever count > 0 (on a collapsed miss the JAX lower may sit at a
neighbouring bucket's start).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops.suffix_array import _pad_len, suffix_array_numpy
from pysubstringsearch_tpu_torch.ops import search as tsearch

torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def _jax_probe(num_limbs, deep, bits):
    return jax.jit(functools.partial(
        jsearch.probe_bounds_phased, num_limbs=num_limbs, deep=deep,
        bits=bits,
    ))


def brute_counts(data: bytes, patterns):
    out = []
    for p in patterns:
        if len(p) == 0:
            out.append(len(data))
            continue
        out.append(
            sum(1 for i in range(len(data)) if data[i: i + len(p)] == p)
        )
    return np.array(out, dtype=np.int32)


def build_row(data: bytes, kind: str, num_limbs: int, depth=None):
    """One padded row with the JAX host builders.  ``kind``: 'd2' / 'd3'
    (full-byte base-258 seed, raw limbs), 'ranked-seed' (alphabet-ranked
    seed, raw limbs) or 'ranked' (ranked seed and ranked limbs)."""
    n = len(data)
    n_pad = _pad_len(n + jsearch.PAD_MARGIN)
    arr = np.frombuffer(data, dtype=np.uint8)
    text = np.zeros(n_pad, dtype=np.uint8)
    text[:n] = arr
    sa = np.zeros(n_pad, dtype=np.int32)
    sa[:n] = suffix_array_numpy(arr)
    bits = None
    if kind in ('d2', 'd3'):
        rank, pres_i = jsearch.identity_rank()
        pres = pres_i > 0
        base, depth = 258, int(kind[1])
    else:
        pres = np.bincount(arr, minlength=256)[:256] > 0
        rank, sigma = jsearch.alphabet_rank(pres)
        base, d = jsearch.pick_table_params(sigma, n)
        depth = d if depth is None else depth
        if kind == 'ranked':
            bits = jsearch.ranked_bits(sigma)
    table = jsearch.build_seed_table_host(arr, sa[:n], rank, base, depth)
    if bits is None:
        limbs = jsearch.build_raw_limbs_host(arr, sa[:n], num_limbs, depth)
    else:
        limbs = jsearch.build_ranked_limbs_host(
            arr, sa[:n], rank, num_limbs, depth, bits
        )
    limbs = jsearch.pad_limbs_host(limbs, n_pad)
    return dict(text=text, n=n, sa=sa, table=table, limbs=limbs, rank=rank,
                present=pres.astype(np.int32), base=base, depth=depth,
                bits=bits, num_limbs=num_limbs)


def run_both(row, pats):
    """(jax lower, jax count, port lower, port count) for one row."""
    packed, lengths = jsearch.pack_patterns(pats)
    K, depth, bits = row['num_limbs'], row['depth'], row['bits']
    cover = (jsearch.raw_cover_bytes(K, depth) if bits is None
             else jsearch.ranked_cover_bytes(K, depth, bits))
    lo_j, cnt_j = _jax_probe(K, packed.shape[1] > cover, bits)(
        jnp.asarray(row['text']), jnp.int32(row['n']),
        jnp.asarray(row['sa']), jnp.asarray(row['table']),
        jnp.asarray(row['limbs']), jnp.asarray(row['rank']),
        jnp.asarray(row['present']), jnp.asarray(packed),
        jnp.asarray(lengths),
    )
    lo_t, cnt_t = tsearch.probe_phased(
        torch.from_numpy(row['text'])[None],
        torch.tensor([row['n']], dtype=torch.int32),
        torch.from_numpy(row['sa'])[None],
        torch.from_numpy(row['table'])[None],
        torch.from_numpy(row['limbs'])[None],
        torch.from_numpy(row['rank']), torch.from_numpy(row['present']),
        torch.from_numpy(packed), torch.from_numpy(lengths),
        K, row['base'], depth, bits,
    )
    return (np.asarray(lo_j), np.asarray(cnt_j), lo_t.numpy()[0],
            cnt_t.numpy()[0])


def assert_agree(data, row, pats):
    lo_j, cnt_j, lo_t, cnt_t = run_both(row, pats)
    expected = brute_counts(data, pats)
    np.testing.assert_array_equal(cnt_t, expected)
    np.testing.assert_array_equal(cnt_j, expected)
    hit = expected > 0
    np.testing.assert_array_equal(lo_t[hit], lo_j[hit])


CORPORA = [
    b'banana banana band ana nab\n',
    bytes(np.random.default_rng(1).integers(97, 100, 3000, dtype=np.uint8)),
    b'aaaaaaaaaaaaaaaaaaaaaaaaaaaaaaaa',
    bytes(np.random.default_rng(2).integers(1, 256, 2500, dtype=np.uint8)),
    b'z' * 10 + b'\xff' * 10 + b'z\xff' * 10 + b'\n',
]


def sample_patterns(data: bytes, seed: int):
    rng = np.random.default_rng(seed)
    pats = [b'', b'\xff', data[:1], data[-1:], data[:2], data[:3], data[:4],
            data[:5]]
    for l in (1, 2, 3, 4, 5, 6, 7, 8, 11, 12, 15, 16, 19, 24, 40):
        if len(data) <= l:
            break
        i = int(rng.integers(0, max(len(data) - l, 1)))
        pats.append(data[i: i + l])
    for _ in range(30):
        i = int(rng.integers(0, len(data) - 1))
        l = int(rng.integers(1, min(20, len(data) - i) + 1))
        pats.append(data[i: i + l])
    if len(data) < 900:
        pats.append(data + b'x')
    pats.append(bytes(rng.integers(1, 256, 5, dtype=np.uint8)))
    return pats


@pytest.mark.parametrize('ci', range(len(CORPORA)))
@pytest.mark.parametrize('kind', ['d2', 'd3', 'ranked-seed'])
def test_raw_limbs_match_jax(ci, kind):
    data = CORPORA[ci]
    row = build_row(data, kind, jsearch.RAW_LIMBS)
    pats = sample_patterns(data, ci)
    if kind == 'ranked-seed':
        # Absent bytes at several positions; raw limbs cannot hold NUL.
        pats += [data[:1] + b'\xfe', data[:4] + b'\xfe' * 3,
                 data[:7] + b'\x01', b'\x02', b'\xfe']
    assert_agree(data, row, pats)


@pytest.mark.parametrize('num_limbs', [1, 2, 3])
@pytest.mark.parametrize('kind', ['d2', 'ranked'])
def test_every_phase_count(kind, num_limbs):
    """Pattern lengths from 1 to the packed coverage + 3."""
    data = CORPORA[1]
    row = build_row(data, kind, num_limbs)
    rng = np.random.default_rng(num_limbs)
    D = 4 if row['bits'] is None else jsearch.ranked_limb_bytes(row['bits'])
    cover = row['depth'] + D * num_limbs
    pats = []
    for l in range(1, cover + 4):
        i = int(rng.integers(0, len(data) - l))
        pats.append(data[i: i + l])
    assert_agree(data, row, pats)


@pytest.mark.parametrize('sigma_hi', [110, 123])  # bits 5 and 6
@pytest.mark.parametrize('depth', [None, 2])
def test_ranked_limbs_match_jax(sigma_hi, depth):
    """Ranked limbs with NUL text bytes, absent-byte patterns at collision
    positions (inside the seed, inside a limb, past the coverage) and
    exact-depth patterns."""
    rng = np.random.default_rng(sigma_hi)
    arr = rng.integers(97, sigma_hi, size=3500, dtype=np.uint8)
    arr[::41] = 0x0A
    arr[::97] = 0x00
    data = arr.tobytes()
    row = build_row(data, 'ranked', 2, depth)
    d = row['depth']
    pres = np.bincount(arr, minlength=256)[:256] > 0
    absent = bytes([next(b for b in range(97, 256) if not pres[b])])
    pref = data[100:112]
    pats = [b'', data[:1], b'\x00', data[40:42], data[200:200 + d],
            data[300:300 + d], absent, pref[:3] + absent,
            pref[:d] + absent, pref[:d + 2] + absent,
            pref[: d + 7] + absent + pref[:2], pref + absent + pref]
    for l in range(1, 30):
        i = int(rng.integers(0, len(data) - l))
        pats.append(data[i: i + l])
    assert_agree(data, row, pats)


@pytest.mark.parametrize('kind', ['d2', 'ranked'])
def test_empty_chunk(kind):
    row = build_row(b'', kind, jsearch.RAW_LIMBS)
    lo_j, cnt_j, lo_t, cnt_t = run_both(row, [b'x', b'', b'xyzzy' * 5])
    assert not cnt_t.any() and not cnt_j.any()


def test_several_rows_in_one_probe():
    """Rows of one stacked index probe together: each row's answer equals
    its own single-row probe."""
    rng = np.random.default_rng(9)
    datas = [bytes(rng.integers(97, 101, size=m, dtype=np.uint8))
             for m in (700, 1, 0, 900)]
    pres = np.zeros(256, dtype=bool)
    for d in datas:
        pres |= np.bincount(np.frombuffer(d, np.uint8), minlength=256)[:256] > 0
    rank, sigma = jsearch.alphabet_rank(pres)
    bits = jsearch.ranked_bits(sigma)
    base, depth = jsearch.pick_table_params(sigma, 900)
    n_pad = _pad_len(900 + jsearch.PAD_MARGIN)
    K = 2
    rows = []
    for d in datas:
        arr = np.frombuffer(d, np.uint8)
        sa = suffix_array_numpy(arr)
        text = np.zeros(n_pad, np.uint8)
        text[: arr.size] = arr
        sa_p = np.zeros(n_pad, np.int32)
        sa_p[: arr.size] = sa
        rows.append((text, sa_p,
                     jsearch.build_seed_table_host(arr, sa, rank, base, depth),
                     jsearch.pad_limbs_host(jsearch.build_ranked_limbs_host(
                         arr, sa, rank, K, depth, bits), n_pad)))
    pats = [datas[0][i: i + l] for i, l in ((0, 3), (5, 9), (17, 25))]
    pats += [b'', b'a', b'zz']
    packed, lengths = tsearch.pack_patterns(pats)
    lo, cnt = tsearch.probe_phased(
        *[torch.from_numpy(np.stack([r[0] for r in rows]))],
        torch.tensor([len(d) for d in datas], dtype=torch.int32),
        *[torch.from_numpy(np.stack([r[k] for r in rows])) for k in (1, 2, 3)],
        torch.from_numpy(rank), torch.from_numpy(pres.astype(np.int32)),
        torch.from_numpy(packed), torch.from_numpy(lengths),
        K, base, depth, bits,
    )
    for r, d in enumerate(datas):
        np.testing.assert_array_equal(cnt[r].numpy(), brute_counts(d, pats))


def _repeated_block(size, seed, lo=97, hi=103):
    """A random block repeated with a few bytes changed: suffixes that
    share hundreds of bytes."""
    rng = np.random.default_rng(seed)
    block = rng.integers(lo, hi, size=397, dtype=np.uint8)
    arr = np.tile(block, size // block.size + 1)[:size]
    arr[rng.integers(0, size, size=size // 300)] = hi
    return arr.tobytes()


def _edge_case(case):
    """(corpus, row, patterns, patterns that brute force decides) of one of
    ``EDGE_CASES``, built with numpy from a seed."""
    rng = np.random.default_rng(len(case))
    if case == 'absent_ties':
        # 'b' and '`' absent: each borrows the rank of the next present
        # byte, so a pattern with one ties in the limbs with 'c' or 'a'.
        arr = rng.choice(np.frombuffer(b'acdefghij\n', np.uint8), size=4000)
        data = arr.tobytes()
        row = build_row(data, 'ranked', 3)
        cover = jsearch.ranked_cover_bytes(3, row['depth'], row['bits'])
        pats = []
        for l in (cover - 1, cover, cover + 1, cover + 7, 40):
            for i in rng.integers(0, len(data) - l, size=6):
                p = bytearray(data[i: i + l])
                pats.append(bytes(p))
                for q in range(row['depth'], min(16, l)):
                    if p[q] in b'ac':
                        p[q] -= 1  # 'a' -> '`', 'c' -> 'b'
                pats.append(bytes(p))
        return data, row, pats, pats
    if case == 'raw_nul':
        arr = rng.integers(1, 256, size=3000, dtype=np.uint8)
        data = arr.tobytes()
        row = build_row(data, 'ranked-seed', jsearch.RAW_LIMBS)
        cover = jsearch.raw_cover_bytes(jsearch.RAW_LIMBS, row['depth'])
        clean = sample_patterns(data, 7)
        pats = list(clean)
        for t in (1, 2, row['depth'], 5, cover - 1):
            tail = data[len(data) - t:]
            pats += [tail + b'\x00', tail + b'\x00' * (cover + 3 - t)]
        for i in rng.integers(0, len(data) - 40, size=12):
            p = bytearray(data[i: i + 30])
            p[int(rng.integers(row['depth'], 16))] = 0
            pats.append(bytes(p))
        pats += [b'\x00', b'\x00' * (cover + 2)]
        return data, row, pats, clean
    if case.startswith('deep_repeats'):
        raw = case.endswith('raw')
        data = _repeated_block(5000, 3, *((1, 200) if raw else (97, 103)))
        row = build_row(data, 'd2' if raw else 'ranked', 3)
        pats = [data[i: i + l] for l in (100, 150, 299, 300)
                for i in rng.integers(0, len(data) - l, size=5)]
        pats += [p[:-1] + bytes([p[-1] ^ 1]) for p in pats[::3]]
        return data, row, pats, pats
    K = int(case.split('_')[1])  # raw_4_limbs, raw_8_limbs
    data = CORPORA[3]
    row = build_row(data, 'd2' if K == 4 else 'ranked-seed', K)
    cover = jsearch.raw_cover_bytes(K, row['depth'])
    pats = sample_patterns(data, K)
    for l in range(1, cover + 4):
        i = int(rng.integers(0, len(data) - l))
        pats.append(data[i: i + l])
    return data, row, pats, pats


EDGE_CASES = ['absent_ties', 'raw_nul', 'deep_repeats', 'deep_repeats_raw',
              'raw_4_limbs', 'raw_8_limbs']


@pytest.mark.parametrize('case', EDGE_CASES)
def test_edge_corpora_match_jax(case):
    """The plain phased probe against the JAX ``probe_bounds_phased`` and
    brute force where the kernel's shortcuts meet their edges: ranked
    patterns whose absent bytes tie in the limbs with present ones inside
    the cover, raw patterns with NUL (packed like a position past n;
    the Reader resolves them on the host, so only the JAX program decides
    them), deep patterns of 100-300 bytes over repeated text, and raw limbs
    at 4 and 8 limbs (a cover past 16 bytes).  Counts and lower bounds
    equal the JAX ones for every pattern, misses included, and the counts
    equal brute force for the patterns it decides."""
    data, row, pats, decided = _edge_case(case)
    lo_j, cnt_j, lo_t, cnt_t = run_both(row, pats)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    np.testing.assert_array_equal(lo_t, lo_j)
    hit = cnt_t > 0
    index = {p: i for i, p in enumerate(pats)}
    sel = [index[p] for p in decided]
    np.testing.assert_array_equal(cnt_t[sel], brute_counts(data, decided))
    assert hit.sum() > 0
