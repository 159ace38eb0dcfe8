"""The last modules of the port on the CPU against the JAX package and a
numpy ground truth: ``make_giant_chunk_build`` (B14g, one row's B9 split
over a mesh: 8 CPU placements in one process and two gloo ranks), the
plain versions of its kernels, ``suffix_array_device``, ``trace_to`` and
the package's type stubs."""

import ast
import glob
import inspect
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu.ops import suffix_array as jsa
from pysubstringsearch_tpu.parallel import mesh as jmesh
from pysubstringsearch_tpu.parallel import sharded as jsharded
from pysubstringsearch_tpu_torch.ops import suffix_array as SA
from pysubstringsearch_tpu_torch.parallel import mesh as tmesh
from pysubstringsearch_tpu_torch.parallel import sharded as tsharded
from pysubstringsearch_tpu_torch.utils.profiling import trace_to

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_case():
    """``tests/test_sharded.py``'s giant-chunk case: seed 7, n = 5000 bytes
    of 97-104 in a row of N = 8192."""
    rng = np.random.default_rng(7)
    n, N = 5000, 8192
    data = rng.integers(97, 105, size=n, dtype=np.uint8)
    padded = np.zeros(N, np.uint8)
    padded[:n] = data
    return data, padded, n, N


def _padded(data, N):
    out = np.zeros(N, np.uint8)
    out[: len(data)] = data
    return out


def _check_sa_full(sa_full, data, N):
    n = len(data)
    want = SA.suffix_array_numpy(data) if n else np.zeros(0, np.int32)
    np.testing.assert_array_equal(sa_full[N - n:], want)
    np.testing.assert_array_equal(sa_full[: N - n],
                                  np.arange(N - 1, n - 1, -1))


def _texts():
    rng = np.random.default_rng(11)
    return {
        'random': (rng.integers(97, 101, size=200, dtype=np.uint8), 256),
        'one_byte': (np.full(250, ord('a'), np.uint8), 256),
        'period2': (np.frombuffer(b'ab' * 125, np.uint8), 256),
        'period3': (np.frombuffer((b'abc' * 84)[:250], np.uint8), 256),
        'n0': (np.zeros(0, np.uint8), 16),
        'n1': (np.array([7], np.uint8), 16),
        'n_eq_N': (rng.integers(0, 4, size=64, dtype=np.uint8), 64),
        'short_blocks': (rng.integers(97, 99, size=13, dtype=np.uint8), 16),
        # Random bytes, all settled by the init, then 'ab', none settled:
        # at S = 2 one shard sorts nothing after the init.
        'uneven': (np.concatenate([rng.integers(0, 256, size=128,
                                                dtype=np.uint8),
                                   np.frombuffer(b'ab' * 61, np.uint8)]),
                   256),
        # UTF-16: a NUL byte every other byte, one just before n, so tied
        # real suffixes read the pads' ranks.
        'nul_tail': (np.frombuffer(('ab' * 50 + 'abc').encode('utf-16-le'),
                                   np.uint8), 256),
        'mostly_pads': (rng.integers(97, 99, size=20, dtype=np.uint8), 256),
    }


TEXTS = _texts()


def test_giant_build_matches_jax_on_eight_placements():
    """B14g on a one-process mesh of 8 CPU placements against the JAX
    ``make_giant_chunk_build`` on conftest's 8-device CPU mesh: the real
    slots equal, the pad slots [N - 1, ..., n] (the JAX kernel orders its
    pad slots otherwise)."""
    data, padded, n, N = _jax_case()
    want = np.asarray(jsharded.make_giant_chunk_build(jmesh.make_mesh())(
        padded, np.int32(n)))
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 8))
    got = build(padded, np.int32(n))
    assert got.dtype == torch.int32 and got.shape == (N,)
    np.testing.assert_array_equal(got.numpy()[N - n:], want[N - n:])
    np.testing.assert_array_equal(got.numpy()[: N - n],
                                  np.arange(N - 1, n - 1, -1))
    assert build.stats['shards'] == 8 and build.stats['block'] == N // 8
    assert max(build.stats['max_recv']) <= build.stats['recv_bound']


@pytest.mark.parametrize('S', [1, 2, 4, 8])
@pytest.mark.parametrize('name', sorted(TEXTS))
def test_giant_build_matches_numpy(name, S):
    """Every text at every mesh size against ``suffix_array_numpy``, the
    pad slots in closed form, and no shard receiving more than 2B + S
    pairs in any sort."""
    data, N = TEXTS[name]
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * S))
    got = build(torch.from_numpy(_padded(data, N)), len(data))
    _check_sa_full(got.numpy(), data, N)
    st = build.stats
    assert st['recv_bound'] == 2 * (N // S) + S
    assert len(st['max_recv']) == len(st['round_bound']) == st['rounds'] + 1
    assert all(r <= b <= st['recv_bound']
               for r, b in zip(st['max_recv'], st['round_bound'])), st


@pytest.mark.parametrize('name', ['random', 'period2', 'one_byte'])
def test_giant_build_runs_b9s_rounds(name, monkeypatch):
    """The distributed build stops where B9 does: as many rounds after the
    init as ``sa_full_doubling_plain`` runs, counted by a spy."""
    data, N = TEXTS[name]
    calls = []
    real = SA._full_key_round_plain

    def spy(*args, **kwargs):
        calls.append(args[2])
        return real(*args, **kwargs)

    monkeypatch.setattr(SA, '_full_key_round_plain', spy)
    text = torch.from_numpy(_padded(data, N))
    want = SA.sa_full_doubling_plain(text, len(data))
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 4))
    got = build(text, len(data))
    assert torch.equal(got, want)
    assert build.stats['rounds'] == len(calls) > 0


def _np_tied(row, n):
    """B9's rounds in numpy on the padded ``row`` of true length ``n``:
    (the pairs each sort of the giant build takes, the real positions
    still tied after each relabel).  A position is tied while its key is
    shared; the init sorts every position, a round the tied ones."""
    N = row.size
    W = N.bit_length()
    keys = _np_byte_keys(row, n)
    sorted_pairs, tied_real = [N], []
    k = 6
    while True:
        rank = np.searchsorted(np.sort(keys), keys, 'left')
        _, inv, size = np.unique(keys, return_inverse=True,
                                 return_counts=True)
        tied = size[inv] > 1
        tied_real.append(int(tied[:n].sum()))
        if not (k < N and tied_real[-1]):
            return sorted_pairs, tied_real
        sorted_pairs.append(int(tied.sum()))
        low = np.zeros(N, np.int64)
        low[: N - k] = rank[k:] + 1
        keys = (rank.astype(np.int64) << W) | low
        k *= 2


@pytest.mark.parametrize('S', [1, 2, 8])
@pytest.mark.parametrize('name', ['random', 'period2', 'uneven', 'nul_tail',
                                  'mostly_pads', 'n_eq_N'])
def test_giant_build_sorts_only_the_tied(name, S):
    """Each sort takes the init's N pairs, then only the positions still
    tied (pads included: they are not settled early), and each relabel
    leaves as many real positions tied as numpy's B9 does; the rounds are
    B9's."""
    data, N = TEXTS[name]
    row = _padded(data, N)
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * S))
    _check_sa_full(build(row, data.size).numpy(), data, N)
    sorted_pairs, tied_real = _np_tied(row, data.size)
    assert build.stats['sorted'] == sorted_pairs
    assert build.stats['tied_real'] == tied_real
    assert build.stats['rounds'] == len(sorted_pairs) - 1


@pytest.mark.parametrize('S', [2, 4, 8])
def test_giant_build_receive_bound_on_the_uneven_text(S, monkeypatch):
    """On the uneven text one shard's pairs all settle in the init and the
    others' do not: a round sorts nothing on that shard (m_s = 0, its
    samples above every pair), and every sort's largest receive stays
    within 2 max_s m_s + S, itself within 2B + S."""
    data, N = TEXTS['uneven']
    sizes = []
    real = tsharded.radix_sort_pairs

    def spy(keys, vals, bits):
        sizes.append(keys.shape[0])
        return real(keys, vals, bits)

    monkeypatch.setattr(tsharded, 'radix_sort_pairs', spy)
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * S))
    _check_sa_full(build(_padded(data, N), data.size).numpy(), data, N)
    st = build.stats
    assert st['rounds'] >= 2
    rounds = [sizes[r * S: (r + 1) * S] for r in range(st['rounds'] + 1)]
    assert rounds[0] == [N // S] * S
    assert all(0 in r for r in rounds[1:]), rounds
    for r, ms in enumerate(rounds):
        assert sum(ms) == st['sorted'][r]
        assert st['round_bound'][r] == 2 * max(ms) + S
        assert st['max_recv'][r] <= st['round_bound'][r] <= st['recv_bound']


def test_giant_build_takes_tensors_and_host_arrays():
    data, padded, n, N = _jax_case()
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh('cpu'))
    ro = padded.copy()
    ro.setflags(write=False)
    a = build(ro, n)
    b = build(torch.from_numpy(padded), torch.tensor(n))
    assert torch.equal(a, b)
    _check_sa_full(a.numpy(), data, N)


def test_giant_build_errors():
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 8))
    with pytest.raises(ValueError, match='does not split'):
        build(np.zeros(12, np.uint8), 4)
    with pytest.raises(ValueError, match='0 <= n <= N'):
        build(np.zeros(16, np.uint8), 17)
    with pytest.raises(ValueError, match='0 <= n <= N'):
        build(np.zeros(16, np.uint8), -1)
    with pytest.raises(ValueError, match='1-D'):
        build(np.zeros((2, 8), np.uint8), 4)
    mixed = tmesh.Mesh((torch.device('cpu'),) * 2, None, 0, 2, True)
    with pytest.raises(ValueError, match='placements'):
        tsharded.make_giant_chunk_build(mixed)
    with pytest.raises(ValueError, match='at most'):
        tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 257))
    with pytest.raises(ValueError, match='S <='):
        SA.giant_partition(torch.zeros(1, dtype=torch.int32),
                           torch.zeros(1, dtype=torch.int32), 1, 0)


def test_shard_places_and_exchange():
    """Shards of a one-process mesh exchange runs by device copies, in
    source order, zero-length runs included; small tensors gather in shard
    order."""
    mesh = tmesh.make_mesh(['cpu'] * 3)
    assert [s for s, _ in tmesh.shard_places(mesh)] == [0, 1, 2]
    sends = [(torch.arange(4) + 10 * j, torch.arange(4) * -1 - 10 * j)
             for j in range(3)]
    counts = [[1, 0, 3], [2, 2, 0], [0, 0, 4]]
    recvs, rcounts = tmesh.exchange_runs(sends, counts, mesh)
    assert rcounts == [[1, 2, 0], [0, 2, 0], [3, 0, 4]]
    assert recvs[0][0].tolist() == [0, 10, 11]
    assert recvs[1][0].tolist() == [12, 13]
    assert recvs[2][0].tolist() == [1, 2, 3, 20, 21, 22, 23]
    assert recvs[2][1].tolist() == [-1, -2, -3, -20, -21, -22, -23]
    g = tmesh.gather_shards([torch.tensor([j, -j]) for j in range(3)], mesh)
    assert g.tolist() == [[0, 0], [1, -1], [2, -2]]


# ---- the plain versions of kernels (a)-(c) against numpy ------------------

def _np_byte_keys(row, n):
    N = row.size
    e = np.where(np.arange(N) < n, row.astype(np.int64) + 1, 0)
    ext = np.concatenate([e, np.zeros(6, np.int64)])
    limbs = [np.zeros(N, np.int64), np.zeros(N, np.int64)]
    for d in range(6):
        limbs[d // 3] = limbs[d // 3] * 257 + ext[d: d + N]
    return (limbs[0] << 25) | limbs[1]


@pytest.mark.parametrize('S', [1, 3, 8])
@pytest.mark.parametrize('n', [0, 1, 37, 60, 64])
def test_byte_keys_plain(S, n):
    rng = np.random.default_rng(n + S)
    N = 64 if S != 3 else 63
    n = min(n, N)
    row = rng.integers(0, 256, size=N, dtype=np.uint8)
    want = _np_byte_keys(row, n)
    B = N // S
    for s in range(S):
        text = torch.from_numpy(row[s * B: (s + 1) * B].copy())
        halo = torch.from_numpy(row[(s + 1) * B: (s + 1) * B + 5].copy())
        keys, vals = SA.giant_byte_keys(text, halo, s * B, n)
        np.testing.assert_array_equal(keys.numpy(), want[s * B: (s + 1) * B])
        np.testing.assert_array_equal(vals.numpy(), np.arange(s * B,
                                                              (s + 1) * B))


def _marked(rng, size, share):
    """Group starts below 2^12, about ``share`` of them unsettled (the
    sign bit set)."""
    g = rng.integers(0, 1 << 12, size=size).astype(np.int64)
    tied = rng.random(size) < share
    return np.where(tied, g - (1 << 31), g).astype(np.int32), tied


@pytest.mark.parametrize('c', [0, 1, 50, 64])
def test_round_keys_plain(c):
    """The compacting round keys against a numpy mask: only the unsettled
    positions, in position order, their marks (and the shifted ranks')
    cleared; the count; and the host's expected count checked."""
    rng = np.random.default_rng(c)
    rank, tied = _marked(rng, 64, 0.6)
    r2 = _marked(rng, c, 0.5)[0]
    keys, vals, count = SA.giant_round_keys(
        torch.from_numpy(rank), torch.from_numpy(r2), 13, 640,
        int(tied.sum()))
    low = np.zeros(64, np.int64)
    low[:c] = (r2.astype(np.int64) & 0x7fffffff) + 1
    want = ((rank.astype(np.int64) & 0x7fffffff) << 13) | low
    np.testing.assert_array_equal(keys.numpy(), want[tied])
    np.testing.assert_array_equal(vals.numpy(), np.arange(640, 704)[tied])
    assert count.tolist() == [int(tied.sum())]
    with pytest.raises(ValueError, match='expected'):
        SA.giant_round_keys(torch.from_numpy(rank), torch.from_numpy(r2), 13,
                            640, int(tied.sum()) + 1)


@pytest.mark.parametrize('seed', range(4))
def test_cuts_plain(seed):
    rng = np.random.default_rng(seed)
    m = int(rng.integers(0, 300))
    keys = rng.integers(0, 6, size=m).astype(np.int64)
    vals = rng.permutation(1000)[:m].astype(np.int32)
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    sk = rng.integers(-1, 7, size=7).astype(np.int64)
    sp = rng.integers(0, 1000, size=7).astype(np.int32)
    got = SA.giant_cuts(torch.from_numpy(keys), torch.from_numpy(vals),
                        torch.from_numpy(sk), torch.from_numpy(sp))
    pairs = list(zip(keys.tolist(), vals.tolist()))
    want = [sum(p < (a, b) for p in pairs) for a, b in zip(sk.tolist(),
                                                           sp.tolist())]
    assert got.tolist() == want


@pytest.mark.parametrize('S', [1, 2, 5, 8])
def test_partition_plain(S):
    rng = np.random.default_rng(S)
    B = 37
    pos = rng.permutation(S * B)[: int(rng.integers(0, S * B))].astype(
        np.int32)
    gs = _marked(rng, pos.size, 0.3)[0]
    live = torch.full((S,), -1, dtype=torch.int32)
    p, g, tot = SA.giant_partition(torch.from_numpy(pos),
                                   torch.from_numpy(gs), B, S, live=live)
    owner = pos // B
    order = np.argsort(owner, kind='stable')
    np.testing.assert_array_equal(p.numpy(), (pos - owner * B)[order])
    np.testing.assert_array_equal(g.numpy(), gs[order])
    np.testing.assert_array_equal(tot.numpy(),
                                  np.bincount(owner, minlength=S))
    np.testing.assert_array_equal(live.numpy(),
                                  np.bincount(owner[gs < 0], minlength=S))


def _np_relabel(keys, off, pred, succ, shift, real_lo, carry_a, carry_b):
    """Numpy's (stats, group starts) of the slot-space relabel, by its
    definition: the list index f of each old group's first member and the
    list index of each new group's first member, carried in from earlier
    shards where the group starts there."""
    m = keys.size
    J = off + np.arange(m)
    g = keys >> shift
    prev = np.concatenate([[pred if pred is not None else -1], keys[:-1]])
    first = np.zeros(m, bool)
    first[:1] = pred is None
    starts = first | (keys != prev)
    old = first | ((keys >> shift) != (prev >> shift))
    nxt = np.ones(m, bool)
    nxt[:-1] = starts[1:]
    if m and succ is not None:
        nxt[-1] = succ != keys[-1]
    a = np.where(old, g - J, -1)
    b = np.where(starts, J, -1)
    tied = int(np.sum(~(starts & nxt) & (keys >= real_lo)))
    stats = [int(a.max()) if m else -1, int(b.max()) if m else -1, tied]
    gs = (np.maximum(np.maximum.accumulate(b), carry_b)
          + np.maximum(np.maximum.accumulate(a), carry_a)) if m else b
    return stats, np.where(starts & nxt, gs, gs - (1 << 31))


@pytest.mark.parametrize('has_pred', [False, True])
@pytest.mark.parametrize('m', [0, 1, 200])
def test_flags_plain(m, has_pred):
    """The flags' plain version against numpy: the largest a (g - J at an
    old group's first member) and b (J at a new group's), the unsettled
    real pairs, with and without a predecessor and a successor."""
    rng = np.random.default_rng(m)
    W = 12
    # Old group starts in [1200, 1240), at or past the list's slots.
    keys = np.sort(((1200 + rng.integers(0, 40, size=m)) << W)
                   | rng.integers(0, 3, size=m)).astype(np.int64)
    pred = int(keys[0]) if m and has_pred else None
    succ = int(keys[-1]) if m and has_pred else None
    off, real_lo = 1000, 1220 << W
    got = SA.giant_flags(torch.from_numpy(keys), off, pred, succ, W, real_lo)
    want, _ = _np_relabel(keys, off, pred, succ, W, real_lo, -1, -1)
    assert got.tolist() == want


def _round_state(row, n, k):
    """numpy's state of B9 on ``row`` before the round at ``k``: every
    position's group start (``rank``) and whether it is tied."""
    N = row.size
    W = N.bit_length()
    keys = _np_byte_keys(row, n)
    kk = 6
    while True:
        rank = np.searchsorted(np.sort(keys), keys, 'left')
        _, inv, size = np.unique(keys, return_inverse=True,
                                 return_counts=True)
        if kk == k:
            return rank, size[inv] > 1
        low = np.zeros(N, np.int64)
        low[: N - kk] = rank[kk:] + 1
        keys = (rank.astype(np.int64) << W) | low
        kk *= 2


@pytest.mark.parametrize('S', [1, 3, 8, SA.GIANT_MAX_SHARDS])
@pytest.mark.parametrize('name,k', [('period2', 6), ('period2', 12),
                                    ('random', 6), ('nul_tail', 12),
                                    ('uneven', 6), ('mostly_pads', 6)])
def test_relabel_plain_matches_a_full_relabel(name, k, S):
    """The slot-space relabel's plain version on the sorted list of the
    tied positions' round keys, split over S shards at uneven cuts (empty
    ones included, and old groups spanning shards, so that f and g carry
    in), against numpy's relabel of every position by a lexsort of all N
    keys: each pair's new group start and its mark, the flags' stop count
    and the carries."""
    data, N = TEXTS[name]
    row = _padded(data, N)
    n = data.size
    W = N.bit_length()
    rank, tied = _round_state(row, n, k)
    low = np.zeros(N, np.int64)
    low[: N - k] = rank[k:] + 1
    full = (rank.astype(np.int64) << W) | low
    order = np.lexsort((np.arange(N), full))
    new_rank = np.empty(N, np.int64)
    new_rank[order] = np.searchsorted(full[order], full[order], 'left')
    _, inv, size = np.unique(full, return_inverse=True, return_counts=True)
    settled = size[inv] == 1
    pos = np.nonzero(tied)[0]
    pos = pos[np.lexsort((pos, full[pos]))]
    keys = full[pos]
    m = keys.size
    rng = np.random.default_rng([S, k, len(name)])
    cuts = np.sort(rng.integers(0, m + 1, size=S - 1))
    edges = np.concatenate([[0], cuts, [m]])
    real_lo = (N - n) << W
    shards = [keys[edges[s]: edges[s + 1]] for s in range(S)]
    stats = []
    for s, kk in enumerate(shards):
        pred = next((int(shards[t][-1]) for t in range(s - 1, -1, -1)
                     if shards[t].size), None)
        succ = next((int(shards[t][0]) for t in range(s + 1, S)
                     if shards[t].size), None)
        st = SA.giant_flags(torch.from_numpy(kk), int(edges[s]), pred, succ,
                            W, real_lo).tolist()
        stats.append((kk, pred, succ, st))
    got = []
    for s, (kk, pred, succ, st) in enumerate(stats):
        carry_a = max([-1] + [x[3][0] for x in stats[:s]])
        carry_b = max([-1] + [x[3][1] for x in stats[:s]])
        out = SA.giant_relabel(torch.from_numpy(kk), int(edges[s]), pred,
                               succ, W, carry_a, carry_b)
        assert out.dtype == torch.int32 and out.shape == (kk.size,)
        want_st, want = _np_relabel(kk, int(edges[s]), pred, succ, W,
                                    real_lo, carry_a, carry_b)
        assert st == want_st
        np.testing.assert_array_equal(out.numpy(), want)
        got.append(out.numpy())
    got = np.concatenate(got).astype(np.int64)
    np.testing.assert_array_equal(got & 0x7fffffff, new_rank[pos])
    np.testing.assert_array_equal(got >= 0, settled[pos])
    assert sum(x[3][2] for x in stats) == int(np.sum(~settled[pos]
                                                     & (pos < n)))


@pytest.mark.parametrize('case', ['all_settled', 'none_settled', 'm0',
                                  'c0', 'tile_edge'])
def test_round_keys_plain_edges(case):
    """The compacting round keys against a numpy mask where no position is
    unsettled, where every one is, on an empty block, with no shifted
    ranks, and over 4097 positions (a tile and one)."""
    rng = np.random.default_rng(len(case))
    m = {'m0': 0, 'tile_edge': 4097}.get(case, 300)
    share = {'all_settled': 0.0, 'none_settled': 1.0}.get(case, 0.5)
    rank, tied = _marked(rng, m, share)
    c = 0 if case == 'c0' else max(m - 7, 0)
    r2 = _marked(rng, c, 0.5)[0]
    keys, vals, count = SA.giant_round_keys(
        torch.from_numpy(rank), torch.from_numpy(r2), 20, 77,
        int(tied.sum()))
    low = np.zeros(m, np.int64)
    low[:c] = (r2.astype(np.int64) & 0x7fffffff) + 1
    want = ((rank.astype(np.int64) & 0x7fffffff) << 20) | low
    np.testing.assert_array_equal(keys.numpy(), want[tied])
    np.testing.assert_array_equal(vals.numpy(), (77 + np.arange(m))[tied])
    assert count.tolist() == [int(tied.sum())]


def _cuts_case(case):
    """(keys, vals, splitter keys, splitter positions) of a cuts edge."""
    rng = np.random.default_rng(len(case))
    if case == 'tie_run':  # 1500 equal keys; splitters inside, at, beside
        keys = np.concatenate([np.full(5, 2), np.full(1500, 3),
                               np.full(7, 4)]).astype(np.int64)
        vals = np.concatenate([np.arange(5), np.arange(100, 3100, 2),
                               np.arange(7)]).astype(np.int32)
        sk = np.array([3, 3, 3, 3, 3, 3, 2, 4], np.int64)
        sp = np.array([-1, 100, 101, 2150, 3098, 5000, 99, -3], np.int32)
        return keys, vals, sk, sp
    m = {'m0': 0, 'm1': 1, 'below_all': 300, 'above_all': 300,
         'splitters255': 4000}[case]
    keys = np.sort(rng.integers(10, 20, size=m)).astype(np.int64)
    vals = rng.permutation(10 * m + 1)[:m].astype(np.int32)
    order = np.lexsort((vals, keys))
    keys, vals = keys[order], vals[order]
    if case == 'below_all':
        sk = np.array([9, 10, 10], np.int64)
        sp = np.array([10 ** 6, -1, int(vals[0]) if m else 0], np.int32)
    elif case == 'above_all':
        sk = np.array([20, 19, 19], np.int64)
        sp = np.array([-5, int(vals[-1]) + 1, 2 ** 31 - 1], np.int32)
    elif case == 'splitters255':
        pick = np.sort(rng.integers(0, m, size=255))
        sk, sp = keys[pick], vals[pick] + rng.integers(-1, 2, size=255)
        sp = sp.astype(np.int32)
    else:  # m0, m1: splitters on both sides of every pair
        sk = np.array([9, 15, 15, 21], np.int64)
        sp = np.array([0, -1, 2 ** 31 - 1, 0], np.int32)
        if m:
            sk[1:3] = keys[0]
    return keys, vals, sk, sp


@pytest.mark.parametrize('case', ['below_all', 'above_all', 'tie_run', 'm0',
                                  'm1', 'splitters255'])
def test_cuts_plain_edges(case):
    """The cuts against numpy's (key, position) order at the kernel's
    edges: splitters below and above every pair, a run of equal keys
    longer than a round of the kernel's probes with splitters on both
    sides of its positions, m = 0 and 1, and 255 splitters; written into
    ``out``."""
    keys, vals, sk, sp = _cuts_case(case)
    out = torch.full((sk.size,), -7, dtype=torch.int64)
    got = SA.giant_cuts(torch.from_numpy(keys), torch.from_numpy(vals),
                        torch.from_numpy(sk), torch.from_numpy(sp), out=out)
    assert got is out
    order = np.lexsort((vals, keys))
    assert np.array_equal(order, np.arange(keys.size))
    # Pairs below each splitter: (key, value) < (sk, sp) lexicographically.
    want = [int(np.sum((keys < a) | ((keys == a) & (vals < b))))
            for a, b in zip(sk.tolist(), sp.tolist())]
    assert out.tolist() == want


@pytest.mark.parametrize('m', [0, 1, 2, 255, 256, 257, 1024, 1025, 65536,
                               65537, 1 << 24, 1 << 27, (1 << 31) - 1])
def test_cuts_rounds(m):
    """The kernel's dependent rounds: at most ceil(log256 m) + 1, 4 at the
    2^27 pairs of a shard of the 512 Mi row, where a binary search takes
    27."""
    r = SA.giant_cuts_rounds(m)
    bound = 0 if m == 0 else 1 + next(k for k in range(6) if 256 ** k >= m)
    assert r <= bound
    assert r == {0: 0, 1: 1, 256: 1, 257: 2, 1 << 27: 4}.get(m, r)


def _partition_case(case):
    """(pos, gs, floor, B, S) of a partition edge."""
    rng = np.random.default_rng(len(case))
    S, B = {'S1': (1, 2 ** 7 - 1), 'S3': (3, 2 ** 9 + 1),
            'S256': (256, 2 ** 5 - 1), 'one_owner': (8, 2 ** 8 + 1),
            'm0': (4, 2 ** 6 + 1), 'marked': (5, 2 ** 8 - 1)}[case]
    m = {'S256': 6000, 'm0': 0}.get(case, 3 * B)
    if case == 'one_owner':  # every pair in shard 5's block
        pos = 5 * B + rng.integers(0, B, size=m)
    else:
        pos = rng.integers(0, S * B, size=m)
    gs = rng.integers(0, 10 ** 6, size=m)
    if case == 'marked':  # most group starts marked unsettled
        gs = np.where(rng.random(m) < 0.8, gs - (1 << 31), gs)
    return pos.astype(np.int32), gs.astype(np.int32), B, S


@pytest.mark.parametrize('case', ['S1', 'S3', 'S256', 'one_owner', 'm0',
                                  'marked'])
def test_partition_plain_edges(case):
    """The partition against numpy at S = 1, 3 and 256, B = 2^k +- 1,
    every pair to one owner, m = 0 and most group starts marked
    unsettled; counts into ``totals``, unsettled counts into ``live``."""
    pos, gs, B, S = _partition_case(case)
    totals = torch.full((S,), -1, dtype=torch.int32)
    live = torch.full((S,), -1, dtype=torch.int32)
    p, g, tot = SA.giant_partition(torch.from_numpy(pos),
                                   torch.from_numpy(gs), B, S,
                                   totals=totals, live=live)
    assert tot is totals
    owner = pos // B
    order = np.argsort(owner, kind='stable')
    np.testing.assert_array_equal(p.numpy(), (pos - owner * B)[order])
    np.testing.assert_array_equal(g.numpy(), gs[order])
    np.testing.assert_array_equal(tot.numpy(),
                                  np.bincount(owner, minlength=S))
    np.testing.assert_array_equal(live.numpy(),
                                  np.bincount(owner[gs < 0], minlength=S))


def test_giant_build_reads_back_once_a_step(monkeypatch):
    """On 8 placements of one device a sort reads its cuts back in one
    copy and a round its partition counts in one: the build's host reads
    are three a sort (cuts, sizes with the first and last keys, relabel
    summaries: the carries and the unsettled real pairs) and one a round
    (each owner's counts and unsettled counts), whatever the number of
    placements; the finish reads nothing; its SA is unchanged."""
    calls = []
    tolist = torch.Tensor.tolist

    def counted(self):
        calls.append(tuple(self.shape))
        return tolist(self)

    data, padded, n, N = _jax_case()
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 8))
    monkeypatch.setattr(torch.Tensor, 'tolist', counted)
    got = build(padded, n).numpy()
    monkeypatch.undo()
    rounds = build.stats['rounds']
    assert len(calls) == 3 * (rounds + 1) + rounds, calls
    assert sorted(set(calls)) == sorted({(8, 7), (8, 3), (8, 16)})
    _check_sa_full(got, data, N)


# ---- step 4's merge of the received runs -----------------------------------

def _merge_case(S, case, seed=0):
    """(keys int64, positions int32, run lengths) of S runs as a shard
    receives them: each sorted by (key, position), run s holding positions
    of source block s only, so positions rise from run to run."""
    rng = np.random.default_rng([S, len(case), seed])
    B = 300
    if case == 'empty_runs':  # every other run empty, and the last
        lengths = [int(rng.integers(1, B)) if s % 2 == 0 and s < S - 1
                   else 0 for s in range(S)]
        if not any(lengths):
            lengths[0] = 5
    elif case == 'unequal':  # one long run among short ones
        lengths = [int(rng.integers(0, 4)) for _ in range(S)]
        lengths[S // 2] = B
    else:
        lengths = [int(rng.integers(0, B)) for _ in range(S)]
    keys, pos = [], []
    for s, length in enumerate(lengths):
        if case == 'all_equal':
            k = np.full(length, 1 << 40, np.int64)
        else:
            k = rng.integers(0, 50, size=length).astype(np.int64) << 54
        p = s * B + rng.permutation(B)[:length]
        o = np.lexsort((p, k))
        keys.append(k[o])
        pos.append(p[o].astype(np.int32))
    return np.concatenate(keys), np.concatenate(pos), lengths


@pytest.mark.parametrize('case', ['random', 'empty_runs', 'all_equal',
                                  'unequal'])
@pytest.mark.parametrize('S', [1, 2, 4, 7, 64])
def test_giant_merge_plain_matches_lexsort(S, case):
    """The merge's plain version, through the wrapper, against numpy's
    lexsort by (key, index in the concatenation), which for runs in source
    order is (key, position)."""
    keys, pos, lengths = _merge_case(S, case)
    got_k, got_v = SA.giant_merge(torch.from_numpy(keys),
                                  torch.from_numpy(pos), lengths)
    order = np.lexsort((np.arange(keys.size), keys))
    np.testing.assert_array_equal(got_k.numpy(), keys[order])
    np.testing.assert_array_equal(got_v.numpy(), pos[order])
    np.testing.assert_array_equal(
        order, np.lexsort((pos.astype(np.int64), keys)))


@pytest.mark.parametrize('runs', [[3, 5], [8, -1], [], [1] * 257])
def test_giant_merge_rejects_bad_runs(runs):
    """Run lengths that do not sum to m, a negative one, none for 7 pairs
    and more runs than shards raise, in the plain version too."""
    m = 7 if sum(runs) != 257 else 257
    keys = torch.zeros(m, dtype=torch.int64)
    vals = torch.zeros(m, dtype=torch.int32)
    for fn in (SA.giant_merge, SA.giant_merge_plain):
        with pytest.raises(ValueError, match='giant_merge'):
            fn(keys, vals, runs)


@pytest.mark.parametrize('runs,rounds', [([], 0), ([0, 0], 0), ([5], 0),
                                         ([0, 5, 0], 0), ([1, 1], 1),
                                         ([1] * 4, 2), ([1, 0, 1, 1], 2),
                                         ([1] * 7, 3), ([1] * 17, 5),
                                         ([1] * 256, 8), ([1] * 255 + [0], 8)])
def test_giant_merge_rounds(runs, rounds):
    """Non-empty runs merge in pairs: ceil(log2) of their number rounds, 2
    at S = 4, 3 at 7, 8 at 256, none with at most one non-empty run."""
    assert SA.giant_merge_rounds(runs) == rounds


def _merge_rows():
    rng = np.random.default_rng(23)
    words = [rng.integers(97, 123, size=int(n), dtype=np.uint8).tobytes()
             for n in rng.integers(2, 7, size=40)]
    text = b' '.join(words[i] for i in rng.integers(0, 40, size=1200))
    return {'words': np.frombuffer(text[:3000], np.uint8),
            'abab': np.frombuffer(b'ab' * 1500, np.uint8)}


def _check_received_runs(keys, pos, runs, B):
    """The runs of one merge as the build hands them over: as long as the
    exchange's receive counts, each sorted by (key, position), run s
    holding positions of source block s only, and their merge by (key,
    run) in (key, position) order."""
    assert sum(runs) == keys.size == pos.size
    at = 0
    for s, length in enumerate(runs):
        k, p = keys[at: at + length], pos[at: at + length]
        assert np.all((k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (p[1:] > p[:-1])))
        assert np.all((p >= s * B) & (p < (s + 1) * B))
        at += length
    order = np.argsort(keys, kind='stable')
    k, p = keys[order], pos[order]
    assert np.all((k[1:] > k[:-1]) | ((k[1:] == k[:-1]) & (p[1:] > p[:-1])))


def _spy_merges(module, B):
    """Wrap ``module``'s ``exchange_runs`` and ``giant_merge`` so that every
    merge is checked against the receive counts of the exchange before it
    (:func:`_check_received_runs`); returns the merges' run lengths."""
    state = {'rc': None, 'j': 0, 'calls': []}
    exchange, merge = module.exchange_runs, module.giant_merge

    def spy_exchange(sends, counts, mesh, *tally):
        out = exchange(sends, counts, mesh, *tally)
        state['rc'], state['j'] = out[1], 0
        return out

    def spy_merge(keys, vals, runs):
        assert list(runs) == list(state['rc'][state['j']])
        state['j'] += 1
        _check_received_runs(keys.numpy(), vals.numpy(), list(runs), B)
        state['calls'].append(list(runs))
        return merge(keys, vals, runs)

    module.exchange_runs, module.giant_merge = spy_exchange, spy_merge
    return state['calls']


@pytest.mark.parametrize('name', ['words', 'abab'])
def test_giant_build_merges_the_exchanged_runs(name, monkeypatch):
    """On 8 placements every sort's received runs reach ``giant_merge``
    with the exchange's receive counts as their lengths, 8 runs a shard,
    each sorted by (key, position) with positions rising from run to run,
    one merge a shard a sort; the SA is unchanged."""
    data = _merge_rows()[name]
    N, S = 4096, 8
    monkeypatch.setattr(tsharded, 'exchange_runs', tsharded.exchange_runs)
    monkeypatch.setattr(tsharded, 'giant_merge', tsharded.giant_merge)
    calls = _spy_merges(tsharded, N // S)
    build = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * S))
    got = build(_padded(data, N), data.size).numpy()
    _check_sa_full(got, data, N)
    assert len(calls) == S * (build.stats['rounds'] + 1)
    assert all(len(runs) == S for runs in calls)
    assert max(max(runs) for runs in calls) > 0


# ---- two gloo ranks -------------------------------------------------------

GIANT_WORKER = r'''
import os, sys
import numpy as np
import torch
rank, tmp = int(sys.argv[1]), sys.argv[2]
from pysubstringsearch_tpu_torch.parallel import mesh as mesh_lib, multihost
from pysubstringsearch_tpu_torch.parallel import sharded
multihost.initialize('file://' + os.path.join(tmp, 'rendezvous'), 2, rank,
                     'gloo')
mesh = mesh_lib.make_mesh('cpu')
assert (mesh.rank, mesh.world, mesh.size) == (rank, 2, 2)
inp = np.load(os.path.join(tmp, 'inputs.npz'))
build = sharded.make_giant_chunk_build(mesh)
out = {}
for name in ('jax', 'period2', 'n0', 'uneven'):
    out[name] = build(inp[name], int(inp[name + '_n'])).numpy()
    assert out[name].shape == (inp[name].size // 2,)
    assert max(build.stats['max_recv']) <= build.stats['recv_bound']
    out[name + '_rounds'] = np.int64(build.stats['rounds'])
np.savez(os.path.join(tmp, f'out{rank}.npz'), **out)
assert 'jax' not in sys.modules and 'pysubstringsearch_tpu' not in sys.modules
print(f'WORKER{rank}_OK', flush=True)
'''


def test_giant_build_on_two_gloo_ranks(tmp_path):
    """Two processes that import only the port join a gloo group through
    ``file://``; each builds its block of the row.  Their blocks joined
    equal the JAX function's real slots and the closed-form pads, and the
    one-process build's rounds; on the uneven text one rank sorts nothing
    after the init."""
    data, padded, n, N = _jax_case()
    ab = np.frombuffer(b'ab' * 500, np.uint8)
    uneven, uneven_N = TEXTS['uneven']
    np.savez(tmp_path / 'inputs.npz', jax=padded, jax_n=n,
             period2=_padded(ab, 1024), period2_n=ab.size,
             n0=np.zeros(16, np.uint8), n0_n=0,
             uneven=_padded(uneven, uneven_N), uneven_n=uneven.size)
    script = tmp_path / 'worker.py'
    script.write_text(GIANT_WORKER)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        pytest.fail('a worker process timed out')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {rank} failed:\n{out}'
        assert f'WORKER{rank}_OK' in out
    res = [np.load(tmp_path / f'out{rank}.npz') for rank in range(2)]
    want = np.asarray(jsharded.make_giant_chunk_build(jmesh.make_mesh())(
        padded, np.int32(n)))
    got = np.concatenate([r['jax'] for r in res])
    np.testing.assert_array_equal(got[N - n:], want[N - n:])
    _check_sa_full(got, data, N)
    _check_sa_full(np.concatenate([r['period2'] for r in res]), ab, 1024)
    _check_sa_full(np.concatenate([r['n0'] for r in res]),
                   np.zeros(0, np.uint8), 16)
    _check_sa_full(np.concatenate([r['uneven'] for r in res]), uneven,
                   uneven_N)
    one = tsharded.make_giant_chunk_build(tmesh.make_mesh(['cpu'] * 2))
    one(_padded(ab, 1024), ab.size)
    assert int(res[0]['period2_rounds']) == one.stats['rounds']


GIANT_MERGE_WORKER = r'''
import os, sys
import numpy as np
import torch
rank, tmp = int(sys.argv[1]), sys.argv[2]
from pysubstringsearch_tpu_torch.parallel import mesh as mesh_lib, multihost
from pysubstringsearch_tpu_torch.parallel import sharded
multihost.initialize('file://' + os.path.join(tmp, 'rendezvous'), 2, rank,
                     'gloo')
mesh = mesh_lib.make_mesh('cpu')
inp = np.load(os.path.join(tmp, 'inputs.npz'))
import importlib.util
spec = importlib.util.spec_from_file_location('giant_spies',
                                              os.path.join(tmp, 'spies.py'))
spies = importlib.util.module_from_spec(spec)
spec.loader.exec_module(spies)
out = {}
for name in ('words', 'abab'):
    row = inp[name]
    calls = spies.spy_merges(sharded, row.size // 2)
    build = sharded.make_giant_chunk_build(mesh)
    out[name] = build(row, int(inp[name + '_n'])).numpy()
    assert len(calls) == build.stats['rounds'] + 1, calls
    assert all(len(runs) == 2 for runs in calls), calls
    out[name + '_merges'] = np.int64(len(calls))
np.savez(os.path.join(tmp, f'out{rank}.npz'), **out)
assert 'jax' not in sys.modules and 'pysubstringsearch_tpu' not in sys.modules
# Both ranks done before either tears the group down.
torch.distributed.barrier()
torch.distributed.destroy_process_group()
print(f'WORKER{rank}_OK', flush=True)
'''


def test_giant_build_merges_the_exchanged_runs_on_two_gloo_ranks(tmp_path):
    """Two gloo ranks (processes that import only the port), each merging
    the 2 runs it receives a sort: the same checks as on 8 placements,
    against the exchange over ``all_to_all_single``, on the word and
    ``abab`` rows; the joined blocks equal numpy's SA."""
    rows = _merge_rows()
    N = 4096
    np.savez(tmp_path / 'inputs.npz',
             **{k: _padded(v, N) for k, v in rows.items()},
             **{k + '_n': v.size for k, v in rows.items()})
    src = 'import numpy as np\n\n\n' + inspect.getsource(
        _check_received_runs).replace('def _check_received_runs',
                                      'def check_received_runs') + \
        '\n\n' + inspect.getsource(_spy_merges).replace(
            'def _spy_merges', 'def spy_merges').replace(
            '_check_received_runs(', 'check_received_runs(')
    (tmp_path / 'spies.py').write_text(src)
    script = tmp_path / 'worker.py'
    script.write_text(GIANT_MERGE_WORKER)
    env = dict(os.environ)
    env['PYTHONPATH'] = REPO + os.pathsep + env.get('PYTHONPATH', '')
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=REPO) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    except subprocess.TimeoutExpired:
        pytest.fail('a worker process timed out')
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f'worker {rank} failed:\n{out}'
        assert f'WORKER{rank}_OK' in out
    res = [np.load(tmp_path / f'out{rank}.npz') for rank in range(2)]
    for name, data in rows.items():
        _check_sa_full(np.concatenate([r[name] for r in res]), data, N)
        assert int(res[0][name + '_merges']) == int(res[1][name + '_merges'])


# ---- suffix_array_device, trace_to, the stubs -----------------------------

@pytest.mark.parametrize('n', [0, 1, 1000, 1018, 1024])
def test_suffix_array_device_matches_jax(n):
    rng = np.random.default_rng(n)
    N = 1024
    padded = np.zeros(N, np.uint8)
    padded[:n] = rng.integers(97, 100, size=n, dtype=np.uint8)
    want = np.asarray(jsa.suffix_array_device(jnp.asarray(padded), n))
    text = torch.from_numpy(padded)
    got = SA.suffix_array_device(text, np.int32(n))
    assert got.dtype == torch.int32 and got.device == text.device
    np.testing.assert_array_equal(got.numpy()[N - n:], want[N - n:])
    np.testing.assert_array_equal(got.numpy()[: N - n],
                                  np.arange(N - 1, n - 1, -1))


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / 'traces' / 'run'
    with trace_to(str(log_dir)) as prof:
        torch.arange(1000).cumsum(0)
    files = glob.glob(str(log_dir / '*.json'))
    assert len(files) == 1
    with open(files[0]) as f:
        trace = json.load(f)
    names = {e.get('name') for e in trace['traceEvents']}
    assert 'aten::cumsum' in names
    assert any(e.key == 'aten::cumsum' for e in prof.key_averages())


def test_trace_to_writes_on_error(tmp_path):
    with pytest.raises(RuntimeError, match='inside'):
        with trace_to(str(tmp_path)):
            torch.ones(3).sum()
            raise RuntimeError('inside')
    assert len(glob.glob(str(tmp_path / '*.json'))) == 1


def _stub_classes():
    path = os.path.join(os.path.dirname(tpss.__file__), '__init__.pyi')
    with open(path) as f:
        tree = ast.parse(f.read())
    return {node.name: node for node in tree.body
            if isinstance(node, ast.ClassDef)}


def _stub_params(fn):
    """(name, kind, has default) of a stub function's parameters, as
    ``inspect`` names the kinds."""
    a = fn.args
    P = inspect.Parameter
    out = []
    pos = a.posonlyargs + a.args
    defaults = [None] * (len(pos) - len(a.defaults)) + list(a.defaults)
    for arg, d in zip(pos, defaults):
        out.append((arg.arg, P.POSITIONAL_OR_KEYWORD, d is not None))
    if a.vararg:
        out.append((a.vararg.arg, P.VAR_POSITIONAL, False))
    for arg, d in zip(a.kwonlyargs, a.kw_defaults):
        out.append((arg.arg, P.KEYWORD_ONLY, d is not None))
    if a.kwarg:
        out.append((a.kwarg.arg, P.VAR_KEYWORD, False))
    return out


@pytest.mark.parametrize('cls', ['Writer', 'Reader'])
def test_stubs_match_the_classes(cls):
    """Every method and property of the stub has the real one's
    parameters (names, kinds, which have defaults), and every public one of
    the class is in the stub."""
    stub = _stub_classes()[cls]
    real = getattr(tpss, cls)
    stubbed = {}
    for fn in stub.body:
        if not isinstance(fn, ast.FunctionDef):
            continue
        decos = {d.id for d in fn.decorator_list if isinstance(d, ast.Name)}
        stubbed[fn.name] = fn
        attr = inspect.getattr_static(real, fn.name)
        if 'property' in decos:
            assert isinstance(attr, property), fn.name
            continue
        if 'classmethod' in decos:
            assert isinstance(attr, classmethod), fn.name
            attr = attr.__func__
        params = [(p.name, p.kind, p.default is not inspect.Parameter.empty)
                  for p in inspect.signature(attr).parameters.values()]
        assert params == _stub_params(fn), fn.name
    public = {name for name in vars(real) if not name.startswith('_')}
    assert public <= set(stubbed), public - set(stubbed)
    assert {'__init__', '__enter__', '__exit__'} & set(vars(real)) <= set(
        stubbed)


def test_package_data_lists_the_stubs():
    with open(os.path.join(REPO, 'pyproject.toml')) as f:
        line = next(ln for ln in f if ln.startswith(
            'pysubstringsearch_tpu_torch = '))
    pkg = os.path.dirname(tpss.__file__)
    for name in ('py.typed', '__init__.pyi'):
        assert f'"{name}"' in line
        assert os.path.exists(os.path.join(pkg, name))
