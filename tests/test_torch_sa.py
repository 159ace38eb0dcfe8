"""The port's device suffix-array build (B1, B2, ``derive_sa``), its
full-sort doubling (B9) with the Writer's device builders, and flat hit
gather (B8), as their plain PyTorch versions run them on the CPU, against
the JAX package's functions on the same numpy inputs, and against the numpy
oracle.  Integers compare exactly.

The JAX sorts are unstable and the port's are stable, so inside a tie group
the ``sa`` of one init or one round may differ; ``rank``, ``gs`` and the
finished SA may not.
"""

import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops.suffix_array import (
    _doubling_kernel,
    _doubling_round,
    _init_round,
    _init_round_anchored_ranked,
    _relabel_and_scatter,
    _suffix_array_int_jax,
    suffix_array_jax,
)
from pysubstringsearch_tpu.ops.suffix_array import (
    suffix_array_int as jsuffix_array_int,
)
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import search as tsearch
from pysubstringsearch_tpu_torch.ops import suffix_array as tsa

torch.set_num_threads(1)

#: One padded row length for every case, so each JAX program compiles once
#: per digit width.
N = 4096

_jinit = jax.jit(_init_round_anchored_ranked, static_argnums=3)
_jrelabel = jax.jit(_relabel_and_scatter)


def _words(seed: int, size: int, letters: int = 20) -> np.ndarray:
    """Natural-ish text: a small vocabulary of short words, so suffixes
    stay tied past the init's 2D characters."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 97 + letters, size=int(l),
                                dtype=np.uint8))
             for l in rng.integers(2, 6, size=15)]
    text = b' '.join(vocab[i] for i in rng.integers(0, 15, size=size))
    return np.frombuffer(text[:size], dtype=np.uint8).copy()


CASES = {
    'words5': lambda: _words(1, 3000),
    'wide6': lambda: np.random.default_rng(2).integers(
        48, 100, size=3000).astype(np.uint8),
    'short': lambda: np.frombuffer(b'abc', dtype=np.uint8).copy(),
    'repeat': lambda: np.full(2000, 101, dtype=np.uint8),
    'empty': lambda: np.zeros(0, dtype=np.uint8),
    'one': lambda: np.array([100], dtype=np.uint8),
}


def _row(data: np.ndarray):
    """(padded text [N], n, rank [256], bits) for a text."""
    pres = np.bincount(data, minlength=256)[:256] > 0
    rank, sigma = tsearch.alphabet_rank(pres)
    bits = tsearch.ranked_bits(sigma)
    assert bits is not None
    padded = np.zeros(N, dtype=np.uint8)
    padded[: data.size] = data
    return padded, data.size, rank, bits


def _within_groups(sa: np.ndarray, gs: np.ndarray) -> np.ndarray:
    """sa with each tie group's members sorted: the order-free content."""
    return sa[np.lexsort((sa, gs))]


@pytest.mark.parametrize('case', ['words5', 'wide6', 'short', 'repeat'])
def test_init_matches_jax(case):
    data = CASES[case]()
    padded, n, rank, bits = _row(data)
    if case == 'wide6':
        assert bits == 6
    sa, rk, gs = tsa.sa_init_ranked(
        torch.from_numpy(padded), n, torch.from_numpy(rank), bits
    )
    jsa, jrk, jgs = (np.asarray(a) for a in _jinit(
        jnp.asarray(padded), jnp.int32(n), jnp.asarray(rank), bits))
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    npad = N - n
    np.testing.assert_array_equal(sa.numpy()[:npad], jsa[:npad])
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))


@pytest.mark.parametrize('case', ['words5', 'wide6', 'repeat', 'empty',
                                  'one'])
def test_derive_sa_matches_jax_and_numpy(case):
    data = CASES[case]()
    padded, n, rank, bits = _row(data)
    sa, ties, tpois = tsa.derive_sa(
        torch.from_numpy(padded), n, torch.from_numpy(rank), bits
    )
    jsa, poisoned = jsearch.derive_sa(
        jnp.asarray(padded), jnp.int32(n), jnp.asarray(rank), bits
    )
    assert not poisoned and not tpois
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sa.numpy()[:n],
                                  tsa.suffix_array_numpy(data))
    if case == 'repeat':
        # Every round stays fully tied until k passes the run length.
        assert len(ties) >= 8 and ties[0] == n - 2 * (30 // bits) + 1
    if case in ('empty', 'one'):
        assert ties == []


def test_refine_round_matches_jax_relabel():
    data = _words(3, 3000)
    padded, n, rank, bits = _row(data)
    sa, rk, gs = tsa.sa_init_ranked_plain(
        torch.from_numpy(padded), n, torch.from_numpy(rank), bits
    )
    k = 2 * (30 // bits)
    # The compacted buffer the JAX loop would feed _relabel_and_scatter.
    gs_np, sa_np, rk_np = gs.numpy(), sa.numpy(), rk.numpy()
    eq_next = np.zeros(N, dtype=bool)
    eq_next[:-1] = gs_np[:-1] == gs_np[1:]
    tied = eq_next.copy()
    tied[1:] |= eq_next[:-1]
    slots = np.flatnonzero(tied)
    pos = sa_np[slots]
    q = pos.astype(np.int64) + k
    r2 = np.where(q < N, rk_np[np.minimum(q, N - 1)], -1).astype(np.int32)
    jsa, jrk, jgs = (np.asarray(a) for a in _jrelabel(
        jnp.asarray(gs_np[slots]), jnp.asarray(r2), jnp.asarray(pos),
        jnp.asarray(sa_np), jnp.asarray(rk_np), jnp.asarray(gs_np)))
    m = tsa.sa_refine_round(sa, rk, gs, k)
    assert m == slots.size > 100
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))


def test_refine_round_without_ties_is_a_no_op():
    sa = torch.arange(16, dtype=torch.int32).flip(0)
    gs = torch.arange(16, dtype=torch.int32)
    rk = gs.flip(0).clone()
    before = [t.clone() for t in (sa, rk, gs)]
    assert tsa.sa_refine_round(sa, rk, gs, 4) == 0
    for a, b in zip((sa, rk, gs), before):
        assert torch.equal(a, b)


@pytest.mark.parametrize('n', [N - 5, N + 1, -1])
def test_pad_contract_enforced(n):
    text = torch.zeros(N, dtype=torch.uint8)
    rank = torch.ones(256, dtype=torch.int32)
    with pytest.raises(ValueError, match='pad contract'):
        tsa.derive_sa(text, n, rank, 5)


def test_derive_writes_into_out_row_and_launches_nothing_on_cpu():
    data = _words(4, 2500)
    padded, n, rank, bits = _row(data)
    stack = torch.full((2, N), -7, dtype=torch.int32)
    before = dict(kernels.LAUNCHES)
    sa, _, _ = tsa.derive_sa(torch.from_numpy(padded), n,
                             torch.from_numpy(rank), bits, out=stack[1])
    assert sa.data_ptr() == stack[1].data_ptr()
    assert (stack[0] == -7).all()
    np.testing.assert_array_equal(stack[1, :n].numpy(),
                                  tsa.suffix_array_numpy(data))
    plain, _, _ = tsa.derive_sa_plain(torch.from_numpy(padded), n,
                                      torch.from_numpy(rank), bits)
    assert torch.equal(plain, stack[1])
    assert kernels.LAUNCHES == before


def _hits_batch(seed: int, B: int):
    rng = np.random.default_rng(seed)
    sa_row = rng.permutation(N).astype(np.int32)
    lower = rng.integers(0, N - 300, size=B).astype(np.int32)
    count = rng.integers(0, 300, size=B).astype(np.int32)
    count[::3] = 0
    return sa_row, lower, count


@pytest.mark.parametrize('B, zero', [(37, False), (5, True)])
def test_gather_hits_flat_matches_jax(B, zero):
    sa_row, lower, count = _hits_batch(B, B)
    if zero:
        count[:] = 0
    total = int(count.sum())
    pos, qid = tsearch.gather_hits_flat(
        torch.from_numpy(sa_row), torch.from_numpy(lower),
        torch.from_numpy(count)
    )
    jpos, jqid = jsearch.gather_hits_flat(
        jnp.asarray(sa_row), jnp.asarray(lower), jnp.asarray(count), total
    )
    assert pos.shape == qid.shape == (total,)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos)[:total])
    np.testing.assert_array_equal(qid.numpy(), np.asarray(jqid)[:total])


def test_gather_hits_flat_empty_batch():
    # The JAX gather reads cum[-1] and needs one query; the port returns
    # empty arrays for an empty batch.
    empty = torch.zeros(0, dtype=torch.int32)
    pos, qid = tsearch.gather_hits_flat(
        torch.arange(N, dtype=torch.int32), empty, empty
    )
    assert pos.shape == qid.shape == (0,)


@pytest.mark.parametrize('n', [1, 1000, 5003])
def test_building_blocks_plain(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 40, size=n).astype(np.int64) << 40
    vals = np.arange(n, dtype=np.int32)
    ks, vs = tsa.radix_sort_pairs(torch.from_numpy(keys.copy()),
                                  torch.from_numpy(vals.copy()), 46)
    order = np.argsort(keys, kind='stable')
    np.testing.assert_array_equal(ks.numpy(), keys[order])
    np.testing.assert_array_equal(vs.numpy(), order)
    x = rng.integers(-3, 50, size=n).astype(np.int32)
    ex = tsa.scan_exclusive_sum(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(ex, np.concatenate(([0], np.cumsum(x))))
    mx = tsa.scan_inclusive_max(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(mx, np.maximum.accumulate(x))


# ---------------------------------------------------------------------------
# B9, full-sort doubling, and the Writer's device builders
# ---------------------------------------------------------------------------

_jfull_init = jax.jit(_init_round)
_jfull_round = jax.jit(_doubling_round)
_jfull = jax.jit(_doubling_kernel)


def _bytes_row(data: np.ndarray) -> np.ndarray:
    padded = np.zeros(N, dtype=np.uint8)
    padded[: data.size] = data
    return padded


FULL_CASES = dict(CASES, nul=lambda: np.random.default_rng(5).integers(
    0, 256, size=3000).astype(np.uint8))


@pytest.mark.parametrize('case', ['words5', 'wide6', 'short', 'repeat',
                                  'one', 'nul'])
def test_full_init_and_round_match_jax(case):
    data = FULL_CASES[case]()
    padded, n = _bytes_row(data), data.size
    sa, rk, count = tsa.sa_full_init_bytes(torch.from_numpy(padded), n)
    jrk, jsa, jcount = (np.asarray(a) for a in _jfull_init(
        jnp.asarray(padded), jnp.int32(n)))
    # Dense ranks are order-free; inside a tie group the sa may differ.
    np.testing.assert_array_equal(rk.numpy(), jrk)
    assert count == int(jcount)
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jrk[jsa]),
                                  _within_groups(jsa, jrk[jsa]))
    count = tsa.sa_full_round(sa, rk, 6, N.bit_length())
    jrk2, _, jcount2 = (np.asarray(a) for a in _jfull_round(
        jnp.asarray(jrk), jnp.int32(6)))
    np.testing.assert_array_equal(rk.numpy(), jrk2)
    assert count == int(jcount2)


@pytest.mark.parametrize('case', ['words5', 'wide6', 'short', 'repeat',
                                  'one', 'nul'])
def test_full_doubling_matches_jax_and_numpy(case):
    data = FULL_CASES[case]()
    padded, n = _bytes_row(data), data.size
    sa = tsa.sa_full_doubling(torch.from_numpy(padded), n)
    jsa = np.asarray(_jfull(jnp.asarray(padded), jnp.int32(n)))
    np.testing.assert_array_equal(sa.numpy()[N - n:], jsa[N - n:])
    np.testing.assert_array_equal(sa.numpy()[N - n:],
                                  tsa.suffix_array_numpy(data))
    assert torch.equal(sa, tsa.sa_full_doubling_plain(
        torch.from_numpy(padded), n))


@pytest.mark.parametrize('n, k', [(1, 1), (7, 2), (100, 3), (1000, 50),
                                  (2000, 1 << 20), (500, 1 << 30)])
def test_int_doubling_matches_jax_and_native(n, k):
    vals = np.random.default_rng(n).integers(0, k, size=n, dtype=np.int32)
    if k == 1 << 30:
        vals[::7] = k - 1  # the widest first-round key: W = 31
    got = tsa.suffix_array_int_torch(vals, device='cpu')
    np.testing.assert_array_equal(got, _suffix_array_int_jax(vals))
    if k <= 1 << 20:  # the native SA-IS refuses a 2^30 alphabet
        np.testing.assert_array_equal(got, tsa.suffix_array_int(vals, k,
                                                                'native'))
    np.testing.assert_array_equal(got, tsa.suffix_array_int(vals, k,
                                                            'numpy'))
    np.testing.assert_array_equal(got, sorted(range(n), key=lambda i: list(
        vals[i:])))


@pytest.mark.parametrize('algorithm', ['segmented', 'full'])
@pytest.mark.parametrize('case', ['words5', 'nul', 'repeat', 'one'])
def test_suffix_array_torch_matches_jax(algorithm, case):
    data = FULL_CASES[case]()
    before = dict(kernels.LAUNCHES)
    got = tsa.suffix_array_torch(data, device='cpu', algorithm=algorithm)
    np.testing.assert_array_equal(
        got, suffix_array_jax(data, algorithm=algorithm))
    np.testing.assert_array_equal(got, tsa.suffix_array_numpy(data))
    assert kernels.LAUNCHES == before


def test_device_builders_argument_errors():
    data = np.frombuffer(b'banana', dtype=np.uint8)
    with pytest.raises(ValueError, match='unknown SA algorithm'):
        tsa.suffix_array_torch(data, device='cpu', algorithm='x')
    assert tsa.suffix_array_torch(data[:0], device='cpu').size == 0
    with pytest.raises(ValueError, match='unknown suffix-array backend'):
        tsa.build_suffix_array(data, backend='jax')
    np.testing.assert_array_equal(
        tsa.build_suffix_array(data, backend='numpy'),
        tsa.build_suffix_array(data, backend='native'))
    with pytest.raises(ValueError, match='full round'):
        tsa.sa_full_round(torch.zeros(8, dtype=torch.int32),
                          torch.zeros(8, dtype=torch.int32), 1, 3)


def test_torch_backend_never_builds_on_the_host(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    data = np.zeros(1 << 17, dtype=np.uint8)
    with pytest.raises(RuntimeError, match='CUDA'):
        tsa.build_suffix_array(data, backend='torch')
    with pytest.raises(RuntimeError, match='CUDA'):
        tsa.suffix_array_int(np.arange(9, dtype=np.int32), backend='torch')


def test_auto_backend_follows_the_jax_rule(monkeypatch):
    """'auto' builds on the card for chunks of at least 64 KiB when CUDA is
    available, and with native SA-IS otherwise, as the JAX ``auto`` does on
    a co-located accelerator and on a CPU backend."""
    calls = []

    def on_card(data, **kw):
        calls.append(data.size)
        return tsa.suffix_array_numpy(data)

    monkeypatch.setattr(tsa, 'suffix_array_torch', on_card)
    big = np.random.default_rng(0).integers(97, 100, size=tsa.DEVICE_MIN_N,
                                            dtype=np.uint8)
    small = big[: tsa.DEVICE_MIN_N - 1]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    tsa.build_suffix_array(big)
    assert calls == []
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    np.testing.assert_array_equal(tsa.build_suffix_array(small),
                                  tsa.suffix_array_numpy(small))
    assert calls == []
    np.testing.assert_array_equal(tsa.build_suffix_array(big),
                                  tsa.suffix_array_numpy(big))
    assert calls == [big.size]


def test_suffix_array_int_validation_as_jax():
    for bad, k, msg in ((np.array([-1], dtype=np.int32), None,
                         'non-negative'),
                        (np.array([5], dtype=np.int32), 5, 'out of range'),
                        (np.array([5], dtype=np.int32), (1 << 30) + 1,
                         'too large')):
        with pytest.raises(ValueError, match=msg):
            tsa.suffix_array_int(bad, k)
        with pytest.raises(ValueError, match=msg):
            jsuffix_array_int(bad, k)
    assert tsa.suffix_array_int(np.empty(0, dtype=np.int32)).size == 0
    assert tsa.suffix_array_int(np.empty(0, dtype=np.int32),
                                backend='torch').size == 0


def test_launch_counts_survive_threads():
    """The Writer builds from a thread pool, so launch counts are added
    under a lock: no update is lost with more threads than cores and a
    short switch interval."""
    before = kernels.LAUNCHES['sa_full_round']
    per, workers = 5000, 32
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            kernels.count_launch('sa_full_round') for _ in range(per)])
            for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernels.LAUNCHES['sa_full_round'] - before == per * workers
    kernels.LAUNCHES['sa_full_round'] = before


def test_concurrent_device_builds_are_right():
    """Writer workers share the module lock around the device part; on the
    CPU device the plain versions run, and every result is the SA."""
    rng = np.random.default_rng(8)
    datas = [rng.integers(0, 4, size=2000 + 37 * i).astype(np.uint8)
             for i in range(12)]
    out = [None] * len(datas)

    def build(i):
        out[i] = tsa.suffix_array_torch(
            datas[i], device='cpu', algorithm=('full', 'segmented')[i % 2])

    threads = [threading.Thread(target=build, args=(i,))
               for i in range(len(datas))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for d, sa in zip(datas, out):
        np.testing.assert_array_equal(sa, tsa.suffix_array_numpy(d))
