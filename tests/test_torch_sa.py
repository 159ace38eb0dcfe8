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
    _int_doubling_kernel,
    _init_round_anchored,
    _init_round_anchored_ranked,
    _relabel_and_scatter,
    _segmented_kernel,
    _suffix_array_int_jax,
    _tied_flags,
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


#: B8's output tile on the card: 256 threads x 16 hits.
GATHER_TILE = 4096


@pytest.mark.parametrize('case', ['one_big', 'big_first', 'big_last'])
def test_gather_hits_flat_skewed_matches_jax(case):
    """A skewed batch: one query holding most of the hits, runs of zero
    counts (at the start and the end too), and a total that crosses
    several of the card's output tiles; the port's gather against the JAX
    one."""
    rng = np.random.default_rng(len(case))
    size = 1 << 16
    sa_row = rng.permutation(size).astype(np.int32)
    B = 600
    count = rng.integers(0, 40, size=B).astype(np.int32)
    count[::4] = 0
    count[:7] = 0
    count[-5:] = 0
    count[200:260] = 0
    big = {'one_big': B // 2, 'big_first': 7, 'big_last': B - 6}[case]
    count[big] = 5 * GATHER_TILE + 123
    lower = rng.integers(0, size - 40, size=B).astype(np.int32)
    lower[big] = 1000
    total = int(count.sum())
    assert total > 5 * GATHER_TILE and count[big] > total // 2
    pos, qid = tsearch.gather_hits_flat(
        torch.from_numpy(sa_row), torch.from_numpy(lower),
        torch.from_numpy(count))
    jpos, jqid = jsearch.gather_hits_flat(
        jnp.asarray(sa_row), jnp.asarray(lower), jnp.asarray(count), total)
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


_jint = jax.jit(_int_doubling_kernel)


def _lcp_max(data: np.ndarray) -> int:
    """The longest common prefix of two neighbours in the SA of data."""
    sa, best = tsa.suffix_array_numpy(data), 0
    for s, t in zip(sa[:-1], sa[1:]):
        a, b = data[s:], data[t:]
        m = min(a.size, b.size)
        neq = np.flatnonzero(a[:m] != b[:m])
        best = max(best, int(neq[0]) if neq.size else m)
    return best


def _rounds_needed(data: np.ndarray, k0: int, width: int) -> int:
    """Rounds k = k0, 2 k0, ... below ``width`` until prefixes of 2k
    separate every pair of real suffixes (they part within lcp + 1)."""
    need, rounds, k = _lcp_max(data) + 1, 0, k0
    while k < min(width, need):
        rounds, k = rounds + 1, 2 * k
    return rounds


def _count_rounds(monkeypatch):
    calls = []
    real = tsa._full_key_round_plain

    def spy(*args):
        calls.append(args[2])
        return real(*args)

    monkeypatch.setattr(tsa, '_full_key_round_plain', spy)
    return calls


@pytest.mark.parametrize('padding', ['tight', 'wide'])
@pytest.mark.parametrize('case', ['words5', 'wide6', 'short', 'repeat',
                                  'one', 'nul'])
def test_full_doubling_stops_when_the_text_is_settled(case, padding,
                                                      monkeypatch):
    """B9 stops once the real slots hold distinct ranks and writes the pad
    slots in closed form: slots [N - n, N) equal the JAX loop's and numpy,
    the pads are [N - 1, ..., n], and the rounds are the ones the text
    needs -- fewer than the JAX loop's on words, whose pads tie until k
    passes N, and all of them on ``repeat`` at the tight padding."""
    data = FULL_CASES[case]()
    n = data.size
    # The Writer's padding, or the scale-out rows' (at least 2n).
    width = tsa._pad_len(n + 6) if padding == 'tight' else 2 * N
    padded = np.zeros(width, dtype=np.uint8)
    padded[:n] = data
    calls = _count_rounds(monkeypatch)
    sa = tsa.sa_full_doubling(torch.from_numpy(padded), n).numpy()
    jsa = np.asarray(_jfull(jnp.asarray(padded), jnp.int32(n)))
    np.testing.assert_array_equal(sa[width - n:], jsa[width - n:])
    np.testing.assert_array_equal(sa[width - n:], tsa.suffix_array_numpy(data))
    np.testing.assert_array_equal(sa[:width - n],
                                  np.arange(width - 1, n - 1, -1))
    rounds = len(calls)
    assert rounds == _rounds_needed(data, 6, width)
    jax_rounds = _rounds_needed(np.zeros(width, dtype=np.uint8), 6, width)
    if case == 'words5':
        assert rounds < jax_rounds
    if case == 'repeat' and padding == 'tight':
        assert rounds == jax_rounds
    plain = tsa.sa_full_doubling_plain(torch.from_numpy(padded), n)
    assert torch.equal(torch.from_numpy(sa), plain)


@pytest.mark.parametrize('n, k', [(1, 1), (100, 3), (1000, 50), (1900, 4),
                                  (2000, 1 << 20)])
def test_int_doubling_stops_when_the_values_are_settled(n, k, monkeypatch):
    """B9's integer form at a padding of at least 2n: slots [N - n, N)
    equal ``_int_doubling_kernel`` and numpy, the pads are closed-form, and
    the rounds after the init are the ones the values need."""
    width = 2 * N
    vals = np.random.default_rng(n).integers(0, k, size=n, dtype=np.int32)
    if k == 4:
        vals[n // 2:] = vals[: n - n // 2]  # a long repeat: real ties
    ranks = np.zeros(width, dtype=np.int32)
    ranks[:n] = vals + 1
    calls = _count_rounds(monkeypatch)
    sa = tsa.sa_full_doubling_int(torch.from_numpy(ranks), n).numpy()
    jsa = np.asarray(_jint(jnp.asarray(ranks), jnp.int32(n)))
    want = tsa.suffix_array_int(vals, k, 'numpy')
    np.testing.assert_array_equal(sa[width - n:], jsa[width - n:])
    np.testing.assert_array_equal(sa[width - n:], want)
    np.testing.assert_array_equal(sa[:width - n],
                                  np.arange(width - 1, n - 1, -1))
    assert calls[0] == 1  # the init, the JAX first round at k = 1
    assert len(calls) - 1 == _rounds_needed(vals, 2, width)
    assert torch.equal(torch.from_numpy(sa), tsa.sa_full_doubling_int_plain(
        torch.from_numpy(ranks), n))


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


# ---------------------------------------------------------------------------
# B2's segmented round: the carried tied list, the split into small and
# large groups by T, the large-group ordinal key, and the list refine, as
# plain stages with a small T, against the JAX round and numpy.
# ---------------------------------------------------------------------------

_jtied = jax.jit(_tied_flags)
_jsegmented = jax.jit(_segmented_kernel)

#: A small T for the plain stages, so groups of T - 1 to 2T members stay
#: small rows.
SEG_T = 8


def _state_of_groups(sizes, seed, singles=3):
    """An anchored (sa, rank, gs) over groups of the given sizes, each after
    ``singles`` singleton slots, with a random SA order: any permutation is a
    valid state for one round."""
    rng = np.random.default_rng(seed)
    gs = []
    for size in sizes:
        for _ in range(singles):
            gs.append(len(gs))
        start = len(gs)
        gs.extend([start] * size)
    gs = np.asarray(gs, dtype=np.int32)
    n = gs.size
    sa = rng.permutation(n).astype(np.int32)
    rank = np.empty(n, dtype=np.int32)
    rank[sa] = gs
    return sa, rank, gs


GROUP_CASES = {
    'around_t': [SEG_T - 1, SEG_T, SEG_T + 1, 2 * SEG_T, 2, 3, 5 * SEG_T],
    'whole_row': 'whole',
    'all_pairs': [2] * 40,
}


def _group_case(name, seed=0):
    if GROUP_CASES[name] == 'whole':
        n = 5 * SEG_T + 3
        sa = np.random.default_rng(seed).permutation(n).astype(np.int32)
        return sa, np.zeros(n, np.int32), np.zeros(n, np.int32)
    return _state_of_groups(GROUP_CASES[name], seed,
                            singles=0 if name == 'all_pairs' else 3)


def _jax_round(sa, rk, gs, k):
    """One JAX round body (``_segmented_loop``'s buffer fed to
    ``_relabel_and_scatter``) on numpy state; returns numpy (sa, rank,
    gs)."""
    tied = np.asarray(_jtied(jnp.asarray(gs)))
    slots = np.flatnonzero(tied)
    pos = sa[slots]
    q = pos.astype(np.int64) + k
    r2 = np.where(q < gs.size, rk[np.minimum(q, gs.size - 1)], -1)
    return tuple(np.asarray(a) for a in _jrelabel(
        jnp.asarray(gs[slots]), jnp.asarray(r2.astype(np.int32)),
        jnp.asarray(pos), jnp.asarray(sa), jnp.asarray(rk),
        jnp.asarray(gs)))


@pytest.mark.parametrize('case', list(GROUP_CASES))
@pytest.mark.parametrize('k', [1, 5])
def test_list_refine_matches_jax_relabel(case, k):
    sa, rk, gs = _group_case(case, k)
    jsa, jrk, jgs = _jax_round(sa, rk, gs, k)
    t_sa, t_rk, t_gs = (torch.from_numpy(a.copy()) for a in (sa, rk, gs))
    m, tl = tsa.sa_round_plain(t_sa, t_rk, t_gs, k, None, SEG_T)
    assert m == int(np.asarray(_jtied(jnp.asarray(gs))).sum())
    np.testing.assert_array_equal(t_rk.numpy(), jrk)
    np.testing.assert_array_equal(t_gs.numpy(), jgs)
    np.testing.assert_array_equal(_within_groups(t_sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))
    # The next round's list from this one's equals the next _tied_flags.
    nxt = tsa.tie_list_plain(t_gs, tl)
    np.testing.assert_array_equal(
        nxt.numpy(), np.flatnonzero(np.asarray(_jtied(jnp.asarray(jgs)))))


@pytest.mark.parametrize('case', list(GROUP_CASES))
def test_split_groups_by_t(case):
    sa, rk, gs = _group_case(case)
    t_gs = torch.from_numpy(gs)
    tl = tsa.tie_list_plain(t_gs)
    large = tsa.split_groups_plain(t_gs, tl, SEG_T).numpy()
    g = gs[tl.numpy()]
    sizes = np.bincount(gs, minlength=gs.size)[g]
    np.testing.assert_array_equal(large, sizes > SEG_T)
    if case == 'around_t':
        # T - 1 and T stay small, T + 1, 2T and 5T are large.
        assert sorted(set(sizes[large])) == [SEG_T + 1, 2 * SEG_T,
                                              5 * SEG_T]
    if case == 'all_pairs':
        assert not large.any()


@pytest.mark.parametrize('case', ['around_t', 'whole_row'])
def test_large_ordinal_key_orders_as_group_and_r2(case):
    """The large members' keys, (group start in the large list >> log2 T)
    << W | (r2 + 1), give the same stable order as the (g, r2) keys, on
    fewer bits."""
    sa, rk, gs = _group_case(case, 2)
    t_sa, t_rk, t_gs = (torch.from_numpy(a) for a in (sa, rk, gs))
    tl = tsa.tie_list_plain(t_gs)
    large = tsa.split_groups_plain(t_gs, tl, SEG_T)
    assert large.any()
    k = 3
    key = tsa.large_keys_plain(t_sa, t_rk, t_gs, tl, large, k, SEG_T)
    s = tl.long()[large]
    full = tsa._round_keys(t_sa, t_rk, t_gs, k)[2]
    full = full[torch.isin(torch.nonzero(tsa._tied_plain(t_gs)).flatten(),
                           s)]
    assert torch.equal(torch.sort(key, stable=True)[1],
                       torch.sort(full, stable=True)[1])
    groups = int(large.sum()) // (SEG_T + 1) + 1
    W = tsa._key_width(gs.size)
    assert int(key.max()) < 1 << (W + groups.bit_length())
    with pytest.raises(ValueError, match='power of two'):
        tsa.large_keys_plain(t_sa, t_rk, t_gs, tl, large, k, 6)


TEXT_CASES = {
    'period2': lambda: np.frombuffer(b'ab' * 700, dtype=np.uint8).copy(),
    'one_group': lambda: np.full(900, 120, dtype=np.uint8),
    'words': lambda: _words(6, 3000, letters=3),
    'empty': lambda: np.zeros(0, dtype=np.uint8),
    'one': lambda: np.array([100], dtype=np.uint8),
}


@pytest.mark.parametrize('case', list(TEXT_CASES))
@pytest.mark.parametrize('seg_t', [SEG_T, tsa.SEG_T])
def test_segmented_plain_stages_match_jax_and_numpy(case, seg_t):
    """``segmented_sa_plain`` through the list stages (B1b, then rounds
    from k = 6) against the JAX ``_segmented_kernel`` and numpy."""
    data = TEXT_CASES[case]()
    n = data.size
    padded = np.zeros(N, dtype=np.uint8)
    padded[:n] = data
    sa, ties = tsa.segmented_sa_plain(torch.from_numpy(padded), n,
                                      seg_t=seg_t)
    want = np.asarray(_jsegmented(jnp.asarray(padded), jnp.int32(n)))
    np.testing.assert_array_equal(sa.numpy()[N - n:], want[N - n:])
    np.testing.assert_array_equal(sa.numpy()[N - n:],
                                  tsa.suffix_array_numpy(data))
    if case == 'one_group':
        assert ties[0] == n - 5  # every suffix but the last 5 tied
    if case in ('empty', 'one'):
        assert ties == []


@pytest.mark.parametrize('case', ['period2', 'words', 'one_group'])
def test_carried_list_is_tied_flags_of_each_round(case):
    """Each round's list, taken from the last round's, is exactly
    ``_tied_flags`` of the round's gs."""
    data = TEXT_CASES[case]()
    padded = np.zeros(N, dtype=np.uint8)
    padded[:data.size] = data
    sa, rk, gs = tsa.sa_init_bytes_plain(torch.from_numpy(padded), data.size)
    k, cand, rounds = 6, None, 0
    while k < N:
        want = np.flatnonzero(np.asarray(_jtied(jnp.asarray(gs.numpy()))))
        m, cand = tsa.sa_round_plain(sa, rk, gs, k, cand, SEG_T)
        np.testing.assert_array_equal(cand.numpy(), want)
        if m == 0:
            break
        rounds += 1
        k *= 2
    assert rounds >= 2


def test_tie_group_histogram():
    _, _, gs = _state_of_groups([2, 2, 5, 17, 300, 5000], 0)
    h = tsa.tie_group_histogram(torch.from_numpy(gs))
    assert h == {'2': [2, 4], '3-16': [1, 5], '17-256': [1, 17],
                 '257-4096': [1, 300], '>4096': [1, 5000]}


_jinit_bytes = jax.jit(_init_round_anchored)


def _marker_text(seg_t: int, seed: int) -> np.ndarray:
    """Lowercase text holding seg_t copies of 'XYZD' and seg_t + 1 of 'QRSD'
    (each followed by 6 random lowercase bytes): two top-bits buckets of
    B1b's key (its first 3 bytes and the top bits of the 4th) of exactly
    seg_t and seg_t + 1 members."""
    rng = np.random.default_rng(seed)
    parts = [m + rng.integers(97, 123, size=6, dtype=np.uint8).tobytes()
             for m, c in ((b'XYZD', seg_t), (b'QRSD', seg_t + 1))
             for _ in range(c)]
    rng.shuffle(parts)
    filler = rng.integers(97, 123, size=1500, dtype=np.uint8).tobytes()
    return np.frombuffer(b''.join(parts) + filler, np.uint8).copy()


#: Rows for the hybrid init's stages: (text, ranked or not).
HYBRID_CASES = {
    'words5': lambda: (_words(1, 3000), True),
    'wide6': lambda: (CASES['wide6'](), True),
    'seg_t': lambda: (_marker_text(16, 3), False),
    'one_bucket': lambda: (np.full(2000, 101, np.uint8), False),
    'utf16': lambda: (np.frombuffer(('ab' * 900).encode('utf-16-le'),
                                    np.uint8).copy(), False),
    'raw_words': lambda: (_words(4, 3000, letters=40) + 33, False),
    'empty': lambda: (np.zeros(0, np.uint8), False),
    'one': lambda: (np.array([100], np.uint8), False),
}


@pytest.mark.parametrize('case', list(HYBRID_CASES))
@pytest.mark.parametrize('seg_t', [16, tsa.SEG_T])
def test_hybrid_init_stages_match_jax(case, seg_t):
    """B1 and B1b's hybrid path through its plain stages (the top-bits
    split, the per-class bucket sort, the large ordinal key) against the
    JAX inits: rank and gs exactly, the pad slots exactly, sa within
    groups; and bit for bit the plain full sort of the key."""
    data, ranked = HYBRID_CASES[case]()
    if ranked:
        padded, n, rank, bits = _row(data)
        text = torch.from_numpy(padded)
        key = tsa._ranked_key(text, n, torch.from_numpy(rank), bits)
        key_bits, cut = tsa.RANKED_KEY_BITS, tsa.INIT_CUT_RANKED
        want = (np.asarray(a) for a in _jinit(
            jnp.asarray(padded), jnp.int32(n), jnp.asarray(rank), bits))
    else:
        padded, n = _bytes_row(data), data.size
        text = torch.from_numpy(padded)
        key = tsa._byte_key(text, n)
        key_bits, cut = tsa.BYTE_KEY_BITS, tsa.INIT_CUT_BYTES
        want = (np.asarray(a) for a in _jinit_bytes(jnp.asarray(padded),
                                                    jnp.int32(n)))
    jsa, jrk, jgs = want
    keys_s, order, bs = tsa.bucket_split_plain(key, n, key_bits, cut)
    npad = N - n
    # The pad bucket: the positions past n, first, each a bucket of its own.
    assert torch.equal(order[:npad], torch.arange(n, N))
    starts = min(npad + 1, N)
    assert torch.equal(bs[:starts], torch.arange(starts))
    large = tsa.large_buckets_plain(bs, seg_t)
    sizes = torch.bincount(bs[npad:], minlength=N)[bs[npad:]]
    if case == 'seg_t' and seg_t == 16:
        assert {seg_t, seg_t + 1} <= set(sizes.tolist())
        assert not bool(large[npad:][sizes == seg_t].any())
        assert bool(large[npad:][sizes == seg_t + 1].all())
    if case == 'one_bucket':
        # All but the last 3 suffixes: the top 32 bits are 3 bytes and the
        # top of the 4th.
        assert int(sizes.max()) == n - 3
    if case == 'utf16' and seg_t == 16:
        assert float(large[npad:].float().mean()) > 0.99
    if bool(large.any()):
        lkey = tsa.large_bucket_keys_plain(keys_s, bs, large,
                                           key_bits - cut, seg_t)
        s = torch.nonzero(large).flatten()
        assert torch.equal(torch.sort(lkey, stable=True)[1],
                           torch.sort(keys_s[s], stable=True)[1])
    sa, rk, gs = tsa.bucket_sort_plain(keys_s, order, bs, n, key_bits - cut,
                                       seg_t)
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    np.testing.assert_array_equal(sa.numpy()[:npad], jsa[:npad])
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))
    for a, b in zip((sa, rk, gs), tsa._init_from_key(key, n)):
        assert torch.equal(a, b)


def test_bucket_histogram():
    key = torch.tensor([0, 0, 5 << 10, 5 << 10 | 1, 7 << 10, 9 << 10] +
                       [3 << 10] * 40 + [4 << 10] * 5000, dtype=torch.int64)
    assert tsa.bucket_histogram(key, 20, 10) == {
        '1': [2, 2], '2-32': [1, 2], '33-4096': [1, 40], '>4096': [1, 5000]}


def test_large_bucket_keys_need_a_power_of_two():
    keys_s, _, bs = tsa.bucket_split_plain(torch.arange(1, 9) << 4, 8, 8, 4)
    with pytest.raises(ValueError, match='power of two'):
        tsa.large_bucket_keys_plain(keys_s, bs, bs >= 0, 4, 6)
