"""The port's big-row derive on the CPU against the JAX package: B10, the
rotating windowed doubler (its 3-byte init, one pass, the whole doubler and
its ``poisoned`` flag), ``derive_sa``'s route past ``SEGMENTED_MAX_N``, the
B9 fallback of a poisoned row through ``DeviceIndex``, ``ShardedIndex`` and
``Reader``, and B16's plain scatter.  The plain versions run here; inputs
are made with numpy from seeds, and integers compare exactly.

The JAX sorts are unstable and the port's stable, so inside a tie group the
``sa`` of one init or one pass may differ; ``rank``, ``gs``, the flags and
the finished SA may not.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
from pysubstringsearch_tpu.container import Chunk as JChunk
from pysubstringsearch_tpu.models.index import DeviceIndex as JIndex
from pysubstringsearch_tpu.ops import search as jsearch
from pysubstringsearch_tpu.ops.suffix_array import (
    _SEG_DIV,
    _init_round_anchored3,
    _rotating_pass,
    segmented_rotating_sa as jsegmented_rotating_sa,
)
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu_torch import sort_bench
from pysubstringsearch_tpu_torch.container import Chunk
from pysubstringsearch_tpu_torch.models.index import DeviceIndex
from pysubstringsearch_tpu_torch.ops import kernels
from pysubstringsearch_tpu_torch.ops import suffix_array as tsa
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN, pack_patterns
from pysubstringsearch_tpu_torch.parallel.reader import ShardedIndex

torch.set_num_threads(1)

_jinit3 = jax.jit(_init_round_anchored3)
_jpass = jax.jit(_rotating_pass, static_argnums=(1, 2, 3))


def _padded(data: np.ndarray, N: int) -> np.ndarray:
    out = np.zeros(N, dtype=np.uint8)
    out[: data.size] = data
    return out


def _within_groups(sa: np.ndarray, gs: np.ndarray) -> np.ndarray:
    """sa with each tie group's members sorted: the order-free content."""
    return sa[np.lexsort((sa, gs))]


def _random(n: int, sigma, seed: int) -> np.ndarray:
    """n bytes over an alphabet of ``sigma``: 97.. for a small one, every
    byte (NUL included) for 256; or a NUL-bearing row by name
    (``NUL_ROWS``)."""
    if isinstance(sigma, str):
        return NUL_ROWS[sigma](n, seed)
    rng = np.random.default_rng(seed)
    lo = 0 if sigma == 256 else 97
    return rng.integers(lo, lo + sigma, size=n).astype(np.uint8)


def _utf16_text(n: int, seed: int) -> np.ndarray:
    """n bytes of UTF-16LE lines of printable words: every second byte NUL,
    as a digit-kind row; odd n ends on a character's low byte."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 7, size=40)]
    text = b''.join(b' '.join(words[i] for i in rng.integers(0, 40, size=5))
                    + b'\n' for _ in range(n // 8 + 1))
    return np.frombuffer(text.decode().encode('utf-16-le')[:n],
                         np.uint8).copy()


def _nul_tail(n: int, seed: int) -> np.ndarray:
    """Random bytes whose last quarter is NUL: real 0x00 suffixes right
    before the pad slots, which the init must order before them."""
    data = np.random.default_rng(seed).integers(0, 256, size=n)
    data[n - n // 4:] = 0
    return data.astype(np.uint8)


#: NUL-bearing rows for the 3-byte init: a real 0x00 digit is 1, a pad
#: slot's 0, so real NUL runs sort after the pads that share their prefix.
NUL_ROWS = {
    'utf16': _utf16_text,
    'nul_tail': _nul_tail,
    'nul_runs': lambda n, seed: np.where(
        np.random.default_rng(seed).random(n) < 0.7, 0,
        np.random.default_rng(seed + 1).integers(1, 4, size=n)
    ).astype(np.uint8),
    'all_nul': lambda n, seed: np.zeros(n, np.uint8),
}


def _words(n: int, seed: int) -> np.ndarray:
    """Words of a 20-word vocabulary with NUL and newline between some, so
    groups stay tied for several rounds."""
    rng = np.random.default_rng(seed)
    vocab = [bytes(rng.integers(97, 104, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 7, size=20)]
    text = b' '.join(vocab[i] + (b'\x00' if i % 7 == 0 else b'')
                     for i in rng.integers(0, 20, size=n))
    return np.frombuffer(text[:n], dtype=np.uint8).copy()


def _group_row(members: int, n: int = 4000) -> np.ndarray:
    """n random bytes in which one 6-byte prefix starts ``members``
    suffixes, so that at N = 4096 (S / 2 = 256) the largest k = 6 group
    has exactly ``members`` members."""
    rng = np.random.default_rng(members)
    data = rng.integers(1, 200, size=n).astype(np.uint8)
    plant = np.frombuffer(b'\xfa\xfb\xfc\xfd\xfe\xff', dtype=np.uint8)
    for p in np.arange(members) * (n // members):
        data[p: p + 6] = plant
    return data


@pytest.mark.parametrize('n, sigma', [(1, 2), (7, 4), (1000, 26),
                                      (3000, 256), (4096, 2), (65536, 26),
                                      (3001, 'utf16'), (4096, 'utf16'),
                                      (3000, 'nul_tail'), (2500, 'nul_runs'),
                                      (1, 'all_nul'), (3000, 'all_nul'),
                                      (4096, 'all_nul')])
def test_init3_matches_jax(n, sigma):
    data = _random(n, sigma, n)
    N = tsa._pad_len(n)
    padded = _padded(data, N)
    sa, rk, gs = tsa.sa_init3_bytes(torch.from_numpy(padded), n)
    psa, prk, pgs = tsa.sa_init3_bytes_plain(torch.from_numpy(padded), n)
    assert all(torch.equal(a, b) for a, b in ((sa, psa), (rk, prk),
                                              (gs, pgs)))
    jsa, jrk, jgs = (np.asarray(a) for a in _jinit3(jnp.asarray(padded),
                                                    jnp.int32(n)))
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    npad = N - n
    np.testing.assert_array_equal(sa.numpy()[:npad], jsa[:npad])
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))


def _pass_against_jax(sa, rk, gs, k, off, poisoned, N):
    """One plain pass and one JAX ``_rotating_pass`` from the same state,
    compared; returns the pass's (k, off, poisoned, m_w)."""
    S = max(N // _SEG_DIV, 8)
    _, W = tsa._rotating_sizes(N)
    state = (jnp.int32(k), jnp.int32(off), jnp.bool_(poisoned),
             jnp.asarray(sa.numpy()), jnp.asarray(rk.numpy()),
             jnp.asarray(gs.numpy()))
    jk, joff, jpois, jsa, jrk, jgs = (np.asarray(a) for a in _jpass(
        state, N, S, W))
    out = tsa.sa_rotating_pass_plain(sa, rk, gs, k, off, poisoned)
    assert out[:3] == (int(jk), int(joff), bool(jpois))
    np.testing.assert_array_equal(rk.numpy(), jrk)
    np.testing.assert_array_equal(gs.numpy(), jgs)
    np.testing.assert_array_equal(_within_groups(sa.numpy(), jgs),
                                  _within_groups(jsa, jgs))
    return out


PASS_CASES = {
    'words': lambda: _words(4000, 1),
    'period2': lambda: np.frombuffer(b'ab' * 1500, np.uint8),
    'one_byte': lambda: np.frombuffer(b'a' * 3000, np.uint8),
    'small_alphabet': lambda: _random(4000, 3, 2),
    'boundary_257': lambda: _group_row(257),
}


@pytest.mark.parametrize('case', list(PASS_CASES))
def test_rotating_pass_matches_jax(case):
    """Pass after pass from the port's own state, each against one JAX
    ``_rotating_pass`` from that same state: k, off, poisoned, rank and gs
    equal, and sa equal as sets within each group."""
    data = PASS_CASES[case]()
    n, N = data.size, 4096
    half, W = tsa._rotating_sizes(N)
    S = max(N // _SEG_DIV, 8)
    assert (half, W) == (S // 2, max(S // 2, 4))
    sa, rk, gs = tsa.sa_init_bytes_plain(torch.from_numpy(_padded(data, N)),
                                         n)
    k, off, poisoned = 6, 0, False
    offsets = set()
    for _ in range(12):
        if not bool(tsa._tied_plain(gs).any()):
            break
        k, off, poisoned, m = _pass_against_jax(sa, rk, gs, k, off, poisoned,
                                                N)
        assert 0 <= m <= S
        offsets.add(off)
    if case in ('one_byte', 'period2', 'boundary_257'):
        assert poisoned
    else:
        assert not poisoned and len(offsets) > 1  # mid-round windows


SPAN_CASES = {
    # n = N, so no pad slots: late windows' spans [off, off + W + S / 2)
    # run past the row's end.
    'span_past_end_words': lambda: _words(4096, 6),
    'span_past_end_small': lambda: _random(4096, 3, 7),
    # n well below N: the first window holds only the pad singletons, so it
    # marks nothing (m_w = 0) and jumps.
    'empty_window_words': lambda: _words(3000, 8),
    'empty_window_small': lambda: _random(2500, 3, 9),
}


@pytest.mark.parametrize('case', list(SPAN_CASES))
def test_rotating_pass_span_edges(case):
    """Passes whose window span crosses the row's end, or whose window
    marks nothing, against the JAX pass from the same state; the span
    flags of the plain scan are the whole-row selection cut to the span."""
    data = SPAN_CASES[case]()
    n, N = data.size, 4096
    half, W = tsa._rotating_sizes(N)
    L = tsa._window_span(N)
    assert L == W + half < N
    sa, rk, gs = tsa.sa_init_bytes_plain(torch.from_numpy(_padded(data, N)),
                                         n)
    k, off, poisoned = 6, 0, False
    seen = set()
    for _ in range(40):
        if poisoned or not bool(tsa._tied_plain(gs).any()) or k >= N:
            break
        ctl = tsa._new_ctl(N, off, 'cpu')
        flags, dest = tsa._window_bufs(N, 'cpu')
        tsa.sa_window_scan_plain(gs, ctl, flags, dest, half, W)
        mask = tsa._span_mask(flags, off, N)
        assert not bool(mask[:off].any()) and not bool(
            mask[min(N, off + L):].any())
        assert int(dest[-1]) == int(mask.sum()) == int(ctl[1])
        start = off
        k, off, poisoned, m = _pass_against_jax(sa, rk, gs, k, off,
                                                poisoned, N)
        assert m == int(ctl[1])
        if start + L > N and m > 0:
            seen.add('span_past_end')
        if m == 0:
            seen.add('empty_window')
    want = case.rsplit('_', 1)[0]
    assert want in seen, seen


def _oracle_cases():
    """The cases of the JAX package's own rotating test, the adversarial
    rows, and rows whose largest k = 6 group has S / 2 and S / 2 + 1
    members."""
    rng = np.random.default_rng(5)
    cases = {f'n{n}_s{s}': rng.integers(0, s, size=int(n)).astype(np.uint8)
             for n, s in ((1, 2), (7, 3), (100, 4), (1000, 26), (5000, 2),
                          (20000, 256), (65536, 27))}
    cases['one_byte'] = np.frombuffer(b'a' * 3000, np.uint8)
    cases['two_symbols'] = np.frombuffer(b'ab' * 2000 + b'b', np.uint8)
    cases['group_256'] = _group_row(256)
    cases['group_257'] = _group_row(257)
    cases['words'] = _words(30000, 3)
    return cases


ORACLE = _oracle_cases()


@pytest.mark.parametrize('case', list(ORACLE))
def test_segmented_rotating_sa_matches_jax(case):
    data = ORACLE[case]
    n = data.size
    N = tsa._pad_len(n)
    padded = _padded(data, N)
    sa, poisoned, ties = tsa.segmented_rotating_sa_plain(
        torch.from_numpy(padded), n)
    jsa, jpoisoned = jsegmented_rotating_sa(jnp.asarray(padded),
                                            jnp.int32(n))
    assert poisoned == jpoisoned
    if case in ('one_byte', 'two_symbols', 'group_257'):
        assert poisoned
    if case == 'group_256':
        assert not poisoned  # exactly S / 2 members fit a window
    if poisoned:
        return
    np.testing.assert_array_equal(sa.numpy(), np.asarray(jsa))
    np.testing.assert_array_equal(sa.numpy()[N - n:],
                                  tsa.suffix_array_numpy(data))
    half, W = tsa._rotating_sizes(N)
    assert all(0 < len(r) and all(0 <= m < 2 * half for m in r)
               for r in ties)
    if case == 'words':
        assert len(ties) >= 3 and max(map(len, ties)) > 1


def test_rotating_arguments():
    text = torch.zeros(16, dtype=torch.uint8)
    with pytest.raises(ValueError, match='0 <= n <= N'):
        tsa.segmented_rotating_sa(text, 17)
    with pytest.raises(ValueError, match='0 <= n <= N'):
        tsa.sa_init3_bytes(text, -1)
    sa, poisoned, ties = tsa.segmented_rotating_sa(text, 0)
    assert sa.tolist() == list(range(15, -1, -1)) and not poisoned
    assert ties == []


def _ranked_row(data: np.ndarray):
    pres = np.bincount(data, minlength=256)[:256] > 0
    from pysubstringsearch_tpu_torch.ops import search as tsearch

    rank, sigma = tsearch.alphabet_rank(pres)
    return torch.from_numpy(rank), tsearch.ranked_bits(sigma)


def test_derive_sa_routes_past_the_threshold(monkeypatch):
    """Past SEGMENTED_MAX_N, derive_sa takes B10 whatever the alphabet
    (rank and bits ignored, as in the JAX derive_sa): the SA of the JAX
    rotating doubler rolled to the front; below it, B1 and B2."""
    data = _words(3000, 4)
    data = np.where(data == 0, 32, data).astype(np.uint8)  # a ranked row
    n = data.size
    N = tsa._pad_len(n + PAD_MARGIN)
    text = torch.from_numpy(_padded(data, N))
    rank, bits = _ranked_row(data)
    low, low_ties, low_pois = tsa.derive_sa(text, n, rank, bits)
    assert all(isinstance(m, int) for m in low_ties) and not low_pois
    monkeypatch.setattr(tsa, 'SEGMENTED_MAX_N', N - 1)
    for fn in (tsa.derive_sa, tsa.derive_sa_plain):
        sa, ties, poisoned = fn(text, n, rank, bits)
        assert not poisoned and ties and all(isinstance(r, list)
                                             for r in ties)
        jsa, _ = jsegmented_rotating_sa(jnp.asarray(text.numpy()),
                                        jnp.int32(n))
        np.testing.assert_array_equal(sa.numpy(),
                                      np.roll(np.asarray(jsa), n - N))
        assert torch.equal(sa, low)
    full = tsa.derive_sa_full(text, n)
    np.testing.assert_array_equal(full[:n].numpy(),
                                  tsa.suffix_array_numpy(data))


def _poison_chunks(cls=Chunk):
    """A chunk whose one 6-byte group outgrows B10's windows (the JAX
    package's own fallback test row) and a natural one."""
    bad = np.frombuffer(b'aaaaaaab' * 400 + b'\n', np.uint8)
    good = np.frombuffer(b'\n'.join(b'line %d of words' % i
                                    for i in range(200)) + b'\n', np.uint8)
    return [cls(data=d, suffix_array=tsa.suffix_array_numpy(d))
            for d in (bad, good)]


def test_poisoned_row_falls_back_to_b9(monkeypatch):
    """With the threshold lowered, a poisoning row in a derive index on the
    CPU takes the B9 fallback (recorded per row), its SA is the oracle's,
    and the probe equals the JAX derive index's."""
    calls = []
    real = tsa.derive_sa_full

    def spy(text, n, out=None):
        calls.append(n)
        return real(text, n, out)

    monkeypatch.setattr(tsa, 'SEGMENTED_MAX_N', 1024)
    from pysubstringsearch_tpu_torch.models import index as tindex
    monkeypatch.setattr(tindex, 'derive_sa_full', spy)
    chunks = _poison_chunks()
    before = dict(kernels.LAUNCHES)
    idx = DeviceIndex(chunks, device='cpu', mode='derive', merge=False)
    assert kernels.LAUNCHES == before
    assert idx.sa_poisoned == [True, False]
    assert calls == [chunks[0].data.size]
    # The natural row took B10: its ties are passes' m_w by round.
    assert idx.sa_ties[1] and all(isinstance(r, list) and r
                                  for r in idx.sa_ties[1])
    for r, c in enumerate(chunks):
        np.testing.assert_array_equal(idx.sa[r, : c.data.size].numpy(),
                                      c.suffix_array)
    j = JIndex(_poison_chunks(JChunk), mode='derive', merge=False)
    packed, lengths = pack_patterns([b'aaa', b'ab', b'b', b'aaaaaaaa',
                                     b'line 1', b'words\n', b'zz', b''])
    lo_t, cnt_t = idx.probe(packed, lengths)
    lo_j, cnt_j = j.probe(packed, lengths)
    np.testing.assert_array_equal(cnt_t, cnt_j)
    hit = cnt_j > 0
    np.testing.assert_array_equal(lo_t[hit], lo_j[hit])
    # The sharded index builds its parts through the same _build.
    sidx = ShardedIndex(chunks, ['cpu', 'cpu'], mode='derive', merge=False)
    assert sidx.sa_poisoned == [True, False] and len(calls) == 2
    np.testing.assert_array_equal(
        sidx.row_sa(0)[: chunks[0].data.size].numpy(), chunks[0].suffix_array)


def test_reader_poisoned_fallback_matches_jax_reader(monkeypatch, tmp_path):
    """A container whose one chunk poisons B10 answers through the port's
    derive Reader on the CPU, B9 fallback taken, as the JAX Reader does."""
    rng = np.random.default_rng(9)
    words = [bytes(rng.integers(97, 110, size=int(l), dtype=np.uint8))
             for l in rng.integers(3, 8, size=40)]
    lines = [b'a' * 40 for _ in range(150)]
    lines += [b' '.join(words[i] for i in rng.integers(0, 40, size=4))
              for _ in range(300)]
    path = str(tmp_path / 'p.idx')
    with tpss.Writer(path) as w:
        for ln in lines:
            w.add_entry(ln.decode())
    monkeypatch.setattr(tsa, 'SEGMENTED_MAX_N', 1024)
    tr = tpss.Reader(path, device='cpu', index_mode='derive')
    assert tr._index.mode == 'derive' and tr._index.num_chunks == 1
    assert tr._index.sa_poisoned == [True]
    jr = jpss.Reader(path, index_mode='derive')
    pats = ['aaaa', 'a' * 40, 'a' * 41, words[0].decode(), words[3][:2].decode(),
            'zz', '\n', lines[200][2:9].decode()]
    want = [sorted(x) for x in jr._search_batch(
        [p.encode() for p in pats])]
    got = [sorted(x) for x in tr._search_batch([p.encode() for p in pats])]
    assert got == want and len(got[0]) == 150 and got[2] == []
    assert collections.Counter(tr.search_multiple(pats)) == \
        collections.Counter(jr.search_multiple(pats))


def _kind_lines(kind: str, nlines: int, seed: int) -> bytes:
    """Newline-terminated lines of printable words (bytes 33-126): as
    they are for the raw kind (96 distinct bytes, no NUL), as UTF-16LE for
    the digit kind (every second byte NUL)."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(33, 127, size=int(l), dtype=np.uint8))
             for l in rng.integers(2, 8, size=300)]
    body = b''.join(b' '.join(words[i] for i in rng.integers(0, 300, size=6))
                    + b'\n' for _ in range(nlines))
    return body.decode().encode('utf-16-le') if kind == 'digit' else body


def _kind_patterns(kind: str, body: bytes, seed: int):
    """Substrings of ``body`` at random offsets (for the digit kind of
    either parity, so half start with a NUL), a few near misses, and the
    kind's odd patterns: NUL and bytes >= 0x80, which the text never holds
    for the raw kind, and chip_smoke's ``DIGIT_HIGH`` ones for the digit
    kind."""
    rng = np.random.default_rng(seed)
    pats = [body[o: o + int(l)] for o, l in zip(
        rng.integers(0, len(body) - 40, size=80), rng.integers(1, 25, 80))]
    pats += [p[:-1] + b'\x7f' for p in pats[:10] if p]
    if kind == 'digit':
        pats += [b'\x00', b'\n\x00', b'\x80', b'\xff\xfe', b'q\x00\xe9',
                 '\u00e9'.encode('utf-16-le'), b'\x00\xc3\xa9']
    else:
        pats += [b'\x00', pats[0] + b'\x00', b'\x80',
                 pats[1] + '\u00e9'.encode()]
    return pats + [b'', b'\n']


@pytest.mark.parametrize('kind', ['raw', 'digit'])
def test_big_row_reader_of_raw_and_digit_matches_jax_reader(
        kind, monkeypatch, tmp_path):
    """A raw and a digit container written at the Writer's defaults (one
    chunk) through the port's derive Reader on the CPU with
    ``SEGMENTED_MAX_N`` lowered below the row: the row derives through B10
    (``sa_ties`` a list of passes a round, not poisoned), its SA is the
    container's, and the answers equal the JAX derive Reader's."""
    body = _kind_lines(kind, 700, 21)
    src = tmp_path / 'corpus.txt'
    src.write_bytes(body)
    path = str(tmp_path / 'c.idx')
    with tpss.Writer(path) as w:
        w.add_entries_from_file_lines(str(src))
    monkeypatch.setattr(tsa, 'SEGMENTED_MAX_N', 1024)
    tr = tpss.Reader(path, device='cpu', index_mode='derive')
    idx = tr._index
    assert idx.kind == kind and idx.mode == 'derive'
    assert idx.num_chunks == 1 and idx.n_pad > tsa.SEGMENTED_MAX_N
    assert idx.sa_poisoned == [False]
    assert len(idx.sa_ties[0]) > 1 and all(
        isinstance(r, list) and r for r in idx.sa_ties[0])
    chunk = tr._chunks[0]
    np.testing.assert_array_equal(idx.sa[0, : chunk.data.size].numpy(),
                                  chunk.suffix_array)
    jr = jpss.Reader(path, index_mode='derive')
    assert jr._index.kind == kind
    pats = _kind_patterns(kind, body, 22)
    want = [sorted(x) for x in jr._search_batch(pats)]
    got = [sorted(x) for x in tr._search_batch(pats)]
    assert got == want and sum(map(len, got)) > 500
    strs = [p.decode('latin-1') for p in pats[:40]]
    assert collections.Counter(tr.search_multiple(strs)) == \
        collections.Counter(jr.search_multiple(strs))


@pytest.mark.parametrize('case', ['raw', 'digit', 'digit_odd_n'])
def test_derive_sa_of_raw_and_digit_rows_past_the_threshold(case,
                                                            monkeypatch):
    """``derive_sa`` of a raw and a digit row past the lowered
    ``SEGMENTED_MAX_N`` (no rank map: the bytes' own order) equals the JAX
    rotating doubler's SA rolled to the front, kernel route and plain."""
    body = _kind_lines(case.split('_')[0], 400, 23)
    data = np.frombuffer(body[: len(body) - (case == 'digit_odd_n')],
                         np.uint8)
    n = data.size
    N = tsa._pad_len(n + PAD_MARGIN)
    text = torch.from_numpy(_padded(data, N))
    monkeypatch.setattr(tsa, 'SEGMENTED_MAX_N', N - 1)
    jsa, jpoisoned = jsegmented_rotating_sa(jnp.asarray(text.numpy()),
                                            jnp.int32(n))
    assert not jpoisoned
    for fn in (tsa.derive_sa, tsa.derive_sa_plain):
        sa, ties, poisoned = fn(text, n)
        assert not poisoned and ties and all(isinstance(r, list)
                                             for r in ties)
        np.testing.assert_array_equal(sa.numpy(),
                                      np.roll(np.asarray(jsa), n - N))
    np.testing.assert_array_equal(sa[:n].numpy(),
                                  tsa.suffix_array_numpy(data))


_jroll = jsearch._roll_front_jit()


@pytest.mark.parametrize('N', [4096, 4099])
@pytest.mark.parametrize('n', [0, 1, 2, 3, 1000, 'N-3', 'N-2', 'N-1', 'N'])
def test_roll_front_matches_jax(N, n):
    """The derived SA's roll (R) against the JAX ``_roll_front_jit`` at
    n = 0, 1, N - 1 and N and at every (N - n) mod 4, on a row length that
    is a multiple of 4 and one that is not."""
    if isinstance(n, str):
        n = N - int(n[2:] or 0)
    sa_full = np.random.default_rng(N + n).permutation(N).astype(np.int32)
    want = np.asarray(_jroll(jnp.asarray(sa_full), jnp.int32(n)))
    got = tsa.sa_roll_front(torch.from_numpy(sa_full), n)
    np.testing.assert_array_equal(got.numpy(), want)
    out = torch.full((N,), -1, dtype=torch.int32)
    assert tsa.sa_roll_front(torch.from_numpy(sa_full), n, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)


def test_device_budget_counts_the_allocator_cache(monkeypatch):
    """A big-row Reader opened right after the Writer's card build: the
    blocks PyTorch's caching allocator holds for no tensor are this
    process's to reuse, so the limb budget counts them as free."""
    from pysubstringsearch_tpu_torch.models import index as tindex

    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda d: (40 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, 'memory_reserved', lambda d: 30 << 30)
    monkeypatch.setattr(torch.cuda, 'memory_allocated', lambda d: 10 << 30)
    assert tindex._device_budget(torch.device('cuda')) == \
        int((60 << 30) * 0.85)
    assert tindex._device_budget(torch.device('cpu')) == 1 << 62


@pytest.mark.parametrize('n', [8192, 3 * 8192, 1000])
def test_scatter_plain_matches_the_bench_reference(n):
    """B16's plain version (and its wrapper on CPU tensors) against the
    benchmark's own reference, ``jnp.zeros((n,), jnp.int32).at[d].set(v)``,
    on a permutation.  The JAX ``pallas_scatter`` itself never lowered,
    even on the TPU (``benchmarks/pallas_sort_results.json``), so the XLA
    scatter is the reference; n of 1000 is not a multiple of its 8192
    tile, which the port does not need."""
    rng = np.random.default_rng(n)
    values = rng.integers(0, 1 << 30, size=n).astype(np.int32)
    dests = rng.permutation(n).astype(np.int32)
    want = np.asarray(jnp.zeros((n,), jnp.int32).at[jnp.asarray(dests)].set(
        jnp.asarray(values)))
    v, d = torch.from_numpy(values), torch.from_numpy(dests)
    np.testing.assert_array_equal(tsa.scatter_plain(v, d).numpy(), want)
    out = torch.full((n,), -1, dtype=torch.int32)
    assert tsa.scatter(v, d, out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    # The radix sort's store pass: scattering values to their ranks sorts.
    order = np.argsort(values, kind='stable')
    ranks = np.empty(n, np.int32)
    ranks[order] = np.arange(n, dtype=np.int32)
    np.testing.assert_array_equal(
        tsa.scatter(v, torch.from_numpy(ranks)).numpy(), np.sort(values))


@pytest.mark.parametrize('case', ['indices', 'dropped'])
def test_scatter_plain_stores_indices_and_drops_outside_dests(case):
    """B16's wrapper on CPU tensors with no values (each dest takes its
    own index) and with dests outside ``out`` (negative or past its end),
    which are dropped, against ``jnp.asarray(preset).at[d].set(v)`` of the
    kept pairs; the untouched slots keep the preset."""
    rng = np.random.default_rng(len(case))
    preset = np.full(30_011, -7, np.int32)
    dests = rng.choice(preset.size, 12_000, replace=False).astype(np.int64)
    if case == 'dropped':
        dests[::5] = -1 - rng.integers(0, 1 << 30, size=dests[::5].size)
        dests[1::7] = preset.size + rng.integers(0, 50, size=dests[1::7].size)
    keep = (dests >= 0) & (dests < preset.size)
    values = (np.arange(dests.size, dtype=np.int32) if case == 'indices'
              else rng.integers(0, 1 << 30, size=dests.size).astype(np.int32))
    want = np.asarray(jnp.asarray(preset).at[jnp.asarray(dests[keep])].set(
        jnp.asarray(values[keep])))
    out = torch.from_numpy(preset.copy())
    d = torch.from_numpy(dests.astype(np.int32))
    v = None if case == 'indices' else torch.from_numpy(values)
    assert tsa.scatter(v, d, out) is out
    np.testing.assert_array_equal(out.numpy(), want)


@pytest.mark.parametrize('case', ['partial_cover', 'one_bin'])
def test_scatter_matches_the_xla_scatter_on_a_preset_out(case):
    """B16's wrapper on CPU tensors (the specification its kernel is held
    to) against ``jnp.asarray(preset).at[d].set(v)``: a partial cover of a
    larger ``out`` preset to a sentinel, whose untouched slots keep it, and
    every dest in one of B16's bins."""
    rng = np.random.default_rng(len(case))
    R = tsa.SCATTER_BIN_SLOTS
    if case == 'partial_cover':
        preset = np.full(50_003, -7, np.int32)
        dests = rng.choice(preset.size, 20_000, replace=False)
    else:
        preset = np.full(4 * R + 5, -7, np.int32)
        dests = 2 * R + rng.choice(R, 3000, replace=False)
    dests = dests.astype(np.int32)
    values = rng.integers(0, 1 << 30, size=dests.size).astype(np.int32)
    want = np.asarray(jnp.asarray(preset).at[jnp.asarray(dests)].set(
        jnp.asarray(values)))
    out = torch.from_numpy(preset.copy())
    assert tsa.scatter(torch.from_numpy(values), torch.from_numpy(dests),
                       out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    assert (out.numpy() == -7).sum() == preset.size - dests.size


def test_sort_bench_needs_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert sort_bench.main(['12']) != 0
    out = capsys.readouterr()
    assert out.out == '' and 'CUDA' in out.err


def test_sa_bench_needs_a_card(monkeypatch, capsys):
    from pysubstringsearch_tpu_torch import sa_bench

    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert sa_bench.main(['--profile']) == 2
    out = capsys.readouterr()
    assert out.out == '' and 'CUDA' in out.err
