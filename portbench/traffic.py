"""The one traffic generator: a mix file's parameters and the run's seed
give a pool of query batches.

One closed-loop client sends the pool's batches: the next when the last
one has answered.  A mix (``traffic/<mix>.json``) holds

- ``cycle``: the batches of one cycle, in order, as entries of
  ``batches`` (how many in a row), ``batch`` (patterns a batch) and
  ``sources``; the pool is ``pool_cycles`` cycles, and the window goes
  through the pool in order, again from its start when it runs out;
- a source is a kind of pattern with its ``share`` of every batch of its
  entry (rounded, so every batch of every seed holds the same number of
  each kind):

  - ``substring``: ``len`` [lo, hi] bytes, uniform, cut at a uniform
    offset inside one line that is long enough, never across a newline;
    ``nul_share`` of them get one byte, at a uniform position, replaced by
    NUL (no line holds one, so their answer is empty);
  - ``word``: a whole vocabulary word, drawn Zipf(``zipf``) over a seeded
    ranking of the vocabulary.

Every seed draws the same work in another order: the lengths and the
Zipf ranks are drawn at evenly spaced quantiles and shuffled, and the
ranking gives rank r a word of the r-th length in turn, the words held
inside fewest other vocabulary words first, so that how many lines a
rank's word is in does not follow the seed.  A batch of words holds the
same ranks for every seed (one from each of as many equal slices of the
sorted draws as it holds words), so that how many of them are distinct,
and the program answers once, does not follow the seed either; only the
batches' order does.
"""

from __future__ import annotations

import dataclasses
import typing

import numpy as np

from .corpus import Corpus, seed_sequence


@dataclasses.dataclass
class Pool:
    #: The batches, each a list of patterns as ``search_multiple`` takes
    #: them.
    batches: typing.List[typing.List[str]]
    #: Per batch, the UTF-8 byte lengths of its distinct patterns (the
    #: program probes each distinct pattern once).
    distinct_lengths: typing.List[np.ndarray]
    #: Per batch, the index of its ``cycle`` entry.
    entries: typing.List[int]


def _substrings(corpus: Corpus, src, n: int, size: int,
                rng) -> typing.List[bytes]:
    lo, hi = src['len']
    starts = corpus.line_starts
    line_len = corpus.newlines - starts
    lens = rng.permutation(lo + (np.arange(n) * (hi - lo + 1)) // n)
    lines = rng.integers(0, starts.size, size=n)
    short = line_len[lines] < lens
    while short.any():
        lines[short] = rng.integers(0, starts.size, size=int(short.sum()))
        short = line_len[lines] < lens
    offs = starts[lines] + np.floor(
        rng.random(n) * (line_len[lines] - lens + 1)).astype(np.int64)
    view = memoryview(corpus.data)
    pats = [bytes(view[o: o + ln]) for o, ln in zip(offs.tolist(),
                                                   lens.tolist())]
    # The same number of NUL patterns in every batch of `size`.
    per = int(round(src.get('nul_share', 0.0) * size))
    order = np.argsort(rng.random((n // size, size)), axis=1)[:, :per]
    nul = (order + size * np.arange(n // size)[:, None]).ravel()
    for i, frac in zip(nul.tolist(), rng.random(nul.size).tolist()):
        p = bytearray(pats[i])
        p[int(frac * len(p))] = 0
        pats[i] = bytes(p)
    return pats


def _words(corpus: Corpus, src, n: int, size: int,
           rng) -> typing.List[bytes]:
    # The ranking: round robin over the word lengths; within a length, the
    # words that fewer other vocabulary words hold first (a short word
    # inside others is in their lines too), ties in a seeded order.
    lengths = np.array([len(w) for w in corpus.words])
    joined = b'\n'.join(corpus.words)
    inside = np.array([joined.count(w) for w in corpus.words])
    tie = rng.permutation(lengths.size)
    buckets = []
    for ln in np.unique(lengths).tolist():
        members = np.flatnonzero(lengths == ln)
        order = np.lexsort((tie[members], inside[members]))
        buckets.append(list(members[order]))
    ranking = []
    while any(buckets):
        for b in buckets:
            if b:
                ranking.append(int(b.pop(0)))
    weights = 1.0 / np.arange(1, len(ranking) + 1) ** float(src['zipf'])
    cdf = np.cumsum(weights / weights.sum())
    ranks = np.minimum(np.searchsorted(cdf, (np.arange(n) + 0.5) / n),
                       len(ranking) - 1)
    return [corpus.words[ranking[r]]
            for r in word_ranks(ranks, size, rng).tolist()]


def word_ranks(ranks: np.ndarray, size: int, rng) -> np.ndarray:
    """The sorted draws ``ranks`` dealt into batches of ``size``: batch b
    takes the b-th draw of each of ``size`` equal slices, so each batch
    holds the same ranks for every seed; the batches come in a seeded
    order."""
    grid = ranks.reshape(size, -1).T
    return grid[rng.permutation(grid.shape[0])].ravel()


_KINDS = {'substring': _substrings, 'word': _words}


def _entry_batches(entry, count: int, corpus: Corpus, rng
                   ) -> typing.List[typing.List[bytes]]:
    """``count`` batches of one cycle entry."""
    B = int(entry['batch'])
    sizes = [int(round(s['share'] * B)) for s in entry['sources']]
    sizes[-1] = B - sum(sizes[:-1])
    drawn = [_KINDS[src['kind']](corpus, src, size * count, size, rng)
             for src, size in zip(entry['sources'], sizes)]
    out = []
    for b in range(count):
        pats = [p for d, size in zip(drawn, sizes)
                for p in d[b * size: (b + 1) * size]]
        out.append([pats[i] for i in rng.permutation(len(pats)).tolist()])
    return out


def make_pool(mix: typing.Mapping[str, typing.Any], corpus: Corpus,
              seed: int) -> Pool:
    """The pool of ``mix`` over ``corpus`` for ``seed``."""
    if int(corpus.data.max(initial=0)) >= 0x80:
        raise ValueError('patterns are cut from ASCII corpora only')
    rng = np.random.default_rng(seed_sequence(seed, 2))
    cycles = int(mix['pool_cycles'])
    per_entry = [
        iter(_entry_batches(e, int(e['batches']) * cycles, corpus, rng))
        for e in mix['cycle']]
    pool = Pool(batches=[], distinct_lengths=[], entries=[])
    for _ in range(cycles):
        for k, entry in enumerate(mix['cycle']):
            for _ in range(int(entry['batches'])):
                pats = next(per_entry[k])
                pool.batches.append([p.decode('ascii') for p in pats])
                pool.distinct_lengths.append(
                    np.array([len(p) for p in set(pats)], dtype=np.int64))
                pool.entries.append(k)
    return pool
