"""The corpus a configuration names, made from the run's seed with numpy.

A corpus is lines of ``words_per_line`` words drawn uniformly from a
vocabulary of ``vocabulary`` words, separated by one space and ended by a
newline, as the upstream README's 500 MB benchmark corpus is: word lengths
uniform in ``word_len`` (inclusive), word bytes uniform in ``bytes``
(inclusive), lines added until their total reaches ``target_bytes``.
Every seed's vocabulary has the same number of words of each length, in
a seeded order, so that the mean line length, and with it the number of
lines, does not follow the seed.
Every step is vectorised: no Python loop runs over the words of the corpus.
"""

from __future__ import annotations

import dataclasses
import os
import typing
from concurrent.futures import ThreadPoolExecutor

import numpy as np

#: Tokens a block of the byte assembly handles at once (bounds each
#: thread's temporaries to about 50 MB).
_BLOCK_TOKENS = 1 << 22


@dataclasses.dataclass
class Corpus:
    #: The corpus bytes, newline-terminated lines.
    data: np.ndarray
    #: The vocabulary, each word as bytes.
    words: typing.List[bytes]
    #: Offset of every newline in ``data``, ascending.
    newlines: np.ndarray

    @property
    def line_starts(self) -> np.ndarray:
        return np.concatenate(([0], self.newlines[:-1] + 1)).astype(np.int64)


def seed_sequence(seed: int, *stream: int) -> np.random.SeedSequence:
    """The seed sequence of one named stream of a run's seed: any whole
    number, negative or past 64 bits included."""
    return np.random.SeedSequence([seed % (1 << 64), *stream])


def make_corpus(spec: typing.Mapping[str, typing.Any], seed: int) -> Corpus:
    """The corpus of ``spec`` (a configuration's ``corpus`` object) for
    ``seed``: the same seed gives the same bytes."""
    rng = np.random.default_rng(seed_sequence(seed, 1))
    lo_byte, hi_byte = spec['bytes']
    lo_len, hi_len = spec['word_len']
    vocab = int(spec['vocabulary'])
    per_line = int(spec['words_per_line'])
    target = int(spec['target_bytes'])

    word_len = rng.permutation(
        lo_len + (np.arange(vocab) * (hi_len - lo_len + 1)) // vocab)
    # Each vocabulary row: the word, then its separator, then padding.
    table = rng.integers(lo_byte, hi_byte + 1, size=(vocab, hi_len + 1),
                         dtype=np.uint8)
    table[np.arange(vocab), word_len] = ord(' ')
    keep = np.arange(hi_len + 1)[None, :] <= word_len[:, None]
    words = [table[w, : word_len[w]].tobytes() for w in range(vocab)]

    # Draw whole lines until they reach the target.
    mean_line = per_line * (word_len.mean() + 1)
    tokens = np.zeros(0, dtype=np.int32)
    line_ends = np.zeros(0, dtype=np.int64)
    while True:
        more = int(target / mean_line * 1.01) + 64 - tokens.size // per_line
        tokens = np.concatenate(
            (tokens, rng.integers(0, vocab, size=max(more, 64) * per_line,
                                  dtype=np.int32)))
        line_ends = np.cumsum(
            (word_len[tokens] + 1).reshape(-1, per_line).sum(1))
        if line_ends[-1] >= target:
            break
    nlines = int(np.searchsorted(line_ends, target)) + 1
    tokens = tokens[: nlines * per_line]
    line_ends = line_ends[:nlines]

    # Assemble whole lines in blocks, on threads (numpy's gathers release
    # the GIL); each block's bytes start where its first line starts.
    data = np.empty(int(line_ends[-1]), dtype=np.uint8)
    lines_per_block = max(1, _BLOCK_TOKENS // per_line)

    def assemble(first_line: int) -> None:
        last_line = min(first_line + lines_per_block, nlines)
        block = tokens[first_line * per_line: last_line * per_line]
        start = int(line_ends[first_line - 1]) if first_line else 0
        piece = np.take(table, block, axis=0)[np.take(keep, block, axis=0)]
        data[start: start + piece.size] = piece

    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
        for f in [pool.submit(assemble, first)
                  for first in range(0, nlines, lines_per_block)]:
            f.result()
    newlines = line_ends - 1
    data[newlines] = ord('\n')
    return Corpus(data=data, words=words, newlines=newlines)
