"""The corpus and traffic generators: the same seed gives the same inputs,
at the sizes, byte ranges and lengths the files state."""

import numpy as np
import pytest

from portbench import spec
from portbench.corpus import make_corpus
from portbench.traffic import make_pool

SEED = 2**31 + 977  # past 32 signed bits, as the driver's seeds are


def small(config_name, target=200_000):
    config = spec.load('configs', config_name)
    return dict(config['corpus'], target_bytes=target)


@pytest.mark.parametrize('config_name', ['ranked-500mb', 'raw-500mb'])
def test_corpus_is_deterministic_and_shaped(config_name):
    corpus_spec = small(config_name)
    a = make_corpus(corpus_spec, SEED)
    b = make_corpus(corpus_spec, SEED)
    c = make_corpus(corpus_spec, SEED + 1)
    assert np.array_equal(a.data, b.data) and a.words == b.words
    assert not np.array_equal(a.data[:1000], c.data[:1000])
    data = a.data
    # Lines are added until their total reaches the target.
    assert data.size >= corpus_spec['target_bytes']
    assert a.newlines[-2] + 1 < corpus_spec['target_bytes']
    assert data[-1] == ord('\n')
    assert np.array_equal(a.newlines, np.flatnonzero(data == ord('\n')))
    lo, hi = corpus_spec['bytes']
    word_bytes = data[(data != ord('\n')) & (data != ord(' '))]
    assert word_bytes.min() >= lo and word_bytes.max() <= hi
    lines = data.tobytes().split(b'\n')[:-1]
    assert len(lines) == a.newlines.size
    vocab = set(a.words)
    wl_lo, wl_hi = corpus_spec['word_len']
    assert all(wl_lo <= len(w) <= wl_hi for w in a.words)
    assert len(a.words) == corpus_spec['vocabulary']
    for line in lines[:500]:
        words = line.split(b' ')
        assert len(words) == corpus_spec['words_per_line']
        assert all(w in vocab for w in words)


@pytest.mark.parametrize('config_name', ['ranked-500mb', 'raw-500mb'])
def test_corpus_word_lengths_do_not_follow_the_seed(config_name):
    """Two seeds draw vocabularies with the same number of words of each
    length, in other orders and of other bytes."""
    corpus_spec = small(config_name)
    a = make_corpus(corpus_spec, SEED)
    b = make_corpus(corpus_spec, SEED + 1)
    la = [len(w) for w in a.words]
    lb = [len(w) for w in b.words]
    assert sorted(la) == sorted(lb) and la != lb
    lo, hi = corpus_spec['word_len']
    assert set(la) == set(range(lo, hi + 1))
    assert a.words != b.words


def test_corpus_at_full_size_arithmetic():
    """The stated size of the 500 MB configurations: the byte count is the
    first line total at or past 524,288,000 (checked on the lengths
    alone, without making the bytes)."""
    corpus_spec = spec.load('configs', 'ranked-500mb')['corpus']
    assert corpus_spec['target_bytes'] == 500 * 1024 * 1024
    assert spec.load('configs', 'raw-500mb')['corpus']['bytes'] == [33, 126]


@pytest.mark.parametrize('mix_name', ['selective', 'broad'])
def test_pool_is_deterministic_and_shaped(mix_name):
    corpus = make_corpus(small('ranked-500mb'), SEED)
    mix = spec.load('traffic', mix_name)
    mix = dict(mix, pool_cycles=3)
    a = make_pool(mix, corpus, SEED)
    b = make_pool(mix, corpus, SEED)
    c = make_pool(mix, corpus, SEED + 1)
    assert a.batches == b.batches and a.entries == b.entries
    assert a.batches != c.batches
    per_cycle = sum(e['batches'] for e in mix['cycle'])
    assert len(a.batches) == 3 * per_cycle
    # Same sizes for every seed: each entry's batch size and order.
    assert [len(x) for x in a.batches] == [len(x) for x in c.batches]
    text = corpus.data.tobytes()
    lines = set(text.split(b'\n'))
    words = set(corpus.words)
    for batch, k in zip(a.batches, a.entries):
        entry = mix['cycle'][k]
        assert len(batch) == entry['batch']
        src = entry['sources'][0]
        pats = [p.encode('ascii') for p in batch]
        assert all(b'\n' not in p for p in pats)
        if src['kind'] == 'word':
            assert all(p in words for p in pats)
            continue
        lo, hi = src['len']
        assert all(lo <= len(p) <= hi for p in pats)
        nul = [p for p in pats if b'\0' in p]
        assert len(nul) == round(src['nul_share'] * entry['batch'])
        for p in pats[:64]:
            if b'\0' not in p:
                assert p in text
                assert any(p in line for line in lines)


def test_zipf_words_are_skewed():
    corpus = make_corpus(small('ranked-500mb'), SEED)
    mix = dict(spec.load('traffic', 'broad'), pool_cycles=40)
    pool = make_pool(mix, corpus, SEED)
    drawn = [p for b, k in zip(pool.batches, pool.entries) if k == 0
             for p in b]
    _, counts = np.unique(drawn, return_counts=True)
    counts = np.sort(counts)[::-1]
    # Zipf(0.99) over 10,000 words: the top word takes about 10% of the
    # draws, far above a uniform draw's 0.01%.
    assert counts[0] / len(drawn) > 0.05


def test_word_batches_hold_the_same_ranks_for_every_seed():
    """Each batch of words holds one draw of each equal slice of the sorted
    draws, whatever the seed: only the batches' order follows it."""
    from portbench.traffic import word_ranks

    ranks = np.sort(np.random.default_rng(5).zipf(1.5, size=16 * 60))
    by_seed = []
    for seed in (SEED, SEED + 1):
        dealt = word_ranks(ranks, 16, np.random.default_rng(seed))
        batches = dealt.reshape(60, 16)
        assert sorted(dealt.tolist()) == ranks.tolist()
        by_seed.append(sorted(map(tuple, np.sort(batches, axis=1).tolist())))
    assert by_seed[0] == by_seed[1]
    # One draw of each slice: the b-th of every slice of 60.
    assert sorted(map(tuple, by_seed[0])) == sorted(
        tuple(ranks[b::60].tolist()) for b in range(60))


def test_word_batches_answer_the_same_number_of_distinct_words():
    corpus = make_corpus(small('ranked-500mb'), SEED)
    mix = dict(spec.load('traffic', 'broad'), pool_cycles=4)
    counts = []
    for seed in (SEED, SEED + 1, SEED + 2):
        pool = make_pool(mix, corpus, seed)
        counts.append(sorted(len(set(b)) for b, k in
                             zip(pool.batches, pool.entries) if k == 0))
    assert counts[0] == counts[1] == counts[2]
