"""The port's public API end to end on the CPU, against the JAX package:
container bytes from both Writers, and result multisets from both Readers
over a multi-chunk container."""

import collections
import threading

import numpy as np
import pytest
import torch

import pysubstringsearch_tpu as jpss
import pysubstringsearch_tpu_torch as tpss
from pysubstringsearch_tpu_torch.ops import native as tnative
from pysubstringsearch_tpu_torch.ops.search import PAD_MARGIN

torch.set_num_threads(1)

CHUNK = 24 << 10


def _corpus_lines(seed: int = 0):
    rng = np.random.default_rng(seed)
    words = [
        bytes(rng.integers(97, 123, size=int(l), dtype=np.uint8))
        for l in rng.integers(3, 10, size=500)
    ]
    lines = []
    for _ in range(5000):
        idx = rng.integers(0, len(words), size=int(rng.integers(2, 9)))
        lines.append(b' '.join(words[i] for i in idx))
    # One line longer than the device margin, so long patterns can hit.
    lines[1234] = b' '.join(words[i % len(words)] for i in range(300))
    assert len(lines[1234]) > PAD_MARGIN + 100
    return lines


@pytest.fixture(scope='module')
def index_pair(tmp_path_factory):
    lines = _corpus_lines()
    d = tmp_path_factory.mktemp('api')
    src = d / 'corpus.txt'
    src.write_bytes(b'\n'.join(lines[100:]) + b'\n')
    paths = {}
    for name, mod in (('jax', jpss), ('torch', tpss)):
        p = str(d / f'{name}.idx')
        w = mod.Writer(p, max_chunk_len=CHUNK)
        for ln in lines[:100]:
            w.add_entry(ln.decode())
        w.add_entries_from_file_lines(str(src))
        w.close()
        paths[name] = p
    return lines, paths


def _patterns(lines):
    rng = np.random.default_rng(3)
    text = b'\n'.join(lines)
    pats = []
    for _ in range(300):
        o = int(rng.integers(0, len(text) - 40))
        pats.append(text[o: o + int(rng.integers(2, 13))])
    pats += [text[o: o + 60] for o in (1000, 50000, 123456)]  # deep
    pats += [lines[7][-3:] + b'\n' + lines[8][:4],  # crosses a newline
             b'\n', b'zzqqzzqq', b'qqq', b'', b'a']
    long_line = lines[1234]
    pats += [long_line[10: 10 + PAD_MARGIN + 50],  # host route
             long_line[5: 5 + PAD_MARGIN + 1] + b'#']  # long miss
    pats += pats[:20]  # duplicates
    return [p.decode() for p in pats]


def test_writers_write_equal_bytes(index_pair):
    _, paths = index_pair
    with open(paths['jax'], 'rb') as f:
        a = f.read()
    with open(paths['torch'], 'rb') as f:
        b = f.read()
    assert len(a) > 4 * CHUNK
    assert a == b


def test_search_multiple_matches_jax_reader(index_pair):
    lines, paths = index_pair
    pats = _patterns(lines)
    jr = jpss.Reader(paths['jax'])
    tr = tpss.Reader(paths['torch'], device='cpu')
    assert tr._index.num_chunks == len(tr._chunks) > 4
    assert tr._index.kind == 'ranked'
    want = [sorted(x) for x in jr._search_batch([p.encode() for p in pats])]
    got = [sorted(x) for x in tr._search_batch([p.encode() for p in pats])]
    assert got == want
    assert sum(map(len, got)) > 1000
    assert collections.Counter(tr.search_multiple(pats)) == \
        collections.Counter(jr.search_multiple(pats))
    for p in ('qqq', lines[42][:6].decode(), ''):
        assert sorted(tr.search(p)) == sorted(jr.search(p))


def test_reader_without_container_extracts_rows(index_pair):
    lines, paths = index_pair
    pats = _patterns(lines)[:80]
    full = tpss.Reader(paths['torch'], device='cpu')
    rows = tpss.Reader.from_chunks(full._chunks, device='cpu')
    assert rows._host_serving is None
    assert collections.Counter(rows.search_multiple(pats)) == \
        collections.Counter(full.search_multiple(pats))


def test_digit_kind_corpus_raises(tmp_path):
    """A corpus with NUL in a wide alphabet (the digit kind) no longer
    raises: its Reader answers as the JAX Reader does."""
    p = str(tmp_path / 'digit.idx')
    w = tpss.Writer(p)
    w.add_entry(bytes(range(0, 256)).decode('latin-1'))
    w.add_entry('abc\x00abd')
    w.close()
    r = tpss.Reader(p, device='cpu')
    jr = jpss.Reader(p)
    pats = ['abc', '\x00', 'c\x00a', 'bc\x00ab', '\x00\x01\x02', '', 'zzz']
    got = [sorted(r.search(x)) for x in pats]
    assert got == [sorted(jr.search(x)) for x in pats]
    assert r._index.kind == 'digit'
    assert got[0] and got[2] and got[3] and got[4] and not got[6]


def test_cuda_reader_needs_cuda(index_pair, monkeypatch):
    _, paths = index_pair
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match='CUDA'):
        tpss.Reader(paths['torch'])


def test_host_serves_while_loading_and_failed_load_raises(index_pair):
    lines, paths = index_pair
    r = tpss.Reader(paths['torch'], device='cpu')
    pats = [lines[3][:5], lines[900][2:9]]
    want = r._search_host_chunks(pats)

    def fail():
        raise MemoryError('device full')

    r._build_device_index = fail
    r._bg_thread = threading.Thread(target=r._bg_load)
    # Load not finished yet: the host path answers.
    assert r._search_batch(pats) == want
    assert not r.device_ready
    r._bg_thread.start()
    r._bg_thread.join(timeout=60)
    assert not r._bg_thread.is_alive()
    assert not r.wait_device_ready()
    with pytest.raises(RuntimeError, match='load failed'):
        r._search_batch(pats)


def test_single_pattern_search_probes_device_index(index_pair):
    lines, paths = index_pair
    jr = jpss.Reader(paths['jax'])
    tr = tpss.Reader(paths['torch'], device='cpu')
    for i, p in enumerate((lines[42][:6].decode(), 'zzqqzzqq')):
        got = tr.search(p)
        assert tr.profiler.counts['probe'] == i + 1
        assert sorted(got) == sorted(jr.search(p))
    assert 'host-serve' not in tr.profiler.counts


@pytest.mark.parametrize('src, tried, load', [
    ('_SAIS_SRC', '_TRIED', '_load'),
    ('_FASTEXT_SRC', '_FASTEXT_TRIED', 'fastext'),
])
def test_missing_native_source_raises(tmp_path, monkeypatch, src, tried,
                                      load):
    monkeypatch.setattr(tnative, src, str(tmp_path / 'gone.cpp'))
    monkeypatch.setattr(tnative, '_LIB', None)
    monkeypatch.setattr(tnative, '_FASTEXT', None)
    monkeypatch.setattr(tnative, tried, False)
    with pytest.raises(FileNotFoundError, match='checkout'):
        getattr(tnative, load)()
