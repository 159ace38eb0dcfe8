"""The plain reference against a naive scan, and the control (the
reference with its exactness given up) departing from it."""

import numpy as np
import pytest

from portbench import reference


def naive(text: bytes, pattern: bytes):
    lines = text.split(b'\n')[:-1]
    return [i for i, line in enumerate(lines) if pattern in line]


def random_text(rng, nlines, alphabet):
    lines = []
    for _ in range(nlines):
        words = [bytes(rng.choice(alphabet, size=rng.integers(1, 9)))
                 for _ in range(rng.integers(1, 7))]
        lines.append(b' '.join(words))
    return b'\n'.join(lines) + b'\n'


@pytest.mark.parametrize('case', range(6))
def test_reference_equals_naive_scan(case):
    rng = np.random.default_rng(case)
    alphabet = np.frombuffer(b'abc' if case % 2 else b'abcdefgh!~',
                             dtype=np.uint8)
    text = random_text(rng, 300, alphabet)
    data = np.frombuffer(text, dtype=np.uint8).copy()
    newlines = np.flatnonzero(data == ord('\n'))
    pats = []
    for _ in range(120):
        o = int(rng.integers(0, len(text) - 1))
        ln = int(rng.integers(1, 30))
        pats.append(text[o: o + ln].split(b'\n')[0] or b'a')
    pats += [b'zzzz', b'a\0b', b'\0', b'abcabcabcabcabcabc', b'!~' * 9,
             text.split(b'\n')[-2], text.split(b'\n')[0], b' ']
    got = reference.find_lines(data, newlines, pats, device='cpu')
    for p, ids in zip(pats, got):
        assert ids.tolist() == naive(text, p), p


def test_reference_blocks_and_line_strings(monkeypatch):
    """Blocks smaller than the text and the pair expansion in blocks give
    the same answer; line_strings gives the lines without newlines."""
    rng = np.random.default_rng(7)
    text = random_text(rng, 400, np.frombuffer(b'ab', dtype=np.uint8))
    data = np.frombuffer(text, dtype=np.uint8).copy()
    newlines = np.flatnonzero(data == ord('\n'))
    pats = [b'ab', b'a', b'abab', b'b a', b'bbbbbbbbb']
    whole = reference.find_lines(data, newlines, pats, device='cpu')
    monkeypatch.setattr(reference, 'BLOCK', 64)
    blocked = reference.find_lines(data, newlines, pats, device='cpu')
    for a, b, p in zip(whole, blocked, pats):
        assert a.tolist() == b.tolist() == naive(text, p)
    lines = text.split(b'\n')
    ids = whole[0][:20]
    assert reference.line_strings(data, newlines, ids) == [
        lines[i].decode() for i in ids.tolist()]


def test_reference_rejects_newline_patterns():
    data = np.frombuffer(b'ab\ncd\n', dtype=np.uint8).copy()
    with pytest.raises(ValueError):
        reference.find_lines(data, np.array([2, 5]), [b'b\nc'], device='cpu')


def test_control_gives_up_exactness():
    """The control accepts a candidate on its first KEY_BYTES bytes: on
    patterns longer than the key it answers lines that do not hold them."""
    text = b'abcdefgXYZ one\nabcdefgQQQ two\nabcdefg\n'
    data = np.frombuffer(text, dtype=np.uint8).copy()
    newlines = np.flatnonzero(data == ord('\n'))
    pats = [b'abcdefgXYZ', b'abcdefg']
    exact = reference.find_lines(data, newlines, pats, device='cpu')
    control = reference.find_lines(data, newlines, pats, device='cpu',
                                   whole_pattern=False)
    assert exact[0].tolist() == [0] and control[0].tolist() == [0, 1]
    assert exact[1].tolist() == control[1].tolist() == [0, 1, 2]
