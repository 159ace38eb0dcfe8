"""The plain reference: which lines of a corpus hold each pattern.

Plain PyTorch over the corpus bytes that the benchmark made (on the card
when there is one, else on the CPU), and numpy.  It imports nothing of the
program and reads nothing that the program made.

A pattern's answer is the ascending ids of the distinct lines that hold
it, as the upstream's ``search`` gives them for a one-chunk index (every
line once, in whatever order; the comparison sorts).  Candidates are the
positions whose first ``min(len, KEY_BYTES)`` bytes equal the pattern's,
found by a sorted-key search over every position of the text in blocks;
each candidate is then checked against the whole pattern.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

#: Bytes of the window key: 7, so a key stays below 2^56 and sorts the
#: same as a signed int64.
KEY_BYTES = 7
#: Text positions, and candidate pairs, a block handles at once.
BLOCK = 1 << 26


def _keys(windows: torch.Tensor, width: int) -> torch.Tensor:
    if width == KEY_BYTES:
        return windows
    return windows & ((1 << (8 * width)) - 1)


def _windows(text: torch.Tensor) -> torch.Tensor:
    """int64 little-endian windows of KEY_BYTES bytes at every position;
    bytes past the end read as 0."""
    n = text.numel()
    win = torch.zeros(n, dtype=torch.int64, device=text.device)
    for j in range(min(KEY_BYTES, n)):
        win[: n - j] |= text[j:].to(torch.int64) << (8 * j)
    return win


def find_lines(data: np.ndarray, newlines: np.ndarray,
               patterns: typing.Sequence[bytes], *,
               device: typing.Union[str, torch.device, None] = None,
               whole_pattern: bool = True) -> typing.List[np.ndarray]:
    """Per pattern, the ascending ids of the lines of ``data`` (uint8,
    newline-terminated lines; ``newlines`` the newline offsets) that hold
    it.  ``whole_pattern=False`` accepts a candidate on its key alone (the
    first ``KEY_BYTES`` bytes): the control, which gives up exactness."""
    if device is None:
        device = 'cuda' if torch.cuda.is_available() else 'cpu'
    if any(b'\n' in p for p in patterns):
        raise ValueError('the reference answers patterns without newlines')
    out = [np.zeros(0, dtype=np.int64) for _ in patterns]
    live = [i for i, p in enumerate(patterns) if p]
    if not live or data.size == 0:
        return out
    text = torch.from_numpy(np.ascontiguousarray(data)).to(device)
    n = text.numel()
    win = _windows(text)

    # Each pattern as KEY_BYTES-byte pieces with the mask of their bytes;
    # pieces past its end are 0 under a 0 mask, so they always agree.
    pieces = max(-(-len(patterns[i]) // KEY_BYTES) for i in live)
    pkeys = np.zeros((len(patterns), pieces), dtype=np.int64)
    pmask = np.zeros((len(patterns), pieces), dtype=np.int64)
    for i in live:
        p = patterns[i]
        for k in range(0, len(p), KEY_BYTES):
            piece = p[k: k + KEY_BYTES]
            pkeys[i, k // KEY_BYTES] = int.from_bytes(piece, 'little')
            pmask[i, k // KEY_BYTES] = (1 << (8 * len(piece))) - 1
    if not whole_pattern:
        pkeys[:, 1:] = 0
        pmask[:, 1:] = 0
    pkeys_d = torch.from_numpy(pkeys).to(device)
    pmask_d = torch.from_numpy(pmask).to(device)
    plen_d = torch.tensor([len(p) for p in patterns], dtype=torch.int64,
                          device=device)

    # Key classes by the width of the first piece; in each, the sorted
    # distinct keys and the patterns behind each key.
    classes: typing.Dict[int, typing.Dict[int, typing.List[int]]] = {}
    for i in live:
        width = min(len(patterns[i]), KEY_BYTES)
        classes.setdefault(width, {}).setdefault(
            int(pkeys[i, 0]), []).append(i)

    found_pos, found_pat = [], []
    for width, by_key in sorted(classes.items()):
        keys = torch.tensor(sorted(by_key), dtype=torch.int64, device=device)
        members = [by_key[k] for k in sorted(by_key)]
        counts = torch.tensor([len(m) for m in members], dtype=torch.int64,
                              device=device)
        flat = torch.tensor([i for m in members for i in m],
                            dtype=torch.int64, device=device)
        firsts = torch.cumsum(counts, 0) - counts
        for start in range(0, n, BLOCK):
            stop = min(start + BLOCK, n)
            masked = _keys(win[start:stop], width)
            idx = torch.searchsorted(keys, masked)
            idx.clamp_(max=keys.numel() - 1)
            hit = keys[idx] == masked
            del masked
            pos = torch.nonzero(hit).flatten()
            kid = idx[pos]
            del idx, hit
            pos += start
            # Every pattern behind a candidate's key, then the whole
            # pattern held against the text, piece by piece.
            rep = counts[kid]
            ends = torch.cumsum(rep, 0)
            total = int(ends[-1]) if rep.numel() else 0
            for lo in range(0, total, BLOCK):
                hi = min(lo + BLOCK, total)
                t = torch.arange(lo, hi, dtype=torch.int64, device=device)
                c = torch.searchsorted(ends, t, right=True)
                pat = flat[firsts[kid[c]] + t - (ends[c] - rep[c])]
                p = pos[c]
                ok = p + plen_d[pat] <= n
                for k in range(pieces):
                    at = torch.clamp(p + k * KEY_BYTES, max=n - 1)
                    ok &= (win[at] & pmask_d[pat, k]) == pkeys_d[pat, k]
                found_pos.append(p[ok])
                found_pat.append(pat[ok])
    del win
    if not found_pos:
        return out
    pos = torch.cat(found_pos)
    pat = torch.cat(found_pat)
    nl = torch.from_numpy(np.ascontiguousarray(newlines,
                                               dtype=np.int64)).to(device)
    line = torch.searchsorted(nl, pos)
    stride = int(newlines.size) + 1
    pairs = torch.unique(pat * stride + line).cpu().numpy()
    pat_of = pairs // stride
    line_of = pairs % stride
    bounds = np.searchsorted(pat_of, np.arange(len(patterns) + 1))
    for i in range(len(patterns)):
        out[i] = line_of[bounds[i]: bounds[i + 1]]
    return out


def line_strings(data: np.ndarray, newlines: np.ndarray,
                 line_ids: np.ndarray) -> typing.List[str]:
    """The lines ``line_ids`` of ``data`` without their newline."""
    ends = newlines[line_ids]
    starts = np.where(line_ids > 0, newlines[np.maximum(line_ids - 1, 0)] + 1,
                      0)
    view = memoryview(data)
    return [bytes(view[s:e]).decode('utf-8', errors='surrogateescape')
            for s, e in zip(starts.tolist(), ends.tolist())]
