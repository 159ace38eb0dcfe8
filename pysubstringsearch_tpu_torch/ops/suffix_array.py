"""Suffix-array construction on the host.

Two backends, one contract (``uint8[n] -> int32[n]``), with the ordering
of the on-disk container: plain bytewise order where a proper prefix sorts
before any extension.

- ``native``: the C++ SA-IS kernel in ``native/sais.cpp`` (:mod:`.native`);
- ``numpy``: host prefix doubling, the ground truth for tests.

The SA of a string is unique, so both give identical bytes.
"""

from __future__ import annotations

import numpy as np

__all__ = ['build_suffix_array', 'suffix_array_numpy']


def suffix_array_numpy(data: np.ndarray) -> np.ndarray:
    """Prefix-doubling SA on the host; ground truth for the native kernel."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.int32)
    rank = data.astype(np.int64)
    order = np.argsort(rank, kind='stable').astype(np.int64)
    k = 1
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        if k < n:
            rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        r1 = rank[order]
        r2 = rank2[order]
        flags = np.empty(n, dtype=np.int64)
        flags[0] = 0
        flags[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(flags)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        if new_rank_sorted[-1] == n - 1 or k >= n:
            break
        k *= 2
    return order.astype(np.int32)


def _pad_len(n: int) -> int:
    """Padded row length for an n-byte row: a power of two below 16 MiB,
    16 MiB granularity above (the device index's row geometry)."""
    step = 1 << 24
    if n >= step:
        return -(-n // step) * step
    p = 8
    while p < n:
        p *= 2
    return p


def build_suffix_array(data: np.ndarray, backend: str = 'auto') -> np.ndarray:
    """Suffix array of ``data`` (uint8).  ``auto`` is the native SA-IS, or
    numpy where no C++ compiler could build it."""
    data = np.asarray(data, dtype=np.uint8)
    from . import native

    if backend == 'numpy' or (backend == 'auto' and not native.available()):
        return suffix_array_numpy(data)
    if backend in ('native', 'auto'):
        return native.suffix_array_native(data)
    raise ValueError(f'unknown suffix-array backend: {backend!r}')

