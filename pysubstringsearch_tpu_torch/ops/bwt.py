"""Burrows-Wheeler transform and its inverse, as the JAX package's
``ops/bwt.py`` gives them (``libsais_bwt``, ``libsais_unbwt`` and their
``_aux`` forms).

Semantics (libsais'):

- ``bwt(T) -> (U, p)`` where, with ``SA`` the suffix array of ``T`` and
  ``i0`` the slot with ``SA[i0] == 0``: ``U[0] = T[n-1]``; the remaining
  ``n-1`` entries are ``T[SA[i]-1]`` in SA order with slot ``i0`` omitted;
  ``p = i0 + 1`` is the primary index.
- ``unbwt(U, p) -> T`` inverts it.

The forward transform is gathers over the SA: :func:`bwt_from_sa` on the
host, :func:`bwt_from_sa_device` (B13, a CUDA kernel with a plain PyTorch
version beside it) where the SA already lives on the card after a device
build.  :func:`bwt` builds the SA with the port's ``build_suffix_array``
(on the card for a chunk of at least 64 KiB when CUDA is present) and
transforms on the host, as the JAX ``bwt`` does.  The inverse is a
sequential LF-mapping walk on the host: native C++ when available, numpy
otherwise.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from . import kernels
from .suffix_array import build_suffix_array

__all__ = [
    'bwt',
    'unbwt',
    'bwt_aux',
    'unbwt_aux',
    'bwt_from_sa',
    'bwt_from_sa_device',
    'byte_frequencies',
]


def byte_frequencies(data: np.ndarray) -> np.ndarray:
    """int32[256] symbol histogram, the ``freq`` output of every libsais
    entry point."""
    data = np.asarray(data, dtype=np.uint8)
    return np.bincount(data, minlength=256).astype(np.int32)


def bwt_from_sa(data: np.ndarray,
                suffix_array: np.ndarray) -> typing.Tuple[np.ndarray, int]:
    """(U, primary_index) from text and its suffix array (host numpy)."""
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n == 0:
        return np.empty(0, dtype=np.uint8), 0
    if n == 1:
        # libsais: U[0] = T[0], return n.
        return data.copy(), 1
    sa = np.asarray(suffix_array, dtype=np.int64)
    i0 = int(np.nonzero(sa == 0)[0][0])
    vals = data[(sa - 1) % n]  # garbage at i0, dropped below
    u = np.empty(n, dtype=np.uint8)
    u[0] = data[n - 1]
    u[1: i0 + 1] = vals[:i0]
    u[i0 + 1:] = vals[i0 + 1:]
    return u, i0 + 1


def bwt_from_sa_device_plain(text: torch.Tensor, sa: torch.Tensor):
    """Plain version of B13: (uint8 [n] U, int32 0-dim primary index) by
    the JAX program's argmin, gathers and select."""
    n = text.shape[0]
    if n == 0:
        raise ValueError('bwt_from_sa_device: empty text')
    sa64 = sa.long()
    i0 = torch.argmin(sa64)  # SA is a permutation of [0, n)
    vals = text[(sa64 - 1) % n]
    iota = torch.arange(n, device=text.device)
    shifted = vals[torch.where(iota <= i0, iota - 1, iota) % n]
    u = torch.where(iota == 0, text[n - 1], shifted).to(torch.uint8)
    return u, (i0 + 1).to(torch.int32)


def bwt_from_sa_device(text: torch.Tensor, sa: torch.Tensor):
    """B13, the BWT on the SA's device: (uint8 [n] U, int32 0-dim primary
    index tensor) from uint8 [n] text and its int32 [n] SA, a permutation of
    [0, n) (see :func:`bwt_from_sa_device_plain`).  Nothing crosses to the
    host.  Raises for n = 0, as the JAX argmin of an empty array does.
    The kernel gathers into an n-byte scratch, then shifts the slots up to
    the primary index by one byte into U.  Replaces the JAX
    ``bwt_from_sa_device``."""
    n = text.shape[0]
    if not kernels.route(text, sa):
        return bwt_from_sa_device_plain(text, sa)
    kernels.check(text, 'text', torch.uint8, 1)
    kernels.check(sa, 'sa', torch.int32, 1)
    if sa.shape[0] != n:
        raise ValueError('bwt_from_sa_device: text and sa differ in length')
    if n == 0:
        raise ValueError('bwt_from_sa_device: empty text')
    u = torch.empty(n, dtype=torch.uint8, device=text.device)
    primary = torch.zeros((), dtype=torch.int32, device=text.device)
    scratch = torch.empty(n, dtype=torch.uint8, device=text.device)
    with kernels.on(text.device):
        kernels.launch('bwt_from_sa', text.data_ptr(), sa.data_ptr(), n,
                       primary.data_ptr(), u.data_ptr(), scratch.data_ptr())
    return u, primary


def bwt(data: np.ndarray,
        backend: str = 'auto') -> typing.Tuple[np.ndarray, int]:
    """BWT of ``data``; the SA is built with the chosen backend."""
    data = np.asarray(data, dtype=np.uint8)
    if data.size <= 1:
        return bwt_from_sa(data, np.empty(data.size, dtype=np.int32))
    return bwt_from_sa(data, build_suffix_array(data, backend=backend))


def bwt_aux(
    data: np.ndarray, r: int, backend: str = 'auto'
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """BWT with sampled auxiliary indexes (``libsais_bwt_aux``): ``(U, I)``
    with ``U`` as :func:`bwt` and ``I[j] = 1 + (SA slot of the suffix
    starting at j*r)`` for ``j = 0 .. (n-1)//r``; ``I[0]`` is the primary
    index.  ``r`` must be a power of two >= 2.  Each ``I[j]`` seeds an
    independent LF walk of ``r`` output bytes (:func:`unbwt_aux`)."""
    if r < 2 or (r & (r - 1)) != 0:
        raise ValueError('r must be a power of two >= 2')
    data = np.asarray(data, dtype=np.uint8)
    n = data.size
    if n <= 1:
        return data.copy(), np.array([n], dtype=np.int32)
    sa = build_suffix_array(data, backend=backend)
    u, _ = bwt_from_sa(data, sa)
    # slot_of[p] = SA slot holding text position p (inverse permutation).
    sampled = np.arange(0, n, r, dtype=np.int64)
    slot_of = np.empty(n, dtype=np.int64)
    slot_of[sa.astype(np.int64)] = np.arange(n, dtype=np.int64)
    return u, (slot_of[sampled] + 1).astype(np.int32)


def unbwt_aux(u: np.ndarray, r: int, I: np.ndarray) -> np.ndarray:
    """Inverse BWT from sampled indexes (``libsais_unbwt_aux``): the
    samples split the output into ``ceil(n/r)`` blocks, each recovered by
    an independent LF walk of at most ``r`` steps, all advancing together
    as numpy lanes.  ``r == n`` with a single index is :func:`unbwt`."""
    u = np.asarray(u, dtype=np.uint8)
    n = u.size
    I = np.asarray(I, dtype=np.int64)
    if r != n and (r < 2 or (r & (r - 1)) != 0):
        raise ValueError('r must be a power of two >= 2 (or r == n)')
    if n <= 1:
        if I.size == 0 or I[0] != n:
            raise ValueError('inconsistent auxiliary indexes')
        return u.copy()
    nb = (n - 1) // r + 1
    if I.size < nb:
        raise ValueError('not enough auxiliary indexes')
    if np.any(I[:nb] <= 0) or np.any(I[:nb] > n):
        raise ValueError('auxiliary index out of range')
    primary_index = int(I[0])
    lf = _lf_mapping(u)
    # Block j emits out[(j+1)*r - 1 .. j*r] (clipped to n) walking backward
    # from the rotation row of the suffix starting at its end boundary: row
    # I[j+1] for interior blocks, row 0 (the sentinel row) for the block
    # ending at n.
    ends = np.minimum((np.arange(nb, dtype=np.int64) + 1) * r, n)
    p = np.zeros(nb, dtype=np.int64)
    interior = ends < n
    p[interior] = I[(ends[interior] // r)]
    sizes = ends - np.arange(nb, dtype=np.int64) * r
    out = np.empty(n, dtype=np.uint8)
    lanes_all = np.arange(nb, dtype=np.int64)
    for s in range(int(sizes.max())):
        lanes = lanes_all[s < sizes]
        m = p[lanes]
        m = np.where(m < primary_index, m, m - 1)
        out[ends[lanes] - 1 - s] = u[m]
        p[lanes] = lf[m]
    return out


def _lf_mapping(u: np.ndarray) -> np.ndarray:
    """LF map over U-indices (sentinel row excluded); see _unbwt_numpy."""
    counts = np.bincount(u, minlength=256).astype(np.int64)
    starts = np.zeros(256, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    starts += 1
    return starts[u] + _stable_rank(u)


def _unbwt_numpy(u: np.ndarray, primary_index: int) -> np.ndarray:
    """LF-mapping inverse in numpy: the counting vectorized, the walk
    sequential.  libsais' U is the rotation-BWT column of ``T + '$'`` with
    the ``$`` entry at row ``primary_index`` removed; ``LF(j) = C[W[j]] +
    occ(W[j], j)`` with ``C[c] = 1 + #{bytes < c in U}`` (row 0 is the
    sentinel's), and walking LF from row 0 emits T back to front."""
    n = u.size
    lf = _lf_mapping(u)
    out = np.empty(n, dtype=np.uint8)
    p = 0
    for i in range(n - 1, -1, -1):
        m = p if p < primary_index else p - 1
        out[i] = u[m]
        p = int(lf[m])
    return out


def _stable_rank(u: np.ndarray) -> np.ndarray:
    """rank[i] = number of j < i with u[j] == u[i] (vectorized)."""
    order = np.argsort(u, kind='stable')
    ranks_sorted = np.arange(u.size, dtype=np.int64)
    sym_sorted = u[order]
    firsts = np.zeros(u.size, dtype=np.int64)
    change = np.empty(u.size, dtype=bool)
    if u.size:
        change[0] = True
        change[1:] = sym_sorted[1:] != sym_sorted[:-1]
        firsts = np.maximum.accumulate(np.where(change, ranks_sorted, 0))
    rank = np.empty(u.size, dtype=np.int64)
    rank[order] = ranks_sorted - firsts
    return rank


def unbwt(u: np.ndarray, primary_index: int) -> np.ndarray:
    """Inverse BWT: the native C++ walk when it is available, else numpy."""
    u = np.asarray(u, dtype=np.uint8)
    if u.size <= 1:
        return u.copy()
    if not 1 <= primary_index <= u.size:
        raise ValueError('primary index out of range')
    from . import native

    if native.available():
        return native.unbwt_native(u, primary_index)
    return _unbwt_numpy(u, primary_index)
