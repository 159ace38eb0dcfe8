"""Chunk-parallel build and probe over a mesh of ranks (B14).

The JAX package's ``shard_map`` programs, on ``torch.distributed``:

- :func:`make_sharded_build`: every rank builds the suffix arrays of its
  block of rows (B9, full-sort doubling, a row at a time);
- :func:`make_sharded_probe`: every rank answers the replicated query
  batch against its rows with one B15 launch, and the per-row bounds are
  all-gathered so that every rank holds the whole [C, B, 2];
- :func:`make_full_step`: build, probe, all-gather of the bounds and a sum
  of the per-pattern hit totals over the ranks.

Every program takes the global chunk-major arrays of the JAX package
(``text [C, N_pad] uint8, n [C] int32, sa [C, N_pad] int32``, patterns and
lengths replicated), host arrays or tensors, moves this rank's contiguous
block of rows to its device, and returns what the JAX ``out_specs`` give:
this rank's block (``P(CHUNK_AXIS)``) or the gathered result, the same on
every rank (``P()``).  C must split evenly over the ranks
(:func:`~.mesh.pad_chunk_count`).  ``make_giant_chunk_build``, one row's
build spread over every rank, is not ported yet.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..ops.search import probe_bytes
from ..ops.suffix_array import sa_full_doubling, sa_roll_front
from .mesh import Mesh, all_gather_rows, all_reduce_sum, rank_rows


def build_chunks(text: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Head-aligned SA int32 [C, N] of uint8 [C, N] rows of true lengths
    ``n`` [C], on the rows' device: B9 (:func:`sa_full_doubling`) on each
    row, rolled so that slots [0, n) hold the row's SA, as the JAX
    ``_build_one`` rolls ``_doubling_kernel``'s output.  The JAX version
    runs the full-sort kernel here on purpose (under ``vmap`` the segmented
    kernel's fallback would run both branches), and so does this one."""
    C, N = text.shape
    out = torch.empty((C, N), dtype=torch.int32, device=text.device)
    for r, n_r in enumerate(n.tolist()):
        sa_roll_front(sa_full_doubling(text[r], int(n_r)), int(n_r),
                      out=out[r])
    return out


def _tensor(x) -> torch.Tensor:
    """``x`` as a tensor; a read-only host array (a JAX result, an mmap) is
    copied, since torch cannot wrap one."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _rows(x, mesh: Mesh, dtype: torch.dtype) -> torch.Tensor:
    """This rank's block of the global [C, ...] array ``x``, contiguous on
    the mesh's device."""
    t = _tensor(x)
    return t[rank_rows(t.shape[0], mesh)].to(mesh.device, dtype).contiguous()


def _replicated(x, mesh: Mesh, dtype: torch.dtype) -> torch.Tensor:
    return _tensor(x).to(mesh.device, dtype).contiguous()


def _probe_local(text, n, sa, patterns, lengths) -> torch.Tensor:
    lower, count = probe_bytes(text, n, sa, patterns, lengths)
    return torch.stack([lower, count], dim=-1)  # [C_local, B, 2]


def make_sharded_build(mesh: Mesh) -> typing.Callable:
    """``(text [C, N], n [C]) -> sa [C / world, N]``, this rank's rows'
    head-aligned SAs on its device."""

    def build(text, n):
        return build_chunks(_rows(text, mesh, torch.uint8),
                            _rows(n, mesh, torch.int32))

    return build


def make_sharded_probe(mesh: Mesh, gather: bool = True) -> typing.Callable:
    """``(text, n, sa, patterns, lengths) -> int32 [C, B, 2]`` (lower,
    count), gathered to every rank; with ``gather=False`` this rank's
    [C / world, B, 2] block."""

    def probe(text, n, sa, patterns, lengths):
        out = _probe_local(
            _rows(text, mesh, torch.uint8), _rows(n, mesh, torch.int32),
            _rows(sa, mesh, torch.int32),
            _replicated(patterns, mesh, torch.uint8),
            _replicated(lengths, mesh, torch.int32),
        )
        return all_gather_rows(out, mesh) if gather else out

    return probe


def make_full_step(mesh: Mesh) -> typing.Callable:
    """``(text, n, patterns, lengths) -> (bounds int32 [C, B, 2], totals
    int32 [B])``: build every rank's rows, probe them, all-gather the
    bounds and sum each pattern's hits over all rows and ranks; both
    results are the same on every rank."""

    def step(text, n, patterns, lengths):
        t = _rows(text, mesh, torch.uint8)
        nn = _rows(n, mesh, torch.int32)
        sa = build_chunks(t, nn)
        out = _probe_local(t, nn, sa, _replicated(patterns, mesh, torch.uint8),
                           _replicated(lengths, mesh, torch.int32))
        bounds = all_gather_rows(out, mesh)
        totals = all_reduce_sum(out[..., 1].sum(0).to(torch.int32), mesh)
        return bounds, totals

    return step
