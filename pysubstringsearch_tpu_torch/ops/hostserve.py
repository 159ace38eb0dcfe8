"""Persistent native host serving over a mapped container.

The reference answers a query with a rayon fan-out over chunks, each worker
doing two binary searches against the on-disk SA plus memmem line extraction
(src/lib.rs:201-287).  This module is that whole pipeline as THREE flat
native calls over the container mmap, with zero per-call setup:

  1. ``tpuss_probe_multi``    — lower/upper bounds for the full
                                (chunk x pattern) grid (native/sais.cpp);
  2. ``tpuss_extract_spans``  — hits -> deduplicated line spans in global
                                file coordinates;
  3. ``fastext.materialize``  — one str decode + fan-out over the flat
                                file buffer.

All chunk pointer tables are built once at construction (the reference's
SubIndex registration, src/lib.rs:186-195), so a single query's critical
path is two ctypes calls: a miss costs one bisection per chunk and returns
before any extraction state is touched.

This is the serving path while the device index loads in the background,
the path for patterns too long for the device rows, the Reader's
tiny-batch and whole-batch routes, and the extraction backend behind the
device probe of container-chunk rows.
"""

from __future__ import annotations

import os
import typing

import numpy as np

from . import native as native_ops
from ..container import Chunk

__all__ = ['HostServing', 'pack_patterns_host', 'HOST_PROBE_UNIT_S']

#: Wall seconds per (pattern, chunk) cell of a threaded ``tpuss_probe_multi``
#: call: the Reader's routing constant for the host probe.  The default,
#: 0.3303 us, is chip_smoke.py's ``HostServing.probe`` of its ranked line
#: batch (2200 patterns) over the 63 chunks of its ranked container
#: (median of 5), on the host of an NVIDIA H100 80GB HBM3 at 700.00 W
#: (2026-10-18); env ``TPUSS_HOST_PROBE_US`` overrides it, in microseconds.
HOST_PROBE_UNIT_S = float(os.environ.get('TPUSS_HOST_PROBE_US',
                                         '0.3303')) * 1e-6


def pack_patterns_host(
    patterns: typing.Sequence[bytes],
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """Zero-padded [B, stride] uint8 + int32 lengths (host layout — no
    device-window margin, any pattern length)."""
    stride = max(1, max((len(p) for p in patterns), default=1))
    packed = np.zeros((len(patterns), stride), dtype=np.uint8)
    lens = np.zeros(len(patterns), dtype=np.int32)
    for i, p in enumerate(patterns):
        packed[i, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        lens[i] = len(p)
    return packed, lens


class HostServing:
    """Native probe + extraction over one container's mmap'd chunks.

    Its profiler's phases: ``hs-pack`` (:func:`pack_patterns_host` in
    :meth:`search`), ``hs-probe``, ``hs-spans`` and ``hs-fanout``; its
    counter: ``hs-lines``, the (pattern, line) pairs each
    :meth:`fanout` returns."""

    @classmethod
    def maybe(
        cls,
        chunks: typing.Sequence[Chunk],
        buf: typing.Optional[np.ndarray],
        profiler=None,
    ) -> typing.Optional['HostServing']:
        """Instance when the native kernels and a flat file buffer are
        available (every chunk mapped from the same container), else None."""
        lib = native_ops._load()
        if (
            lib is None
            or not hasattr(lib, 'tpuss_probe_multi')
            or buf is None
            or not chunks
            or any(c.text_offset < 0 for c in chunks)
        ):
            return None
        return cls(chunks, buf, profiler)

    def __init__(
        self,
        chunks: typing.Sequence[Chunk],
        buf: np.ndarray,
        profiler=None,
    ) -> None:
        import ctypes

        from ..utils.profiling import PhaseProfiler

        #: Sub-phase timings (``hs-pack``, ``hs-probe``, ``hs-spans``,
        #: ``hs-fanout``) and the counter ``hs-lines`` (the (pattern,
        #: line) pairs the fan-out made) — shared with the owning
        #: Reader's profiler when one is passed.
        self.prof = profiler if profiler is not None else PhaseProfiler()

        self._ct = ctypes
        self._lib = native_ops._load()
        assert self._lib is not None
        self.chunks = list(chunks)
        self.buf = buf
        self._buf_view = memoryview(buf)
        C = len(self.chunks)
        self.num_chunks = C
        # Keep the arrays referenced: the pointer tables borrow their memory.
        self._datas = (ctypes.c_void_p * C)(
            *[c.data.ctypes.data for c in self.chunks]
        )
        self._sas = (ctypes.c_void_p * C)(
            *[c.suffix_array.ctypes.data for c in self.chunks]
        )
        self._ns = np.array([c.data.size for c in self.chunks], dtype=np.int32)
        self._offs = np.array(
            [c.text_offset for c in self.chunks], dtype=np.int64
        )
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        self._ns_p = self._ns.ctypes.data_as(i32p)
        self._offs_p = self._offs.ctypes.data_as(i64p)
        self._i32p, self._i64p = i32p, i64p
        self._u8p = ctypes.POINTER(ctypes.c_uint8)
        self._threads = max(1, os.cpu_count() or 1)

    # -- native calls -------------------------------------------------------

    def probe(
        self, packed: np.ndarray, lens: np.ndarray
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """(lower, count) int32 [C, B] over the container chunks."""
        ct = self._ct
        packed = np.ascontiguousarray(packed, dtype=np.uint8)
        lens = np.ascontiguousarray(lens, dtype=np.int32)
        B, stride = packed.shape
        lo = np.empty((self.num_chunks, B), dtype=np.int32)
        cnt = np.empty((self.num_chunks, B), dtype=np.int32)
        rc = self._lib.tpuss_probe_multi(
            ct.c_int32(self.num_chunks), self._datas, self._ns_p, self._sas,
            packed.ctypes.data_as(self._u8p),
            lens.ctypes.data_as(self._i32p), ct.c_int32(stride),
            ct.c_int32(B), lo.ctypes.data_as(self._i32p),
            cnt.ctypes.data_as(self._i32p), ct.c_int32(self._threads),
        )
        if rc != 0:
            raise RuntimeError(f'native probe_multi failed with code {rc}')
        return lo, cnt

    def extract_spans(
        self, lo: np.ndarray, cnt: np.ndarray
    ) -> typing.Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Deduplicated line spans for probe bounds.

        Returns (spans [total_cap, 2] int64 global coords, out_base [C*B]
        pair offsets, out_cnt [C, B] written span counts) — cells are
        written sparsely at ``out_base``; callers compact with
        :meth:`fanout`."""
        ct = self._ct
        C, B = cnt.shape
        lo = np.ascontiguousarray(lo, dtype=np.int32)
        cnt = np.ascontiguousarray(np.maximum(cnt, 0), dtype=np.int32)
        flat_cnt = cnt.reshape(-1).astype(np.int64)
        out_base = np.concatenate(
            ([0], np.cumsum(flat_cnt)[:-1])
        ).astype(np.int64)
        total_cap = int(flat_cnt.sum())
        spans = np.empty((max(total_cap, 1), 2), dtype=np.int64)
        out_cnt = np.empty((C, B), dtype=np.int32)
        rc = self._lib.tpuss_extract_spans(
            ct.c_int32(C), self._datas, self._ns_p, self._sas, self._offs_p,
            lo.ctypes.data_as(self._i32p), cnt.ctypes.data_as(self._i32p),
            ct.c_int32(B), out_base.ctypes.data_as(self._i64p),
            spans.ctypes.data_as(self._i64p),
            out_cnt.ctypes.data_as(self._i32p), ct.c_int32(self._threads),
        )
        if rc != 0:
            raise RuntimeError(f'native extract_spans failed with code {rc}')
        return spans, out_base, out_cnt

    # -- assembly -----------------------------------------------------------

    def fanout(
        self,
        B: int,
        spans: np.ndarray,
        out_base: np.ndarray,
        out_cnt: np.ndarray,
    ) -> typing.List[typing.List[str]]:
        """Compact sparse per-(chunk, query) spans into per-query line lists
        (query-major, chunks ascending, line starts ascending within a
        chunk — this repo's ascending-line-id convention, matching
        ops/extract.py; the reference emits lines in SA-iteration order
        instead, src/lib.rs:262-280, but result SETS are identical and the
        reference's own tests are order-insensitive)."""
        C = self.num_chunks
        oc_bc = out_cnt.T.reshape(-1).astype(np.int64)  # (b, c) order
        base_bc = out_base.reshape(C, B).T.reshape(-1)
        total = int(oc_bc.sum())
        self.prof.count('hs-lines', total)
        out: typing.List[typing.List[str]] = [[] for _ in range(B)]
        if total == 0:
            return out
        firsts = np.cumsum(oc_bc) - oc_bc
        idx = np.repeat(base_bc - firsts, oc_bc) + np.arange(
            total, dtype=np.int64
        )
        starts = np.ascontiguousarray(spans[idx, 0])
        ends = np.ascontiguousarray(spans[idx, 1])
        tot_b = out_cnt.sum(axis=0, dtype=np.int64)
        nz = np.flatnonzero(tot_b)
        gstop = np.cumsum(tot_b)
        gstart = (gstop - tot_b)[nz]
        gstop = gstop[nz]
        qid = nz.astype(np.int64)
        fx = native_ops.fastext()
        if fx is not None and hasattr(fx, 'materialize_dedup'):
            # Hash-deduplicated decode: each distinct line becomes ONE str
            # object per batch no matter how many queries hit it (the numpy
            # unique+inverse equivalent costs an argsort — measured ~8 s at
            # 22M entries; the hash pass is one sweep).  Cyclic GC is
            # paused for big batches: allocating tens of millions of
            # objects triggers thousands of collections whose full-heap
            # scans scale with the PROCESS's object graph, not this call's
            # (measured ~2x wall on the 22M-line batch inside a fat
            # large serving process); nothing allocated here can be cyclic.
            import gc

            pause_gc = starts.size > 1_000_000 and gc.isenabled()
            if pause_gc:
                gc.disable()
            try:
                per = fx.materialize_dedup(
                    self._buf_view, starts, ends,
                    np.ascontiguousarray(gstart),
                    np.ascontiguousarray(gstop), np.ascontiguousarray(qid),
                )
            finally:
                if pause_gc:
                    gc.enable()
            for b, lines in per.items():
                out[b] = lines
            return out
        mv = self._buf_view
        vals = [
            bytes(mv[s:e]).decode('utf-8', errors='surrogateescape')
            for s, e in zip(starts.tolist(), ends.tolist())
        ]
        for g0, g1, b in zip(gstart.tolist(), gstop.tolist(), qid.tolist()):
            out[int(b)] = vals[g0:g1]
        return out

    # -- end-to-end ---------------------------------------------------------

    def search(
        self, patterns: typing.Sequence[bytes]
    ) -> typing.List[typing.List[str]]:
        """Full host search: probe + extract + materialize.  Exact reference
        semantics (per-chunk search, line-offset dedup, a line once per
        chunk it matches in)."""
        if not patterns or self.num_chunks == 0:
            return [[] for _ in patterns]
        with self.prof.phase('hs-pack'):
            packed, lens = pack_patterns_host(patterns)
        with self.prof.phase('hs-probe'):
            lo, cnt = self.probe(packed, lens)
        if not cnt.any():  # miss fast path: no extraction state touched
            return [[] for _ in patterns]
        return self.extract(lo, cnt)

    def extract(
        self, lo: np.ndarray, cnt: np.ndarray
    ) -> typing.List[typing.List[str]]:
        """Lines for per-(chunk, query) SA bounds — from :meth:`probe` or
        from a device probe whose rows coincide with container chunks."""
        with self.prof.phase('hs-spans'):
            spans, out_base, out_cnt = self.extract_spans(lo, cnt)
        with self.prof.phase('hs-fanout'):
            return self.fanout(cnt.shape[1], spans, out_base, out_cnt)
