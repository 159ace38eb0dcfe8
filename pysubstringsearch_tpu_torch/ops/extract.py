"""Host-side line materialization: hit positions -> deduplicated line strings.

The reference walks each matching suffix position with forward/backward
``memmem`` newline scans and dedups by line-start offset (reference:
src/lib.rs:262-278).  Here newline positions are precomputed once per chunk
(one vectorized scan at load), so each hit resolves to its line id with a
single ``searchsorted`` — O(hits log lines) with no per-hit byte scanning —
and dedup is ``np.unique`` over line ids.

Quirk preserved for byte parity: if a chunk's text does not end with a
newline (impossible via the Writer, possible via a foreign container), the
reference truncates the final line's last byte (``None => data.len() - 1``,
src/lib.rs:268-270).  We emulate it by placing the virtual terminator at
``n - 1``.
"""

from __future__ import annotations

import threading
import typing

import numpy as np

__all__ = ['LineTable']


class LineTable:
    """Per-chunk newline index enabling O(log L) position -> line lookup."""

    def __init__(self, data: np.ndarray) -> None:
        assert data.dtype == np.uint8
        self.data = data
        # Zero-copy view of the text (mmap-backed chunks must not be
        # duplicated into RAM — reference memory parity, src/lib.rs:175-177);
        # every consumer takes slices via the buffer protocol.
        self._data_bytes = memoryview(data)
        nl = np.flatnonzero(data == 0x0A).astype(np.int64)
        if data.size and (nl.size == 0 or nl[-1] != data.size - 1):
            # Foreign container without trailing terminator: reference quirk.
            nl = np.append(nl, data.size - 1)
        self.nl = nl
        self._line_of: typing.Optional[np.ndarray] = None
        self._lock = threading.Lock()
        self._building = False
        self._hits_served = 0

    @property
    def num_lines(self) -> int:
        return int(self.nl.size)

    def line_ids(self, positions: np.ndarray) -> np.ndarray:
        """Line id for each text position (the line whose span contains it).

        A position sitting exactly on a ``\\n`` byte belongs to the line that
        terminator ends — matching the reference's forward-scan-from-self
        (src/lib.rs:265-267).

        Route: ``searchsorted`` costs ~220 ns/hit at bench scale; the O(n)
        direct-gather table costs ~10 ns/hit but ~32 ns/char to BUILD (8.7 s
        for a 272 MiB row on this host — measured).  The table is built
        lazily only once the CUMULATIVE hits served justify its build cost
        (~n/8 hits), under a lock: concurrent pooled span stages must not
        each pay the build.
        """
        if self.num_lines == 0:
            return np.searchsorted(self.nl, positions, side='left')
        # Snapshot once: the reference is published under the lock below but
        # read here without it (safe under the GIL; the snapshot also keeps
        # the rest of this method race-free on free-threaded builds).
        table = self._line_of
        if table is None:
            build = False
            with self._lock:
                self._hits_served += positions.size
                if (
                    self._hits_served >= self.data.size // 8
                    and self._line_of is None
                    and not self._building
                ):
                    # Claim the build but run it OUTSIDE the lock: the O(n)
                    # cumsum takes seconds for a reference-scale row, and
                    # holding the lock would stall every concurrent pooled
                    # caller for the duration — they fall back to
                    # searchsorted until the table is published.
                    self._building = True
                    build = True
            if build:
                mark = np.zeros(self.data.size, dtype=np.int32)
                mark[self.nl[:-1] + 1] = 1
                table = np.cumsum(mark, dtype=np.int32)
                with self._lock:
                    self._line_of = table
                    self._building = False
            else:
                table = self._line_of
            if table is None:
                return np.searchsorted(self.nl, positions, side='left')
        # Clip: positions past the last terminator (possible only via
        # the foreign-container quirk) belong to the final line.
        return table[
            np.minimum(positions, table.size - 1)
        ].astype(np.int64)

    def line_span(self, line_id: int) -> typing.Tuple[int, int]:
        start = int(self.nl[line_id - 1]) + 1 if line_id > 0 else 0
        return start, int(self.nl[line_id])

    def line_bytes(self, line_id: int) -> bytes:
        start, end = self.line_span(line_id)
        return bytes(self._data_bytes[start:end])

    def line_str(self, line_id: int) -> str:
        # The reference returns the raw bytes reinterpreted as str without
        # validation (from_utf8_unchecked, src/lib.rs:275); surrogateescape is
        # the faithful Python analogue — lossless and identical for UTF-8.
        return self.line_bytes(line_id).decode('utf-8', errors='surrogateescape')

    def extract_unique_lines(self, positions: np.ndarray) -> typing.List[str]:
        """Lines containing the given hit positions, deduped by line start."""
        if positions.size == 0:
            return []
        ids = np.unique(self.line_ids(positions))
        return [self.line_str(int(i)) for i in ids]

    def extract_lines_batch(
        self,
        suffix_array: np.ndarray,
        lower: np.ndarray,  # int [B] SA range start per query
        count: np.ndarray,  # int [B] SA range length per query
    ) -> typing.Dict[int, typing.List[str]]:
        """Per-query deduplicated lines for a whole batch, vectorized.

        One flat gather materializes every query's SA slice, one
        ``searchsorted`` maps all hit positions to line ids, and per-query
        dedup is a single ``np.unique`` over packed (query, line) keys — no
        Python loop over (query, chunk) pairs (the reference's per-hit
        newline walk is src/lib.rs:262-278; the O(B*C) Python loop this
        replaces was the round-1 shape).  Each distinct line is decoded
        exactly once per batch.  Returns {query index: [line, ...]} for
        queries with at least one hit; line order is ascending line id,
        matching :meth:`extract_unique_lines`.
        """
        # Clamp defensively: a foreign/corrupt container (or a probe bug)
        # must degrade to "no hits", not crash np.repeat on a negative count.
        count = np.maximum(np.asarray(count, dtype=np.int64), 0)
        lower = np.asarray(lower, dtype=np.int64)
        total = int(count.sum())
        if total == 0:
            return {}
        firsts = np.cumsum(count) - count  # flat start per query
        # offsets[i] = lower[q] + (i - firsts[q]) for i in query q's span.
        ar = np.arange(total, dtype=np.int64)
        seg = np.repeat(np.arange(count.size, dtype=np.int64), count)
        offsets = np.repeat(lower - firsts, count) + ar
        return self.lines_for_positions(seg, suffix_array[offsets])

    def lines_for_positions(
        self,
        seg: np.ndarray,  # int [T] owning query index per hit
        positions: np.ndarray,  # int [T] text position per hit
    ) -> typing.Dict[int, typing.List[str]]:
        """Per-query deduplicated lines for flat (query, position) hits —
        the back half of :meth:`extract_lines_batch`, also fed directly by
        the Reader's device flat-gather readback and the native host-probe
        route."""
        return self.materialize_spans(self.spans_for_positions(seg, positions))

    def spans_for_positions(
        self,
        seg: np.ndarray,
        positions: np.ndarray,
    ) -> typing.Optional[tuple]:
        """Numpy-only front half of :meth:`lines_for_positions`: dedup and
        group flat (query, position) hits into distinct line spans plus the
        fan-out plan.  Releases the GIL for its duration (pure numpy), so
        callers can run it for several chunks concurrently and feed the
        GIL-bound :meth:`materialize_spans` serially — object creation
        cannot parallelize under the GIL, but this half can."""
        if positions.size == 0:
            return None
        seg = np.asarray(seg, dtype=np.int64)
        ids = self.line_ids(positions)
        key = seg * np.int64(self.num_lines + 1) + ids
        uniq = np.unique(key)
        useg = uniq // np.int64(self.num_lines + 1)
        uid = uniq - useg * np.int64(self.num_lines + 1)
        # Decode each distinct line once, then fan the str objects out into
        # per-query lists.  uniq is sorted, so each query's ids appear
        # contiguously, ascending.  dist/inv via a dense remap over the
        # bounded line-id space — ~20x np.unique(return_inverse)'s sort at
        # bench scale.
        seen = np.zeros(self.num_lines + 1, dtype=bool)
        seen[uid] = True
        dist = np.flatnonzero(seen)
        remap = np.zeros(self.num_lines + 1, dtype=np.int64)
        remap[dist] = np.arange(dist.size, dtype=np.int64)
        inv = remap[uid]
        starts = np.where(dist > 0, self.nl[dist - 1] + 1, 0).astype(np.int64)
        ends = self.nl[dist].astype(np.int64)
        bounds = np.flatnonzero(np.diff(useg)) + 1
        gstart = np.concatenate(([0], bounds)).astype(np.int64)
        gstop = np.concatenate((bounds, [uniq.size])).astype(np.int64)
        qid = useg[gstart].astype(np.int64)
        return starts, ends, inv, gstart, gstop, qid

    def materialize_spans(
        self, spans: typing.Optional[tuple]
    ) -> typing.Dict[int, typing.List[str]]:
        """GIL-bound back half: decode each distinct line span once and fan
        the str objects out into per-query lists."""
        if spans is None:
            return {}
        starts, ends, inv, gstart, gstop, qid = spans
        from . import native as native_ops

        fx = native_ops.fastext()
        if fx is not None:
            # Native object fan-out (native/fastext.c): ~20x the python
            # comprehension at bench scale — the step that dominates
            # full-batch extraction cost.
            return fx.materialize(
                self._data_bytes,
                np.ascontiguousarray(starts),
                np.ascontiguousarray(ends),
                np.ascontiguousarray(inv.astype(np.int64)),
                np.ascontiguousarray(gstart),
                np.ascontiguousarray(gstop),
                np.ascontiguousarray(qid),
            )
        big = self._data_bytes
        obj = np.empty(starts.size, dtype=object)
        obj[:] = [
            bytes(big[s:e]).decode('utf-8', errors='surrogateescape')
            for s, e in zip(starts.tolist(), ends.tolist())
        ]
        vals = obj[inv]
        out: typing.Dict[int, typing.List[str]] = {}
        for start, stop, q in zip(
            gstart.tolist(), gstop.tolist(), qid.tolist()
        ):
            out[int(q)] = vals[start:stop].tolist()
        return out
