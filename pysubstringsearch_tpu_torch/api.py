"""Public API: ``Writer`` and ``Reader`` with the JAX package's signatures,
container bytes and result multisets.

    Writer(index_file_path, max_chunk_len=None)
        .add_entry(text) / .add_entries_from_file_lines(path)
        .dump_data() / .finalize()
    Reader(index_file_path, device='cuda')
        .search(substring) -> list[str]
        .search_multiple(substrings) -> list[str]

``search`` returns each matching line once per chunk it matches in (dedup
by line-start offset within a chunk); ``search_multiple`` concatenates the
per-pattern results with duplicates across patterns, but probes all
patterns as one batch.
"""

from __future__ import annotations

import collections
import os
import threading
import time
import typing
from concurrent.futures import Future, ThreadPoolExecutor

import numpy as np
import torch

from . import container
from .models.index import DeviceIndex
from .ops import native as native_ops
from .ops import search as search_ops
from .ops.extract import LineTable
from .ops.hostserve import HOST_PROBE_UNIT_S, HostServing, pack_patterns_host
from .ops.suffix_array import (
    build_suffix_array,
    device_rtt_estimate,
    host_device_link_mbps,
)
from .utils.profiling import PhaseProfiler


class Writer:
    """Index writer with reference semantics plus a pipelined build stage.

    ``build_workers > 0`` overlaps suffix-array construction of flushed
    chunks with further ingestion: each ``dump_data`` submits the chunk to a
    thread pool (the native SA-IS kernel releases the GIL, so host builds
    run truly in parallel across chunks — the parallelism the reference
    compiled OUT of libsais by not passing -fopenmp, build.rs:1-11) and
    completed chunks are appended to the file in submission order.  The
    resulting container bytes are identical to a synchronous build.

    ``sa_backend`` picks the suffix-array builder
    (ops/suffix_array.build_suffix_array): ``'auto'`` builds a chunk of at
    least 64 KiB on the CUDA card when one is present and the card's build
    with its transfers is estimated faster than native SA-IS
    (``_device_build_worthwhile``: the link rates and
    ``TPUSS_DEVICE_BUILD_MBPS``, ``TPUSS_NATIVE_BUILD_MBPS``; B1b and B2,
    one worker at a time on the card), the rest with native SA-IS;
    ``'torch'`` always builds on the card and raises without one;
    ``'native'`` and ``'numpy'`` build on the host.
    """

    def __init__(
        self,
        index_file_path: str,
        max_chunk_len: typing.Optional[int] = None,
        *,
        sa_backend: str = 'auto',
        build_workers: typing.Optional[int] = None,
        profiler: typing.Optional['PhaseProfiler'] = None,
    ) -> None:
        self._file: typing.Optional[typing.BinaryIO] = open(index_file_path, 'wb')
        self._buffer = container.ChunkBuffer(max_chunk_len)
        self._sa_backend = sa_backend
        self._prof = profiler if profiler is not None else PhaseProfiler()
        if build_workers is None:
            build_workers = min(8, os.cpu_count() or 1)
        self._build_workers = build_workers
        self._executor: typing.Optional[ThreadPoolExecutor] = None
        # (data, future) pairs in submission order; file writes drain the
        # head so the on-disk chunk order always matches flush order.
        self._pending: typing.Deque[
            typing.Tuple[np.ndarray, 'Future[np.ndarray]']
        ] = collections.deque()

    #: Fast-ingest read granularity (bytes).
    _INGEST_BLOCK = 32 << 20

    def add_entries_from_file_lines(self, input_file_path: str) -> None:
        """Bulk line ingest — behaviorally identical to the reference's
        per-line loop (src/lib.rs:67-86: strip ``\\n`` terminator and a
        preceding ``\\r``, no too-big guard, oversized lines grow the
        buffer), but LF-only input is ingested as whole multi-line blocks:
        for such input the buffer contents equal the raw file bytes, so the
        per-line Python loop (measured ~15 s for a 500 MB corpus) reduces to
        finding each chunk's last fitting newline and one bulk append.
        """
        with open(input_file_path, 'rb') as input_file:
            leftover = b''
            while True:
                block = input_file.read(self._INGEST_BLOCK)
                if not block:
                    break
                buf = leftover + block if leftover else block
                cut = buf.rfind(b'\n')
                if cut == -1:
                    leftover = buf
                    continue
                self._ingest_segment(buf[: cut + 1])
                leftover = buf[cut + 1:]
        if leftover:
            # Final unterminated line: appended as-is (the reference's line
            # reader yields it without a terminator and strips no \r).
            if self._buffer.would_overflow(len(leftover)):
                self.dump_data()
            self._buffer.append(leftover)

    def _ingest_segment(self, segment: bytes) -> None:
        """Ingest whole ``\\n``-terminated lines with reference flush
        semantics: a line is appended to the current chunk iff
        ``size + len(line) + 1 <= capacity``, else the chunk flushes first;
        a single line larger than the whole capacity becomes its own
        oversized chunk (with the Vec capacity-growth quirk, see
        container.ChunkBuffer)."""
        if b'\r\n' in segment:
            # CRLF present: the \r-strip changes bytes, so take the exact
            # per-line path.
            start = 0
            while start < len(segment):
                end = segment.index(b'\n', start)
                line = segment[start:end]
                if line.endswith(b'\r'):
                    line = line[:-1]
                if self._buffer.would_overflow(len(line)):
                    self.dump_data()
                self._buffer.append(line)
                start = end + 1
            return
        pos = 0
        n = len(segment)
        while pos < n:
            room = self._buffer.capacity - len(self._buffer)
            cut = segment.rfind(b'\n', pos, pos + room) if room > 0 else -1
            if cut == -1:
                if len(self._buffer) > 0:
                    self.dump_data()
                    continue
                # Empty buffer and the first line alone exceeds capacity:
                # reference quirk — it becomes an oversized chunk and grows
                # the Vec (append() emulates the growth rule).
                end = segment.index(b'\n', pos)
                self._buffer.append(segment[pos:end])
                pos = end + 1
                continue
            self._buffer.append_block(segment[pos: cut + 1])
            pos = cut + 1

    def add_entry(self, text: str) -> None:
        data = text.encode('utf-8')
        if len(data) > self._buffer.capacity:
            raise ValueError('entry is too big')
        if self._buffer.would_overflow(len(data)):
            self.dump_data()
        self._buffer.append(data)

    @property
    def profiler(self) -> PhaseProfiler:
        """Per-phase build timings (SURVEY.md §5.5 — the observability the
        reference never had).  Phases: ``sa-build`` (per chunk; summed
        across worker threads, so it can exceed wall time) and ``serialize``.
        """
        return self._prof

    def _drain(self, block: bool) -> None:
        """Write completed head-of-queue chunks; with ``block``, all of them."""
        assert self._file is not None
        while self._pending:
            head_data, head_future = self._pending[0]
            if not block and not head_future.done():
                # Backpressure: never hold more than 2x workers of chunks.
                if len(self._pending) <= 2 * max(1, self._build_workers):
                    return
            suffix_array = head_future.result()
            with self._prof.phase('serialize'):
                container.write_chunk(self._file, head_data, suffix_array)
            self._pending.popleft()

    def _build_sa(self, data: np.ndarray) -> np.ndarray:
        with self._prof.phase('sa-build'):
            return build_suffix_array(data, backend=self._sa_backend)

    def dump_data(self) -> None:
        if len(self._buffer) == 0:
            return
        assert self._file is not None, 'Writer is closed'
        data = self._buffer.take()
        if self._build_workers <= 0:
            suffix_array = self._build_sa(data)
            with self._prof.phase('serialize'):
                container.write_chunk(self._file, data, suffix_array)
            return
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=self._build_workers,
                thread_name_prefix='tpuss-sa-build',
            )
        future = self._executor.submit(self._build_sa, data)
        self._pending.append((data, future))
        self._drain(block=False)

    def finalize(self) -> None:
        if self._file is None:
            return
        if len(self._buffer) > 0:
            self.dump_data()
        self._drain(block=True)
        self._file.flush()

    def close(self) -> None:
        """Finalize and release the file handle (not part of the reference
        API — its Writer flushes on Drop, src/lib.rs:138-144 — but Python
        callers deserve a deterministic close)."""
        if self._file is not None:
            self.finalize()
            self._file.close()
            self._file = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    def __enter__(self) -> 'Writer':
        return self

    def __exit__(self, *exc: typing.Any) -> None:
        self.close()

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass


def native_available_for_probe() -> bool:
    """True when the native host bisection can answer: the Reader's host
    routes need it."""
    return native_ops.probe_batch_available()


class Reader:
    """Index reader whose probe runs on a device.

    ``device`` is where the index lives: ``'cuda'`` (the default) raises
    when no CUDA device is present, ``'cpu'`` runs the kernels' plain
    PyTorch versions.  On CUDA the index builds on a background thread
    (``TPUSS_BG_LOAD``: ``0``, ``false`` or ``no`` load it synchronously at
    the first query, anything else on a thread on any device) while the
    native host path answers queries off the container; the thread then
    warms the probe, measures the device's round trip and the link, and
    marks the index ready.  If the load failed, the next query raises.
    ``index_mode`` forwards to :class:`DeviceIndex` (env
    ``TPUSS_INDEX_MODE`` overrides it): ``'auto'`` derives the SA on a
    CUDA card over merged rows for every alphabet kind (ranked, raw, and
    digit: more than 62 distinct bytes with NUL, such as UTF-16 text),
    ``'upload'`` keeps the container's chunks and SA.

    Once the index is ready a batch takes the cheapest of the JAX Reader's
    routes, by its cost model: patterns longer than ``PAD_MARGIN`` go to
    the host; a batch whose host estimate (patterns x chunks x
    ``HOST_PROBE_UNIT_S``) is under the device round trip
    (``device_rtt_estimate``) goes to the host whole; else the device
    probes it, and each merged row's lines come either from a device hit
    gather (B8) read back, or, when the host is estimated cheaper or the
    readback passes ``_READBACK_CAP``, from the native host bisection of
    the row's source chunks (``x-host-*`` phases); when every merged row
    takes the host, the whole batch goes to ``HostServing.search``.
    """

    def __init__(
        self,
        index_file_path: str,
        *,
        device: typing.Union[str, torch.device] = 'cuda',
        index_mode: str = 'auto',
    ) -> None:
        prof = PhaseProfiler()
        with prof.phase('load-container'):
            cont = container.read_container(index_file_path)
        self._container: typing.Optional[container.MappedContainer] = cont
        self._init_from_chunks(cont.chunks, device, prof, index_mode)

    def _init_from_chunks(
        self,
        chunks: typing.List[container.Chunk],
        device: typing.Union[str, torch.device] = 'cuda',
        prof: typing.Optional[PhaseProfiler] = None,
        index_mode: str = 'auto',
    ) -> None:
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                "Reader(device='cuda') needs a CUDA device; pass "
                "device='cpu' to run the plain PyTorch kernels"
            )
        if not hasattr(self, '_container'):
            self._container = None  # from_chunks: no backing mmap
        self._chunks = chunks
        self._hostserve_obj: typing.Optional[HostServing] = None
        self._hostserve_tried = False
        self._prof = prof if prof is not None else PhaseProfiler()
        self._index_mode = os.environ.get('TPUSS_INDEX_MODE', index_mode)
        self._device_index: typing.Optional[DeviceIndex] = None
        self._row_tables: typing.Optional[typing.List[LineTable]] = None
        self._chunk_tables: typing.Dict[int, LineTable] = {}
        self._device_exc: typing.Optional[BaseException] = None
        self._device_ready = threading.Event()
        self._bg_thread: typing.Optional[threading.Thread] = None
        if self._background_load_default() and chunks:
            self._bg_thread = threading.Thread(
                target=self._bg_load, name='pss-device-load', daemon=True
            )
            self._bg_thread.start()

    def _background_load_default(self) -> bool:
        """``TPUSS_BG_LOAD`` when set (``0``, ``false`` and ``no`` load
        synchronously), else a background load on a CUDA device."""
        flag = os.environ.get('TPUSS_BG_LOAD')
        if flag is not None:
            return flag not in ('0', 'false', 'no')
        return self.device.type == 'cuda'

    @classmethod
    def from_chunks(
        cls,
        chunks: typing.List[container.Chunk],
        device: typing.Union[str, torch.device] = 'cuda',
    ) -> 'Reader':
        """Reader over already-parsed chunks (no container mmap, so no
        native host serving)."""
        reader = cls.__new__(cls)
        reader._init_from_chunks(chunks, device)
        return reader

    def _build_device_index(self) -> DeviceIndex:
        return DeviceIndex(self._chunks, device=self.device,
                           mode=self._index_mode, profiler=self._prof)

    def _warm_tunnel_async(self) -> None:
        """A 1 KiB round trip to the device on a side thread, so the first
        transfers of the process (the CUDA context, the copy engines) are
        set up beside the index build instead of in front of the first
        probe."""
        device = self.device

        def warm():
            try:
                torch.zeros(1024, dtype=torch.uint8).to(device).cpu()
            except Exception:  # best effort: the load reports device faults
                pass

        threading.Thread(
            target=warm, name='pss-link-warm', daemon=True
        ).start()

    def _bg_load(self) -> None:
        self._warm_tunnel_async()
        try:
            with self._prof.phase('device-load'):
                index = self._build_device_index()
                if self.device.type == 'cuda':
                    # The builders launch asynchronously: a fault in them
                    # surfaces here, before the index is marked ready.
                    torch.cuda.synchronize(self.device)
            with self._prof.phase('device-warm'):
                # One probe before "ready", so the first query pays no
                # first-launch cost; then the round trip of a 1-pattern
                # probe, measured once and cached for the routes.
                probe_pats = np.full((8, 4), ord('e'), dtype=np.uint8)
                probe_lens = np.full((8,), 4, dtype=np.int32)
                index.probe(probe_pats, probe_lens)
                device_rtt_estimate(self.device, index)
            # The link rates route extraction; measured here, once, while
            # the device is idle.  A failure leaves the defaults and does
            # not fail a built index.
            try:
                host_device_link_mbps(self.device)
            except Exception:
                pass
            self._device_index = index
        except BaseException as exc:  # noqa: BLE001 — re-raised on access
            self._device_exc = exc
        finally:
            self._device_ready.set()

    @property
    def profiler(self) -> PhaseProfiler:
        """Per-phase timings: ``load-container``, ``device-load`` (split
        into :class:`DeviceIndex`'s ``index-*`` phases), ``device-warm``
        (the warm probe and the round-trip measurement), ``line-tables``.

        A query is one ``batch`` (all of :meth:`search_multiple` or
        :meth:`search`), whose direct children are ``encode`` (the UTF-8
        encode), ``dedup`` (the map of distinct patterns and the fan-back
        of their results), ``route`` (the long-pattern split and the tiny
        batch test), ``pack`` (``pack_patterns``), ``probe`` (of which
        :class:`DeviceIndex`'s ``probe-upload``, ``probe-kernel``,
        ``probe-readback`` and, for the raw kind, ``probe-nul``),
        ``extract``, ``flatten`` (the per-pattern lists joined into one,
        then freed with the encoded patterns), ``host-serve`` (the host
        path while the index loads) and ``host-route`` (the tiny batch
        route and the patterns too long for the device rows).  Under
        ``extract``, for merged rows, ``x-dev-gather``, the device gather
        and its readback, and ``x-dev-lines``, the line materialisation,
        on the device route; ``x-host-probe``, ``x-host-gather``,
        ``x-host-spans`` and ``x-host-lines``, summed over the source
        chunks, on the host route; :class:`HostServing`'s ``hs-*`` phases
        and its ``hs-lines`` counter wherever it answers.  While a
        ``torch.profiler`` session records on the querying thread, each
        phase is also a ``record_function`` range in its trace."""
        return self._prof

    @property
    def _index(self) -> DeviceIndex:
        if self._device_index is None:
            if self._bg_thread is not None:
                self._device_ready.wait()
                if self._device_exc is not None:
                    raise RuntimeError(
                        'background device index load failed'
                    ) from self._device_exc
                return self._device_index  # type: ignore[return-value]
            with self._prof.phase('device-load'):
                self._device_index = self._build_device_index()
        return self._device_index

    @property
    def device_ready(self) -> bool:
        """True once queries are served by the device index."""
        if self._bg_thread is None:
            return self._device_index is not None
        return self._device_ready.is_set() and self._device_exc is None

    def wait_device_ready(self, timeout: typing.Optional[float] = None) -> bool:
        """Block until the background device load finishes; returns
        :attr:`device_ready`."""
        if self._bg_thread is not None:
            self._device_ready.wait(timeout)
        return self.device_ready

    @property
    def row_tables(self) -> typing.List[LineTable]:
        """One LineTable per probe row.  A merged row's table spans its
        concatenated text: every chunk ends with ``\\n``, so no line spans
        a source-chunk boundary and dedup by line offset equals the
        reference's per-chunk dedup."""
        if self._row_tables is None:
            with self._prof.phase('line-tables'):
                self._row_tables = [
                    LineTable(d) for d in self._index.row_data
                ]
        return self._row_tables

    #: Bytes of a merged row's hit readback (4 a hit) past which the row's
    #: lines come from the native host bisection instead of the device
    #: gather (env ``TPUSS_READBACK_CAP``, read at import).  The default is
    #: one hit under the smallest readback at which chip_smoke.py's sweep
    #: over its ranked derive rows found the host route faster than the
    #: device route: 48,320 bytes, the smaller row's 12,080 hits of 16
    #: patterns (host 7.8 ms, device 51.1 ms; at 1 pattern, 4 bytes, the
    #: device won), on an NVIDIA H100 80GB HBM3 at 700.00 W (2026-10-18).
    _READBACK_CAP = int(os.environ.get('TPUSS_READBACK_CAP', '48316'))

    @property
    def _host_serving(self) -> typing.Optional[HostServing]:
        """Native serving state over the container mmap, or None without a
        container or the native kernels.  Built once."""
        if not self._hostserve_tried:
            self._hostserve_tried = True
            if self._container is not None:
                self._hostserve_obj = HostServing.maybe(
                    self._chunks, self._container.buf, self._prof
                )
        return self._hostserve_obj

    def _search_batch(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        """Per-pattern result lists, each in row-major order.  Duplicate
        patterns are probed once and their results fanned back out."""
        if not patterns or not self._chunks:
            return [[] for _ in patterns]
        with self._prof.phase('dedup'):
            uniq: typing.Dict[bytes, int] = {}
            for p in patterns:
                uniq.setdefault(p, len(uniq))
        if len(uniq) == len(patterns):
            return self._search_distinct(patterns)
        uniq_results = self._search_distinct(list(uniq))
        with self._prof.phase('dedup'):
            return [uniq_results[uniq[p]] for p in patterns]

    def _search_distinct(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        """:meth:`_search_batch` of distinct patterns."""
        if self._bg_thread is not None and not self._device_ready.is_set():
            # Device index still loading: serve from the host path over the
            # container's per-chunk SAs.  (A finished but failed load falls
            # through and raises in ``_index``.)
            with self._prof.phase('host-serve'):
                return self._search_host_chunks(patterns)
        with self._prof.phase('route'):
            long_idx = [
                i for i, p in enumerate(patterns)
                if len(p) > search_ops.PAD_MARGIN
            ]
            if not long_idx:
                idx = self._index
                # A batch so small that the whole host bisection costs
                # less than the device probe's fixed round trip.
                tiny = native_available_for_probe() and (
                    len(patterns) * max(idx.num_source_chunks, 1)
                    * HOST_PROBE_UNIT_S < device_rtt_estimate(self.device))
        if long_idx:
            # Patterns beyond the device rows' margin take the exact host
            # path; the rest of the batch still runs on the device.
            out: typing.List[typing.List[str]] = [[] for _ in patterns]
            long_set = set(long_idx)
            short_idx = [i for i in range(len(patterns)) if i not in long_set]
            if short_idx:
                for i, lines in zip(
                    short_idx,
                    self._search_distinct([patterns[i] for i in short_idx]),
                ):
                    out[i] = lines
            with self._prof.phase('host-route'):
                long_out = self._search_host_chunks(
                    [patterns[i] for i in long_idx])
            for i, lines in zip(long_idx, long_out):
                out[i] = lines
            return out
        if tiny:
            with self._prof.phase('host-route'):
                return self._search_host_chunks(patterns)
        with self._prof.phase('pack'):
            packed, lengths = search_ops.pack_patterns(patterns)
        with self._prof.phase('probe'):
            lo, cnt = idx.probe(packed, lengths)
        hs = self._host_serving
        with self._prof.phase('extract'):
            if (hs is not None and not idx.merged
                    and idx.num_chunks == len(self._chunks)):
                # Probe rows are container chunks, so the device bounds
                # feed the native span extraction directly.
                return hs.extract(lo, cnt)
            if hs is not None and idx.merged and self._host_extract_all(cnt):
                # Every merged row would take the host route: the native
                # pipeline over the container chunks answers the whole
                # batch, with no crossing filter to apply.
                return hs.search(patterns)
            out = [[] for _ in patterns]
            # Rows run one after another: the host route inside a row
            # already spreads over the cores.
            for r in range(idx.num_chunks):
                per = self._extract_row(r, packed, lengths, lo[r], cnt[r])
                for b, lines in per.items():
                    out[b].extend(lines)
            return out

    def _row_takes_host(self, B: int, group_size: int, total: int) -> bool:
        """The cost model of a merged row of ``group_size`` source chunks
        and ``total`` hits for a batch of ``B`` patterns: the host
        re-probe (B x chunks x ``HOST_PROBE_UNIT_S``) against the device
        gather (the round trip plus 4 bytes a hit over the link), or a
        readback past ``_READBACK_CAP``."""
        _, d2h = host_device_link_mbps(self.device)
        host_est = B * group_size * HOST_PROBE_UNIT_S
        dev_est = device_rtt_estimate(self.device) + total * 4 / max(
            d2h * 1e6, 1e-9
        )
        return host_est < dev_est or total * 4 > self._READBACK_CAP

    def _host_extract_all(self, cnt: np.ndarray) -> bool:
        """True when every merged row's extraction would take the host
        route (:meth:`_row_takes_host`); rows of one chunk do not count."""
        if not native_ops.probe_batch_available():
            return False
        idx = self._index
        B = cnt.shape[1]
        for r in range(idx.num_chunks):
            if len(idx.groups[r]) <= 1:
                continue  # cheap on either route
            total = int(np.maximum(cnt[r], 0).sum())
            if not self._row_takes_host(B, len(idx.groups[r]), total):
                return False
        return True

    def _extract_row(
        self,
        r: int,
        packed: np.ndarray,
        lengths: np.ndarray,
        lo_r: np.ndarray,
        cnt_r: np.ndarray,
    ) -> typing.Dict[int, typing.List[str]]:
        """One probe row's lines, by the cheapest route:

        - a row that is one container chunk gathers from the chunk's host
          SA;
        - a merged row on the device route gathers its hits on the device
          (B8), reads them back, and drops the occurrences that span a
          source-chunk boundary;
        - a merged row on the host route (:meth:`_row_takes_host`)
          re-probes each source chunk with the native bisection, which
          never crosses a boundary, and gathers from the chunk's host SA.
        """
        idx = self._index
        table = self.row_tables[r]
        group = idx.groups[r]
        if len(group) == 1:
            return table.extract_lines_batch(
                self._chunks[group[0]].suffix_array, lo_r, cnt_r
            )
        total = int(np.maximum(cnt_r, 0).sum())
        use_host = (native_ops.probe_batch_available()
                    and self._row_takes_host(packed.shape[0], len(group),
                                             total))
        if not use_host:
            if not cnt_r.any():
                return {}
            with self._prof.phase('x-dev-gather'):
                sa_r = idx.row_sa(r)
                pos_d, qid_d = search_ops.gather_hits_flat(
                    sa_r, torch.as_tensor(lo_r, device=sa_r.device),
                    torch.as_tensor(cnt_r, device=sa_r.device),
                )
                pos = pos_d.cpu().numpy().astype(np.int64)
                qid = qid_d.cpu().numpy().astype(np.int64)
            pos, qid = self._drop_crossings(r, packed, lengths, pos, qid)
            with self._prof.phase('x-dev-lines'):
                return table.lines_for_positions(qid, pos)

        # Host route: per source chunk, the native bisection, the gather
        # from its host SA and the numpy span stage (which release the GIL)
        # in a pool; the str materialisation, which holds the GIL, on this
        # thread in chunk order.  Lines are chunk-local (every chunk ends
        # with \n), so per-chunk dedup is the row's.
        def one(j_c):
            j, c = j_c
            chunk = self._chunks[c]
            t0 = time.perf_counter()
            lo_c, cnt_c = native_ops.probe_batch_native(
                chunk.data, chunk.suffix_array, packed, lengths
            )
            t1 = time.perf_counter()
            cnt_c = np.maximum(cnt_c.astype(np.int64), 0)
            seg = np.repeat(np.arange(cnt_c.size, dtype=np.int64), cnt_c)
            firsts = np.cumsum(cnt_c) - cnt_c
            offs = (
                np.repeat(lo_c.astype(np.int64) - firsts, cnt_c)
                + np.arange(int(cnt_c.sum()), dtype=np.int64)
            )
            pos = chunk.suffix_array[offs].astype(np.int64)
            t2 = time.perf_counter()
            spans = table.spans_for_positions(
                seg, pos + int(idx.group_offsets[r][j])
            )
            t3 = time.perf_counter()
            return spans, (t1 - t0, t2 - t1, t3 - t2)

        per_chunk = []
        with ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1)
        ) as pool:
            futures = [pool.submit(one, jc) for jc in enumerate(group)]
            for f in futures:
                spans, (tp, tg, ts) = f.result()
                self._prof.add('x-host-probe', tp)
                self._prof.add('x-host-gather', tg)
                self._prof.add('x-host-spans', ts)
                t0 = time.perf_counter()
                per_chunk.append(table.materialize_spans(spans))
                self._prof.add('x-host-lines', time.perf_counter() - t0)
        merged: typing.Dict[int, typing.List[str]] = {}
        for per in per_chunk:
            for b, lines in per.items():
                if b in merged:
                    merged[b].extend(lines)
                else:
                    merged[b] = lines
        return merged

    def _drop_crossings(
        self,
        r: int,
        packed: np.ndarray,
        lengths: np.ndarray,
        pos: np.ndarray,
        qid: np.ndarray,
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """Drop merged-row occurrences that span a source-chunk boundary
        (possible only for patterns containing ``\\n``: every chunk ends
        with one; see DeviceIndex.boundary_crossings)."""
        ends = self._index.boundaries[r]
        if ends.size == 0 or pos.size == 0:
            return pos, qid
        jpos = np.arange(packed.shape[1])[None, :]
        has_nl = ((packed == 0x0A) & (jpos < lengths[:, None])).any(axis=1)
        if not has_nl.any():
            return pos, qid
        L = lengths.astype(np.int64)[qid]
        check = has_nl[qid] & (L >= 2)
        crosses = check & (
            np.searchsorted(ends, pos, side='right')
            != np.searchsorted(ends, pos + L - 1, side='right')
        )
        keep = ~crosses
        return pos[keep], qid[keep]

    def _chunk_table(self, c: int) -> LineTable:
        table = self._chunk_tables.get(c)
        if table is None:
            table = self._chunk_tables[c] = LineTable(self._chunks[c].data)
        return table

    def _search_host_chunks(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        """Host-only search straight off the container: bisection over each
        chunk's on-disk SA plus per-chunk line extraction, for any pattern
        length and with no device index."""
        out: typing.List[typing.List[str]] = [[] for _ in patterns]
        if not patterns:
            return out
        hs = self._host_serving
        if hs is not None:
            return hs.search(patterns)
        packed, plens = pack_patterns_host(patterns)
        use_native = native_ops.available()

        def one(c: int) -> typing.Dict[int, typing.List[str]]:
            chunk = self._chunks[c]
            if use_native:
                lo_c, cnt_c = native_ops.probe_batch_native(
                    chunk.data, chunk.suffix_array, packed, plens
                )
            else:
                data = chunk.data.tobytes()
                lo_c = np.zeros(len(patterns), dtype=np.int64)
                cnt_c = np.zeros(len(patterns), dtype=np.int64)
                for b, pat in enumerate(patterns):
                    lo_c[b], cnt_c[b] = search_ops.host_probe_bounds(
                        data, chunk.suffix_array, pat
                    )
            return self._chunk_table(c).extract_lines_batch(
                chunk.suffix_array, lo_c, cnt_c
            )

        workers = min(len(self._chunks), max(os.cpu_count() or 1, 1))
        if workers > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                per_chunk = list(pool.map(one, range(len(self._chunks))))
        else:
            per_chunk = [one(c) for c in range(len(self._chunks))]
        for per in per_chunk:
            for b, lines in per.items():
                out[b].extend(lines)
        return out

    def search(self, substring: str) -> typing.List[str]:
        prof = self._prof
        with prof.phase('batch'):
            with prof.phase('encode'):
                pattern = substring.encode('utf-8')
            return self._search_batch([pattern])[0]

    def search_multiple(self, substrings: typing.List[str]) -> typing.List[str]:
        prof = self._prof
        with prof.phase('batch'):
            with prof.phase('encode'):
                patterns = [s.encode('utf-8') for s in substrings]
            per_pattern = self._search_batch(patterns)
            with prof.phase('flatten'):
                results: typing.List[str] = []
                for r in per_pattern:
                    results.extend(r)
                # Released here, not at the return: a 4096-pattern batch's
                # lists and bytes take about 0.25 ms to free.
                del per_pattern, patterns
            return results
