"""Device-resident substring index: every container chunk is one probe row
of stacked, padded tensors on one device,

    text   [C, n_pad] uint8     sa     [C, n_pad] int32    lengths [C] int32
    tables [C, base^depth+1] int32    limbs  [C, num_limbs * n_pad] int32

and a query batch is answered by one launch of the phased probe over all
rows (ops/search.py:probe_phased).

Only the upload geometry exists so far: rows are the container's chunks and
the SA comes from the container.  For a ranked alphabet the text and SA are
uploaded and the limb planes and seed tables are built on the device
(ops/search.py K1-K3); for a large NUL-free alphabet the host builders make
them and they are uploaded.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..container import Chunk
from ..ops import search as search_ops
from ..ops.suffix_array import _pad_len
from ..utils.profiling import PhaseProfiler


def _device_budget(device: torch.device) -> int:
    """Device memory bytes the index may fill: 85% of what is free now, so
    the probe's scratch still fits.  The CPU is not metered."""
    if device.type == 'cpu':
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    return int(free * 0.85)


class DeviceIndex:
    """Stacked padded chunks on one device."""

    def __init__(
        self,
        chunks: typing.Sequence[Chunk],
        *,
        device: typing.Union[str, torch.device] = 'cuda',
        num_limbs: typing.Optional[int] = None,
        mode: str = 'auto',
        profiler: typing.Optional[PhaseProfiler] = None,
    ) -> None:
        """``mode``: ``'upload'`` (and ``'auto'``, which means upload) makes
        each container chunk one row.  ``'derive'``, which rebuilds the SA on
        the device over merged rows, is not ported yet (ROADMAP B1, B2,
        B8).  ``profiler`` records the build's phases: ``index-alphabet``
        (the byte-presence scan that picks the kind), ``index-alloc`` (the
        zeroed device rows), ``index-host-copy`` (container views into
        aligned host arrays), ``index-h2d`` (their upload) and
        ``index-aux`` (limb planes and seed tables), each device phase
        ending in a synchronise."""
        if mode == 'derive':
            raise NotImplementedError(
                "DeviceIndex mode='derive' is not ported yet "
                '(ROADMAP B1, B2 and B8)'
            )
        if mode not in ('auto', 'upload'):
            raise ValueError(f'unknown DeviceIndex mode: {mode!r}')
        self.mode = 'upload'
        self.device = torch.device(device)
        prof = profiler if profiler is not None else PhaseProfiler()
        self.num_source_chunks = len(chunks)
        self.groups = [[i] for i in range(len(chunks))]
        self.merged = False
        self.row_data: typing.List[np.ndarray] = [c.data for c in chunks]
        self.group_offsets = [np.zeros(1, dtype=np.int64) for _ in chunks]
        self.num_chunks = len(chunks)  # probe rows
        # Limb encoding: rank-packed digits for alphabets of at most 62
        # bytes (NUL-safe), raw 4-byte packing for larger NUL-free ones; the
        # base-258 digit kind (large alphabets with NUL) is not ported yet.
        with prof.phase('index-alphabet'):
            pres = np.zeros(256, dtype=bool)
            for c in chunks:
                pres |= np.bincount(c.data, minlength=256)[:256] > 0
        sigma = int(pres.sum())
        bits = search_ops.ranked_bits(sigma)
        if bits is not None:
            self.kind = 'ranked'
        elif not pres[0]:
            self.kind = 'raw'
        else:
            raise NotImplementedError(
                'digit-kind index (an alphabet of more than 62 bytes that '
                'contains NUL) is not ported yet (ROADMAP B11 and B12)'
            )
        self._bits = bits
        rank, sigma = search_ops.alphabet_rank(pres)
        max_n = max([d.size for d in self.row_data] + [1])
        self._base, self._depth = search_ops.pick_table_params(sigma, max_n)
        self.n_pad = _pad_len(max_n + search_ops.PAD_MARGIN)
        self.rank = torch.as_tensor(rank, device=self.device)
        self.present = torch.as_tensor(pres.astype(np.int32),
                                       device=self.device)
        self.num_limbs = (
            self._auto_num_limbs() if num_limbs is None else num_limbs
        )
        C, n_pad = self.num_chunks, self.n_pad
        self.lengths = torch.as_tensor(
            np.array([d.size for d in self.row_data], dtype=np.int32),
            device=self.device,
        )
        with prof.phase('index-alloc'):
            self.text = torch.zeros((C, n_pad), dtype=torch.uint8,
                                    device=self.device)
            self.sa = torch.zeros((C, n_pad), dtype=torch.int32,
                                  device=self.device)
            self._sync()
        for i, c in enumerate(chunks):
            with prof.phase('index-host-copy'):
                # np.array: an aligned, writable copy of the container's
                # mmap view (its SA view is generally unaligned).
                text = torch.from_numpy(np.array(c.data))
                sa = torch.from_numpy(
                    np.array(c.suffix_array, dtype=np.int32)
                )
            with prof.phase('index-h2d'):
                self.text[i, : c.data.size] = text
                self.sa[i, : c.data.size] = sa
                self._sync()
        table_len = self._base ** self._depth + 1
        with prof.phase('index-aux'):
            self._build_aux(chunks, rank, table_len)
            self._sync()

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _build_aux(
        self, chunks: typing.Sequence[Chunk], rank: np.ndarray, table_len: int
    ) -> None:
        """Limb planes and seed tables: K1-K3 on the device for the ranked
        kind, the host builders for the raw kind."""
        C, n_pad, bits = self.num_chunks, self.n_pad, self._bits
        if self.kind == 'ranked':
            self.tables = torch.empty((C, table_len), dtype=torch.int32,
                                      device=self.device)
            self.limbs = torch.empty((C, self.num_limbs * n_pad),
                                     dtype=torch.int32, device=self.device)
            packed = torch.empty(n_pad, dtype=torch.int32,
                                 device=self.device)
            for i, d in enumerate(self.row_data):
                search_ops.ranked_pack(self.text[i], d.size, self.rank, bits,
                                       out=packed)
                search_ops.seed_table(packed, self.sa[i], d.size, self._base,
                                      self._depth, bits, out=self.tables[i])
                search_ops.ranked_limb_planes(
                    packed, self.sa[i], d.size, self._depth, bits,
                    self.num_limbs, out=self.limbs[i],
                )
        else:
            tables = np.zeros((C, table_len), dtype=np.int32)
            limbs = np.zeros((C, self.num_limbs * n_pad), dtype=np.int32)
            for i, c in enumerate(chunks):
                tables[i] = search_ops.build_seed_table_host(
                    c.data, c.suffix_array, rank, self._base, self._depth
                )
                limbs[i] = search_ops.pad_limbs_host(
                    search_ops.build_raw_limbs_host(
                        c.data, c.suffix_array, self.num_limbs, self._depth
                    ),
                    n_pad,
                )
            self.tables = torch.as_tensor(tables, device=self.device)
            self.limbs = torch.as_tensor(limbs, device=self.device)

    @classmethod
    def from_arrays(
        cls,
        arrays: typing.Mapping[str, np.ndarray],
        meta: typing.Mapping[str, typing.Any],
        device: typing.Union[str, torch.device] = 'cpu',
    ) -> 'DeviceIndex':
        """An index over state built elsewhere (the JAX package's upload
        index, read back as numpy).  ``arrays``: ``text``, ``lengths``,
        ``sa``, ``tables``, ``limbs``, ``rank``, ``present``; ``meta``:
        ``kind``, ``bits``, ``base``, ``depth``, ``num_limbs``."""
        if meta['kind'] not in ('ranked', 'raw'):
            raise NotImplementedError(
                f"{meta['kind']}-kind index is not ported yet (ROADMAP B11)"
            )
        self = cls.__new__(cls)
        self.mode = 'upload'
        self.device = torch.device(device)

        def put(name, dtype):
            # A copy: the caller's arrays may be read-only views.
            return torch.from_numpy(
                np.array(arrays[name], dtype=dtype)
            ).to(self.device)

        self.text = put('text', np.uint8)
        self.lengths = put('lengths', np.int32)
        self.sa = put('sa', np.int32)
        self.tables = put('tables', np.int32)
        self.limbs = put('limbs', np.int32)
        self.rank = put('rank', np.int32)
        self.present = put('present', np.int32)
        self.kind = meta['kind']
        self._bits = meta['bits']
        self._base, self._depth = meta['base'], meta['depth']
        self.num_limbs = meta['num_limbs']
        C, self.n_pad = self.text.shape
        lengths = np.asarray(arrays['lengths'])
        self.row_data = [
            np.asarray(arrays['text'])[i, : lengths[i]] for i in range(C)
        ]
        self.num_chunks = self.num_source_chunks = C
        self.groups = [[i] for i in range(C)]
        self.merged = False
        self.group_offsets = [np.zeros(1, dtype=np.int64) for _ in range(C)]
        return self

    def _auto_num_limbs(self) -> int:
        """Most limb planes (at most RAW_LIMBS, at least 1) whose resident
        footprint fits the device: per row text (1 B) + SA (4 B) + one int32
        per plane per slot, plus the seed table and one pack scratch row."""
        C = max(self.num_chunks, 1)
        table_bytes = 4 * (self._base ** self._depth + 1)
        fixed = C * (5 * self.n_pad + table_bytes) + 4 * self.n_pad
        fit = (_device_budget(self.device) - fixed) // (4 * C * self.n_pad)
        return int(max(1, min(search_ops.RAW_LIMBS, fit)))

    def boundary_crossings(self, patterns: np.ndarray,
                           lengths: np.ndarray) -> np.ndarray:
        """int32 [C, B] occurrences that span a source-chunk boundary: all
        zero, since every row is one container chunk."""
        return np.zeros((self.num_chunks, patterns.shape[0]), dtype=np.int32)

    def count_matches(self, patterns: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
        """int32 [C, B] exact per-row match counts."""
        _, cnt = self.probe(patterns, lengths)
        return cnt - self.boundary_crossings(patterns, lengths)

    def probe(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """(lower, count) int32 [C, B] host arrays: the SA range of each
        pattern's matches in each row, from one probe launch."""
        patterns = np.asarray(patterns, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        B = patterns.shape[0]
        if self.num_chunks == 0 or B == 0 or patterns.shape[1] > self.n_pad:
            # A pattern wider than every row cannot match.
            zeros = np.zeros((self.num_chunks, B), dtype=np.int32)
            return zeros, zeros.copy()
        lo, cnt = search_ops.probe_phased(
            self.text, self.lengths, self.sa, self.tables, self.limbs,
            self.rank, self.present,
            torch.as_tensor(np.ascontiguousarray(patterns),
                            device=self.device),
            torch.as_tensor(lengths, device=self.device),
            self.num_limbs, self._base, self._depth, self._bits,
        )
        lo, cnt = lo.cpu().numpy(), cnt.cpu().numpy()
        if self.kind == 'raw':
            # NUL-free text cannot contain a pattern with a 0x00 byte, and
            # the raw packing cannot represent one: resolve on the host.
            jpos = np.arange(patterns.shape[1])[None, :]
            has_nul = np.any(
                (patterns == 0) & (jpos < lengths[:, None]), axis=1
            )
            if has_nul.any():
                lo = np.where(has_nul[None, :], 0, lo)
                cnt = np.where(has_nul[None, :], 0, cnt)
        return lo, cnt
