"""Device-resident substring index: probe rows of stacked, padded tensors
on one device,

    text   [C, n_pad] uint8     sa     [C, n_pad] int32    lengths [C] int32
    tables [C, base^depth+1] int32    limbs  [C, num_limbs * n_pad] int32

and a query batch is answered by one probe launch over all rows: the
phased probe (ops/search.py:probe_phased) for the ranked and raw kinds, the
digit-limb probe (ops/search.py:probe_limbs) for the digit kind.

Two ways to build it, as in the JAX package:

- upload: every container chunk is one row and its SA comes from the
  container; the text and SA are uploaded.
- derive: the container's chunks are concatenated into merged rows of up
  to ``TPUSS_MERGE_CAP`` bytes (default ``MERGE_CAP_DEFAULT``;
  ``TPUSS_MERGE=0`` keeps a chunk a row), only their text is uploaded, and
  each row's SA is built on the device (ops/suffix_array.py: B1 and B2 for a
  ranked alphabet, B1b and B2 for the raw and digit kinds; B10 for every
  kind on rows padded past ``SEGMENTED_MAX_N``, such as one default 512
  MiB chunk, with B9 for a row B10 flags as poisoned).  A merged row can
  match an occurrence that spans a source-chunk boundary;
  :meth:`count_matches` and the Reader's extraction drop those.

Either way the limb planes and seed tables are built on the device from
the rows' text and SA (ops/search.py): K1-K3 for the ranked kind, K7 with
K3 and K6 for the raw kind, B12d (K7 at base 258 with K3, and the digit
limb planes) for the digit kind; the limb planes gather the text.

:meth:`DeviceIndex.plan` makes the rows' geometry alone, with nothing on
the device, and :meth:`DeviceIndex.probe_device_parts` leaves a probe's
bounds on the device for callers that read them there.
"""

from __future__ import annotations

import os
import typing

import numpy as np
import torch

from ..container import Chunk
from ..ops import search as search_ops
from ..ops.suffix_array import (
    SA_BUILD_BYTES_PER_SLOT,
    _pad_len,
    derive_sa,
    derive_sa_full,
)
from ..utils.profiling import PhaseProfiler


def _device_budget(device: torch.device) -> int:
    """Device memory bytes the index may fill: 85% of what is free now,
    counting the blocks PyTorch's caching allocator holds for no tensor
    (this process reuses them; a Writer's card build just before leaves
    tens of GiB there), so the probe's scratch still fits.  The CPU is not
    metered."""
    if device.type == 'cpu':
        return 1 << 62
    free, _ = torch.cuda.mem_get_info(device)
    cached = (torch.cuda.memory_reserved(device)
              - torch.cuda.memory_allocated(device))
    return int((free + cached) * 0.85)


def _merge_groups(sizes: typing.Sequence[int],
                  cap: int) -> typing.List[typing.List[int]]:
    """Balanced split of consecutive chunks into rows: rows are stacked as
    one padded [C, n_pad] array, so a lopsided tail row wastes memory for
    every row and a plain greedy fill makes one.  Each row aims at
    total / ngroups bytes with the cap as a hard ceiling."""
    total = sum(sizes)
    ngroups = max(1, -(-total // cap))
    target = total / ngroups
    groups: typing.List[typing.List[int]] = []
    cur: typing.List[int] = []
    size = 0
    for i, s in enumerate(sizes):
        if cur and (size + s > cap or size >= target):
            groups.append(cur)
            cur, size = [], 0
        cur.append(i)
        size += s
    if cur:
        groups.append(cur)
    return groups


class DeviceIndex:
    """Stacked padded rows on one device."""

    #: Rows at least this long get the digit kind's 3-digit bucket table
    #: (258^3 + 1 entries), shorter ones the 2-digit table, as in the JAX
    #: package.
    DEEP_TABLE_MIN_CHUNK = 8 << 20

    #: Text bytes of a merged derive row at most (a longer single chunk
    #: stays one row): its padded row of 256 or 272 MiB is the size the
    #: JAX package derives.  The default of ``TPUSS_MERGE_CAP``, both read
    #: at construction.
    MERGE_CAP_DEFAULT = 256 << 20

    def __init__(
        self,
        chunks: typing.Sequence[Chunk],
        *,
        device: typing.Union[str, torch.device] = 'cuda',
        num_limbs: typing.Optional[int] = None,
        mode: str = 'auto',
        merge: typing.Optional[bool] = None,
        profiler: typing.Optional[PhaseProfiler] = None,
    ) -> None:
        """``mode``:

        - ``'upload'``: each container chunk is one row, with its SA from
          the container;
        - ``'derive'``: upload the text only and build each row's SA on the
          device; with ``merge`` (default on; ``TPUSS_MERGE=0`` turns it
          off when ``merge`` is None) the chunks are concatenated into rows
          of up to ``TPUSS_MERGE_CAP`` bytes (default
          ``MERGE_CAP_DEFAULT``);
        - ``'auto'``: derive on a CUDA device, upload on the CPU, as the
          JAX package derives on an accelerator.

        The kind follows the alphabet, as in the JAX package: ``ranked``
        (at most 62 distinct bytes), ``raw`` (more, without NUL) or
        ``digit`` (more, with NUL: base-258 digits, bucket depth 3 for rows
        of at least ``DEEP_TABLE_MIN_CHUNK`` bytes, else 2).

        ``profiler`` records the build's phases, each device phase ending
        in a synchronise: ``index-alphabet`` (the byte-presence scan that
        picks the kind), ``index-alloc`` (the zeroed device rows),
        ``index-h2d`` (the uploads), ``index-aux`` (limb planes and seed
        tables); upload adds ``index-host-copy`` (container views into
        aligned host arrays), derive ``index-merge`` (the host
        concatenation of merged rows) and ``index-sa`` (each row's SA
        build: B1 or B1b and B2, or B10, and B9 after a poisoned B10).

        The index keeps ``profiler`` (or its own) for its probes' phases,
        which nest inside the Reader's ``probe``: ``probe-upload`` (the
        patterns and lengths to the device), ``probe-kernel`` (the K4 or
        B11 launch, enqueued only), ``probe-readback`` (the bounds'
        ``torch.stack`` and the blocking copy to the host, the wait for the
        kernel included) and, for the raw kind, ``probe-nul`` (the host
        mask of patterns that hold NUL)."""
        prof = profiler if profiler is not None else PhaseProfiler()
        self._plan(chunks, device, mode, merge, num_limbs, prof)
        self._build(chunks, prof)

    @classmethod
    def plan(
        cls,
        chunks: typing.Sequence[Chunk],
        *,
        device: typing.Union[str, torch.device] = 'cuda',
        num_limbs: typing.Optional[int] = None,
        mode: str = 'auto',
        merge: typing.Optional[bool] = None,
        profiler: typing.Optional[PhaseProfiler] = None,
    ) -> 'DeviceIndex':
        """A geometry-only instance: every planning attribute (``kind``,
        ``mode``, ``groups``, ``row_data``, ``boundaries``,
        ``group_offsets``, ``n_pad``, ``num_limbs``, the table parameters,
        :attr:`cover_bytes`, :meth:`probe_class_keys`) and no tensor on
        the device; the arguments are the constructor's.
        :meth:`warm_probe` on it builds the kernel library before the
        index exists."""
        self = cls.__new__(cls)
        self._plan(chunks, device, mode, merge, num_limbs,
                   profiler if profiler is not None else PhaseProfiler())
        return self

    def _plan(self, chunks: typing.Sequence[Chunk], device, mode: str,
              merge: typing.Optional[bool], num_limbs: typing.Optional[int],
              prof: PhaseProfiler, shares: int = 1) -> None:
        """Everything decided over all chunks before any row is built: the
        kind, mode, rows (``groups``, ``row_data``, geometry), table
        parameters, ``n_pad``, ``num_limbs`` and the rank maps.  With
        ``shares`` > 1 the rows are padded with empty ones (n = 0, no
        source chunk, never a hit) to a multiple of ``shares``, and the
        limb budget meters one share of them, as the JAX index does for a
        mesh."""
        if mode not in ('auto', 'upload', 'derive'):
            raise ValueError(f'unknown DeviceIndex mode: {mode!r}')
        self._prof = prof
        self.device = torch.device(device)
        self.num_source_chunks = len(chunks)
        # Limb encoding: rank-packed digits for alphabets of at most 62
        # bytes (NUL-safe), raw 4-byte packing for larger NUL-free ones,
        # base-258 digits for large alphabets with NUL.
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
            self.kind = 'digit'
        if mode == 'auto':
            mode = 'derive' if self.device.type == 'cuda' else 'upload'
        self.mode = mode
        self._bits = bits
        if merge is None:
            merge = os.environ.get('TPUSS_MERGE', '1') != '0'
        merge = merge and mode == 'derive' and len(chunks) > 1
        if merge:
            cap = int(os.environ.get('TPUSS_MERGE_CAP',
                                     str(self.MERGE_CAP_DEFAULT)))
            with prof.phase('index-merge'):
                self.groups = _merge_groups(
                    [c.data.size for c in chunks], cap
                )
                self.row_data = [
                    chunks[g[0]].data if len(g) == 1
                    else np.concatenate([chunks[i].data for i in g])
                    for g in self.groups
                ]
        else:
            self.groups = [[i] for i in range(len(chunks))]
            self.row_data = [c.data for c in chunks]
        while self.groups and len(self.groups) % shares:
            self.groups.append([])
            self.row_data.append(np.zeros(0, dtype=np.uint8))
        self._set_geometry([[chunks[i].data.size for i in g]
                            for g in self.groups])
        max_n = max([d.size for d in self.row_data] + [1])
        if self.kind == 'digit':
            rank, present = search_ops.identity_rank()
            pres = present > 0
            self._base = search_ops._RADIX
            self._depth = 3 if max_n >= self.DEEP_TABLE_MIN_CHUNK else 2
        else:
            rank, sigma = search_ops.alphabet_rank(pres)
            self._base, self._depth = search_ops.pick_table_params(sigma,
                                                                   max_n)
        self.n_pad = _pad_len(max_n + search_ops.PAD_MARGIN)
        # Host arrays: the plan places nothing on the device (_build does).
        self._rank_host = np.asarray(rank, dtype=np.int32)
        self._present_host = pres.astype(np.int32)
        self._lengths_host = np.array([d.size for d in self.row_data],
                                      dtype=np.int32)
        self.num_limbs = (
            self._auto_num_limbs(shares) if num_limbs is None else num_limbs
        )

    def _part(self, rows: slice, device) -> 'DeviceIndex':
        """An unbuilt index of this plan's rows ``rows`` on ``device``: the
        plan's kind, tables, ``n_pad`` and limbs, its own rows' groups and
        geometry.  :meth:`_build` then fills its arrays."""
        part = DeviceIndex.__new__(DeviceIndex)
        part.__dict__.update(self.__dict__)
        part.device = torch.device(device)
        part.groups = self.groups[rows]
        part.row_data = self.row_data[rows]
        part.boundaries = self.boundaries[rows]
        part.group_offsets = self.group_offsets[rows]
        part.num_chunks = len(part.groups)
        part.merged = any(len(g) > 1 for g in part.groups)
        part._lengths_host = self._lengths_host[rows]
        return part

    def _build(self, chunks: typing.Sequence[Chunk],
               prof: PhaseProfiler) -> None:
        """The planned rows' arrays on the device: text and SA (uploaded,
        or the SA derived), then limb planes and seed tables."""
        C, n_pad = self.num_chunks, self.n_pad
        #: Per row (derive mode), as ``derive_sa`` reports them: the tie
        #: count m of every B2 round, or on a B10 row a list per round of
        #: its passes' m_w; and whether B10 found the row poisoned (B9 then
        #: re-derived it).
        self.sa_ties: typing.List[list] = []
        self.sa_poisoned: typing.List[bool] = []
        with prof.phase('index-alloc'):
            self.rank = torch.as_tensor(self._rank_host, device=self.device)
            self.present = torch.as_tensor(self._present_host,
                                           device=self.device)
            self.lengths = torch.as_tensor(self._lengths_host,
                                           device=self.device)
            self.text = torch.zeros((C, n_pad), dtype=torch.uint8,
                                    device=self.device)
            self.sa = torch.zeros((C, n_pad), dtype=torch.int32,
                                  device=self.device)
            self._sync()
        if self.mode == 'derive':
            self._derive_sa(prof)
        else:
            self._upload(chunks, prof)
        table_len = self._base ** self._depth + 1
        with prof.phase('index-aux'):
            self._build_aux(table_len)
            self._sync()

    def _set_geometry(self, sizes: typing.List[typing.List[int]]) -> None:
        """Row geometry from each row's source-chunk sizes: ``merged``,
        ``boundaries`` (the interior source-chunk end offsets of each row)
        and ``group_offsets`` (each source chunk's start in its row)."""
        self.num_chunks = len(sizes)  # probe rows
        self.merged = any(len(s) > 1 for s in sizes)
        self.boundaries = [np.cumsum(s, dtype=np.int64)[:-1] for s in sizes]
        self.group_offsets = [
            np.concatenate(([0], b)).astype(np.int64) for b in self.boundaries
        ]

    def _sync(self) -> None:
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)

    def _upload(self, chunks: typing.Sequence[Chunk],
                prof: PhaseProfiler) -> None:
        for i, g in enumerate(self.groups):
            if not g:  # a padding row stays empty
                continue
            c = chunks[g[0]]
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

    def _derive_sa(self, prof: PhaseProfiler) -> None:
        """Pass 1 of derive: per row, upload the text into ``text[i]`` and
        derive the SA into ``sa[i]``.  The limb planes are allocated only
        after this pass, once every row's SA-build scratch is freed."""
        for i, d in enumerate(self.row_data):
            if d.size == 0:  # a padding row keeps its zero SA
                self.sa_ties.append([])
                self.sa_poisoned.append(False)
                continue
            with prof.phase('index-h2d'):
                # Singleton rows are the container's read-only mmap views,
                # which torch cannot wrap; merged rows are fresh arrays.
                host = d if d.flags.writeable else np.array(d)
                self.text[i, : d.size] = torch.from_numpy(host)
                self._sync()
            with prof.phase('index-sa'):
                # B1 on the rank digits for the ranked kind, B1b on the
                # bytes (bits None) for the raw and digit kinds; B10 on
                # the bytes for every kind past SEGMENTED_MAX_N.
                _, ties, poisoned = derive_sa(
                    self.text[i], d.size,
                    self.rank if self.kind == 'ranked' else None,
                    self._bits, out=self.sa[i],
                )
                if poisoned:
                    # A group too big for B10's windows: re-derive by
                    # full-sort doubling, as the JAX index does.
                    derive_sa_full(self.text[i], d.size, out=self.sa[i])
                self.sa_ties.append(ties)
                self.sa_poisoned.append(poisoned)
                self._sync()

    def _build_aux(self, table_len: int) -> None:
        """Limb planes and seed tables of every row on the device, through
        one int32 [n_pad] scratch row: K1, then K3 from the ranked pack; or
        K7 and K3 from the prefix values; or, for the digit kind, B12d's
        table (K7 at the bucket depth, K3).  The limb planes (K2, K6 or
        B12d's) are gathered from the text itself."""
        C, n_pad, bits = self.num_chunks, self.n_pad, self._bits
        base, depth, K = self._base, self._depth, self.num_limbs
        self.tables = torch.empty((C, table_len), dtype=torch.int32,
                                  device=self.device)
        self.limbs = torch.empty((C, K * n_pad), dtype=torch.int32,
                                 device=self.device)
        scratch = torch.empty(n_pad, dtype=torch.int32, device=self.device)
        for i, d in enumerate(self.row_data):
            text, sa, n = self.text[i], self.sa[i], d.size
            if self.kind == 'ranked':
                search_ops.ranked_pack(text, n, self.rank, bits, out=scratch)
                search_ops.seed_table(scratch, sa, n, base, depth, bits,
                                      out=self.tables[i])
                search_ops.ranked_limb_planes(text, sa, n, self.rank, depth,
                                              bits, K, out=self.limbs[i])
            elif self.kind == 'digit':
                search_ops.digit_bucket_table(text, sa, n, depth,
                                              out=self.tables[i],
                                              scratch=scratch)
                search_ops.digit_limb_planes(text, sa, n, K,
                                             out=self.limbs[i])
            else:
                search_ops.seed_prefix(text, n, self.rank, base, depth,
                                       out=scratch)
                search_ops.seed_table_from_prefix(scratch, sa, n, base, depth,
                                                  out=self.tables[i])
                search_ops.raw_limb_planes(text, sa, n, depth, K,
                                           out=self.limbs[i])

    @classmethod
    def from_arrays(
        cls,
        arrays: typing.Mapping[str, np.ndarray],
        meta: typing.Mapping[str, typing.Any],
        device: typing.Union[str, torch.device] = 'cuda',
    ) -> 'DeviceIndex':
        """An index over state built elsewhere (the JAX package's index,
        read back as numpy).  ``arrays``: ``text``, ``lengths``, ``sa``,
        ``tables``, ``limbs``, ``rank``, ``present``; ``meta``: ``kind``,
        ``bits``, ``base``, ``depth``, ``num_limbs``, and for merged rows
        ``mode``, ``groups`` (the source chunks of every row) and
        ``boundaries`` (their interior end offsets in the row).  The
        arrays go to ``device``, the CUDA card unless the caller names
        another; without one, ``'cuda'`` raises."""
        if meta['kind'] not in ('ranked', 'raw', 'digit'):
            raise ValueError(f"unknown index kind: {meta['kind']!r}")
        self = cls.__new__(cls)
        self._prof = PhaseProfiler()
        self.mode = meta.get('mode', 'upload')
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                "DeviceIndex.from_arrays(device='cuda') needs a CUDA device; "
                "pass device='cpu' to run the plain PyTorch kernels"
            )

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
        self.sa_ties, self.sa_poisoned = [], []
        C, self.n_pad = self.text.shape
        lengths = np.asarray(arrays['lengths'])
        self.row_data = [
            np.asarray(arrays['text'])[i, : lengths[i]] for i in range(C)
        ]
        self.groups = [list(g) for g in meta.get('groups',
                                                 [[i] for i in range(C)])]
        bounds = meta.get('boundaries', [np.zeros(0, np.int64)] * C)
        self._set_geometry([
            np.diff(np.concatenate(([0], np.asarray(b, np.int64),
                                    [lengths[i]]))).tolist()
            for i, b in enumerate(bounds)
        ])
        self.num_source_chunks = sum(len(g) for g in self.groups)
        return self

    def _auto_num_limbs(self, shares: int = 1) -> int:
        """Most limb planes (at most RAW_LIMBS, or KEY_LIMBS for the digit
        kind; at least 1) whose footprint fits the device.  Resident per
        row: text (1 B) + SA (4 B) + one int32 per plane per slot, plus the
        seed table; besides that the aux build's one scratch row (the
        ranked pack, or the raw or digit kind's K7 values), and in derive mode one row's SA-build
        scratch (sort keys, values and their double buffers, the working
        rank and group starts; ops/suffix_array.SA_BUILD_BYTES_PER_SLOT).
        With rows split over ``shares`` devices, each device's share of
        the rows is metered."""
        C = max(self.num_chunks // shares, 1)
        table_bytes = 4 * (self._base ** self._depth + 1)
        fixed = C * (5 * self.n_pad + table_bytes) + 4 * self.n_pad
        if self.mode == 'derive':
            fixed += SA_BUILD_BYTES_PER_SLOT * self.n_pad
        fit = (_device_budget(self.device) - fixed) // (4 * C * self.n_pad)
        cap = (search_ops.KEY_LIMBS if self.kind == 'digit'
               else search_ops.RAW_LIMBS)
        return int(max(1, min(cap, fit)))

    def row_sa(self, r: int) -> torch.Tensor:
        """Row ``r``'s int32 [n_pad] SA on its device."""
        return self.sa[r]

    def boundary_crossings(self, patterns: np.ndarray,
                           lengths: np.ndarray) -> np.ndarray:
        """int32 [C, B]: occurrences counted by a merged-row probe that
        span a source-chunk boundary (not matches: the reference never
        matches across chunks).

        Every source chunk ends with ``\\n`` (Writer invariant), so a
        crossing occurrence contains a newline; patterns without one are
        exact for free.  For the rest, occurrences are counted in the
        2L-2 byte window around each boundary with an overlapping find; an
        occurrence spanning several boundaries is attributed to the first
        one it crosses (counted once)."""
        patterns = np.asarray(patterns)
        lengths = np.asarray(lengths)
        B = patterns.shape[0]
        out = np.zeros((self.num_chunks, B), dtype=np.int32)
        if not self.merged or B == 0:
            return out
        jpos = np.arange(patterns.shape[1])[None, :]
        has_nl = ((patterns == 0x0A) & (jpos < lengths[:, None])).any(axis=1)
        for bi in np.flatnonzero(has_nl):
            L = int(lengths[bi])
            if L < 2:
                continue
            pat = patterns[bi, :L].tobytes()
            for r, ends in enumerate(self.boundaries):
                if ends.size == 0:
                    continue
                data = self.row_data[r].tobytes()
                total = 0
                prev = 0
                for e in ends.tolist():
                    start = max(prev, e - L + 1)
                    window = data[start: e + L - 1]
                    o = window.find(pat)
                    while o != -1:
                        if start + o <= e - 1:  # starts before the boundary
                            total += 1
                        o = window.find(pat, o + 1)
                    prev = e
                out[r, bi] = total
        return out

    def count_matches(self, patterns: np.ndarray,
                      lengths: np.ndarray) -> np.ndarray:
        """int32 [C, B] exact per-row match counts: the probe's counts
        minus the boundary crossings of merged rows."""
        _, cnt = self.probe(patterns, lengths)
        return cnt - self.boundary_crossings(patterns, lengths)

    @property
    def cover_bytes(self) -> int:
        """Pattern bytes the seed table and the limb planes resolve; past
        them the probe refines on the text."""
        if self.kind == 'ranked':
            return search_ops.ranked_cover_bytes(self.num_limbs, self._depth,
                                                 self._bits)
        if self.kind == 'raw':
            return search_ops.raw_cover_bytes(self.num_limbs, self._depth)
        return search_ops.key_cover_bytes(self.num_limbs)

    def probe_class_keys(self, lengths: np.ndarray) -> list:
        """The launches a batch with these pattern lengths makes: ``[]``
        for the digit kind (one B11 launch, nothing to choose) and for an
        index without rows, as in the JAX package; else one key, K4's
        ``('probe_phased', kernel)``, where ``kernel`` is the one the
        batch's (row, pattern) pair count selects
        (``search_ops.PHASED_PAIRS_WIDE``).  The JAX package compiles a
        program per length class; K4 makes one launch a batch."""
        B = np.asarray(lengths).shape[0]
        if self.kind == 'digit' or self.num_chunks == 0 or B == 0:
            return []
        wide = self.num_chunks * B > search_ops.PHASED_PAIRS_WIDE
        return [('probe_phased', 'probe_phased_wide_kernel' if wide
                 else 'probe_phased_kernel')]

    def warm_probe(self, lengths: np.ndarray, parallel: bool = True) -> None:
        """Make the first probe of a batch with these pattern lengths cost
        what later ones do: on a CUDA index, build (or load) the kernel
        library, and on a built index launch one probe of the batch's
        shape.  ``parallel`` is the JAX signature's (it compiles its
        per-class programs in parallel); the port has one library."""
        del parallel
        if self.device.type != 'cuda':
            return
        from ..ops import kernels

        kernels.library()
        lengths = np.asarray(lengths, dtype=np.int32)
        if lengths.size and hasattr(self, 'text'):
            pats = np.zeros((lengths.size, max(int(lengths.max()), 1)),
                            dtype=np.uint8)
            self.probe(pats, lengths)

    def probe_device_parts(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.List[typing.Tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
        """``[(members, lower, count)]``: the batch's probe on the device
        with no readback, as the JAX method returns it: ``members`` the
        host indices [B] of the patterns, ``lower`` and ``count`` int32
        [C, B] tensors on the index's device, from one launch (B11 for the
        digit kind, K4 for the others); one part, where the JAX package
        has one a length class.  On a merged row the count includes
        occurrences across a source-chunk boundary (see
        :meth:`boundary_crossings`), and for the raw kind a pattern that
        holds NUL keeps the kernel's unmasked bounds: :meth:`probe` zeroes
        them on the host, as the JAX ``probe`` does."""
        patterns = np.asarray(patterns, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        B = patterns.shape[0]
        members = np.arange(B)
        if self.num_chunks == 0 or B == 0 or patterns.shape[1] > self.n_pad:
            # A pattern wider than every row cannot match.
            zeros = torch.zeros((self.num_chunks, B), dtype=torch.int32,
                                device=self.device)
            return [(members, zeros, zeros.clone())]
        with self._prof.phase('probe-upload'):
            pats_d = torch.as_tensor(np.ascontiguousarray(patterns),
                                     device=self.device)
            lens_d = torch.as_tensor(lengths, device=self.device)
        with self._prof.phase('probe-kernel'):
            if self.kind == 'digit':
                # NUL is digit 1, so the digit kind needs no host check.
                lo, cnt = search_ops.probe_limbs(
                    self.text, self.lengths, self.sa, self.tables,
                    self.limbs, pats_d, lens_d, self.num_limbs,
                )
            else:
                lo, cnt = search_ops.probe_phased(
                    self.text, self.lengths, self.sa, self.tables,
                    self.limbs, self.rank, self.present, pats_d, lens_d,
                    self.num_limbs, self._base, self._depth, self._bits,
                )
        return [(members, lo, cnt)]

    def probe(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.Tuple[np.ndarray, np.ndarray]:
        """(lower, count) int32 [C, B] host arrays: the SA range of each
        pattern's matches in each row, :meth:`probe_device_parts` read back
        in one transfer.  On a merged row the count includes occurrences
        that span a source-chunk boundary (see
        :meth:`boundary_crossings`)."""
        patterns = np.asarray(patterns, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        B = patterns.shape[0]
        if self.num_chunks == 0 or B == 0 or patterns.shape[1] > self.n_pad:
            zeros = np.zeros((self.num_chunks, B), dtype=np.int32)
            return zeros, zeros.copy()
        # One part, every pattern of the batch in order.
        (_, lo_d, cnt_d), = self.probe_device_parts(patterns, lengths)
        with self._prof.phase('probe-readback'):
            lo, cnt = torch.stack((lo_d, cnt_d)).cpu().numpy()
        if self.kind == 'raw':
            # NUL-free text cannot contain a pattern with a 0x00 byte, and
            # the raw packing cannot represent one: resolve on the host.
            with self._prof.phase('probe-nul'):
                jpos = np.arange(patterns.shape[1])[None, :]
                has_nul = np.any(
                    (patterns == 0) & (jpos < lengths[:, None]), axis=1
                )
                if has_nul.any():
                    lo = np.where(has_nul[None, :], 0, lo)
                    cnt = np.where(has_nul[None, :], 0, cnt)
        return lo, cnt
