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
(:func:`~.mesh.pad_chunk_count`).

:func:`make_giant_chunk_build` (B14g) builds ONE row's suffix array with
its positions split over every placement of the mesh: B9 as a sample sort
a round (see :class:`_GiantBuild`).
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from ..ops.search import probe_bytes
from ..ops.suffix_array import (
    BYTE_INIT_WIDTH,
    BYTE_KEY_BITS,
    GIANT_MAX_SHARDS,
    _check_width,
    _key_width,
    giant_byte_keys,
    giant_cuts,
    giant_flags,
    giant_merge,
    giant_partition,
    giant_relabel,
    giant_round_keys,
    radix_sort_pairs,
    sa_full_doubling,
    sa_roll_front,
    scatter,
)
from .mesh import (
    Mesh,
    all_gather_rows,
    all_reduce_sum,
    exchange_runs,
    gather_shards,
    rank_rows,
    shard_places,
)


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


class _GiantBuild:
    """One call of :func:`make_giant_chunk_build`: B9 (the JAX
    ``_doubling_kernel``) on a padded uint8 [N] row whose positions are
    split in S = ``mesh.size`` blocks of B = N / S, shard s owning [s * B,
    (s + 1) * B), as a sample sort a round over the shards.  A round sorts
    only the positions whose group is still tied, as B9 refines only its
    tied groups.

    1. Init: B9's 6-byte key of each block's positions (kernel (a),
       :func:`giant_byte_keys`), from the block's text and the 5 bytes
       after it, fetched from the shards that hold them.
    2. Sort every shard's (key, position) pairs locally
       (:func:`radix_sort_pairs`, stable, so equal keys stay in position
       order); S - 1 regular samples a shard, at r * m_s / S of its m_s
       sorted pairs, gathered; every (S - 1)-th of the sorted samples is a
       splitter.  The splitters are (key, position) pairs, so a run of
       equal keys (every early round of ``abab...``) can span shards;
       with regular sampling no shard then receives more than 2 max_s m_s
       + S pairs (``stats['max_recv']`` against ``stats['round_bound']``,
       at most ``stats['recv_bound']`` = 2B + S).
    3. Cut every sorted shard at the splitters (kernel (b),
       :func:`giant_cuts`) and exchange the pieces.  A shard receives S
       runs, each sorted by (key, position), in source order, which is
       position order, so merging them by (key, run) (:func:`giant_merge`,
       with the exchange's receive counts as the run lengths) leaves the
       shard in (key, position) order.
    4. Relabel in slot space (kernel (c)): the shards' merged pairs form
       one list in key order, which holds every member of each old group
       (the key's top bits, the group start g) contiguously, so a pair at
       list index J sits at slot g + J - f, f the list index of its old
       group's first member; a new group starts where the key differs from
       its predecessor's, at that slot.  :func:`giant_flags` gives each
       shard's carries (the largest g - f and J at old and new groups'
       first members) and its unsettled real pairs, read back with every
       shard's; :func:`giant_relabel` gives every pair its new group
       start, with the sign bit set where the pair is unsettled (its
       group has two members or more).  A shard's first pair's predecessor
       is the last key of the nearest non-empty earlier shard, its last
       pair's successor the first key of the nearest later one.  The build
       stops when no real pair (the positions below n) is left unsettled,
       B9's settled stop, or at k >= N.  Pads are not settled early: a
       real position's shifted rank may be a pad's.
    5. Otherwise the list goes home: each (position, group start) pair,
       partitioned by owner (kernel (b), :func:`giant_partition`, which
       also counts the unsettled pairs an owner receives), is stored into
       the owner's rank block (:func:`scatter`).  A settled position keeps
       its final slot there, so the block serves every ``rank[i + k]``.
    6. A round at k: the shifted ranks ``rank[i + k]`` of a block lie in
       at most two shards, fetched with one exchange whose other split
       sizes are 0 (none past N: they key as 0); the key ``rank[i] << W |
       (rank[i + k] + 1)`` (kernel (a), :func:`giant_round_keys`), W =
       bit_length(N) bits each, of the unsettled positions only, compacted
       in position order, as many as the send-home counted; then steps
       2-5 on those pairs.
    7. Finish: every real position's rank is its slot.  A process that
       holds every shard stores the last list's group starts into the
       rank blocks, its rows of one buffer, directly by position, then
       every position into sa_full by its slot (:func:`scatter` drops the
       unsettled pads' negative slots); over ranks the last list goes
       home, and each shard's real (slot, position) pairs are partitioned
       by the slot's owner, exchanged and stored.  The pad slots are
       written in closed form, [N - 1, ..., n].

    No step gathers the row on one shard.  Counts, splitters and
    per-shard summaries cross on the host; the pairs stay on the devices.
    """

    def __init__(self, mesh: Mesh, places, text: torch.Tensor, n: int):
        if text.dim() != 1:
            raise ValueError('make_giant_chunk_build: the row must be 1-D, '
                             f'got shape {tuple(text.shape)}')
        N, S = text.shape[0], mesh.size
        if N % S:
            raise ValueError(f'make_giant_chunk_build: a row of {N} slots '
                             f'does not split over {S} shards')
        if not 0 <= n <= N:
            raise ValueError(f'make_giant_chunk_build: need 0 <= n <= N, '
                             f'got n={n}, N={N}')
        self.W = _key_width(N)
        _check_width(N, self.W)
        self.mesh, self.places = mesh, places
        self.N, self.n, self.S, self.B = N, n, S, N // S
        B = self.B
        self.text = [text[s * B: (s + 1) * B].to(dev, torch.uint8)
                     .contiguous() for s, dev in places]
        #: The local shards' rank blocks, from the first send-home on: rows
        #: of one [shards, B] buffer a device (``rank_bufs``); and the
        #: unsettled positions each holds (the last send-home's count).
        self.rank: typing.List[torch.Tensor] = []
        self.rank_bufs: typing.Dict[torch.device, torch.Tensor] = {}
        self.live: typing.List[int] = []
        self.stats = {'shards': S, 'block': B, 'rounds': 0, 'sorted': [],
                      'tied_real': [], 'max_recv': [], 'round_bound': [],
                      'recv_bound': 2 * B + S}

    def _fetch(self, blocks, k: int, length: int) -> typing.List[torch.Tensor]:
        """Each local shard s's values at positions [s * B + k, s * B + k +
        length), cut at N, of the array held as ``blocks``: one exchange,
        each holder sending the part of its block in each window."""
        N, B, S = self.N, self.B, self.S
        sends, counts = [], []
        for (t, _), blk in zip(self.places, blocks):
            cnt, pieces = [], []
            for s in range(S):
                a = s * B + k
                lo, hi = max(a, t * B), min(a + length, N, (t + 1) * B)
                cnt.append(max(hi - lo, 0))
                if lo < hi:
                    pieces.append((lo - t * B, hi - t * B))
            if not pieces:
                send = blk[:0]
            elif all(p[1] == q[0] for p, q in zip(pieces, pieces[1:])):
                send = blk[pieces[0][0]: pieces[-1][1]]
            else:  # overlapping windows: blocks shorter than the halo
                send = torch.cat([blk[a:b] for a, b in pieces])
            sends.append((send,))
            counts.append(cnt)
        return [r[0] for r in exchange_runs(sends, counts, self.mesh)[0]]

    def _rows(self, width: int, dtype: torch.dtype):
        """One [shards on d, ``width``] tensor a device d of this process
        (by device) and every local shard's row of it, so that a step's
        results for all the shards of a device come back in one copy
        (:meth:`_read_rows`)."""
        shards: typing.Dict[torch.device, int] = {}
        for _, dev in self.places:
            shards[dev] = shards.get(dev, 0) + 1
        bufs = {dev: torch.empty((k, width), dtype=dtype, device=dev)
                for dev, k in shards.items()}
        rows, taken = [], dict.fromkeys(bufs, 0)
        for _, dev in self.places:
            rows.append(bufs[dev][taken[dev]])
            taken[dev] += 1
        return bufs, rows

    def _read_rows(self, bufs) -> typing.List[typing.List[int]]:
        """Every local shard's row of :meth:`_rows`' tensors on the host:
        one copy, and one wait, a device."""
        host = {dev: iter(buf.tolist()) for dev, buf in bufs.items()}
        return [next(host[dev]) for _, dev in self.places]

    def _splitters(self, g: np.ndarray, dev: torch.device):
        """The (key, position) splitters ``g`` int64 [S - 1, 2] on ``dev``
        in one copy: an int64 buffer of the keys, then the positions packed
        as int32; returns (keys int64, positions int32) views of it."""
        s = g.shape[0]
        host = np.zeros(s + (s + 1) // 2, np.int64)
        host[:s] = g[:, 0]
        host[s:].view(np.int32)[:s] = g[:, 1]
        buf = torch.from_numpy(host)
        if dev.type == 'cuda':
            buf = buf.pin_memory().to(dev, non_blocking=True)
        else:
            buf = buf.to(dev)
        return buf[:s], buf[s:].view(torch.int32)[:s]

    def _splits(self, keys, vals):
        """Every local shard's sorted pairs cut at the S - 1 splitters:
        (the counts each sends to shards 0..S-1, every shard's m_s).  A
        shard's samples go out with its m_s (an empty shard's are above
        every pair); the splitters go to each device once and the cuts
        come back once a device."""
        S = self.S
        if S == 1:
            return [[kk.shape[0]] for kk in keys], [keys[0].shape[0]]
        samples = []
        for (_, dev), kk, vv in zip(self.places, keys, vals):
            m = kk.shape[0]
            smp = torch.zeros((S, 2), dtype=torch.int64, device=dev)
            if m:
                pick = torch.arange(1, S, device=dev) * m // S
                smp[:S - 1, 0] = kk[pick]
                smp[:S - 1, 1] = vv[pick]
            else:  # above every pair: keys are below 2^63 - 1
                smp[:S - 1, 0] = np.iinfo(np.int64).max
                smp[:S - 1, 1] = np.iinfo(np.int32).max
            smp[S - 1, 0] = m
            samples.append(smp)
        g = gather_shards(samples, self.mesh).numpy()
        ms = [int(m) for m in g[:, S - 1, 0]]
        g = g[:, : S - 1].reshape(-1, 2)
        g = g[np.lexsort((g[:, 1], g[:, 0]))][S - 2::S - 1][:S - 1]
        bufs, rows = self._rows(S - 1, torch.int64)
        splitters = {dev: self._splitters(g, dev) for dev in bufs}
        for (_, dev), kk, vv, row in zip(self.places, keys, vals, rows):
            giant_cuts(kk, vv, *splitters[dev], out=row)
        counts = []
        for (_, dev), kk, cuts in zip(self.places, keys,
                                      self._read_rows(bufs)):
            edges = [0] + cuts + [kk.shape[0]]
            counts.append([edges[d + 1] - edges[d] for d in range(S)])
        return counts, ms

    def _sort_relabel(self, keys: list, vals: list, bits: int, shift: int,
                      real_lo: int):
        """Steps 2-4 on the local shards' (key, position) pairs, which the
        lists give up: (positions, group starts marked where unsettled,
        unsettled real pairs over every shard)."""
        S = self.S
        for kk, vv in zip(keys, vals):
            radix_sort_pairs(kk, vv, bits)
        counts, ms = self._splits(keys, vals)
        self.stats['sorted'].append(sum(ms))
        self.stats['round_bound'].append(2 * max(ms) + S)
        sends = list(zip(keys, vals))
        keys.clear()
        vals.clear()
        recvs, runs = exchange_runs(sends, counts, self.mesh)
        del sends
        metas = []
        for j, (_, dev) in enumerate(self.places):
            kk, vv = giant_merge(*recvs[j], runs[j])
            recvs[j] = (kk, vv)
            meta = torch.full((3,), -1, dtype=torch.int64, device=dev)
            meta[0] = kk.shape[0]
            if kk.shape[0]:
                meta[1] = kk[0]
                meta[2] = kk[-1]
            metas.append(meta)
        meta = gather_shards(metas, self.mesh).tolist()
        sizes = [m for m, _, _ in meta]
        offs = [sum(sizes[:s]) for s in range(S)]
        self.stats['max_recv'].append(max(sizes))
        ends, sts = [], []
        for (s, _), (kk, _) in zip(self.places, recvs):
            pred = next((meta[t][2] for t in range(s - 1, -1, -1)
                         if sizes[t]), None)
            succ = next((meta[t][1] for t in range(s + 1, S) if sizes[t]),
                        None)
            ends.append((pred, succ))
            sts.append(giant_flags(kk, offs[s], pred, succ, shift, real_lo))
        st = gather_shards(sts, self.mesh).tolist()
        pos, gs = [], []
        for (s, _), (pred, succ) in zip(self.places, ends):
            kk, vv = recvs.pop(0)
            carry_a = max([-1] + [a for a, _, _ in st[:s]])
            carry_b = max([-1] + [b for _, b, _ in st[:s]])
            gs.append(giant_relabel(kk, offs[s], pred, succ, shift, carry_a,
                                    carry_b))
            pos.append(vv)
            del kk, vv
        tied = sum(t for _, _, t in st)
        self.stats['tied_real'].append(tied)
        return pos, gs, tied

    def _send_home(self, pos: list, gs: list) -> None:
        """Step 5: every (position, group start) pair into its owner's rank
        block, and every local shard's count of unsettled positions into
        ``live``; the lists are given up."""
        S, B = self.S, self.B
        if not self.rank:
            self.rank_bufs, self.rank = self._rows(B, torch.int32)
        sends = []
        bufs, rows = self._rows(2 * S, torch.int32)
        for row in rows:
            p, g, _ = giant_partition(pos.pop(0), gs.pop(0), B, S,
                                      totals=row[:S], live=row[S:])
            sends.append((p, g))
            del p, g
        host = self._read_rows(bufs)
        recvs, _, tally = exchange_runs(sends, [h[:S] for h in host],
                                        self.mesh, [h[S:] for h in host])
        del sends
        for (p, g), rank in zip(recvs, self.rank):
            scatter(g, p, out=rank)
        self.live = [sum(t) for t in tally]

    def _place_all(self, pos: list, gs: list) -> torch.Tensor:
        """Step 7 in a process that holds every shard: sa_full [N] on its
        first placement.  With no round the init's list is every position
        in slot order.  Otherwise the rank blocks, one [N] array by
        position (the shards' rows of one buffer, or copied together),
        take the last list's group starts, and one store by slot writes
        every settled position: only unsettled pads, marked negative, are
        dropped."""
        first = self.places[0][1]
        if not self.rank:
            return torch.cat([p.to(first) for p in pos])
        if len(self.rank_bufs) == 1:
            ranks = self.rank_bufs[first].view(-1)
        else:
            ranks = torch.cat([r.to(first) for r in self.rank])
        self.rank, self.rank_bufs = [], {}
        # The last list in one store: each of several would visit every
        # bin of the row.
        scatter(torch.cat([g.to(first) for g in gs]),
                torch.cat([p.to(first) for p in pos]), out=ranks)
        pos.clear()
        gs.clear()
        return scatter(None, ranks, torch.empty(self.N, dtype=torch.int32,
                                                device=first))

    def _place_block(self, pos: list, gs: list) -> torch.Tensor:
        """Step 7 over ranks: this rank's slots of sa_full, its real
        positions' (slot, position) pairs exchanged by the slot's owner."""
        B, n = self.B, self.n
        self._send_home(pos, gs)
        (t, dev), = self.places
        c = min(max(n - t * B, 0), B)
        p, g, counts = giant_partition(
            self.rank[0][:c],
            torch.arange(t * B, t * B + c, dtype=torch.int32, device=dev),
            B, self.S)
        (slots, where), = exchange_runs([(p, g)], [counts.tolist()],
                                        self.mesh)[0]
        del p, g
        return scatter(where, slots,
                       torch.empty(B, dtype=torch.int32, device=dev))

    def run(self) -> torch.Tensor:
        B, n, N, W = self.B, self.n, self.N, self.W
        halo = self._fetch(self.text, B, BYTE_INIT_WIDTH - 1)
        keys, vals = [], []
        for (s, _), t, h in zip(self.places, self.text, halo):
            kk, vv = giant_byte_keys(t, h, s * B, n)
            keys.append(kk)
            vals.append(vv)
            del kk, vv
        del halo
        # The init's keys are below 2^63: one old group, pad keys 0.
        pos, gs, tied = self._sort_relabel(keys, vals, BYTE_KEY_BITS, 63,
                                           int(n < N))
        k = BYTE_INIT_WIDTH
        while k < N and tied:
            self._send_home(pos, gs)
            r2 = self._fetch(self.rank, k, B)
            for (s, _), rank, live in zip(self.places, self.rank, self.live):
                kk, vv, _ = giant_round_keys(rank, r2.pop(0), W, s * B, live)
                keys.append(kk)
                vals.append(vv)
                del kk, vv
            pos, gs, tied = self._sort_relabel(keys, vals, 2 * W, W,
                                               (N - n) << W)
            self.stats['rounds'] += 1
            k *= 2
        if len(self.places) == self.S:
            out, lo = self._place_all(pos, gs), 0
        else:
            out, lo = self._place_block(pos, gs), self.places[0][0] * B
        self.rank, self.rank_bufs = [], {}
        c = min(max(N - n - lo, 0), out.shape[0])
        if c:
            top = N - 1 - lo
            out[:c] = torch.arange(top, top - c, -1, dtype=torch.int32,
                                   device=out.device)
        return out


def make_giant_chunk_build(mesh: Mesh) -> typing.Callable:
    """B14g: ``(text_padded [N] uint8, n) -> sa_full``, the SA build of ONE
    row with its positions split over every placement of ``mesh``, for a
    row whose build working set exceeds one device.  It computes exactly
    :func:`~..ops.suffix_array.suffix_array_device`: pad-first, [N - 1,
    ..., n] then the SA of ``text_padded[:n]``.  The row comes as a host
    array or a tensor, whole, on every rank; each process gets its
    contiguous N / world slots of ``sa_full`` on its first placement (a
    one-process mesh all [N]), as the JAX ``P(CHUNK_AXIS)`` out-sharding
    gives them.  The mesh is one process with S placements (which may
    all be one card) or S ranks with one placement each; S must divide N.
    The callable's ``stats`` describe its last call: ``rounds`` after the
    init; per sort, ``sorted`` (the pairs it sorted: N at the init, then
    the positions still tied, pads included), ``tied_real`` (the real
    positions left tied after its relabel), ``max_recv`` (the most pairs
    a shard received) and ``round_bound`` (2 max_s m_s + S, m_s the pairs
    shard s sorted); and ``recv_bound`` (2B + S, the bound of every
    sort).  See :class:`_GiantBuild`."""
    places = shard_places(mesh)
    if mesh.size > GIANT_MAX_SHARDS:
        raise ValueError(f'make_giant_chunk_build: at most '
                         f'{GIANT_MAX_SHARDS} shards, the mesh has '
                         f'{mesh.size}')

    def build(text_padded, n):
        job = _GiantBuild(mesh, places, _tensor(text_padded), int(n))
        build.stats = job.stats
        return job.run()

    build.stats = {}
    return build
