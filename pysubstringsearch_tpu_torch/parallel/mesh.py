"""The 1-D mesh over the corpus-chunk axis, on ``torch.distributed``.

The JAX package splits [C, ...] chunk-major arrays along axis 0 over a 1-D
device ``Mesh`` (``P(CHUNK_AXIS)``), replicates the query batch, and joins
per-chunk results with collectives.  Here a mesh is the process group the
collectives run over, this process's rank in it and its size, and the
devices this process places rows on: one for the chunk-parallel programs
(parallel/sharded.py), which run one rank per device, or several for a
single-process ``ShardedReader``.

Rows split in contiguous blocks, as ``P(CHUNK_AXIS)`` splits axis 0: the
row count is padded to a multiple of the mesh size with n = 0 rows (which
never produce hits), and placement k owns rows ``[k * C / size, (k + 1) *
C / size)``.  Collectives go over the mesh's group (NCCL for CUDA tensors,
gloo for CPU tensors, as the group was made); without an initialised
``torch.distributed`` the mesh is a world of one and they are the
identity.

One row split over every placement (``make_giant_chunk_build``) holds its
shards as :func:`shard_places` lists them, and moves data between them
with :func:`exchange_runs` (an all-to-all with split sizes) and
:func:`gather_shards` (small per-shard tensors to every process).
"""

from __future__ import annotations

import dataclasses
import typing

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's row placements; ``group``: the process
    group of the collectives (None: the default group); ``rank`` and
    ``world``: this process's place in it; ``distributed``: whether
    ``torch.distributed`` was initialised (else the collectives are the
    identity)."""

    devices: typing.Tuple[torch.device, ...]
    group: typing.Any = None
    rank: int = 0
    world: int = 1
    distributed: bool = False

    @property
    def size(self) -> int:
        """Row placements over the whole mesh."""
        return self.world * len(self.devices)

    @property
    def device(self) -> torch.device:
        """This rank's one device (the chunk-parallel programs')."""
        if len(self.devices) != 1:
            raise ValueError(
                f'the chunk-parallel programs run one device per rank; this '
                f'mesh places rows on {len(self.devices)}'
            )
        return self.devices[0]


def make_mesh(device: typing.Union[str, torch.device, typing.Sequence] =
              'cuda', group=None) -> Mesh:
    """The mesh of this process: ``device`` (one, or a sequence of row
    placements) in ``group`` (None: the default group).  With
    ``torch.distributed`` uninitialised it is a world of one, as the JAX
    ``make_mesh()`` spans whatever devices exist.  A bare ``'cuda'`` in a
    world of several ranks means this rank's card, ``cuda:<rank mod
    device count>``."""
    if isinstance(device, (str, torch.device)):
        devices = (torch.device(device),)
    else:
        devices = tuple(torch.device(d) for d in device)
    if not devices:
        raise ValueError('a mesh needs at least one device')
    if dist.is_available() and dist.is_initialized():
        rank = dist.get_rank(group)
        world = dist.get_world_size(group)
        if (world > 1 and len(devices) == 1 and devices[0].type == 'cuda'
                and devices[0].index is None):
            devices = (torch.device('cuda',
                                    rank % torch.cuda.device_count()),)
        return Mesh(devices, group, rank, world, True)
    if group is not None:
        raise ValueError('a process group needs torch.distributed '
                         'initialised')
    return Mesh(devices)


def pad_chunk_count(c: int, mesh: Mesh) -> int:
    """Chunk count rounded up to a multiple of the mesh size (padding rows
    carry n = 0 and never produce hits)."""
    d = mesh.size
    return -(-c // d) * d


def rank_rows(c: int, mesh: Mesh) -> slice:
    """This rank's contiguous block of ``c`` rows; ``c`` must be a multiple
    of the world size (see :func:`pad_chunk_count`)."""
    if c % mesh.world:
        raise ValueError(
            f'{c} rows do not split over {mesh.world} ranks; pad them to '
            'pad_chunk_count'
        )
    per = c // mesh.world
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def all_gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's [c, ...] block stacked in rank order, [world * c, ...],
    on every rank (the JAX ``all_gather(..., tiled=True)``)."""
    if not mesh.distributed:
        return local
    local = local.contiguous()
    c = local.shape[0]
    out = local.new_empty((mesh.world * c,) + tuple(local.shape[1:]))
    dist.all_gather([out[i * c: (i + 1) * c] for i in range(mesh.world)],
                    local, group=mesh.group)
    return out


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the ranks, in place and returned (the JAX
    ``psum``)."""
    if mesh.distributed:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.group)
    return x


def shard_places(mesh: Mesh) -> typing.List[typing.Tuple[int, torch.device]]:
    """The (shard, device) pairs this process holds of a program that
    splits one array over every placement of the mesh, shard s owning its
    s-th block: all of them on a one-process mesh (shard s on
    ``devices[s]``, which may all be one card), or shard ``rank`` on this
    rank's device over a group of ranks with one placement each.  A mesh
    of several ranks with several placements each raises."""
    if mesh.distributed and len(mesh.devices) == 1:
        return [(mesh.rank, mesh.devices[0])]
    if mesh.world == 1:
        return list(enumerate(mesh.devices))
    raise ValueError(
        f'a mesh of {mesh.world} ranks with {len(mesh.devices)} placements '
        'each: a program over every placement takes one rank with several, '
        'or ranks with one each'
    )


def _by_collectives(mesh: Mesh) -> bool:
    return mesh.distributed and len(mesh.devices) == 1


def exchange_runs(sends: typing.Sequence[typing.Sequence[torch.Tensor]],
                  counts: typing.Sequence[typing.Sequence[int]],
                  mesh: Mesh,
                  tally: typing.Optional[
                      typing.Sequence[typing.Sequence[int]]] = None):
    """All-to-all between the shards of :func:`shard_places`: ``sends[j]``
    holds local shard j's 1-D tensors (several of one length, moved
    alike), each the runs for shards 0..S-1 in order, ``counts[j][t]``
    elements for shard t.  Returns (``recvs``, ``recv_counts``):
    ``recvs[j]`` local shard j's tensors, the runs it received from shards
    0..S-1 concatenated in that order, on its device, and
    ``recv_counts[j][s]`` their lengths.  With ``tally`` (an int a run,
    ``tally[j][t]`` going with run t of local shard j) it also returns
    ``recv_tally[j][s]``, the tally of each received run, which crosses
    with the counts.  Over ranks the counts go first, then each tensor by
    ``all_to_all_single`` with split sizes (zeros included); between the
    placements of one process each run is a device copy."""
    if _by_collectives(mesh):
        (send,), (cnt,) = sends, counts
        dev = mesh.devices[0]
        rows = [[int(c)] for c in cnt]
        if tally is not None:
            rows = [r + [int(x)] for r, x in zip(rows, tally[0])]
        mine = torch.tensor(rows, dtype=torch.int64, device=dev)
        theirs = torch.empty_like(mine)
        dist.all_to_all_single(theirs, mine, group=mesh.group)
        got = theirs.tolist()
        rcnt = [r[0] for r in got]
        outs = []
        for x in send:
            out = x.new_empty(sum(rcnt))
            dist.all_to_all_single(out, x.contiguous(), rcnt,
                                   [int(c) for c in cnt], group=mesh.group)
            outs.append(out)
        if tally is None:
            return [tuple(outs)], [rcnt]
        return [tuple(outs)], [rcnt], [[r[1] for r in got]]
    places = shard_places(mesh)
    starts = []
    for cnt in counts:
        acc, st = 0, []
        for c in cnt:
            st.append(acc)
            acc += int(c)
        starts.append(st)
    recvs, rcounts = [], []
    for t, dev in places:
        rc = [int(counts[s][t]) for s in range(len(places))]
        recvs.append(tuple(
            torch.cat([sends[s][q][starts[s][t]: starts[s][t] + rc[s]].to(dev)
                       for s in range(len(places))])
            for q in range(len(sends[0]))))
        rcounts.append(rc)
    if tally is None:
        return recvs, rcounts
    return recvs, rcounts, [[int(tally[s][t]) for s in range(len(places))]
                            for t, _ in places]


def gather_shards(xs: typing.Sequence[torch.Tensor],
                  mesh: Mesh) -> torch.Tensor:
    """[S, ...] on the CPU, on every process: each shard's small tensor of
    one shape (``xs[j]`` local shard j's), in shard order; one copy to the
    host when the shards share a device."""
    if _by_collectives(mesh):
        (x,) = xs
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(mesh.world)]
        dist.all_gather(out, x, group=mesh.group)
        return torch.stack(out).cpu()
    if len({x.device for x in xs}) == 1:
        return torch.stack(list(xs)).cpu()
    return torch.stack([x.cpu() for x in xs])
