"""Multi-process runtime glue on ``torch.distributed``.

Every process owns the corpus chunks of its shard files, the query batch
is replicated, and results flow back through host collectives: the
process-level form of the reference's fan-out over sub-indexes and mutex
merge.  Search is stateless per batch, so recovery from a lost process is
re-running the batch against its shards after reassignment.

Host data (counts, pickled result lists) is gathered over a gloo group: the
default group when it is gloo, else one made once with
``new_group(backend='gloo')``.  With ``torch.distributed`` uninitialised a
process is rank 0 of 1, as ``jax.process_index()`` is without
``jax.distributed``, and every gather returns its own input alone.
"""

from __future__ import annotations

import pickle
import typing

import numpy as np
import torch
import torch.distributed as dist

#: (default group, its gloo twin): made once per default group, so a
#: re-initialised process group gets a fresh one.
_HOST_GROUP: typing.Tuple[typing.Any, typing.Any] = (None, None)


def initialize(init_method: str, world_size: int, rank: int,
               backend: str) -> None:
    """Join the process group: ``init_method`` as
    ``torch.distributed.init_process_group`` takes it (``'file://...'`` or
    ``'tcp://host:port'``), and the backend named explicitly (``'gloo'``
    for CPU tensors, ``'nccl'`` for CUDA ones)."""
    dist.init_process_group(backend=backend, init_method=init_method,
                            world_size=world_size, rank=rank)


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _host_group():
    """The gloo group host gathers go over (None: the default group)."""
    global _HOST_GROUP
    if dist.get_backend() == 'gloo':
        return None
    world = dist.group.WORLD
    if _HOST_GROUP[0] is not world:
        _HOST_GROUP = (world, dist.new_group(backend='gloo'))
    return _HOST_GROUP[1]


def _allgather_host(x: np.ndarray) -> np.ndarray:
    """[world, *x.shape]: every process's same-shaped host array, in rank
    order."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if not dist.is_initialized():
        return t.numpy()[None].copy()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t, group=_host_group())
    return torch.stack(out).numpy()


def my_chunk_ids(num_chunks: int) -> typing.List[int]:
    """Round-robin chunk -> process assignment; each process loads only its
    own chunks' text and SA from the container."""
    pid, nproc = process_index(), process_count()
    return [c for c in range(num_chunks) if c % nproc == pid]


def allgather_counts(local_counts: np.ndarray) -> np.ndarray:
    """Gather per-process [C_local, B] hit-count blocks to every process:
    [world, C_local, B]."""
    return _allgather_host(np.asarray(local_counts))


def allgather_bytes(payload: bytes) -> typing.List[bytes]:
    """Gather one variable-length bytes blob per process to every process,
    in rank order: an all-gather of the lengths, then of the payloads
    padded to the longest."""
    lengths = _allgather_host(
        np.array([len(payload)], dtype=np.int64)).reshape(-1)
    pad = int(lengths.max(initial=1))
    row = np.zeros(pad, dtype=np.uint8)
    row[: len(payload)] = np.frombuffer(payload, dtype=np.uint8)
    rows = _allgather_host(row).reshape(len(lengths), pad)
    return [rows[p, : lengths[p]].tobytes() for p in range(len(lengths))]


class MultiHostReader:
    """Search over a sharded-manifest index across processes.

    Every process loads only its own shard files (round-robin,
    parallel/manifest.py) into a ``Reader`` on ``device``, answers the
    replicated batch from them, extracts its own lines, and the per-process
    result lists are merged on every process in rank order.  All processes
    return the same result multiset.  The call pattern is SPMD: every
    process calls ``search`` / ``search_multiple`` with the same
    arguments.  Single-process use needs no ``torch.distributed``.
    """

    def __init__(self, manifest_dir: str,
                 device: typing.Union[str, torch.device] = 'cuda') -> None:
        from .. import container
        from ..api import Reader
        from . import manifest

        self._local = Reader.from_chunks(
            [c for path in manifest.local_shard_paths(manifest_dir)
             for c in container.read_chunks(path)],
            device,
        )

    def wait_device_ready(self, timeout: typing.Optional[float] = None
                          ) -> bool:
        """Block until this process's device index is built."""
        return self._local.wait_device_ready(timeout)

    def _search_batch(
        self, patterns: typing.List[bytes]
    ) -> typing.List[typing.List[str]]:
        local = self._local._search_batch(patterns)
        out: typing.List[typing.List[str]] = [[] for _ in patterns]
        for blob in allgather_bytes(pickle.dumps(local)):
            for b, lines in enumerate(pickle.loads(blob)):
                out[b].extend(lines)
        return out

    def search(self, substring: str) -> typing.List[str]:
        return self._search_batch([substring.encode('utf-8')])[0]

    def search_multiple(self, substrings: typing.List[str]
                        ) -> typing.List[str]:
        per = self._search_batch([s.encode('utf-8') for s in substrings])
        return [line for lines in per for line in lines]
