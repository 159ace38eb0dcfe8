"""Sharded-manifest container: the index format split over N files.

A single container file serialises all IO through one host, so this module
writes the same byte format into N shard files plus a small JSON manifest:

    <dir>/manifest.json                 {"format": ..., "shards": [...]}
    <dir>/shard-0000.idx, shard-0001.idx, ...

Every shard file is itself a valid container, which a ``Reader`` opens
directly.  Chunks go to shards round-robin in flush order, which is the
chunk -> process assignment of ``multihost.my_chunk_ids``, so each process
of an N-process job reads only its own shard files.  The format string and
the file names are the JAX package's, byte for byte, so a manifest written
by either package opens in the other.

Crash behaviour matches the single-file Writer: fully flushed chunks in
every shard stay readable, and the manifest is rewritten on every flush and
on finalize, so a crashed build leaves a loadable prefix.
"""

from __future__ import annotations

import json
import os
import typing

import torch

from .. import container
from ..api import Reader
from ..ops.suffix_array import build_suffix_array
from .multihost import process_count, process_index

MANIFEST_NAME = 'manifest.json'
_FORMAT = 'pysubstringsearch-sharded-v1'


def _shard_path(dir_path: str, i: int) -> str:
    return os.path.join(dir_path, f'shard-{i:04d}.idx')


def _write_manifest(dir_path: str, counts: typing.List[int]) -> None:
    manifest = {
        'format': _FORMAT,
        'num_shards': len(counts),
        'shards': [
            {'path': os.path.basename(_shard_path(dir_path, i)),
             'chunks': counts[i]}
            for i in range(len(counts))
        ],
    }
    tmp = os.path.join(dir_path, MANIFEST_NAME + '.tmp')
    with open(tmp, 'w') as f:
        json.dump(manifest, f, indent=1)
    os.replace(tmp, os.path.join(dir_path, MANIFEST_NAME))


class ShardedWriter:
    """Round-robin chunk writer over N shard containers.

    The Writer's ingestion API and flush policy; only the placement of
    flushed chunks differs.  ``num_shards`` is typically the process count
    of the serving job.  ``sa_backend`` takes the port's builders
    (``'auto'``, ``'torch'``, ``'native'``, ``'numpy'``; see
    ``ops/suffix_array.build_suffix_array``): ``'auto'`` builds chunks of
    at least 64 KiB on the CUDA card when one is present.
    """

    def __init__(
        self,
        dir_path: str,
        num_shards: int,
        max_chunk_len: typing.Optional[int] = None,
        *,
        sa_backend: str = 'auto',
    ) -> None:
        if num_shards < 1:
            raise ValueError('num_shards must be >= 1')
        os.makedirs(dir_path, exist_ok=True)
        self._dir = dir_path
        self._files = [
            open(_shard_path(dir_path, i), 'wb') for i in range(num_shards)
        ]
        self._buffer = container.ChunkBuffer(max_chunk_len)
        self._sa_backend = sa_backend
        self._next_shard = 0
        self._chunks_per_shard = [0] * num_shards

    def add_entry(self, text: str) -> None:
        data = text.encode('utf-8')
        if len(data) > self._buffer.capacity:
            raise ValueError('entry is too big')
        if self._buffer.would_overflow(len(data)):
            self.dump_data()
        self._buffer.append(data)

    def add_entries_from_file_lines(self, input_file_path: str) -> None:
        with open(input_file_path, 'rb') as input_file:
            for line in input_file:
                if line.endswith(b'\n'):
                    line = line[:-1]
                    if line.endswith(b'\r'):
                        line = line[:-1]
                if self._buffer.would_overflow(len(line)):
                    self.dump_data()
                self._buffer.append(line)

    def dump_data(self) -> None:
        if len(self._buffer) == 0:
            return
        data = self._buffer.take()
        sa = build_suffix_array(data, backend=self._sa_backend)
        i = self._next_shard
        container.write_chunk(self._files[i], data, sa)
        self._files[i].flush()
        self._chunks_per_shard[i] += 1
        self._next_shard = (i + 1) % len(self._files)
        _write_manifest(self._dir, self._chunks_per_shard)

    def finalize(self) -> None:
        if len(self._buffer) > 0:
            self.dump_data()
        _write_manifest(self._dir, self._chunks_per_shard)
        for f in self._files:
            f.flush()

    def close(self) -> None:
        self.finalize()
        for f in self._files:
            f.close()
        self._files = []

    def __enter__(self) -> 'ShardedWriter':
        return self

    def __exit__(self, *exc: typing.Any) -> None:
        self.close()


def read_manifest(dir_path: str) -> typing.List[str]:
    """Absolute shard paths listed by a manifest directory."""
    with open(os.path.join(dir_path, MANIFEST_NAME)) as f:
        manifest = json.load(f)
    if manifest.get('format') != _FORMAT:
        raise ValueError(f'unknown manifest format: {manifest.get("format")!r}')
    return [
        os.path.join(dir_path, shard['path']) for shard in manifest['shards']
    ]


def local_shard_paths(dir_path: str) -> typing.List[str]:
    """The shard files this process loads: round-robin by its rank in
    ``torch.distributed`` (all of them in a world of one), aligned with
    ``multihost.my_chunk_ids``."""
    pid, nproc = process_index(), process_count()
    return [p for i, p in enumerate(read_manifest(dir_path))
            if i % nproc == pid]


def open_local_reader(dir_path: str,
                      device: typing.Union[str, torch.device] = 'cuda'
                      ) -> Reader:
    """A Reader on ``device`` over this process's shards (in a world of
    one: all of them).  Chunks of several shard files are concatenated;
    search semantics are those of one file holding the same chunks."""
    chunks: typing.List[container.Chunk] = []
    for p in local_shard_paths(dir_path):
        chunks.extend(container.read_chunks(p))
    return Reader.from_chunks(chunks, device)


def convert_index(index_file_path: str, dir_path: str,
                  num_shards: int) -> None:
    """Split an existing single-file index into a sharded manifest; each
    chunk is copied verbatim, with no SA rebuild."""
    os.makedirs(dir_path, exist_ok=True)
    chunks = container.read_chunks(index_file_path)
    files = [open(_shard_path(dir_path, i), 'wb') for i in range(num_shards)]
    counts = [0] * num_shards
    try:
        for i, c in enumerate(chunks):
            container.write_chunk(files[i % num_shards], c.data,
                                  c.suffix_array)
            counts[i % num_shards] += 1
    finally:
        for f in files:
            f.close()
    _write_manifest(dir_path, counts)


__all__ = [
    'ShardedWriter',
    'read_manifest',
    'local_shard_paths',
    'open_local_reader',
    'convert_index',
    'MANIFEST_NAME',
]
