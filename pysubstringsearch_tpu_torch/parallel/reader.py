"""ShardedReader: the Reader with its probe rows split over several devices.

The same API and result multisets as ``api.Reader``; only the index's
placement differs, as in the JAX package's ``ShardedReader``:

- the rows (merged groups in derive mode) are planned over all chunks, as
  are the kind, table parameters, ``n_pad`` and limb count, so every
  device's block is built alike; the row count is then padded with empty
  rows to a multiple of the device count;
- device k owns rows ``[k * rpd, (k + 1) * rpd)``, and the limb budget
  meters one device's share;
- upload mode copies each block's container chunks to its device; derive
  mode builds each block's SA, limbs and tables on its device;
- a batch is probed by one launch per device, all launched before any is
  joined; the bounds are copied to the first device, joined in row order
  and read back in one transfer.

This is the single-process form: the process holds all chunk text for line
extraction and places only the device arrays.  Across processes, see
``parallel/multihost.py``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from .. import container
from ..api import Reader
from ..container import Chunk
from ..models.index import DeviceIndex
from ..utils.profiling import PhaseProfiler
from .mesh import Mesh, make_mesh


class ShardedIndex(DeviceIndex):
    """One index whose rows are split over ``devices``: a
    :class:`DeviceIndex` per device (``parts``) built from one plan over
    all chunks."""

    def __init__(
        self,
        chunks: typing.Sequence[Chunk],
        devices: typing.Sequence[typing.Union[str, torch.device]],
        *,
        mode: str = 'auto',
        num_limbs: typing.Optional[int] = None,
        merge: typing.Optional[bool] = None,
        profiler: typing.Optional[PhaseProfiler] = None,
    ) -> None:
        prof = profiler if profiler is not None else PhaseProfiler()
        self._plan(chunks, devices[0], mode, merge, num_limbs, prof,
                   shares=len(devices))
        self._rows_per_device = self.num_chunks // len(devices)
        rpd = self._rows_per_device
        self.parts: typing.List[DeviceIndex] = []
        for k, dev in enumerate(devices):
            part = self._part(slice(k * rpd, (k + 1) * rpd), dev)
            part._build(chunks, prof)
            self.parts.append(part)
        self.sa_ties = [t for p in self.parts for t in p.sa_ties]
        self.sa_poisoned = [x for p in self.parts for x in p.sa_poisoned]

    def row_sa(self, r: int) -> torch.Tensor:
        part = self.parts[r // self._rows_per_device]
        return part.sa[r % self._rows_per_device]

    def probe_device_parts(
        self,
        patterns: np.ndarray,  # uint8 [B, L]
        lengths: np.ndarray,  # int32 [B]
    ) -> typing.List[typing.Tuple[np.ndarray, torch.Tensor, torch.Tensor]]:
        """``[(members, lower, count)]``: the batch's probe over every
        device with no readback, as the JAX sharded index answers over its
        mesh.  One part, where the JAX package has one a length class:
        ``members`` the host indices [B], ``lower`` and ``count`` int32
        [C, B] tensors on the first device.  Every device's probe is
        launched first, so they run together; then each device's
        [rows per device, B] block is copied to the first device and the
        blocks are joined in row order (a padding row's bounds are 0).
        :meth:`probe` reads the joined part back in one transfer, and for
        the raw kind zeroes the patterns that hold NUL."""
        patterns = np.asarray(patterns, dtype=np.uint8)
        lengths = np.asarray(lengths, dtype=np.int32)
        B = patterns.shape[0]
        if self.num_chunks == 0 or B == 0 or patterns.shape[1] > self.n_pad:
            return DeviceIndex.probe_device_parts(self, patterns, lengths)
        blocks = [p.probe_device_parts(patterns, lengths)[0][1:]
                  for p in self.parts]
        lo, cnt = (torch.cat([b[j].to(self.device) for b in blocks])
                   for j in (0, 1))
        return [(np.arange(B), lo, cnt)]


class ShardedReader(Reader):
    """``Reader`` over one container whose index rows are placed on
    ``mesh``: a :class:`~.mesh.Mesh` or a sequence of devices (default:
    ``make_mesh()``, the CUDA card).  ``index_mode`` as ``Reader``'s."""

    def __init__(
        self,
        index_file_path: str,
        mesh: typing.Union[Mesh, typing.Sequence, None] = None,
        *,
        index_mode: str = 'auto',
    ) -> None:
        if mesh is None:
            mesh = make_mesh()
        elif not isinstance(mesh, Mesh):
            mesh = make_mesh(mesh)
        if mesh.world != 1:
            raise ValueError('ShardedReader places rows on one process\'s '
                             'devices; across processes use '
                             'multihost.MultiHostReader')
        self.mesh = mesh
        prof = PhaseProfiler()
        with prof.phase('load-container'):
            cont = container.read_container(index_file_path)
        self._container = cont
        self._init_from_chunks(cont.chunks, mesh.devices[0], prof,
                               index_mode)

    def _build_device_index(self) -> ShardedIndex:
        return ShardedIndex(self._chunks, self.mesh.devices,
                            mode=self._index_mode, profiler=self._prof)

    # Introspection kept for tools and tests: padded row count, real rows.
    @property
    def _C(self) -> int:
        return self._index.num_chunks

    @property
    def _num_real(self) -> int:
        return sum(1 for g in self._index.groups if g)
