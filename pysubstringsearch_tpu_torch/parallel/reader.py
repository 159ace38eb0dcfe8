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
- a batch is probed by one launch per device, and the bounds are joined in
  row order.

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

    def probe(self, patterns: np.ndarray, lengths: np.ndarray):
        """(lower, count) int32 [C, B] host arrays: each device's probe
        launch over its rows, joined in row order."""
        if not self.parts:
            zeros = np.zeros((0, np.asarray(patterns).shape[0]), np.int32)
            return zeros, zeros.copy()
        los, cnts = zip(*(p.probe(patterns, lengths) for p in self.parts))
        return np.concatenate(los), np.concatenate(cnts)


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
