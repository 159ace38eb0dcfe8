"""Build and bind the hand-written CUDA kernels in ``csrc/``.

The sources are compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into one shared library with a plain C interface, written to
the package's ignored ``_build/`` directory, and loaded with ctypes.  Every
C entry point launches on the stream it is given (PyTorch's current stream)
and returns ``cudaGetLastError()``; :func:`launch` raises when that is not
0 and counts the launch.

``LAUNCHES`` holds one count per kernel.  Only :func:`launch` adds to it,
once per kernel launch, so a run can show which kernels its path went
through.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import typing

from .native import BUILD_DIR, compile_once

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
_SO = os.path.join(BUILD_DIR, 'libpss_kernels.so')
_NVCC_FLAGS = [
    '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
    '-shared', '-Xcompiler', '-fPIC',
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry point -> argtypes (pointers and the stream as c_void_p).
_SIGNATURES: typing.Dict[str, list] = {
    # text, N, n, rank, bits, out, stream
    'pss_ranked_pack': [_P, _L, _I, _P, _I, _P, _P],
    # packed, sa, N, n, depth, bits, num_limbs, limbs, stream
    'pss_ranked_limb_planes': [_P, _P, _L, _I, _I, _I, _I, _P, _P],
    # packed, sa, n, shift, size, table, stream
    'pss_seed_table': [_P, _P, _I, _I, _L, _P, _P],
    # text, n, sa, tables, limbs, rank, present, patterns, lengths,
    # C, B, L, n_pad, table_len, num_limbs, depth, base, bits,
    # lower, count, stream
    'pss_probe_phased': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _L, _L, _I, _I, _I, _I,
                         _P, _P, _P],
}

#: Kernel name (the C entry point without its prefix) -> launches so far.
LAUNCHES: typing.Dict[str, int] = {
    name[len('pss_'):]: 0 for name in _SIGNATURES
}

_LOCK = threading.Lock()
_LIB: typing.Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def library() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises if it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        sources = sorted(glob.glob(os.path.join(_CSRC, '*.cu')))
        if len(sources) != 1:
            raise RuntimeError(f'expected one kernel source in {_CSRC}')
        try:
            so = compile_once(sources[0], _SO, [nvcc_path()] + _NVCC_FLAGS)
        except subprocess.CalledProcessError as exc:
            raise RuntimeError(f'nvcc failed:\n{exc.stderr[-4000:]}') from exc
        lib = ctypes.CDLL(so)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIB = lib
        return _LIB


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` (without the ``pss_`` prefix) on the current
    stream of the calling thread's current device and count it.  The caller
    passes every argument but the stream."""
    import torch

    lib = library()
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, 'pss_' + name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: error {rc}')
    LAUNCHES[name] += 1


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
