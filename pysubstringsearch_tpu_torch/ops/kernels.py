"""Build and bind the hand-written CUDA kernels in ``csrc/``.

Every ``csrc/*.cu`` is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``), one ``nvcc -c`` per source, all started together, and the
objects are linked into one shared library with a plain C interface,
written to the package's ignored ``_build/`` directory and loaded with
ctypes.  An object is rebuilt when its source is newer, the library when
any object is.  Every C entry point launches on the stream it is given
(PyTorch's current stream) and returns ``cudaGetLastError()``;
:func:`launch` raises when that is not 0 and counts the launch.

``LAUNCHES`` holds one count per entry point.  Only :func:`launch` adds to
it, once per call and under a lock (the Writer builds from a thread pool),
so a run can show which kernels its path went through.

:func:`route` and :func:`check` are the wrappers' shared guards: a wrapper
takes its plain PyTorch version only for tensors on the CPU, and launches
its kernel (or raises) for tensors on a CUDA device.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import os
import shutil
import subprocess
import threading
import typing
from concurrent.futures import ThreadPoolExecutor

from .native import BUILD_DIR, compile_once

_CSRC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'csrc')
_SO = os.path.join(BUILD_DIR, 'libpss_kernels.so')
_ARCH = ['-gencode', 'arch=compute_90a,code=sm_90a']
_COMPILE_FLAGS = _ARCH + ['-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-c']
_LINK_FLAGS = _ARCH + ['-shared']

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: C entry point -> argtypes (pointers and the stream as c_void_p).
_SIGNATURES: typing.Dict[str, list] = {
    # text, N, n, rank, bits, out, stream
    'pss_ranked_pack': [_P, _L, _I, _P, _I, _P, _P],
    # text, rank, sa, N, n, depth, bits, num_limbs, limbs, stream
    'pss_ranked_limb_planes': [_P, _P, _P, _L, _L, _I, _I, _I, _P, _P],
    # packed, sa, n, shift, size, scratch, table, stream
    'pss_seed_table': [_P, _P, _I, _I, _L, _P, _P, _P],
    # text, N, n, out, stream
    'pss_raw_pack': [_P, _L, _L, _P, _P],
    # text, sa, N, n, depth, num_limbs, limbs, stream
    'pss_raw_limb_planes': [_P, _P, _L, _L, _I, _I, _P, _P],
    # text, N, n, rank, base, depth, out, stream
    'pss_seed_prefix': [_P, _L, _L, _P, _I, _I, _P, _P],
    # text, n, sa, tables, limbs, rank, present, patterns, lengths,
    # C, B, L, n_pad, table_len, num_limbs, depth, base, bits,
    # lower, count, stream
    'pss_probe_phased': [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                         _I, _I, _I, _L, _L, _I, _I, _I, _I,
                         _P, _P, _P],
    # text, sa, N, n, num_limbs, limbs, stream
    'pss_digit_limb_planes': [_P, _P, _L, _L, _I, _P, _P],
    # text, n, sa, tables, limbs, patterns, lengths, C, B, L, n_pad,
    # table_len, depth, num_limbs, lower, count, stream
    'pss_probe_limbs': [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _I,
                        _I, _P, _P, _P],
    # sa, lower, offsets, B, total, pos, qid, stream
    'pss_gather_hits_flat': [_P, _P, _P, _I, _L, _P, _P, _P],
    # text, n, sa, patterns, lengths, C, B, L, n_pad, lower, count, stream
    'pss_probe_bytes': [_P, _P, _P, _P, _P, _I, _I, _I, _L, _P, _P, _P],
    # sa, lower, count, B, N, cap columns, out, stream
    'pss_gather_hit_positions': [_P, _P, _P, _L, _L, _I, _P, _P],
    # text, sa, n, primary, u, scratch, stream
    'pss_bwt_from_sa': [_P, _P, _L, _P, _P, _P, _P],
    # in, out, n, scratch, stream
    'pss_scan_exclusive_sum': [_P, _P, _L, _P, _P],
    'pss_scan_inclusive_max': [_P, _P, _L, _P, _P],
    # keys, vals, n, key_bits, scratch, stream
    'pss_radix_sort_pairs': [_P, _P, _L, _I, _P, _P],
    # text, N, n, rank_map, bits, sa, rank, gs, scratch, stats, stream
    'pss_sa_init_ranked': [_P, _L, _L, _P, _I, _P, _P, _P, _P, _P, _P],
    # text, N, n, sa, rank, gs, scratch, stats, stream
    'pss_sa_init_bytes': [_P, _L, _L, _P, _P, _P, _P, _P, _P],
    # gs, N, cand, c, tl, counts, scratch, stream
    'pss_sa_tie_scan': [_P, _L, _P, _L, _P, _P, _P, _P],
    # sa, rank, gs, N, k, m, tl, counts, scratch, stream
    'pss_sa_refine_round': [_P, _P, _P, _L, _L, _L, _P, _P, _P, _P],
    # sa_full, N, n, out, stream
    'pss_sa_roll_front': [_P, _L, _L, _P, _P],
    # text, N, n, sa, rank, count, scratch, stream
    'pss_sa_full_init_bytes': [_P, _L, _L, _P, _P, _P, _P, _P],
    # sa, rank, N, npad, W, count, scratch, stream
    'pss_sa_full_init_ranks': [_P, _P, _L, _L, _I, _P, _P, _P],
    # sa, rank, N, k, W, npad, sort, count, scratch, stream
    'pss_sa_full_round': [_P, _P, _L, _L, _I, _L, _I, _P, _P, _P],
    # text, N, n, sa, rank, gs, scratch, stream
    'pss_sa_init3_bytes': [_P, _L, _L, _P, _P, _P, _P, _P],
    # gs, N, half, W, ctl, flags, dest, scratch, stream
    'pss_sa_window_scan': [_P, _L, _L, _L, _P, _P, _P, _P, _P],
    # sa, rank, gs, N, k, m, half, W, flags, dest, ctl, scratch, stream
    'pss_sa_rotating_pass': [_P, _P, _P, _L, _L, _L, _L, _L, _P, _P, _P, _P,
                             _P],
    # values, dests, n, out, out_len, scratch, stream
    'pss_scatter': [_P, _P, _L, _P, _L, _P, _P],
    # values, dests, n, out, scratch, stream
    'pss_scatter_blocked': [_P, _P, _L, _P, _P, _P],
    # text, m, halo, h, p0, n, keys, vals, stream
    'pss_giant_byte_keys': [_P, _L, _P, _L, _L, _L, _P, _P, _P],
    # rank, r2, m, c, W, p0, keys, vals, stream
    'pss_giant_round_keys': [_P, _P, _L, _L, _I, _L, _P, _P, _P],
    # keys, vals, m, split keys, split positions, splitters, cuts, stream
    'pss_giant_cuts': [_P, _P, _L, _P, _P, _I, _P, _P],
    # pos, gs, m, B, S, floor, out_pos, out_gs, totals, scratch, stream
    'pss_giant_partition': [_P, _P, _L, _L, _I, _I, _P, _P, _P, _P, _P],
    # keys, m, off, pred, has_pred, real_lo, v, stats, stream
    'pss_giant_flags': [_P, _L, _L, _L, _I, _L, _P, _P, _P],
}

#: Scratch sizers: pss_<name>_scratch_bytes(count) -> bytes, or of more
#: counts where the value says so.  Host functions; they launch nothing and
#: are not counted.
_SCRATCH = {'scan': 1, 'radix_sort': 1, 'sa_hybrid': 1, 'sa_init': 1,
            'sa_tie': 1, 'sa_round': 1, 'sa_refine': 1, 'sa_pass': 1,
            'sa_full': 1, 'scatter': 1, 'scatter_blocked': 1,
            'seed_table': 1,
            'giant_part': 2}

#: Kernel name (the C entry point without its prefix) -> launches so far.
LAUNCHES: typing.Dict[str, int] = {
    name[len('pss_'):]: 0 for name in _SIGNATURES
}

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
_LIB: typing.Optional[ctypes.CDLL] = None


def nvcc_path() -> str:
    found = shutil.which('nvcc')
    if found:
        return found
    cand = '/usr/local/cuda/bin/nvcc'
    if os.path.exists(cand):
        return cand
    raise RuntimeError('nvcc not found: the CUDA kernels cannot be built')


def _build() -> str:
    sources = sorted(glob.glob(os.path.join(_CSRC, '*.cu')))
    if not sources:
        raise RuntimeError(f'no kernel sources in {_CSRC}')
    nvcc = nvcc_path()
    objects = [
        os.path.join(BUILD_DIR, os.path.basename(s)[:-len('.cu')] + '.o')
        for s in sources
    ]
    try:
        with ThreadPoolExecutor(max_workers=len(sources)) as pool:
            futures = [
                pool.submit(compile_once, [src], obj, [nvcc] + _COMPILE_FLAGS)
                for src, obj in zip(sources, objects)
            ]
            for f in futures:
                f.result()
        return compile_once(objects, _SO, [nvcc] + _LINK_FLAGS)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f'nvcc failed:\n{exc.stderr[-4000:]}') from exc


def library() -> ctypes.CDLL:
    """The kernel library, built on first call.  Raises if it cannot be
    built or loaded."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(_build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        for name, counts in _SCRATCH.items():
            fn = getattr(lib, f'pss_{name}_scratch_bytes')
            fn.argtypes = [_L] * counts
            fn.restype = _L
        _LIB = lib
        return _LIB


_FNS: typing.Dict[str, typing.Any] = {}
_NO_GUARD = contextlib.nullcontext()
#: torch's C calls for the current device and its raw stream, where the
#: CUDA build of torch has them (looked up once; one tuple, bound whole).
_C_CALLS: typing.Optional[tuple] = None


def _c_calls() -> tuple:
    global _C_CALLS
    if _C_CALLS is None:
        import torch

        _C_CALLS = (getattr(torch._C, '_cuda_getDevice', None),
                    getattr(torch._C, '_cuda_getCurrentRawStream', None))
    return _C_CALLS


def _current_stream() -> int:
    """The raw current stream of the current device: two C calls where the
    CUDA build of torch has them, else through a Stream object."""
    device, raw = _c_calls()
    if raw is not None:
        return raw(device())
    import torch

    return torch.cuda.current_stream().cuda_stream


def on(device):
    """``torch.cuda.device(device)``, or a no-op context when ``device`` is
    already the current one: every wrapper launches inside it, and a
    kernel of a few microseconds should not pay a device switch there and
    back."""
    current = _c_calls()[0]
    if current is not None and device.index == current():
        return _NO_GUARD
    import torch

    return torch.cuda.device(device)


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` (without the ``pss_`` prefix) on the current
    stream of the calling thread's current device and count it.  The caller
    passes every argument but the stream."""
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(library(), 'pss_' + name)
    rc = fn(*args, _current_stream())
    if rc != 0:
        raise RuntimeError(f'CUDA kernel {name} failed to launch: error {rc}')
    count_launch(name)


def count_launch(name: str) -> None:
    """Add one launch of ``name`` to ``LAUNCHES``; safe across threads."""
    with _COUNT_LOCK:
        LAUNCHES[name] += 1


def scratch(name: str, count, device):
    """An uninitialised uint8 scratch tensor on ``device`` of the size
    ``pss_<name>_scratch_bytes(count)`` asks for; ``count`` is a tuple for
    a sizer of several counts."""
    import torch

    counts = count if isinstance(count, tuple) else (count,)
    size = getattr(library(), f'pss_{name}_scratch_bytes')(
        *(int(c) for c in counts))
    return torch.empty(size, dtype=torch.uint8, device=device)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def route(*tensors) -> bool:
    """True for the CUDA kernel, False for the plain version (CPU tensors);
    raises on mixed or other devices.  Reads flags and indices only, which
    costs less than comparing device objects: a small kernel's whole call
    pays for every wrapper's checks."""
    first = tensors[0]
    if first.is_cuda:
        index = first.get_device()
        if all(t.is_cuda and t.get_device() == index for t in tensors):
            return True
    elif first.is_cpu and all(t.is_cpu for t in tensors):
        return False
    devs = sorted({str(t.device) for t in tensors})
    if len(devs) != 1:
        raise ValueError(f'tensors on several devices: {devs}')
    raise ValueError(f'no kernel for device {devs[0]}')


def check(t, name: str, dtype, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``ndim``
    dimensions, as the kernels take it."""
    if t.dtype != dtype or t.dim() != ndim or not t.is_contiguous():
        raise ValueError(
            f'{name}: want contiguous {dtype} of {ndim} dims, got '
            f'{t.dtype} {tuple(t.shape)} contiguous={t.is_contiguous()}'
        )
