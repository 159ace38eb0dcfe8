"""ctypes loader for the native C++ host kernels (``native/sais.cpp``) and
the CPython line-materialization extension (``native/fastext.c``).

Both are compiled from the repository's ``native/`` sources at first use,
into this package's own ignored ``_build/`` directory (never into
``native/``, so a process running the JAX package's loader at the same time
cannot race this one).  Each build writes a process-private temporary file
and renames it into place, so concurrent test workers never load a
half-written library.  The sources must be present, so the port runs from
a checkout of the repository: a missing source raises.  A failed build
warns with the compiler's output, and the callers fall back to the numpy
suffix-array backend and the Python line fan-out.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sysconfig
import threading
import typing
import warnings

import numpy as np

_LOCK = threading.Lock()
_LIB: typing.Optional[ctypes.CDLL] = None
_TRIED = False

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REPO_ROOT = os.path.dirname(_PKG_ROOT)
BUILD_DIR = os.path.join(_PKG_ROOT, '_build')
_SAIS_SRC = os.path.join(_REPO_ROOT, 'native', 'sais.cpp')
_FASTEXT_SRC = os.path.join(_REPO_ROOT, 'native', 'fastext.c')


def _require_source(src: str) -> None:
    if not os.path.isfile(src):
        raise FileNotFoundError(
            f'native source {src} is missing: the port builds its host '
            "kernels from the repository's native/ directory, so run it "
            'from a checkout'
        )


def _warn_build_failed(src: str, exc: BaseException) -> None:
    detail = getattr(exc, 'stderr', None) or exc
    warnings.warn(
        f'building {os.path.basename(src)} failed, falling back to the '
        f'slower Python path: {detail}',
        RuntimeWarning, stacklevel=3,
    )


def compile_once(srcs: typing.Sequence[str], so: str,
                 cmd: typing.List[str]) -> str:
    """Build ``so`` from ``srcs`` with ``cmd + ['-o', tmp, *srcs]`` unless a
    build newer than every source exists; the output is renamed into place
    atomically.  Raises ``OSError`` or ``subprocess.SubprocessError`` (with
    the compiler's output) when the build fails."""
    if os.path.exists(so) and all(
        os.path.getmtime(so) >= os.path.getmtime(s) for s in srcs
    ):
        return so
    os.makedirs(os.path.dirname(so), exist_ok=True)
    tmp = f'{so}.{os.getpid()}.{threading.get_ident()}.tmp'
    try:
        subprocess.run(
            cmd + ['-o', tmp, *srcs], check=True, capture_output=True,
            text=True, timeout=600,
        )
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load() -> typing.Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _require_source(_SAIS_SRC)
        _TRIED = True
        try:
            lib = ctypes.CDLL(compile_once(
                [_SAIS_SRC], os.path.join(BUILD_DIR, 'libpss_host.so'),
                ['g++', '-O3', '-std=c++17', '-shared', '-fPIC',
                 '-march=native', '-pthread'],
            ))
        except (OSError, subprocess.SubprocessError) as exc:
            _warn_build_failed(_SAIS_SRC, exc)
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64p = ctypes.POINTER(ctypes.c_int64)
        vpp = ctypes.POINTER(ctypes.c_void_p)
        lib.tpuss_build_sa_u8.restype = ctypes.c_int32
        lib.tpuss_build_sa_u8.argtypes = [u8p, ctypes.c_int32, i32p]
        lib.tpuss_build_sa_i32.restype = ctypes.c_int32
        lib.tpuss_build_sa_i32.argtypes = [i32p, ctypes.c_int32,
                                           ctypes.c_int32, i32p]
        lib.tpuss_unbwt.restype = ctypes.c_int32
        lib.tpuss_unbwt.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, u8p]
        lib.tpuss_probe_batch.restype = ctypes.c_int32
        lib.tpuss_probe_batch.argtypes = [
            u8p, ctypes.c_int32, i32p, u8p, i32p, ctypes.c_int32,
            ctypes.c_int32, i32p, i32p,
        ]
        lib.tpuss_probe_multi.restype = ctypes.c_int32
        lib.tpuss_probe_multi.argtypes = [
            ctypes.c_int32,   # nchunks
            vpp,              # datas
            i32p,             # ns
            vpp,              # sas
            u8p,              # pats
            i32p,             # lens
            ctypes.c_int32,   # stride
            ctypes.c_int32,   # B
            i32p,             # lo_out
            i32p,             # cnt_out
            ctypes.c_int32,   # nthreads
        ]
        lib.tpuss_extract_spans.restype = ctypes.c_int32
        lib.tpuss_extract_spans.argtypes = [
            ctypes.c_int32,   # nchunks
            vpp,              # datas
            i32p,             # ns
            vpp,              # sas
            i64p,             # text_offs
            i32p,             # lo
            i32p,             # cnt
            ctypes.c_int32,   # B
            i64p,             # out_base
            i64p,             # spans_out
            i32p,             # out_cnt
            ctypes.c_int32,   # nthreads
        ]
        _LIB = lib
        return _LIB


def available() -> bool:
    return _load() is not None


def probe_batch_available() -> bool:
    """True when the native host bisection (:func:`probe_batch_native`)
    can run: the routes that re-probe on the host need it."""
    lib = _load()
    return lib is not None and hasattr(lib, 'tpuss_probe_batch')


_FASTEXT = None
_FASTEXT_TRIED = False


def fastext():
    """The native materialization module, or None when unavailable."""
    global _FASTEXT, _FASTEXT_TRIED
    with _LOCK:
        if _FASTEXT is not None or _FASTEXT_TRIED:
            return _FASTEXT
        _require_source(_FASTEXT_SRC)
        _FASTEXT_TRIED = True
        inc = sysconfig.get_paths()['include']
        import importlib.util

        try:
            so = compile_once(
                [_FASTEXT_SRC], os.path.join(BUILD_DIR, '_fastext.so'),
                ['gcc', '-O2', '-shared', '-fPIC', f'-I{inc}'],
            )
            spec = importlib.util.spec_from_file_location(
                'pysubstringsearch_tpu_torch._fastext', so
            )
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
        except (ImportError, OSError, subprocess.SubprocessError) as exc:
            _warn_build_failed(_FASTEXT_SRC, exc)
            return None
        _FASTEXT = mod
        return _FASTEXT


def suffix_array_native(data: np.ndarray) -> np.ndarray:
    """SA via the C++ SA-IS kernel; raises if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native SA-IS library is not available')
    data = np.ascontiguousarray(data, dtype=np.uint8)
    n = data.size
    if n > 0x7FFFFFFF:
        raise ValueError('chunk exceeds int32 suffix-array limit')
    sa = np.empty(n, dtype=np.int32)
    if n == 0:
        return sa
    rc = lib.tpuss_build_sa_u8(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int32(n),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f'native SA-IS failed with code {rc}')
    return sa


def suffix_array_int_native(data: np.ndarray, k: int) -> np.ndarray:
    """SA over an int32 alphabet [0, k) via the C++ SA-IS kernel
    (``libsais_int`` parity); raises if the library is unavailable."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native int-alphabet SA-IS is not available')
    data = np.ascontiguousarray(data, dtype=np.int32)
    n = data.size
    sa = np.empty(n, dtype=np.int32)
    if n == 0:
        return sa
    rc = lib.tpuss_build_sa_i32(
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.c_int32(n),
        ctypes.c_int32(k),
        sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError(f'native int SA-IS failed with code {rc}')
    return sa


def probe_batch_native(
    data: np.ndarray,
    sa: np.ndarray,
    packed: np.ndarray,  # uint8 [B, stride], zero padded
    lengths: np.ndarray,  # int32 [B]
) -> typing.Tuple[np.ndarray, np.ndarray]:
    """(lower, count) int32 [B] via the native host bisection over one
    chunk.  Releases the GIL for the whole batch."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native probe_batch is not available')
    data = np.ascontiguousarray(data, dtype=np.uint8)
    sa = np.ascontiguousarray(sa, dtype=np.int32)
    packed = np.ascontiguousarray(packed, dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int32)
    B, stride = packed.shape
    lo = np.empty(B, dtype=np.int32)
    cnt = np.empty(B, dtype=np.int32)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.tpuss_probe_batch(
        data.ctypes.data_as(u8p), ctypes.c_int32(data.size),
        sa.ctypes.data_as(i32p), packed.ctypes.data_as(u8p),
        lengths.ctypes.data_as(i32p), ctypes.c_int32(stride),
        ctypes.c_int32(B), lo.ctypes.data_as(i32p),
        cnt.ctypes.data_as(i32p),
    )
    if rc != 0:
        raise RuntimeError(f'native probe_batch failed with code {rc}')
    return lo, cnt


def unbwt_native(u: np.ndarray, primary_index: int) -> np.ndarray:
    """Inverse BWT via the native LF walk (``libsais_unbwt`` parity);
    raises if the library is unavailable or the primary index is bad."""
    lib = _load()
    if lib is None:
        raise RuntimeError('native unbwt is not available')
    u = np.ascontiguousarray(u, dtype=np.uint8)
    out = np.empty(u.size, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    rc = lib.tpuss_unbwt(u.ctypes.data_as(u8p), ctypes.c_int32(u.size),
                         ctypes.c_int32(primary_index),
                         out.ctypes.data_as(u8p))
    if rc != 0:
        raise RuntimeError(f'native unbwt failed with code {rc}')
    return out
