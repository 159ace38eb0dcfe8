"""Substring search over suffix-array indexes, with the probe on an NVIDIA
GPU through PyTorch and hand-written CUDA kernels.

The same ``Writer``/``Reader`` API, container bytes and result multisets as
``pysubstringsearch_tpu``, the JAX package it is ported from.  This package
imports torch and numpy only.
"""


def _disable_numpy_hugepage_madvise() -> None:
    """Turn off numpy's MADV_HUGEPAGE on large allocations.

    On kernels with ``transparent_hugepage/defrag = madvise``, numpy's
    hugepage madvise sends every first touch of a fresh large array through
    synchronous page compaction, and index build and load stream through
    multi-GB fresh buffers.  ``TPUSS_NUMPY_HUGEPAGE=1`` keeps numpy's
    default.
    """
    import os

    if os.environ.get('TPUSS_NUMPY_HUGEPAGE') == '1':
        return
    try:
        import numpy as _np

        _np._core.multiarray._set_madvise_hugepage(False)
    except AttributeError:
        pass  # older numpy layouts; harmless to skip


_disable_numpy_hugepage_madvise()

from .api import Reader, Writer  # noqa: E402

__all__ = ['Reader', 'Writer']
__version__ = '0.1.0'
