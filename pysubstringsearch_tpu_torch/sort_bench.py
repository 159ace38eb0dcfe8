"""Time the store pass of an LSD radix sort (B16) against whole sorts on one
CUDA card:

    python -m pysubstringsearch_tpu_torch.sort_bench [log2n]

The counterpart of ``benchmarks/pallas_sort_bench.py``.  At n = 2^log2n
(default 24) it makes, with numpy's ``default_rng(0)`` as that benchmark
does, int32 keys below 2^30, the values 0..n-1 and a permutation of
destinations, and times each of these with CUDA events (mean of ``reps``
runs after one warm-up):

- ``torch_sort_pairs_ms``: one stable ``torch.sort`` of the keys with the
  values gathered by its order (the benchmark's ``lax.sort`` of 2 operands);
- ``radix_sort_pairs_ms``: the port's own radix sort of the same pairs on
  30 key bits (4 passes of histogram, scan and scatter);
- ``plain_scatter_ms``: ``out[dests] = values``, B16's plain version (the
  benchmark's XLA scatter);
- ``library_scatter_ms``: one ``Tensor.scatter_`` at int64 destinations made
  beforehand;
- ``scatter_ms``: the B16 kernel, which must equal the plain version
  (``scatter_max_abs_err``), beside ``scatter_bound_ms``, its 12 bytes an
  element at 3.35 TB/s.

It prints one JSON line with the card's name.  Without a CUDA card it
prints nothing to stdout and exits 2: the numbers are the card's or none.
"""

from __future__ import annotations

import json
import sys
import typing

import numpy as np
import torch

from .ops import suffix_array as SA

#: Device memory rate of the H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12


def _cuda_ms(fn, reps: int, setup=None) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up,
    CUDA events around each run; ``setup`` (untimed) runs before each."""
    total = 0.0
    for i in range(reps + 1):
        if setup:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        if i:
            total += start.elapsed_time(end)
    return total / reps


def measure(log2n: int, reps: int = 10) -> typing.Dict[str, typing.Any]:
    """The numbers of one run at n = 2^log2n on the current CUDA card."""
    n = 1 << log2n
    dev = torch.device('cuda')
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 1 << 30, n,
                                         dtype=np.int32)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    dests = torch.from_numpy(rng.permutation(n).astype(np.int32)).to(dev)

    def torch_pairs():
        ks, order = torch.sort(keys, stable=True)
        return ks, vals[order]

    k64 = keys.long()
    work_k, work_v = torch.empty_like(k64), torch.empty_like(vals)

    def reset():
        work_k.copy_(k64)
        work_v.copy_(vals)

    reset()
    rk, rv = SA.radix_sort_pairs(work_k, work_v, 30)
    tk, tv = torch_pairs()
    sort_err = max(int((rk - tk.long()).abs().max()),
                   int((rv - tv).abs().max()))
    out = SA.scatter(vals, dests)
    plain = SA.scatter_plain(vals, dests)
    err = int((out - plain).abs().max())
    del tk, tv, plain
    d64 = dests.long()
    lib_out = torch.empty_like(vals)
    return {
        'n': n, 'log2n': log2n, 'reps': reps,
        'device': torch.cuda.get_device_name(dev),
        'torch_sort_pairs_ms': _cuda_ms(torch_pairs, reps),
        'radix_sort_pairs_ms': _cuda_ms(
            lambda: SA.radix_sort_pairs(work_k, work_v, 30), reps, reset),
        'radix_sort_max_abs_err': sort_err,
        'plain_scatter_ms': _cuda_ms(lambda: SA.scatter_plain(vals, dests),
                                     reps),
        'library_scatter_ms': _cuda_ms(lambda: lib_out.scatter_(0, d64, vals),
                                       reps),
        'scatter_ms': _cuda_ms(lambda: SA.scatter(vals, dests, out), reps),
        'scatter_max_abs_err': err,
        'scatter_bound_ms': 12 * n / HBM_BYTES_PER_S * 1e3,
    }


def main(argv: typing.Optional[typing.List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    log2n = int(args[0]) if args else 24
    if not torch.cuda.is_available():
        print('sort_bench: no CUDA device; nothing to measure',
              file=sys.stderr)
        return 2
    print(json.dumps(measure(log2n)), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
