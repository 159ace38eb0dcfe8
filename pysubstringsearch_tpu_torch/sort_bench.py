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
- ``radix_sort_pairs_ms``: the port's own one-sweep radix sort of the same
  pairs on 30 key bits (``radix_sort_passes``, 4: one histogram kernel,
  then one kernel a pass);
- ``plain_scatter_ms``: ``out[dests] = values``, B16's plain version (the
  benchmark's XLA scatter);
- ``library_scatter_ms``: one ``Tensor.scatter_`` at int64 destinations made
  beforehand;
- ``scatter_ms``: the B16 kernel, which must equal the plain version
  (``scatter_max_abs_err``), beside ``scatter_bound_ms``, its 12 bytes an
  element at 3.35 TB/s;  at n = 2^27 (``GIANT_RANK_STORE_LOG2N``) that is
  the giant build's rank store, a permutation of a shard's 128 Mi slots;
- ``blocked_scatter_ms``: the same store blocked by destination
  (``suffix_array.scatter_blocked``: one one-sweep pass on the dests' top 8
  bits, then the stores bin by bin), equal to the plain version
  (``blocked_scatter_max_abs_err``).

:func:`measure_wide` times the same two sorts at the shape of one B10 pass
on a 512 Mi row: ``WIDE_PAIRS`` (21 Mi) pairs of random 60-bit keys, 8
passes; :func:`skewed_batch` makes B8's batch with one common pattern.  ``main`` prints one JSON line with the card's name, the B10
shape's numbers under ``wide``.  Without a CUDA card it prints nothing to
stdout and exits 2: the numbers are the card's or none.
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

#: log2 of the giant build's rank store: each of 4 shards of a 512 Mi row
#: scatters a permutation of its 128 Mi slots (``parallel/sharded.py``).
GIANT_RANK_STORE_LOG2N = 27

#: Pairs and key bits of one B10 pass on a 512 Mi row: m_w about 21 M
#: marked slots, keyed (group start << 30) | (r2 + 1).
WIDE_PAIRS = 21 << 20
WIDE_KEY_BITS = 60


def passes(key_bits: int) -> int:
    """Digit passes of ``radix_sort_pairs`` on ``key_bits`` bits."""
    return -(-key_bits // 8)


def cuda_ms(fn, reps: int, setup=None) -> float:
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


def skewed_batch(seed: int = 7, slots: int = 1 << 26,
                 big: int = (1 << 24) + 3, big_lower: int = 12_345):
    """B8's skewed batch, numpy int32 (sa, lower, count): a random
    permutation of ``slots`` SA slots and 10,001 queries of 0-300 hits,
    every fifth, a run of 300 and the last 3 at zero, the middle one of
    ``big`` hits from ``big_lower`` (one common pattern in a batch)."""
    rng = np.random.default_rng(seed)
    sa = rng.permutation(slots).astype(np.int32)
    B = 10_001
    count = rng.integers(0, 301, size=B).astype(np.int32)
    count[::5] = 0
    count[100:400] = 0
    count[-3:] = 0
    count[B // 2] = big
    lower = rng.integers(0, slots - 301, size=B).astype(np.int32)
    lower[B // 2] = big_lower
    return sa, lower, count


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
    blocked = SA.scatter_blocked(vals, dests)
    blocked_err = int((blocked - plain).abs().max())
    del tk, tv, plain
    d64 = dests.long()
    lib_out = torch.empty_like(vals)
    return {
        'n': n, 'log2n': log2n, 'reps': reps,
        'device': torch.cuda.get_device_name(dev),
        'torch_sort_pairs_ms': cuda_ms(torch_pairs, reps),
        'radix_sort_pairs_ms': cuda_ms(
            lambda: SA.radix_sort_pairs(work_k, work_v, 30), reps, reset),
        'radix_sort_passes': passes(30),
        'radix_sort_max_abs_err': sort_err,
        'plain_scatter_ms': cuda_ms(lambda: SA.scatter_plain(vals, dests),
                                     reps),
        'library_scatter_ms': cuda_ms(lambda: lib_out.scatter_(0, d64, vals),
                                       reps),
        'scatter_ms': cuda_ms(lambda: SA.scatter(vals, dests, out), reps),
        'scatter_max_abs_err': err,
        'blocked_scatter_ms': cuda_ms(
            lambda: SA.scatter_blocked(vals, dests, blocked), reps),
        'blocked_scatter_max_abs_err': blocked_err,
        'scatter_bound_ms': 12 * n / HBM_BYTES_PER_S * 1e3,
    }


def measure_wide(n: int = WIDE_PAIRS, key_bits: int = WIDE_KEY_BITS,
                 reps: int = 10) -> typing.Dict[str, typing.Any]:
    """``radix_sort_pairs`` against one stable ``torch.sort`` of the pairs
    at B10's pass shape: n random int64 keys below 2^key_bits (numpy's
    ``default_rng(1)``) with the values 0..n-1."""
    dev = torch.device('cuda')
    rng = np.random.default_rng(1)
    keys = torch.from_numpy(rng.integers(0, 1 << key_bits, n,
                                         dtype=np.int64)).to(dev)
    vals = torch.arange(n, dtype=torch.int32, device=dev)
    work_k, work_v = keys.clone(), vals.clone()

    def reset():
        work_k.copy_(keys)
        work_v.copy_(vals)

    def torch_pairs():
        ks, order = torch.sort(keys, stable=True)
        return ks, vals[order]

    rk, rv = SA.radix_sort_pairs(work_k, work_v, key_bits)
    tk, tv = torch_pairs()
    err = max(int((rk - tk).abs().max()), int((rv - tv).abs().max()))
    del tk, tv
    return {
        'n': n, 'key_bits': key_bits, 'radix_sort_passes': passes(key_bits),
        'torch_sort_pairs_ms': cuda_ms(torch_pairs, reps),
        'radix_sort_pairs_ms': cuda_ms(
            lambda: SA.radix_sort_pairs(work_k, work_v, key_bits), reps,
            reset),
        'radix_sort_max_abs_err': err,
        'sort_bound_ms': 24 * n / HBM_BYTES_PER_S * 1e3,
    }


def main(argv: typing.Optional[typing.List[str]] = None) -> int:
    args = sys.argv[1:] if argv is None else argv
    log2n = int(args[0]) if args else 24
    if not torch.cuda.is_available():
        print('sort_bench: no CUDA device; nothing to measure',
              file=sys.stderr)
        return 2
    print(json.dumps({**measure(log2n), 'wide': measure_wide()}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
