"""Time and profile the suffix-array build's kernels on one CUDA card, for
this checkout or for another one:

    python pysubstringsearch_tpu_torch/sa_bench.py [--tree ROOT] [--profile]

It imports ``pysubstringsearch_tpu_torch`` from the checkout at ROOT (by
default the one holding this file) and measures it with this checkout's
``sort_bench``, so the same script times an older checkout unpacked beside
this one; to compare two, run them in turns in one call on one card
(parent, change, change, parent).  It prints one JSON line of CUDA-event
times (``sort_bench.cuda_ms``: the mean of ``REPS`` runs after one warm-up):

- ``radix_sort_pairs`` beside one stable ``torch.sort`` of the pairs
  (``sort_bench.measure_wide``) at 2^26 pairs x 30 bits, 21 Mi x 60 bits
  and 2^29 x 25 bits;
- B8 (``gather_hits_flat``, the whole call) on ``sort_bench.skewed_batch``:
  one query of 2^24 + 3 hits beside 10,000 small ones;
- B15's capped gather (``gather_hit_positions``, the whole call) of 64
  columns for the skewed batch's 10,001 queries;
- on ``bench.make_corpus(500)`` as one row padded to 512 Mi slots (cached
  in ``--corpus``): B10's init, its first pass (k = 3, off = 0) from the
  init's state, the whole doubler (wall seconds, passes, peak GiB above
  what was resident), B1b + B2 on the same row (wall, peak) and B2's round
  1 after B1b (k = 6) from a copy of B1b's state.

With ``--profile`` it first prints the device time by kernel
(``torch.profiler``'s ``key_averages``) of B10's init, of that first pass
and of B2's round 1, one ``PROFILE`` line each, and the group sizes of
round 1's tied groups (``HISTOGRAM``: groups and slots of 2, 3-16, 17-256,
257-4096 and more members).  Without a CUDA card it prints nothing to
stdout and exits 2.
"""

import argparse
import importlib.util
import json
import os
import sys
import tempfile
import time

#: Timed runs of each measurement after its warm-up.
REPS = 5


def _wall_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _profile(torch, label, fn):
    """One PROFILE line: device microseconds by kernel of one run."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # acc_events: the profiler may flush its buffers mid-run, and would then
    # report only the kernels after the last flush.
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ('device_time_total' if hasattr(events[0], 'device_time_total')
           else 'cuda_time_total')
    rows = sorted(((getattr(e, key), e.count,
                    e.key.replace('(anonymous namespace)::', '').split('(')[0])
                   for e in events if getattr(e, key) > 0), reverse=True)
    print('PROFILE ' + json.dumps({
        'label': label, 'device_us': sum(r[0] for r in rows),
        'by_kernel_us': [[name, us, count] for us, count, name in rows]}),
        flush=True)


def main(argv=None) -> int:
    own = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=os.path.dirname(own),
                    help='checkout whose package to time (default: this one)')
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--corpus', default=os.path.join(
        tempfile.gettempdir(), 'sa_bench_corpus.npy'))
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('sa_bench: no CUDA device; nothing to measure', file=sys.stderr)
        return 2
    # Run as a script, this file's own directory leads sys.path; the
    # package comes from the chosen checkout's root instead.
    sys.path = [p for p in sys.path if os.path.abspath(p) != own]
    sys.path.insert(0, os.path.abspath(args.tree))
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    # This checkout's sort_bench, bound to the chosen checkout's package.
    spec = importlib.util.spec_from_file_location(
        'pysubstringsearch_tpu_torch.sort_bench',
        os.path.join(own, 'sort_bench.py'))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    dev = torch.device('cuda')
    out = {'tree': args.tree, 'device': torch.cuda.get_device_name(0)}
    sort_err = 0
    # 64 Mi as sort_bench's, one B10 pass's shape, B10's init at 512 Mi.
    for n, bits in ((1 << 26, 30), (bench.WIDE_PAIRS, bench.WIDE_KEY_BITS),
                    (1 << 29, 25)):
        w = bench.measure_wide(n, bits, REPS)
        out[f'sort_{n}x{bits}_ms'] = w['radix_sort_pairs_ms']
        out[f'torch_sort_{n}x{bits}_ms'] = w['torch_sort_pairs_ms']
        sort_err = max(sort_err, w['radix_sort_max_abs_err'])
        torch.cuda.empty_cache()
    out['sort_max_abs_err'] = sort_err

    sa, lo, cnt = (torch.from_numpy(a).to(dev) for a in bench.skewed_batch())
    out['b8_skewed_ms'] = bench.cuda_ms(
        lambda: S.gather_hits_flat(sa, lo, cnt), REPS)
    # Many runs: one call takes some microseconds.
    out['b15_gather_ms'] = bench.cuda_ms(
        lambda: S.gather_hit_positions(sa, lo, cnt, 64), 50 * REPS)
    del sa
    torch.cuda.empty_cache()

    if not os.path.exists(args.corpus):
        from bench import make_corpus  # the checkout's, on sys.path

        np.save(args.corpus, np.frombuffer(make_corpus(500, 0)[0], np.uint8))
    data = np.load(args.corpus)
    n = data.size
    text = torch.zeros(1 << 29, dtype=torch.uint8, device=dev)
    text[:n] = torch.from_numpy(data).to(dev)
    first = SA.sa_init3_bytes(text, n)
    state = [t.clone() for t in first]

    def restore():
        for s, t in zip(state, first):
            s.copy_(t)

    if args.profile:
        _profile(torch, 'b10 init', lambda: SA.sa_init3_bytes(text, n))
        restore()
        _profile(torch, 'b10 pass k3 off0',
                 lambda: SA.sa_rotating_pass(*state, 3, 0))
    out['b10_init_ms'] = bench.cuda_ms(lambda: SA.sa_init3_bytes(text, n),
                                       REPS)
    restore()
    out['b10_pass_m'] = SA.sa_rotating_pass(*state, 3, 0)[3]
    out['b10_pass_ms'] = bench.cuda_ms(
        lambda: SA.sa_rotating_pass(*state, 3, 0), REPS, restore)
    del state, first
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (sa_k, _, ties), out['b10_doubler_s'] = _wall_s(
        torch, lambda: SA.segmented_rotating_sa(text, n))
    out['b10_peak_gib'] = (torch.cuda.max_memory_allocated() - base) / 2**30
    out['b10_passes'] = sum(map(len, ties))
    del sa_k
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, out['b1b_b2_s'] = _wall_s(torch, lambda: SA.segmented_sa(text, n))
    out['b1b_b2_peak_gib'] = (torch.cuda.max_memory_allocated() - base) / 2**30
    first = SA.sa_init_bytes(text, n)
    state = [t.clone() for t in first]
    if args.profile:
        hist = getattr(SA, 'tie_group_histogram', None)
        if hist is not None:
            print('HISTOGRAM ' + json.dumps({'label': 'b2 round 1 after b1b',
                                             'groups_slots': hist(first[2])}),
                  flush=True)
        _profile(torch, 'b2 round 1 k6',
                 lambda: SA.sa_refine_round(*state, SA.BYTE_INIT_WIDTH))
        restore()
    out['b2_round1_m'] = SA.sa_refine_round(*state, SA.BYTE_INIT_WIDTH)
    out['b2_round1_ms'] = bench.cuda_ms(
        lambda: SA.sa_refine_round(*state, SA.BYTE_INIT_WIDTH), REPS, restore)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
