#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # 500 MB corpora, 10k + 200 patterns

Every phase checks every pattern's count against the host path and runs
its probe and gather kernels over the whole batch against their plain
versions; it makes and checks lines (``search_multiple``) for its line
batch: the first ``LINE_PATTERNS`` (2000) patterns with all its deep and
odd ones.

Phases (any failure raises and exits non-zero):

1. print the torch / CUDA / nvcc versions and the card; build the CUDA
   kernels from ``pysubstringsearch_tpu_torch/csrc`` and time the build;
2. build ``bench.make_corpus(--mb)`` into a container in 8 MiB chunks with
   the port's Writer (native SA-IS, host only), then again at
   ``sa_backend='auto'`` (the ``writer`` phase: the chunks its rule sends
   to the card, both walls, the containers equal);
3. the main path, with every kernel launch count set to 0 first:
   ``Reader(path)`` derives its index on the card over merged rows (text
   up, SA by B1 and B2, limbs and tables by K1-K3, then the ``device-warm``
   probe), ``wait_device_ready()`` must be True, and on the device route
   (forced with the routing knobs, :func:`forced`) ``search_multiple``
   answers the line batch of the 10k-pattern batch of ``bench.py`` plus
   200 patterns of 23-200 bytes (K4, then B8 on every merged row), and
   ``search`` answers one pattern, which must launch K4 and B8 again;
   every kernel of the path must have launched; then the line batch and
   one pattern under the routing rule, the route each took and its lines
   against the device route's;
4. each kernel against its plain PyTorch version on the card, on the
   index's own tensors, equal exactly, both timed with CUDA events beside
   the kernel's bound (its inputs read once and outputs written once at
   3.35 TB/s) and, where one PyTorch call computes the same function, that
   call's time: K1-K3 and B1 and one B2 round on row 0 (K1 also on a
   small row cut from it, N = n = 4111, whose last pack tile is partial;
   B1's path, its
   buckets by its keys' top 16, 24 and 32 bits and its device time by
   kernel from ``torch.profiler``; the round's tied groups by size and
   its device time by kernel),
   K4 and B8 on every row x the whole batch, and the whole ``derive_sa`` of
   every row; then, launch counts from 0, B13 (``bwt_from_sa_device``) on
   row 0 and on chunk 0 and B15's capped gather of row 0's hits, each
   against its plain version (B13 also against the host BWT and, on chunk
   0, ``unbwt_native`` and ``bwt()``; the gather against B8's blocks, and
   its kernel's device time beside ``torch.take``'s), and B15's bucket
   table at depth 2 and 3 against its plain version;
5. the device path's answers against the host native path's: per-pattern
   counts summed over rows and chunks; the lines ``search_multiple``
   returned in 3 against one timed ``HostServing.search`` of the line
   batch,
   pattern by pattern (each pattern's block as long as the host's list and
   holding its lines as a multiset); ``_search_batch`` per pattern for a
   sample of 200; and one pattern across every container chunk boundary
   (which a merged row must not match);
6. serving numbers: probe p50 for the whole batch, the device probe
   against the native host probe for batches of 1-8 patterns, the split
   of the device load, and where row 0's line extraction goes; the
   routing constants on this card and host (link rates and the 1-pattern
   round trip the load measured, the host probe's seconds a (pattern,
   chunk), B1b + B2 and native SA-IS on an 8 MiB chunk); and the route
   sweep: batches of 1, 16, 256 and 2200 line patterns, each route forced
   in turn and under the rule, each run's wall, route (from the launch
   counts of K4 and B8 and the ``x-host-*`` phases), lines (equal across
   routes) and phases, and the smallest per-row readback at which the
   host beat the device route;
7. the upload path (``Reader(path, index_mode='upload')``) after the derive
   Reader is freed: launch counts from 0, K1-K4 against their plain
   versions, counts against the host, and the same serving numbers;
8. the scale-out path on the same container after the upload Reader is
   freed: a 1-process NCCL group, the 63 chunks stacked as rows at the
   upload geometry, and, launch counts from 0, ``make_sharded_build`` (B9
   a row), ``make_sharded_probe`` (one B15 launch, then the all-gather)
   and ``make_full_step``; every row's SA against native SA-IS, every B15
   count against K4's upload count, B15 against its plain version, the
   collectives timed; then ``ShardedReader`` on the card, a
   ``MultiHostReader`` of two worker processes over ``convert_index``'s
   two shards (a gloo group: one card holds one NCCL rank), and the CLI's
   ``search`` and ``shard`` as processes, each against the single
   Reader's lines for the first 2000 patterns;
9. the raw kind after the scale-out phase: ``make_raw_corpus(--mb)``
   (``make_corpus`` with word bytes 33-126, so 96 distinct bytes and no
   NUL) in a container of its own; launch counts from 0, then ``Reader``
   derives it over merged rows (SA by B1b and B2 from k = 6, tables by K7
   and K3, limbs by K6 from the text, no K5) and answers the same kind of
   batch plus a few patterns holding NUL or a byte >= 0x80 (on the device
   route, then under the rule, as in 3); B1b, one B2
   round, K5, K6, K7 and K3 against their plain versions on row 0, timed
   (K5, the JAX raw_pack_jit's counterpart, on no path; K7 also on a row
   of N = n = 4111 cut from row 0); every row's
   ``derive_sa`` against its plain version and row 0's SA against the
   host's native SA-IS; K4 and B8 on every row against their plain
   versions; the answers against the host as in 5; probe p50, and the
   probe's host NUL check (``DeviceIndex.probe``'s lines for the raw kind)
   timed alone on the batch; and two small full-byte chunks (255 distinct bytes), derived on the card (SA
   against native SA-IS, K7 with K3 at base 258, K4) and uploaded (K6, K7
   and K3 launched once a chunk, row 0's table and limbs against the host
   builders, K4);
10. the digit kind: ``make_digit_corpus(--mb)`` (the lines of
   ``make_raw_corpus(--mb // 2)`` as UTF-16LE: 97 distinct bytes with NUL)
   written by the Writer at its default ``'auto'``, so on the card, with
   launch counts from 0: B1b once for every chunk its rule sends to the
   card (every chunk of at least 64 KiB, at the H100's rates), and
   every chunk's SA against native SA-IS; then, counts from 0 again,
   ``Reader(path)`` derives it (SA by B1b and B2, bucket table 258^3 and
   5 limb planes by B12d: one K7 pass a row for the table, the planes from
   the text; probe B11, hits B8) and
   answers (on the device route, then under the rule, as in 3) 10k
   patterns of 4-12 characters, 500 of 4-12 bytes, the 200
   deep ones, patterns of 1-2 bytes and patterns holding a byte >= 0x80
   (count 0); K7, K3 and the limb planes on row 0, B1b and one B2 round
   on row 0 (paths, buckets, group sizes and device time as above), B1b
   on the Writer's first chunk (one launch, padded as the Writer pads it,
   with its path, buckets and device time), and B11 and B8 on every
   row against their plain versions, timed; B11 on NUL and newline
   patterns (every line hits) against its plain version and their counts
   against the host; bench.py's byte sampler (10k patterns of 4-12 bytes)
   through B11 and B8 against their plain versions and its counts against
   the host, pattern by pattern, without lines; every row's
   ``derive_sa``; the answers against the host as in 5; probe p50;
   and a digit index of two 4 MiB chunks in ``mode='upload'`` (the digit
   aux launched once a chunk, row 0's table and limbs against the host
   builders, B11);
11. B9 with launch counts from 0: ``suffix_array_torch(algorithm='full')``
    on two 8 MiB digit chunks against native SA-IS, timed against
    ``'segmented'``, and ``suffix_array_int(backend='torch')`` on 4 Mi
    values at k = 2^20 against native; then B9's init and one round
    against their plain versions, timed, and the whole byte and integer
    doubling against plain;
12. the big-row derive (``bigrow``): the corpus of 2, made once, written by
    the Writer at its defaults (one 512 MiB chunk, its SA built on the card
    by B1b and B2, launch counts from 0) and checked against native SA-IS
    of the corpus (run on a host thread since the corpus was made); then,
    counts from 0, ``Reader(path)`` derives the
    single row of N = 512 Mi through B10 (the 3-byte init and the windowed
    passes, no B1, not poisoned; passes per round, m_w, ``index-sa`` and
    the load's memory peak logged; the SA equal to the container's) and
    answers the ranked batch (counts and lines against the host, one
    ``search``, probe p50, K4 against its plain version); B10's init, one pass and the whole doubler
    against their plain versions on the row, timed beside their bounds and
    one ``torch.sort`` of their keys; B1b + B2 on the same row, timed with
    its memory peak, its SA equal; then a 400 MiB period-2 row (N = 416
    Mi) in ``DeviceIndex(mode='derive')`` must be poisoned and re-derived
    by B9 (SA equal to native SA-IS, also run on a host thread from the
    start; time and peak logged), and a small
    all-``a`` row must be poisoned in kernel and plain;
13. B14g (``giant``), ``make_giant_chunk_build``: the big row's SA again
    with its positions split over ``GIANT_PLACEMENTS`` (4) placements of
    the card, launch counts from 0 (B14g's kernels, the radix sort, the
    max scan and the scatter must launch), against native SA-IS of 12 and
    the pad slots in closed form, its wall, rounds, memory peak (at most
    ``SA_BUILD_BYTES_PER_SLOT`` bytes a slot with the text) and every
    sort's largest receive against 2B + S; its kernels against their
    plain versions on the row's shapes, timed beside their bounds; then
    on a 1-process NCCL group (every exchange an ``all_to_all_single``)
    an 8 MiB chunk of the corpus against B9 and native SA-IS and 64 MiB
    of ``ab`` (all ties) against its closed form and B9;
14. B16 (``b16``): ``sort_bench`` at 2^24, 2^26 and 2^27 (the giant
    build's rank store, a permutation of 128 Mi), launch counts from 0:
    the scatter kernel equal to its plain version, timed beside its bound,
    the plain and library scatters, one ``torch.sort`` of (key, value)
    pairs and the port's ``radix_sort_pairs`` (equal, with its pass
    count), both sorts again at one B10 pass's shape (21 Mi pairs of
    60-bit keys); and B8 on a skewed batch (one query of 2^24 + 3 hits
    beside 10,000 small ones and runs of zero counts) against its plain
    version, timed as a whole call and as the kernel alone;
15. one JSON line of kernels (each with its launches on its path, error,
    time, plain time, bound and library-call time), the card's name and
    power limit, and the result line ``{"ok": true, "device": {...}}``
    last.

It exits non-zero, printing no result, when CUDA is unavailable or when
it is run outside a checkout of the repository.
"""

import argparse
import contextlib
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

#: Entry points the derive main path launches (the JSON line lists the
#: seven TPU kernels among them; the tie scan and the exclusive scan are
#: B2's and B8's first launches).
PATH_KERNELS = ('ranked_pack', 'ranked_limb_planes', 'seed_table',
                'probe_phased', 'sa_init_ranked', 'sa_tie_scan',
                'sa_refine_round', 'sa_roll_front', 'scan_exclusive_sum',
                'gather_hits_flat')
UPLOAD_KERNELS = ('ranked_pack', 'ranked_limb_planes', 'seed_table',
                  'probe_phased')
#: Entry points the raw-kind derive path launches.
RAW_KERNELS = ('sa_init_bytes', 'sa_tie_scan', 'sa_refine_round',
               'sa_roll_front', 'seed_prefix', 'seed_table',
               'raw_limb_planes', 'probe_phased', 'scan_exclusive_sum',
               'gather_hits_flat')
#: Entry points the digit-kind derive path launches.
DIGIT_KERNELS = ('sa_init_bytes', 'sa_tie_scan', 'sa_refine_round',
                 'sa_roll_front', 'seed_prefix', 'seed_table',
                 'digit_limb_planes', 'probe_limbs', 'scan_exclusive_sum',
                 'gather_hits_flat')
#: Entry points the Writer's device build launches (B1b and B2).
WRITER_KERNELS = ('sa_init_bytes', 'sa_tie_scan', 'sa_refine_round')
#: Entry points the big-row derive path launches: B10 and the ranked aux
#: and probe (a single-chunk row extracts on the host, so no B8).
BIGROW_KERNELS = ('sa_init3_bytes', 'sa_window_scan', 'sa_rotating_pass',
                  'sa_roll_front', 'ranked_pack', 'ranked_limb_planes',
                  'seed_table', 'probe_phased')
#: Entry points a poisoned big row launches: B10 until the poison, then B9.
FALLBACK_KERNELS = ('sa_init3_bytes', 'sa_window_scan', 'sa_full_init_bytes',
                    'sa_full_round', 'sa_roll_front')
#: Entry points of B9's paths: the 'full' build and the integer alphabet.
B9_KERNELS = ('sa_full_init_bytes', 'sa_full_init_ranks', 'sa_full_round')
#: Entry points the scale-out path launches: B9 a row for the sharded
#: build and the full step, B15 once for each probe.
PARALLEL_KERNELS = ('sa_full_init_bytes', 'sa_full_round', 'sa_roll_front',
                    'probe_bytes')
#: Bytes of the period-2 row that must poison B10 (N = 416 Mi, past
#: SEGMENTED_MAX_N) and fall back to B9.
POISON_ROW_BYTES = 400 << 20
#: Entry points of B14g's steps of its own (the giant build also runs the
#: radix sort, the max scan and the scatter).
GIANT_KERNELS = ('giant_byte_keys', 'giant_round_keys', 'giant_cuts',
                 'giant_partition', 'giant_flags', 'radix_sort_pairs',
                 'scan_inclusive_max', 'scatter')
#: Placements of one card the giant build splits the big row over.
GIANT_PLACEMENTS = 4
#: The world-1 giant builds: an 8 MiB chunk of the corpus (its padded row
#: 8 Mi) and a period-2 row, all ties, of 64 MiB.
GIANT_CHUNK_BYTES = (8 << 20) - 300
GIANT_PERIOD2_BYTES = 64 << 20
#: Patterns a phase makes and checks lines for (``line_batch``): the
#: first of its batch, with all its deep and odd ones.  Every pattern's
#: count is checked against the host, and the probe and gather kernels run
#: over the whole batch against their plain versions; lines for the whole
#: batch in every phase (about 22 M each) would take half the run's time
#: limit on a slow host.
LINE_PATTERNS = 2000
#: The deep patterns (23-200 bytes) ``sample_patterns`` appends.
DEEP_PATTERNS = 200
#: Patterns (the first of the ranked batch) that ShardedReader,
#: MultiHostReader and the CLI answer against the single Reader.
SHARD_PATTERNS = 2000
#: Seconds a MultiHostReader worker or a CLI process may take.
WORKER_TIMEOUT_S = 600

#: Device memory rate of the H100 SXM (NVIDIA's data sheet), bytes/s.
HBM_BYTES_PER_S = 3.35e12

SEARCH_SRC = 'pysubstringsearch_tpu_torch/csrc/search_kernels.cu'
SA_SRC = 'pysubstringsearch_tpu_torch/csrc/suffix_array_kernels.cu'
BWT_SRC = 'pysubstringsearch_tpu_torch/csrc/bwt_kernels.cu'
JAX_SEARCH = 'pysubstringsearch_tpu/ops/search.py'
JAX_SA = 'pysubstringsearch_tpu/ops/suffix_array.py'
JAX_BWT = 'pysubstringsearch_tpu/ops/bwt.py'
GIANT_SRC = 'pysubstringsearch_tpu/parallel/sharded.py:93'


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, reps, setup=None):
    """Mean milliseconds of ``fn`` over ``reps`` runs after one warm-up
    run, CUDA events around each run; ``setup`` (not timed) runs before
    each."""
    import torch

    if setup:
        setup()
    fn()
    total = 0.0
    for _ in range(reps):
        if setup:
            setup()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def p50_ms(fn, reps=51):
    """Median host wall milliseconds of ``fn`` over ``reps`` runs, after
    one warm-up run; ``fn`` must return only once its work is done."""
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] * 1e3


def wall_s(fn):
    """(result, host wall seconds) of ``fn`` ended by a synchronise."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_times(fn):
    """Device microseconds of one run of ``fn`` by kernel, from
    ``torch.profiler``'s ``key_averages``: (total, [[kernel, us, calls],
    ...] largest first)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    # acc_events: the profiler may flush its buffers mid-run, and would then
    # report only the kernels after the last flush.
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    key = ('device_time_total' if events and hasattr(events[0],
                                                     'device_time_total')
           else 'cuda_time_total')
    rows = sorted(((getattr(e, key), e.count,
                    e.key.replace('(anonymous namespace)::', '').split('(')[0])
                   for e in events if getattr(e, key) > 0), reverse=True)
    return sum(r[0] for r in rows), [[n, us, c] for us, c, n in rows]


def err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def sort_ms(keys):
    """Milliseconds of one stable ``torch.sort`` of int64 ``keys`` with its
    indices: the library call beside a sort kernel."""
    import torch

    ms = cuda_ms(lambda: torch.sort(keys, stable=True), 3)
    del keys
    return ms


def gather_ms(src, sa, offset, stride, K):
    """Milliseconds of one ``torch.take`` of ``src`` at every limb plane's
    indices ``sa[i] + offset + stride * j`` (made beforehand, untimed): the
    library call beside a limb-plane kernel."""
    import torch

    N = src.shape[0]
    idx = (sa.long().clamp(0, N - 1)[None, :] + offset
           + stride * torch.arange(K, device=sa.device)[:, None])
    idx = idx.clamp(max=N - 1).reshape(-1)
    ms = cuda_ms(lambda: torch.take(src, idx), 5)
    del idx
    return ms


def searchsorted_ms(src, sa, n, size, shift):
    """Milliseconds of one ``torch.searchsorted`` of every table entry into
    the keys ``src[sa[i]] >> shift`` in SA order, gathered beforehand (the
    library call beside K3), and of the same with the gather timed too
    (what a PyTorch user pays for K3's function)."""
    import torch

    def gather():
        return src[sa[:n].long()].long() >> shift

    keys = gather()
    probes = torch.arange(size, dtype=torch.int64, device=src.device)
    ms = cuda_ms(lambda: torch.searchsorted(keys, probes), 5)
    with_gather_ms = cuda_ms(lambda: torch.searchsorted(gather(), probes), 5)
    del keys, probes
    return ms, with_gather_ms


def pad_slots(N, n, dev):
    """The pad slots of B9's sa_full, closed-form: [N - 1, ..., n]."""
    import torch

    return torch.arange(N - 1, n - 1, -1, dtype=torch.int32, device=dev)


def table_bytes(table):
    """K3's bytes: the table written once and, for each entry, at least one
    (SA slot, key) pair read."""
    return 12 * table.shape[0]


def probe_bytes(idx, packed_np):
    """A probe's bytes: the patterns and lengths read once, and for each
    (row, pattern) the bounds written and at least the four seed-table
    entries read."""
    C = idx.num_chunks
    B, L = packed_np.shape
    return B * L + 4 * B + C * B * 24


def hit_slots(lower, count):
    """int64 SA slots of every hit in B8's output order (made beforehand,
    for the library gather)."""
    import torch

    count = count.long()
    qid = torch.repeat_interleave(
        torch.arange(count.shape[0], device=count.device), count)
    starts = torch.cumsum(count, 0) - count
    return (lower.long()[qid]
            + torch.arange(qid.shape[0], device=count.device) - starts[qid])


def sh(cmd):
    try:
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f'unavailable ({exc})'


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--mb', type=int, default=500,
                    help='corpus size in MiB (default 500, bench.py\'s)')
    ap.add_argument('--queries', type=int, default=10000)
    ap.add_argument('--chunk-mb', type=int, default=8)
    ap.add_argument('--seed', type=int, default=0, help='corpus seed')
    args = ap.parse_args()

    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device; nothing to measure',
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from bench import make_corpus
    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels

    t_start = time.perf_counter()
    dev = torch.device('cuda')
    card = sh(['nvidia-smi', '--query-gpu=name,power.limit',
               '--format=csv,noheader'])
    # ---- 1. toolchain and kernel build ----
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} '
        f'x{torch.cuda.device_count()}')
    log('nvcc: ' + sh([kernels.nvcc_path(), '--version']).splitlines()[-1])
    log('card: ' + card)
    t0 = time.perf_counter()
    kernels.library()
    kernel_build_s = time.perf_counter() - t0
    log(f'kernel build (every csrc/*.cu in parallel, then one link): '
        f'{kernel_build_s:.2f} s')

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    result = {'kernel_build_s': kernel_build_s, 'phases_s': {}}
    kernel_rows = []
    tmp_root = '/dev/shm' if os.path.isdir('/dev/shm') else None
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        def timed(phase, fn):
            t = time.perf_counter()
            out = fn()
            result['phases_s'][phase] = time.perf_counter() - t
            log(f'phase {phase}: {result["phases_s"][phase]:.1f} s')
            free()
            return out

        # ---- 2-7. the ranked corpus: derive main path, then upload ----
        # Made once: the big-row phase writes the same bytes again.  Its
        # native SA-IS references (of the corpus and of the poisoning row)
        # run from now on, on two host threads beside every earlier phase.
        t0 = time.perf_counter()
        corpus = make_corpus(args.mb, args.seed)[0]
        log(f'bench.make_corpus({args.mb}): {time.perf_counter() - t0:.1f} s')
        adv = poison_row()
        natives = ThreadPoolExecutor(max_workers=2)
        refs = (natives.submit(timed_native, np.frombuffer(corpus, np.uint8)),
                natives.submit(timed_native, adv))
        idx_path, result['index_build_s'], pats = build_container(
            pss, lambda: corpus, d, 'corpus', args)
        result['writer'] = timed('writer', lambda: writer_auto_check(
            pss, corpus, d, args, idx_path, result['index_build_s'], card))
        result['derive'] = timed('ranked', lambda: run_derive(idx_path, pats,
                                                              dev, card))
        kernel_rows += result['derive'].pop('kernels')
        result['upload'] = timed('upload', lambda: run_upload(idx_path, pats,
                                                              dev))
        upload_bounds = result['upload'].pop('bounds')
        shard_ref = result['upload'].pop('shard_ref')
        # ---- 8. the scale-out path on the same container ----
        result['parallel'] = timed('parallel', lambda: run_parallel(
            idx_path, pats, dev, upload_bounds, shard_ref, d))
        kernel_rows += result['parallel'].pop('kernels')
        del shard_ref, upload_bounds
        os.remove(idx_path)
        # ---- 9. the raw kind ----
        raw_path, result['raw_index_build_s'], raw_pats = build_container(
            pss, lambda: make_raw_corpus(args.mb, args.seed), d, 'raw', args)
        result['raw'] = timed('raw', lambda: run_raw(
            raw_path, raw_pats, dev, result['derive']['rows']))
        kernel_rows += result['raw'].pop('kernels')
        os.remove(raw_path)
        # ---- 10-12. the digit kind, written on the card; B9 ----
        (digit_path, result['digit_writer'], (digit_pats, byte_pats),
         native_sas, chunk_datas) = write_digit_container(pss, d, args)
        result['digit'] = timed('digit', lambda: run_digit(
            digit_path, digit_pats, byte_pats, dev, chunk_datas))
        kernel_rows += result['digit'].pop('kernels')
        result['b9'] = timed('b9', lambda: run_b9(chunk_datas, native_sas,
                                                  dev))
        kernel_rows += result['b9'].pop('kernels')
        del chunk_datas
        # ---- 12-13. the big-row derive (B10) and B16 ----
        result['bigrow'] = timed('bigrow', lambda: run_bigrow(
            corpus, adv, refs, pats, d, dev))
        natives.shutdown()
        kernel_rows += result['bigrow'].pop('kernels')
        # ---- 13. B14g on the big row ----
        result['giant'] = timed('giant', lambda: run_giant(corpus, refs[0],
                                                           d, dev))
        kernel_rows += result['giant'].pop('kernels')
        del corpus, adv, refs
        result['b16'] = timed('b16', run_b16)
        kernel_rows += result['b16'].pop('kernels')
    result['total_s'] = time.perf_counter() - t_start
    log('summary: ' + json.dumps(result))
    log(json.dumps({'kernels': kernel_rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def make_raw_corpus(mb, seed=0):
    """``bench.make_corpus`` with one change: the 10,000 vocabulary words
    draw their bytes from 33-126 instead of 97-122, so the corpus holds 96
    distinct bytes (94 printable, space, newline) and no NUL, the raw kind.
    Word lengths, the word indices and the lines are ``make_corpus``'s own:
    its lowercase draw is replayed and dropped so the seeded index draw
    lines up, and the word bytes come from a second generator.  Built with
    numpy: the same bytes as a loop that joins 8 words a line until the
    target size is reached."""
    import numpy as np

    rng = np.random.default_rng(seed)
    nwords = 10_000
    word_len = rng.integers(3, 12, size=nwords)
    for l in word_len:  # make_corpus's word draw, kept for its rng state
        rng.integers(97, 123, size=l, dtype=np.uint8)
    byte_rng = np.random.default_rng([seed, 33])
    words = [byte_rng.integers(33, 127, size=l, dtype=np.uint8).tobytes()
             for l in word_len]
    target = mb * 1024 * 1024
    widx = rng.integers(0, nwords, size=target // 4)
    # A line is 8 words, 7 spaces and its newline; lines are added until
    # their total reaches the target.
    line_bytes = word_len[widx[: widx.size // 8 * 8]].reshape(-1, 8).sum(1) + 8
    nlines = int(np.searchsorted(np.cumsum(line_bytes), target)) + 1
    tokens = widx[: 8 * nlines]
    last = np.arange(tokens.size) % 8 == 7
    pieces = np.array([w + b' ' for w in words] + [w + b'\n' for w in words],
                      dtype=object)
    return b''.join(pieces[tokens + nwords * last].tolist())


def build_container(pss, make, d, name, args, backend='native',
                    sampler=None):
    """Make a corpus with ``make()`` and write it with the port's Writer in
    ``--chunk-mb`` chunks, suffix arrays by ``backend``; returns (container
    path, build seconds, the patterns ``sampler`` (default
    :func:`sample_patterns`) draws from the corpus)."""
    import numpy as np

    t0 = time.perf_counter()
    corpus = make()
    sigma = np.count_nonzero(np.bincount(np.frombuffer(corpus, np.uint8),
                                         minlength=256))
    log(f'{name}: {len(corpus)} bytes, {sigma} distinct, made in '
        f'{time.perf_counter() - t0:.1f} s')
    corpus_path = os.path.join(d, f'{name}.txt')
    idx_path = os.path.join(d, f'{name}.idx')
    with open(corpus_path, 'wb') as f:
        f.write(corpus)
    t0 = time.perf_counter()
    with pss.Writer(idx_path, max_chunk_len=args.chunk_mb << 20,
                    sa_backend=backend) as w:
        w.add_entries_from_file_lines(corpus_path)
    build_s = time.perf_counter() - t0
    log(f'{name} index build (Writer, sa_backend {backend!r}): '
        f'{build_s:.2f} s, {len(corpus) / 1e6 / build_s:.1f} MB/s')
    os.remove(corpus_path)
    return idx_path, build_s, (sampler or sample_patterns)(corpus,
                                                           args.queries)


def sample_patterns(corpus, nq):
    """bench.py's sampler (4-12 bytes at random offsets, newlines replaced),
    plus 200 patterns of 23-200 bytes that reach the deep byte compare."""
    import numpy as np

    rng = np.random.default_rng(1)
    offs = rng.integers(0, len(corpus) - 16, size=nq)
    lens = rng.integers(4, 13, size=nq)
    pats = [corpus[o: o + l].replace(b'\n', b'x') for o, l in zip(offs, lens)]
    rng2 = np.random.default_rng(2)
    for o, l in zip(rng2.integers(0, len(corpus) - 256, size=200),
                    rng2.integers(23, 201, size=200)):
        pats.append(corpus[o: o + l])
    return pats


def line_batch(pats, tail):
    """The patterns a phase makes lines for: the first ``LINE_PATTERNS``
    of its batch and its last ``tail`` (its deep and odd ones)."""
    return pats[:LINE_PATTERNS] + pats[len(pats) - tail:]


def check_answers(r, idx, pats, packed_np, lengths_np, res, lpats):
    """The device path's answers against the host native path's: counts
    for every pattern of ``pats``; ``search_multiple``'s lines for
    ``lpats`` (``res``, the main path's own output, pattern after pattern)
    against ``HostServing.search`` of them, which is timed once here: the
    total, then each pattern's block of ``res`` (as long as the host's list
    for it) holds the host's lines as a multiset, so every pattern's
    result length and lines equal the host's; and ``_search_batch`` per
    pattern for a sample of 200.  Returns the host search's seconds."""
    import numpy as np

    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    hs = r._host_serving
    check(hs is not None, 'native host serving available')
    lo_h, cnt_h = hs.probe(*pack_patterns_host(pats))
    if idx.merged:
        cm = idx.count_matches(packed_np, lengths_np)
        check(np.array_equal(cm.sum(0), cnt_h.sum(0)),
              'merged-row counts summed over rows equal the host counts '
              'summed over chunks, per pattern')
    else:
        lo_d, cnt_d = idx.probe(packed_np, lengths_np)
        check(np.array_equal(cnt_d, cnt_h), 'device counts equal host')
        hit = cnt_h > 0
        check(np.array_equal(lo_d[hit], lo_h[hit]), 'lower bounds equal')
    log(f'counts equal for all {cnt_h.shape[1]} patterns, '
        f'{int(cnt_h.sum())} suffix hits')
    t0 = time.perf_counter()
    host_lists = hs.search(lpats)
    host_search_s = time.perf_counter() - t0
    host_lines = sum(map(len, host_lists))
    log(f'HostServing.search({len(lpats)}) on the host, one run: '
        f'{host_search_s:.3f} s, {host_lines} lines')
    check(len(res) == host_lines,
          f'search_multiple returned {len(res)} lines, the host path '
          f'{host_lines}')
    off = 0
    for i, want in enumerate(host_lists):
        check(sorted(res[off: off + len(want)]) == sorted(want),
              f'search_multiple lines of pattern {i} equal the host path')
        off += len(want)
    sample = np.random.default_rng(4).choice(len(lpats), 200,
                                             replace=False)
    dev_lists = r._search_batch([lpats[i] for i in sample])
    for got, i in zip(dev_lists, sample):
        check(sorted(got) == sorted(host_lists[i]),
              f'result multiset of pattern {i}')
    log('search_multiple\'s lines equal the host path\'s, pattern by '
        'pattern (length and multiset); _search_batch equal for a sample '
        'of 200')
    return host_search_s


def check_boundaries(r, idx):
    """One pattern across every container chunk boundary: a merged row's
    crossing occurrences are dropped and the results equal the host
    path's."""
    import numpy as np

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    chunks = r._chunks
    bpats = [chunks[c].data[-6:].tobytes() + chunks[c + 1].data[:6].tobytes()
             for c in range(len(chunks) - 1)]
    bp, bl = S.pack_patterns(bpats)
    crossings = idx.boundary_crossings(bp, bl)
    check(int(crossings.sum()) > 0, 'boundary patterns cross merged rows')
    check(np.array_equal(idx.count_matches(bp, bl).sum(0),
                         r._host_serving.probe(
                             *pack_patterns_host(bpats))[1].sum(0)),
          'boundary patterns: counts equal the host')
    with forced('device', r):  # the route that must drop crossings
        dev_b = r._search_batch(bpats)
    host_b = r._search_host_chunks(bpats)
    check([sorted(x) for x in dev_b] == [sorted(x) for x in host_b],
          'boundary patterns: results equal the host path')
    log(f'{len(bpats)} chunk-boundary patterns: {int(crossings.sum())} '
        f'crossing occurrences dropped, results equal the host path')


def probe_p50(idx, packed_np, lengths_np):
    """Median of 21 probes of the whole batch, host arrays in and out."""
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        idx.probe(packed_np, lengths_np)
        ts.append(time.perf_counter() - t0)
    p50 = sorted(ts)[len(ts) // 2] * 1e3
    log(f'probe p50 ({packed_np.shape[0]} patterns, host arrays in and '
        f'out): {p50:.3f} ms')
    return p50


def serving_numbers(r, idx, pats, packed_np, lengths_np, host_search_s):
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    hs = r._host_serving
    probe_p50_ms = probe_p50(idx, packed_np, lengths_np)
    small = {}
    for b in (1, 2, 4, 8):
        sp, sl = S.pack_patterns(pats[:b])
        hp, hl = pack_patterns_host(pats[:b])
        small[b] = {'device': p50_ms(lambda: idx.probe(sp, sl)),
                    'host': p50_ms(lambda: hs.probe(hp, hl))}
        log(f'probe of {b} pattern(s), p50 of 51: device '
            f'{small[b]["device"]:.4f} ms, native host '
            f'{small[b]["host"]:.4f} ms')
    with forced('device', r):
        one_dev = p50_ms(lambda: r._search_batch([pats[1]]))
    one_host = p50_ms(lambda: r._search_host_chunks([pats[1]]))
    log(f'search of 1 pattern end to end, p50 of 51: device route '
        f'{one_dev:.4f} ms, host route {one_host:.4f} ms')
    return {'probe_p50_ms': probe_p50_ms, 'small_probe_ms': small,
            'search_1_ms': {'device': one_dev, 'host': one_host},
            'host_search_s': host_search_s}


def main_path(r, strs, pats, prof_keys, probe='probe_phased'):
    """search_multiple of the batch and search of one pattern on the device
    route (forced, so that every kernel of the path launches), the one
    pattern launching the index's ``probe`` kernel once; returns (launch
    counts after each, e2e seconds and phase seconds of the
    search_multiple, its lines)."""
    from pysubstringsearch_tpu_torch.ops import kernels

    before = dict(r.profiler.totals)
    with forced('device', r):
        t0 = time.perf_counter()
        res = r.search_multiple(strs)
        e2e_s = time.perf_counter() - t0
        phases = {k: r.profiler.totals.get(k, 0.0) - before.get(k, 0.0)
                  for k in prof_keys}
        after = dict(kernels.LAUNCHES)
        one = r.search(strs[0])
    launches = dict(kernels.LAUNCHES)
    log(f'search_multiple({len(strs)}): {e2e_s:.3f} s, {len(res)} lines; '
        f'search(1 pattern): {len(one)} lines; launches {launches}')
    check(launches[probe] == after[probe] + 1,
          'search() of one pattern probed on the device')
    check(sorted(one) == sorted(r._search_host_chunks([pats[0]])[0]),
          'search() of one pattern equals the host path')
    log('phases of search_multiple: ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in phases.items()))
    return after, launches, e2e_s, phases, res


#: The Reader's routes a run can force (:func:`forced`), and the rule.
ROUTES = ('device', 'host_rows', 'whole_batch', 'tiny', 'rule')
#: Profiler phases read around a routed run.
ROUTE_PHASES = ('probe', 'extract', 'line-tables', 'x-dev-gather',
                'x-dev-lines', 'x-host-probe', 'x-host-gather',
                'x-host-spans', 'x-host-lines', 'hs-probe', 'hs-spans',
                'hs-fanout')


@contextlib.contextmanager
def forced(route, r):
    """Force one of Reader ``r``'s routes with the JAX package's knobs, or
    none for ``'rule'``: ``'device'`` (``HOST_PROBE_UNIT_S`` infinite and
    ``_READBACK_CAP`` past any readback: the device probe and, on merged
    rows, B8); ``'host_rows'`` (``_READBACK_CAP`` 0, the round trip 0 and
    no ``HostServing``, as a Reader without a container has: each merged
    row re-probed on the host); ``'whole_batch'`` (``_READBACK_CAP`` 0 and
    the round trip 0: the device probe, then ``HostServing.search`` when
    every merged row has hits); ``'tiny'`` (a round trip of 1000 s: the
    host alone)."""
    from pysubstringsearch_tpu_torch import api

    saved = (api.HOST_PROBE_UNIT_S, api.Reader._READBACK_CAP,
             os.environ.get('TPUSS_DEVICE_RTT'))
    hs = r._host_serving
    try:
        if route == 'device':
            api.HOST_PROBE_UNIT_S = float('inf')
            api.Reader._READBACK_CAP = 1 << 62
        elif route in ('host_rows', 'whole_batch'):
            api.Reader._READBACK_CAP = 0
            os.environ['TPUSS_DEVICE_RTT'] = '0'
            if route == 'host_rows':
                r._hostserve_obj = None
        elif route == 'tiny':
            os.environ['TPUSS_DEVICE_RTT'] = '1000'
        elif route != 'rule':
            raise ValueError(route)
        yield
    finally:
        api.HOST_PROBE_UNIT_S, api.Reader._READBACK_CAP = saved[:2]
        if saved[2] is None:
            os.environ.pop('TPUSS_DEVICE_RTT', None)
        else:
            os.environ['TPUSS_DEVICE_RTT'] = saved[2]
        r._hostserve_obj, r._hostserve_tried = hs, True


def routed(r, strs, route, probe='probe_phased', reps=1):
    """``search_multiple(strs)`` under ``route`` (:func:`forced`): (its
    lines, the median wall of ``reps`` runs in seconds, the route the run
    took as the launch counts of the probe kernel and B8 and the
    ``x-host-*`` phases show it, each phase's seconds in the last run)."""
    from pysubstringsearch_tpu_torch.ops import kernels

    walls = []
    with forced(route, r):
        for _ in range(reps):
            before = dict(kernels.LAUNCHES)
            pbefore = (dict(r.profiler.totals), dict(r.profiler.counts))
            t0 = time.perf_counter()
            res = r.search_multiple(strs)
            walls.append(time.perf_counter() - t0)
            probes = kernels.LAUNCHES[probe] - before[probe]
            gathers = (kernels.LAUNCHES['gather_hits_flat']
                       - before['gather_hits_flat'])
            host_rows = (r.profiler.counts.get('x-host-probe', 0)
                         - pbefore[1].get('x-host-probe', 0))
    phases = {k: r.profiler.totals.get(k, 0.0) - pbefore[0].get(k, 0.0)
              for k in ROUTE_PHASES if r.profiler.totals.get(k, 0.0)
              > pbefore[0].get(k, 0.0)}
    if not probes:
        took = 'host (no probe)'
    else:
        took = ' + '.join(
            [f'device rows ({gathers} B8)'] * bool(gathers)
            + [f'host rows ({host_rows} chunk probes)'] * bool(host_rows)
        ) or 'probe + HostServing (search or extract)'
    return res, sorted(walls)[len(walls) // 2], took, phases


def multiset_key(lines):
    """An order-free key of a list of lines (their count and the sum of
    their hashes): two routes' ``search_multiple`` of one batch return the
    same lines pattern after pattern, each pattern's in another order."""
    return len(lines), sum(map(hash, lines)) & ((1 << 64) - 1)


def rule_runs(r, strs, label, device_lines, probe='probe_phased'):
    """The line batch and its first pattern under the rule: route, wall,
    lines and phases logged and returned; the lines must equal the device
    route's (``device_lines``, the main path's ``search_multiple`` of the
    batch, and the first pattern's, searched here)."""
    with forced('device', r):
        one = r.search_multiple(strs[:1])
    out = {}
    for name, batch, want, reps in (('line_batch', strs, device_lines, 1),
                                    ('one_pattern', strs[:1], one, 5)):
        res, wall, took, phases = routed(r, batch, 'rule', probe, reps)
        check(multiset_key(res) == multiset_key(want),
              f'{label}the rule\'s lines equal the device route\'s '
              f'({name})')
        out[name] = {'patterns': len(batch), 'wall_s': wall, 'route': took,
                     'lines': len(res), 'phases_s': phases}
        log(f'{label}under the rule, {name} ({len(batch)} patterns): '
            f'{wall:.4f} s, route {took}, {len(res)} lines; phases '
            + json.dumps({k: round(v, 6) for k, v in phases.items()}))
    return out


def route_sweep(r, idx, lpats, card):
    """Batches of 1, 16, 256 and all of ``lpats`` (the line batch) on the
    ranked derive rows: each route forced in turn and the rule, each run's
    wall (median of 5 runs below 256 patterns), route, lines and phases,
    and each batch's hits per row (the readback at 4 bytes a hit).  Every
    route's lines must equal the device route's.  Returns the sweep and
    the smallest per-row readback (of the rows with hits) at which the
    route that exceeding ``_READBACK_CAP`` on every row sends a batch to
    (``whole_batch``) was faster than the device route."""
    from pysubstringsearch_tpu_torch.ops import search as S

    sweep = []
    for B in (1, 16, 256, len(lpats)):
        sub = lpats[:B]
        strs = [p.decode('latin-1') for p in sub]
        packed_np, lengths_np = S.pack_patterns(sub)
        hits = idx.probe(packed_np, lengths_np)[1].clip(min=0).sum(1)
        row = {'patterns': B, 'hits_per_row': hits.tolist(),
               'readback_bytes_per_row': (4 * hits).tolist(), 'routes': {}}
        want = None
        for route in ROUTES:
            res, wall, took, phases = routed(r, strs, route,
                                             reps=5 if B < 256 else 1)
            if want is None:
                want = multiset_key(res)
            check(multiset_key(res) == want,
                  f'sweep: route {route} returned the device route\'s lines '
                  f'for {B} patterns')
            row['routes'][route] = {'wall_s': wall, 'route': took,
                                    'lines': len(res), 'phases_s': phases}
            log(f'sweep B={B} ({card}): {route}: {wall:.4f} s, took {took}, '
                f'{len(res)} lines, hits per row {hits.tolist()}; phases '
                + json.dumps({k: round(v, 6) for k, v in phases.items()}))
        sweep.append(row)
    faster = [min(b for b in x['readback_bytes_per_row'] if b > 0)
              for x in sweep if any(x['readback_bytes_per_row'])
              and x['routes']['whole_batch']['wall_s']
              < x['routes']['device']['wall_s']]
    cap = min(faster) if faster else None
    log(f'sweep: smallest per-row readback at which the host (whole batch) '
        f'beat the device route: {cap} bytes ({card})')
    return sweep, cap


def routing_constants(r, idx, lpats, card):
    """The routing constants on this card and its host: the link rates and
    the 1-pattern probe's round trip the Reader's load measured (and a p50
    of 51 such probes beside it), the host probe's seconds per (pattern,
    chunk) from ``HostServing.probe`` of the line batch over the
    container's chunks (median of 5), and the two build rates on chunk 0:
    B1b + B2 (``segmented_sa`` on the padded chunk already on the card,
    CUDA events, no transfers) and one ``native.suffix_array_native``
    call."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.ops.hostserve import (
        HOST_PROBE_UNIT_S, pack_patterns_host)
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    hs = r._host_serving
    hp, hl = pack_patterns_host(lpats)
    cells = len(lpats) * hs.num_chunks
    unit_s = p50_ms(lambda: hs.probe(hp, hl), 5) / 1e3 / cells
    sp, sl = S.pack_patterns(lpats[:1])
    rtt_p50 = p50_ms(lambda: idx.probe(sp, sl)) / 1e3
    chunk = r._chunks[0].data
    n = int(chunk.size)
    N = SA._pad_len(n + SA.BYTE_INIT_WIDTH)
    padded = torch.zeros(N, dtype=torch.uint8, device=idx.device)
    padded[:n] = torch.from_numpy(np.array(chunk)).to(idx.device)
    check(np.array_equal(SA.segmented_sa(padded, n)[0][N - n:].cpu().numpy(),
                         r._chunks[0].suffix_array),
          'B1b + B2 on chunk 0 equal its container SA')
    device_ms = cuda_ms(lambda: SA.segmented_sa(padded, n), 3)
    del padded
    t0 = time.perf_counter()
    suffix_array_native(chunk)
    native_s = time.perf_counter() - t0
    out = {
        'card': card,
        'link_mbps': list(SA._LINK_RATES) if SA._LINK_RATES else None,
        'device_rtt_s': SA._DEVICE_RTT, 'probe_1_p50_s': rtt_p50,
        'host_probe_unit_s': unit_s, 'host_probe_cells': cells,
        'device_build_mbps': n / 1e6 / (device_ms / 1e3),
        'native_build_mbps': n / 1e6 / native_s, 'chunk_bytes': n,
        'in_use': {'link_mbps': list(SA.host_device_link_mbps(probe=False)),
                   'device_rtt_s': SA.device_rtt_estimate(idx.device),
                   'host_probe_unit_s': HOST_PROBE_UNIT_S,
                   'device_build_mbps': SA._DEVICE_BUILD_MBPS,
                   'native_build_mbps': SA._NATIVE_BUILD_MBPS,
                   'readback_cap': r._READBACK_CAP},
    }
    log(f'routing constants ({card}): link {out["link_mbps"]} MB/s (H2D, '
        f'D2H; 4 MB each, at load); 1-pattern probe round trip '
        f'{SA._DEVICE_RTT} s at load (fastest of 3), p50 of 51 {rtt_p50:.6f}'
        f' s; host probe {unit_s * 1e6:.4f} us a (pattern, chunk) '
        f'({len(lpats)} patterns x {hs.num_chunks} chunks, median of 5); '
        f'build rates on a {n}-byte chunk: B1b + B2 {device_ms:.3f} ms '
        f'({out["device_build_mbps"]:.1f} MB/s, device time), native SA-IS '
        f'{native_s:.3f} s ({out["native_build_mbps"]:.2f} MB/s); in use '
        + json.dumps(out['in_use']))
    return out


def writer_auto_check(pss, corpus, d, args, native_path, native_s, card):
    """The ranked corpus written again by the Writer at ``'auto'``, which
    builds each chunk on the card or natively by its rule, launch counts
    from 0: its wall beside the ``'native'`` Writer's (``native_s``), the
    chunks it built on the card, and the container's bytes (so every SA)
    equal to the native one's."""
    from pysubstringsearch_tpu_torch.container import read_container
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    corpus_path = os.path.join(d, 'auto.txt')
    path = os.path.join(d, 'auto.idx')
    with open(corpus_path, 'wb') as f:
        f.write(corpus)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with pss.Writer(path, max_chunk_len=args.chunk_mb << 20,
                    sa_backend='auto') as w:
        w.add_entries_from_file_lines(corpus_path)
    auto_s = time.perf_counter() - t0
    os.remove(corpus_path)
    sizes = [c.data.size for c in read_container(path).chunks]
    on_card = sum(s >= SA.DEVICE_MIN_N and SA._device_build_worthwhile(s)
                  for s in sizes)
    check(kernels.LAUNCHES['sa_init_bytes'] == on_card,
          f"the 'auto' Writer built the {on_card} chunks its rule sends to "
          f"the card there (B1b launched {kernels.LAUNCHES['sa_init_bytes']}"
          ' times)')
    with open(path, 'rb') as f, open(native_path, 'rb') as g:
        equal = f.read() == g.read()
    check(equal, "the 'auto' Writer's container equals the 'native' one's")
    os.remove(path)
    log(f"ranked Writer ({card}): 'auto' {auto_s:.2f} s ({on_card} of "
        f"{len(sizes)} chunks on the card), 'native' {native_s:.2f} s; "
        'containers (every SA) equal')
    return {'auto_s': auto_s, 'native_s': native_s, 'chunks': len(sizes),
            'on_card': on_card, 'equal': equal}


def bound_ms(nbytes):
    """The least milliseconds the card could take to move ``nbytes`` (each
    input read once, each output written once) at its 3.35 TB/s."""
    return nbytes / HBM_BYTES_PER_S * 1e3


def kernel_check(label='', entries=None, launches=None):
    """The ``entry(name, replaces, src, max_abs_err, ms, plain_ms, nbytes,
    library_ms)`` callback of the kernel comparisons: checks that the
    kernel equals its plain version and logs both times, its bound from
    ``nbytes`` (this run's inputs read once and outputs written once) and
    the time of one PyTorch call computing the same function (None where
    there is none); with ``entries`` it also appends the kernel's row of
    the JSON line, its launch count taken from ``launches``.  Every kernel
    here moves integers and runs no tensor-core or float work, so bytes
    bound it."""
    def entry(name, replaces, src, e, ms, plain_ms, nbytes, library_ms=None,
              library_gather_ms=None):
        check(e == 0, f'{label}{name} equals its plain version (max err {e})')
        b_ms = bound_ms(nbytes)
        if entries is not None:
            entries.append({
                'name': name, 'route': 'cuda', 'source': src,
                'replaces': replaces, 'launches': launches[name],
                'max_abs_err': e, 'ms': ms, 'plain_ms': plain_ms,
                'bound_ms': b_ms, 'bound_by': 'bytes',
                'library_ms': library_ms,
            })
            if library_gather_ms is not None:
                entries[-1]['library_gather_ms'] = library_gather_ms
        lib = 'none' if library_ms is None else f'{library_ms:.4f} ms'
        if library_gather_ms is not None:
            lib += f' ({library_gather_ms:.4f} ms with its gather)'
        log(f'{label}{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'bound {b_ms:.4f} ms, library call {lib}, max abs err {e}')
    return entry


def load_split(r, split, label):
    """Seconds of the device load's phases ``split`` and of what lies
    outside them."""
    tot = r.profiler.totals
    out = {k: tot[k] for k in split}
    out['outside'] = tot['device-load'] - sum(out.values())
    log(f'{label} load split: ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in out.items())
        + f', of device-load {tot["device-load"]:.3f} s')
    return out


def open_derive(idx_path, pats, kind, path_kernels, label):
    """Launch counts set to 0, then ``Reader(path)`` derives its index over
    merged rows and answers ``pats`` (a line batch) with
    ``search_multiple`` and one pattern with ``search``; every kernel in
    ``path_kernels`` must have
    launched.  Returns (Reader, launch counts, search_multiple's lines, the
    phase's numbers)."""
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels

    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = pss.Reader(idx_path)
    check(r.wait_device_ready(), f'{label}device index ready')
    device_ready_s = time.perf_counter() - t0
    load_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    idx = r._index
    check(idx.kind == kind and idx.mode == 'derive' and idx.merged,
          f'{kind} derive index over merged rows (kind {idx.kind}, mode '
          f'{idx.mode})')
    rows = [{'chunks': len(g), 'n': int(d.size), 'rounds': len(t),
             'ties': t}
            for g, d, t in zip(idx.groups, idx.row_data, idx.sa_ties)]
    log(f'{label}device ready: {device_ready_s:.2f} s; {idx.num_chunks} '
        f'merged rows x n_pad {idx.n_pad} from {len(r._chunks)} chunks, '
        f'chunks per row {[x["chunks"] for x in rows]}, row bytes '
        f'{[x["n"] for x in rows]}; kind {idx.kind}, sigma '
        f'{int(idx.present.sum())}, bits {idx._bits}, seed '
        f'{idx._base}^{idx._depth}, {idx.num_limbs} limbs; device memory '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, '
        f'{load_peak_gib:.2f} GiB peak during the load')
    strs = [p.decode('latin-1') for p in pats]
    probe = 'probe_limbs' if kind == 'digit' else 'probe_phased'
    after_multi, launches, e2e_s, phases, res = main_path(
        r, strs, pats, ('probe', 'extract', 'x-dev-gather', 'x-dev-lines',
                        'line-tables'), probe)
    for name in path_kernels:
        check(after_multi[name] > 0,
              f'kernel {name} launched by search_multiple on the {kind} '
              'derive path')
    check(launches['gather_hits_flat'] > after_multi['gather_hits_flat'],
          'search() of one pattern gathered its hits on the device')
    log(f'{label}reader phases: '
        + r.profiler.report().replace('\n', ' | '))
    split = load_split(r, ('index-alphabet', 'index-merge', 'index-alloc',
                           'index-h2d', 'index-sa', 'index-aux'),
                       f'{label}derive')
    warm_s = r.profiler.totals['device-warm']
    log(f'{label}device-warm (the 8-pattern warm probe and the round-trip '
        f'measurement, after device-load, before ready): {warm_s:.4f} s')
    rule = rule_runs(r, strs, label, res, probe)
    return r, launches, res, {
        'rule': rule, 'device_warm_s': warm_s,
        'device_ready_s': device_ready_s, 'load_split_s': split,
        'load_peak_gib': load_peak_gib, 'search_multiple_s': e2e_s,
        'search_multiple_phases_s': phases, 'lines': len(res), 'rows': rows,
        'n_pad': idx.n_pad, 'seed': [idx._base, idx._depth],
        'num_limbs': idx.num_limbs,
    }


def init_profile(init, text, n, key, key_bits, cut, label, name):
    """The path the anchored init ``init`` (B1 or B1b) takes on ``text``,
    its device time by kernel, and the buckets of its keys (``key(text,
    n)``, ``key_bits`` wide) by their top 16, 24 and 32 bits and its own
    ``cut``; logged and returned."""
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    stats = torch.zeros(3, dtype=torch.int32, device=text.device)
    init(text, n, stats=stats)
    path, est, large = stats.tolist()
    total_us, by_kernel = device_times(lambda: init(text, n))
    keys = key(text, n)
    buckets = {c: SA.bucket_histogram(keys, key_bits, c)
               for c in sorted({16, 24, 32, cut})}
    del keys
    log(f'{label}{name}: path {path} (1 the top {cut} bits and bucket sorts, '
        f'2 the full sort, 3 the full sort after the large cap), large '
        f'members estimated {est}, counted {large}; device time '
        f'{total_us / 1e3:.4f} ms by kernel (us, calls) '
        + json.dumps([[k, round(us, 1), c] for k, us, c in by_kernel])
        + f'; buckets by top key bits {json.dumps(buckets)} ([buckets, '
        'slots] of 1, 2-32, 33-4096 and more members)')
    return {'path': path, 'large_estimated': est, 'large': large,
            'device_us': total_us, 'by_kernel_us': by_kernel,
            'buckets': buckets}


def init_and_round(idx, init, init_plain, key, key_bits, cut, k0, entry,
                   round_entry, name, line, label=''):
    """The anchored init ``init`` (B1 or B1b, the entry ``name`` replacing
    ``JAX_SA:line``) and one B2 round from k = ``k0`` (to ``round_entry``)
    against their plain versions on row 0, timed, each beside one
    ``torch.sort`` of its keys (``key(text, n)`` for the init); logs the
    init's path, device time by kernel and buckets (:func:`init_profile`),
    the sizes of round 1's tied groups and the round's device time by
    kernel.  Returns the round's (tie count m, kernel ms, plain ms, the
    numbers)."""
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    n0 = int(idx.row_data[0].size)
    text0 = idx.text[0]
    N = text0.shape[0]
    first = init(text0, n0)
    plain = init_plain(text0, n0)
    init_ms = cuda_ms(lambda: init(text0, n0), 3)
    init_sort_ms = sort_ms(key(text0, n0))
    entry(name, f'{JAX_SA}:{line}', SA_SRC,
          max(err(a, b) for a, b in zip(first, plain)), init_ms,
          cuda_ms(lambda: init_plain(text0, n0), 1), 13 * N, init_sort_ms)
    del plain
    init_numbers = {'ms': init_ms, 'sort_keys_ms': init_sort_ms,
                    **init_profile(init, text0, n0, key, key_bits, cut,
                                   label, name)}
    state = [t.clone() for t in first]
    pstate = [t.clone() for t in first]
    m = SA.sa_refine_round(*state, k0)
    pm = SA.sa_refine_round_plain(*pstate, k0)
    check(m == pm == idx.sa_ties[0][0], f'round-1 tie counts {m} {pm}')
    round_err = max(err(a, b) for a, b in zip(state, pstate))
    del pstate

    def restore():
        for s, t in zip(state, first):
            s.copy_(t)

    hist = SA.tie_group_histogram(first[2])
    restore()
    total_us, by_kernel = device_times(
        lambda: SA.sa_refine_round(*state, k0))
    ms = cuda_ms(lambda: SA.sa_refine_round(*state, k0), 3, restore)
    plain_ms = cuda_ms(lambda: SA.sa_refine_round_plain(*state, k0), 1,
                       restore)
    lib_ms = sort_ms(SA._round_keys(*first, k0)[2])
    round_entry('sa_refine_round', f'{JAX_SA}:394', SA_SRC, round_err, ms,
                plain_ms, 4 * N + 24 * m, lib_ms)
    log(f'{label}B2 round 1 (k {k0}, m {m}): tied groups by size '
        f'{json.dumps(hist)} ([groups, slots]); device time '
        f'{total_us / 1e3:.4f} ms by kernel (us, calls) '
        + json.dumps([[n, round(us, 1), c] for n, us, c in by_kernel]))
    del state, first
    torch.cuda.empty_cache()
    return m, ms, plain_ms, {'m': m, 'ms': ms, 'plain_ms': plain_ms,
                             'sort_keys_ms': lib_ms, 'histogram': hist,
                             'device_us': total_us, 'by_kernel_us': by_kernel,
                             'init': init_numbers}


def check_derive_rows(idx, label, *args):
    """Every row's ``derive_sa`` against ``derive_sa_plain`` and the
    index's own SA, wall-timed, with the SA build's memory peak; ``args``
    are the rank map and bits of a ranked alphabet, none for the raw
    kind."""
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    rows = []
    for i, d in enumerate(idx.row_data):
        n = int(d.size)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (sa_k, ties_k, pois_k), k_s = wall_s(
            lambda: SA.derive_sa(idx.text[i], n, *args))
        peak = torch.cuda.max_memory_allocated() - base
        (sa_p, ties_p, pois_p), p_s = wall_s(
            lambda: SA.derive_sa_plain(idx.text[i], n, *args))
        e = max(err(sa_k, sa_p), err(sa_k, idx.sa[i]))
        check(e == 0 and ties_k == ties_p == idx.sa_ties[i]
              and not pois_k and not pois_p,
              f'{label}derive_sa of row {i} equals its plain version and the '
              'index')
        rows.append({'n': n, 'kernel_s': k_s, 'plain_s': p_s,
                     'peak_gib': peak / 2**30, 'ties': ties_k})
        log(f'{label}derive_sa row {i} ({n} bytes, n_pad {idx.n_pad}): '
            f'kernels {k_s:.3f} s, plain {p_s:.3f} s, equal; SA-build peak '
            f'{peak / 2**30:.2f} GiB above the resident index')
        del sa_k, sa_p
        torch.cuda.empty_cache()
    return rows


def aux_kernels(idx, row, entry):
    """K1-K3 against their plain versions on one row of the index."""
    from pysubstringsearch_tpu_torch.ops import search as S

    n0 = int(idx.lengths[row])
    text0, sa0 = idx.text[row], idx.sa[row]
    N = text0.shape[0]
    bits, depth, base, K = idx._bits, idx._depth, idx._base, idx.num_limbs
    packed = S.ranked_pack(text0, n0, idx.rank, bits)
    ref = S.ranked_pack_plain(text0, n0, idx.rank, bits)
    entry('ranked_pack', f'{JAX_SEARCH}:1166', SEARCH_SRC, err(packed, ref),
          cuda_ms(lambda: S.ranked_pack(text0, n0, idx.rank, bits,
                                        out=packed), 20),
          cuda_ms(lambda: S.ranked_pack_plain(text0, n0, idx.rank, bits), 3),
          n0 + 4 * N)
    limbs = S.ranked_limb_planes(text0, sa0, n0, idx.rank, depth, bits, K)
    entry('ranked_limb_planes', f'{JAX_SEARCH}:1188', SEARCH_SRC,
          max(err(limbs, S.ranked_limb_planes_text_plain(
              text0, sa0, n0, idx.rank, depth, bits, K)),
              err(limbs, S.ranked_limb_planes_plain(packed, sa0, n0, depth,
                                                     bits, K)),
              err(limbs, idx.limbs[row])),
          cuda_ms(lambda: S.ranked_limb_planes(text0, sa0, n0, idx.rank,
                                               depth, bits, K, out=limbs),
                  20),
          cuda_ms(lambda: S.ranked_limb_planes_text_plain(
              text0, sa0, n0, idx.rank, depth, bits, K), 3),
          5 * N + 4 * K * N, gather_ms(packed, sa0, depth, 30 // bits, K))
    table = S.seed_table(packed, sa0, n0, base, depth, bits)
    entry('seed_table', f'{JAX_SEARCH}:896', SEARCH_SRC,
          max(err(table, S.seed_table_plain(packed, sa0, n0, base, depth,
                                            bits)),
              err(table, idx.tables[row])),
          cuda_ms(lambda: S.seed_table(packed, sa0, n0, base, depth, bits,
                                       out=table), 20),
          cuda_ms(lambda: S.seed_table_plain(packed, sa0, n0, base, depth,
                                             bits), 3),
          table_bytes(table), *searchsorted_ms(
              packed, sa0, n0, table.shape[0],
              (30 // bits - depth) * bits))


#: Length of the small pack rows: N mod 16 = 15, so the row's last tile of
#: the pack kernels (16 positions a thread) is partial.
PACK_EDGE_N = 4111


def pack_edge_row(idx, label=''):
    """K1 (ranked kind) or K7 (raw kind, the index's table base and depth)
    on a small row cut from row 0, ``PACK_EDGE_N`` slots with n = N, so the
    last positions' windows cross both n and the row's end, bit for bit
    against its plain version on the card."""
    from pysubstringsearch_tpu_torch.ops import search as S

    N = PACK_EDGE_N
    text = idx.text[0, :N].clone()
    if idx.kind == 'ranked':
        name = 'ranked_pack'
        got = S.ranked_pack(text, N, idx.rank, idx._bits)
        want = S.ranked_pack_plain(text, N, idx.rank, idx._bits)
    else:
        name = 'seed_prefix'
        got = S.seed_prefix(text, N, idx.rank, idx._base, idx._depth)
        want = S.seed_prefix_plain(text, N, idx.rank, idx._base, idx._depth)
    e = err(got, want)
    check(e == 0, f'{label}{name} on a row of N = n = {N} equals its plain '
          f'version (max err {e})')
    log(f'{label}{name} on a row of N = n = {N} (N mod 16 = {N % 16}): '
        'equal to its plain version')


def probe_kernel(idx, packed_np, lengths_np, entry):
    """K4 against its plain version on every row x the whole batch."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S

    dev = idx.device
    probe_args = (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
                  idx.rank, idx.present, torch.from_numpy(packed_np).to(dev),
                  torch.from_numpy(lengths_np).to(dev), idx.num_limbs,
                  idx._base, idx._depth, idx._bits)
    lo_k, cnt_k = S.probe_phased(*probe_args)
    lo_p, cnt_p = S.probe_phased_plain(*probe_args)
    entry('probe_phased', f'{JAX_SEARCH}:1261', SEARCH_SRC,
          max(err(cnt_k, cnt_p), err(lo_k, lo_p)),
          cuda_ms(lambda: S.probe_phased(*probe_args), 10),
          cuda_ms(lambda: S.probe_phased_plain(*probe_args), 2),
          probe_bytes(idx, packed_np))
    return lo_k, cnt_k


def gather_alone_ms(sa, lo, cnt, reps=5):
    """Milliseconds of B8's kernel alone, its offsets scanned and its
    total read beforehand (untimed): what the whole call costs above the
    scan and the one host read."""
    import torch

    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S

    offsets = S.scan_exclusive_sum(cnt)
    total = int(offsets[-1])
    pos = torch.empty(total, dtype=torch.int32, device=sa.device)
    qid = torch.empty_like(pos)
    ms = cuda_ms(lambda: kernels.launch(
        'gather_hits_flat', sa.data_ptr(), lo.data_ptr(), offsets.data_ptr(),
        lo.shape[0], total, pos.data_ptr(), qid.data_ptr()), reps)
    del pos, qid, offsets
    return ms


def gather_kernel(idx, lo_k, cnt_k, entry, label=''):
    """B8 against its plain version on every merged row, on the row's SA
    and the probe's bounds for the whole batch, timed: the whole call (the
    JSON line's time, as earlier runs timed it) and the kernel alone.
    Returns the summed numbers."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S

    gather = []
    for i in range(idx.num_chunks):
        sa_i = idx.sa[i]
        lo_i, cnt_i = lo_k[i].contiguous(), cnt_k[i].contiguous()
        pos_k, qid_k = S.gather_hits_flat(sa_i, lo_i, cnt_i)
        pos_p, qid_p = S.gather_hits_flat_plain(sa_i, lo_i, cnt_i)
        check(pos_k.shape[0] == int(cnt_i.long().sum()), f'{label}B8 total')
        slot = hit_slots(lo_i, cnt_i)
        gather.append((max(err(pos_k, pos_p), err(qid_k, qid_p)),
                       cuda_ms(lambda: S.gather_hits_flat(sa_i, lo_i, cnt_i),
                               5),
                       cuda_ms(lambda: S.gather_hits_flat_plain(sa_i, lo_i,
                                                                cnt_i), 2),
                       int(pos_k.shape[0]),
                       cuda_ms(lambda: torch.take(sa_i, slot), 5),
                       gather_alone_ms(sa_i, lo_i, cnt_i)))
        del pos_k, qid_k, pos_p, qid_p, slot
    log(f'{label}gather_hits_flat per row (hits, call ms, kernel alone ms, '
        'plain ms): ' + ', '.join(f'{g[3]} {g[1]:.4f} {g[5]:.4f} {g[2]:.4f}'
                                  for g in gather))
    numbers = {'hits': sum(g[3] for g in gather),
               'call_ms': sum(g[1] for g in gather),
               'kernel_alone_ms': sum(g[5] for g in gather),
               'plain_ms': sum(g[2] for g in gather),
               'library_ms': sum(g[4] for g in gather),
               'bound_ms': bound_ms(sum(12 * g[3] + 8 * lo_k.shape[1]
                                        for g in gather))}
    entry('gather_hits_flat', f'{JAX_SEARCH}:1625', SEARCH_SRC,
          max(g[0] for g in gather), numbers['call_ms'], numbers['plain_ms'],
          sum(12 * g[3] + 8 * lo_k.shape[1] for g in gather),
          numbers['library_ms'])
    return numbers


def skewed_gather_check(dev):
    """B8 on ``sort_bench.skewed_batch``: one query of 2^24 + 3 hits
    beside 10,000 small ones (0-300 hits) and runs of zero counts, over a
    random permutation of 2^26 slots, against its plain version; timed
    (the whole call and the kernel alone) beside its bound and one
    ``torch.take`` at the hit slots made beforehand.  Returns the
    numbers."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.sort_bench import skewed_batch

    sa, lower, count = skewed_batch()
    B = count.shape[0]
    sa, lo, cnt = (torch.from_numpy(a).to(dev) for a in (sa, lower, count))
    pos_k, qid_k = S.gather_hits_flat(sa, lo, cnt)
    pos_p, qid_p = S.gather_hits_flat_plain(sa, lo, cnt)
    e = max(err(pos_k, pos_p), err(qid_k, qid_p))
    hits = int(pos_k.shape[0])
    check(e == 0 and hits == int(count.astype(np.int64).sum()),
          f'B8 on the skewed batch equals its plain version (max err {e})')
    del pos_k, qid_k, pos_p, qid_p
    slot = hit_slots(lo, cnt)
    out = {'hits': hits, 'largest': int(count.max()),
           'call_ms': cuda_ms(lambda: S.gather_hits_flat(sa, lo, cnt), 5),
           'kernel_alone_ms': gather_alone_ms(sa, lo, cnt),
           'plain_ms': cuda_ms(lambda: S.gather_hits_flat_plain(sa, lo, cnt),
                               2),
           'library_ms': cuda_ms(lambda: torch.take(sa, slot), 5),
           'bound_ms': bound_ms(12 * hits + 8 * B)}
    del slot, sa
    log(f'B8 skewed batch ({B} queries, {hits} hits, one of {out["largest"]})'
        f': call {out["call_ms"]:.4f} ms, kernel alone '
        f'{out["kernel_alone_ms"]:.4f} ms, plain {out["plain_ms"]:.4f} ms, '
        f'bound {out["bound_ms"]:.4f} ms, torch.take {out["library_ms"]:.4f}'
        ' ms, equal')
    return out


def nul_check_ms(packed_np, lengths_np, rows, probe_p50_ms):
    """The raw probe's host NUL check alone: the lines of
    ``DeviceIndex.probe`` (models/index.py) that clear the answers of the
    patterns holding NUL, run on this batch and answer arrays of the
    index's shape, median of 21; logged beside the probe p50."""
    import numpy as np

    lo = np.zeros((rows, packed_np.shape[0]), dtype=np.int32)
    cnt = np.ones_like(lo)
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        jpos = np.arange(packed_np.shape[1])[None, :]
        has_nul = np.any(
            (packed_np == 0) & (jpos < lengths_np[:, None]), axis=1
        )
        if has_nul.any():
            out_lo = np.where(has_nul[None, :], 0, lo)
            out_cnt = np.where(has_nul[None, :], 0, cnt)
        ts.append(time.perf_counter() - t0)
    check(has_nul.any() and not out_cnt[:, has_nul].any()
          and out_lo.shape == lo.shape,
          'raw NUL check: the batch holds NUL patterns, cleared')
    ms = sorted(ts)[len(ts) // 2] * 1e3
    log(f'raw probe host NUL check alone ({int(has_nul.sum())} of '
        f'{packed_np.shape[0]} patterns with NUL, {rows} rows): {ms:.3f} ms, '
        f'{100 * ms / probe_p50_ms:.1f}% of the probe p50 '
        f'{probe_p50_ms:.3f} ms')
    return ms


def raw_probe_check(ridx, rpats, label):
    """K4 against its plain version on a small raw-kind index."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S

    dev = ridx.device
    rp, rl = S.pack_patterns(rpats)
    raw_args = (ridx.text, ridx.lengths, ridx.sa, ridx.tables, ridx.limbs,
                ridx.rank, ridx.present, torch.from_numpy(rp).to(dev),
                torch.from_numpy(rl).to(dev), ridx.num_limbs, ridx._base,
                ridx._depth, None)
    rlo, rcnt = S.probe_phased(*raw_args)
    rlo_p, rcnt_p = S.probe_phased_plain(*raw_args)
    raw_err = max(err(rcnt, rcnt_p), err(rlo, rlo_p))
    check(raw_err == 0, f'{label} probe equals plain (max err {raw_err})')
    check(int(rcnt.sum()) >= len(rpats), f'{label} patterns found')
    log(f'probe_phased {label} ({ridx.num_chunks} rows x {len(rpats)}): '
        f'equal to plain, kernel '
        f'{cuda_ms(lambda: S.probe_phased(*raw_args), 10):.4f} ms, plain '
        f'{cuda_ms(lambda: S.probe_phased_plain(*raw_args), 2):.4f} ms')


def raw_kind_probe(dev):
    """Two small full-byte raw-kind chunks (255 distinct bytes, no NUL).
    Derived on the card by ``'auto'``: its SA against native SA-IS, K7
    with K3 at base 258 and K4 against their plain versions.  Uploaded
    with ``mode='upload'``: K6, K7 and K3 launched once a chunk, row
    0's table and limbs equal the host builders', and K4 against its plain
    version."""
    import numpy as np

    from pysubstringsearch_tpu_torch.container import Chunk
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    rr = np.random.default_rng(3)
    raw_chunks = []
    for _ in range(2):
        body = rr.integers(1, 256, size=4 << 20, dtype=np.uint8)
        body[::61] = 0x0A
        body[-1] = 0x0A
        raw_chunks.append(Chunk(data=body,
                                suffix_array=suffix_array_native(body)))
    ridx = DeviceIndex(raw_chunks, device=dev)
    check(ridx.kind == 'raw' and ridx.mode == 'derive'
          and ridx._base == 258 and ridx.num_chunks == 1,
          f'full-byte raw-kind derive index (got {ridx.kind}, {ridx.mode}, '
          f'base {ridx._base}, {ridx.num_chunks} rows)')
    n0 = int(ridx.row_data[0].size)
    check(np.array_equal(ridx.sa[0, :n0].cpu().numpy(),
                         suffix_array_native(ridx.row_data[0])),
          'full-byte derived SA equals native SA-IS')
    base, depth = ridx._base, ridx._depth
    pv = S.seed_prefix(ridx.text[0], n0, ridx.rank, base, depth)
    table = S.seed_table_from_prefix(pv, ridx.sa[0], n0, base, depth)
    pv_p = S.seed_prefix_plain(ridx.text[0], n0, ridx.rank, base, depth)
    table_err = max(err(pv, pv_p), err(table, ridx.tables[0]), err(
        table, S.seed_table_from_prefix_plain(pv_p, ridx.sa[0], n0, base,
                                              depth)))
    check(table_err == 0, f'K7 + K3 at base 258 equal plain ({table_err})')
    log(f'full-byte raw kind: derived SA equals native SA-IS; seed prefix '
        f'and table at {base}^{depth} equal plain')
    rpats = [raw_chunks[i % 2].data[o: o + l].tobytes() for i, (o, l) in
             enumerate(zip(rr.integers(0, (4 << 20) - 64, size=2000),
                           rr.integers(1, 40, size=2000)))]
    raw_probe_check(ridx, rpats, 'full-byte raw derive')
    del ridx, pv, pv_p, table

    before = dict(kernels.LAUNCHES)
    uidx = DeviceIndex(raw_chunks, device=dev, mode='upload')
    check(uidx.kind == 'raw' and uidx.mode == 'upload'
          and uidx.num_chunks == 2,
          f'full-byte raw-kind upload index (got {uidx.kind}, {uidx.mode}, '
          f'{uidx.num_chunks} rows)')
    for name in ('raw_limb_planes', 'seed_prefix', 'seed_table'):
        check(kernels.LAUNCHES[name] - before[name] == 2,
              f'raw upload built its aux with {name} once a chunk')
    c0 = raw_chunks[0]
    rank = uidx.rank.cpu().numpy()
    check(np.array_equal(uidx.tables[0].cpu().numpy(),
                         S.build_seed_table_host(c0.data, c0.suffix_array,
                                                 rank, uidx._base,
                                                 uidx._depth)),
          'raw upload row 0 seed table equals the host builder')
    check(np.array_equal(uidx.limbs[0].cpu().numpy(), S.pad_limbs_host(
        S.build_raw_limbs_host(c0.data, c0.suffix_array, uidx.num_limbs,
                               uidx._depth), uidx.n_pad)),
          'raw upload row 0 limbs equal the host builder')
    log(f'full-byte raw upload: K6, K7 and K3 once a chunk; row 0 seed table '
        f'at {uidx._base}^{uidx._depth} and {uidx.num_limbs} limb planes '
        'equal the host builders')
    raw_probe_check(uidx, rpats, 'full-byte raw upload')


def lines_breakdown(idx, lo_k, cnt_k, patterns=2000):
    """Where row 0's share of ``x-dev-lines`` goes, for the hits of the
    batch's first ``patterns`` patterns (a fifth of it, to keep the run
    short), on a fresh LineTable (so its lazy line-id table is not built
    mid-measurement): the newline bisection of the hits in SA order and in
    sorted order, the dedup of the whole span step, the str
    materialisation, and the per-call fixed cost of a one-hit batch."""
    import numpy as np

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.extract import LineTable

    pos_d, qid_d = S.gather_hits_flat(idx.sa[0],
                                      lo_k[0, :patterns].contiguous(),
                                      cnt_k[0, :patterns].contiguous())
    pos = pos_d.cpu().numpy().astype(np.int64)
    qid = qid_d.cpu().numpy().astype(np.int64)
    t0 = time.perf_counter()
    table = LineTable(idx.row_data[0])
    out = {'table_s': time.perf_counter() - t0}
    t0 = time.perf_counter()
    np.searchsorted(table.nl, pos, side='left')
    out['bisect_sa_order_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.searchsorted(table.nl, np.sort(pos), side='left')
    out['sort_and_bisect_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spans = table.spans_for_positions(qid, pos)
    out['spans_s'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    table.materialize_spans(spans)
    out['materialize_s'] = time.perf_counter() - t0
    out['one_hit_spans_ms'] = p50_ms(
        lambda: table.spans_for_positions(qid[:1], pos[:1]), 11)
    log(f'row 0 line extraction, first {patterns} patterns ({pos.size} '
        f'hits, {table.num_lines} lines): '
        + ', '.join(f'{k} {v:.3f}' for k, v in out.items()))
    return out


def run_derive(idx_path, pats, dev, card):
    """Phases 3-6 on the derive main path, then the routing constants and
    the route sweep; returns its numbers."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    # ---- 3. the main path, launches counted ----
    lpats = line_batch(pats, DEEP_PATTERNS)
    r, launches, res, result = open_derive(idx_path, lpats, 'ranked',
                                           PATH_KERNELS, '')
    idx = r._index
    for i, x in enumerate(result['rows']):
        log(f'row {i}: {x["rounds"]} B2 rounds, tie counts m {x["ties"]}')

    # ---- 4. kernels against their plain versions on the card ----
    entries = []
    entry = kernel_check('', entries, launches)
    aux_kernels(idx, 0, entry)
    pack_edge_row(idx)
    packed_np, lengths_np = S.pack_patterns(pats)
    lo_k, cnt_k = probe_kernel(idx, packed_np, lengths_np, entry)
    bits = idx._bits
    round1 = init_and_round(
        idx, lambda t, n, **kw: SA.sa_init_ranked(t, n, idx.rank, bits, **kw),
        lambda t, n: SA.sa_init_ranked_plain(t, n, idx.rank, bits),
        lambda t, n: SA._ranked_key(t, n, idx.rank, bits),
        SA.RANKED_KEY_BITS, SA.INIT_CUT_RANKED, 2 * (30 // bits), entry,
        entry, 'sa_init_ranked', 330)[3]
    derive_rows = check_derive_rows(idx, '', idx.rank, bits)
    gather = gather_kernel(idx, lo_k, cnt_k, entry)
    row0 = row0_bwt_and_b15(r, idx, lo_k, cnt_k, entries)

    # ---- 5. device answers against the host native path ----
    host_search_s = check_answers(r, idx, pats, packed_np, lengths_np, res,
                                  lpats)
    del res
    check_boundaries(r, idx)

    # ---- 6. serving numbers ----
    numbers = serving_numbers(r, idx, pats, packed_np, lengths_np,
                              host_search_s)
    numbers['lines_row0_s'] = lines_breakdown(idx, lo_k, cnt_k)
    del lo_k, cnt_k
    numbers['constants'] = routing_constants(r, idx, lpats, card)
    numbers['sweep'], numbers['readback_cap_from_sweep'] = route_sweep(
        r, idx, lpats, card)
    return {
        **result, 'kernels': entries, 'derive_rows': derive_rows,
        'resident_gib': torch.cuda.memory_allocated() / 2**30, **numbers,
        'row0': row0, 'gather': gather, 'round1': round1,
    }


def odd_patterns(pats):
    """Patterns holding NUL or a byte >= 0x80, which the raw kind's text
    never holds: the host resolves NUL, and neither can match."""
    return [b'\x00', pats[0] + b'\x00', pats[1][:2] + b'\x00' + pats[1][2:],
            b'\x80', pats[2][:3] + b'\xff' + pats[2][3:],
            pats[3] + '\u00e9'.encode()]


def run_raw(idx_path, pats, dev, ranked_rows):
    """Phase 8: raw-kind derive on its own container; returns its numbers
    and its kernels' JSON rows."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    pats = pats + odd_patterns(pats)
    lpats = line_batch(pats, DEEP_PATTERNS + len(odd_patterns(pats)))
    r, launches, res, result = open_derive(idx_path, lpats, 'raw',
                                           RAW_KERNELS, 'raw ')
    idx = r._index
    check(idx.num_chunks == 2,
          f'raw derive index over 2 merged rows ({idx.num_chunks} rows)')
    for i, x in enumerate(result['rows']):
        log(f'raw row {i}: {x["rounds"]} B2 rounds from k = 6, tie counts m '
            f'{x["ties"]}; ranked row {i}: {ranked_rows[i]["rounds"]} rounds '
            f'from k = 12, m {ranked_rows[i]["ties"]}')

    # Native SA-IS of row 0 on a host thread (it releases the GIL) while
    # the card's checks run; its result is checked below.
    native_pool = ThreadPoolExecutor(max_workers=1)
    native_future = native_pool.submit(
        lambda: (suffix_array_native(idx.row_data[0]), time.perf_counter()))
    native_t0 = time.perf_counter()

    # The raw path's kernels against their plain versions, on row 0.
    entries = []
    entry = kernel_check('', entries, launches)
    check_only = kernel_check('raw ')
    m, round_ms, round_plain_ms, round1 = init_and_round(
        idx, SA.sa_init_bytes, SA.sa_init_bytes_plain, SA._byte_key,
        SA.BYTE_KEY_BITS, SA.INIT_CUT_BYTES, SA.BYTE_INIT_WIDTH, entry,
        check_only, 'sa_init_bytes', 271, 'raw ')

    n0 = int(idx.row_data[0].size)
    text0, sa0 = idx.text[0], idx.sa[0]
    N = text0.shape[0]
    base, depth, K = idx._base, idx._depth, idx.num_limbs
    pv = S.seed_prefix(text0, n0, idx.rank, base, depth)
    pv_p = S.seed_prefix_plain(text0, n0, idx.rank, base, depth)
    entry('seed_prefix', f'{JAX_SEARCH}:971', SEARCH_SRC, err(pv, pv_p),
          cuda_ms(lambda: S.seed_prefix(text0, n0, idx.rank, base, depth,
                                        out=pv), 20),
          cuda_ms(lambda: S.seed_prefix_plain(text0, n0, idx.rank, base,
                                              depth), 3), n0 + 4 * N)
    pack_edge_row(idx, 'raw ')
    table = S.seed_table_from_prefix(pv, sa0, n0, base, depth)
    table_ms = cuda_ms(lambda: S.seed_table_from_prefix(
        pv, sa0, n0, base, depth, out=table), 20)
    table_plain_ms = cuda_ms(lambda: S.seed_table_from_prefix_plain(
        pv, sa0, n0, base, depth), 3)
    check_only('seed_table', f'{JAX_SEARCH}:971', SEARCH_SRC,
               max(err(table, idx.tables[0]), err(
                   table, S.seed_table_from_prefix_plain(pv, sa0, n0, base,
                                                         depth))),
               table_ms, table_plain_ms, table_bytes(table),
               *searchsorted_ms(pv, sa0, n0, table.shape[0], 0))
    del pv_p
    # K5 is on no path since K6 gathers the text; it is held against its
    # plain version here, and the library gather beside K6 reads its pack.
    check(launches['raw_pack'] == 0,
          'the raw derive path launched no raw pack (K6 reads the text)')
    packed = S.raw_pack(text0, n0, out=pv)
    entry('raw_pack', f'{JAX_SEARCH}:833', SEARCH_SRC,
          err(packed, S.raw_pack_plain(text0, n0)),
          cuda_ms(lambda: S.raw_pack(text0, n0, out=packed), 20),
          cuda_ms(lambda: S.raw_pack_plain(text0, n0), 3), n0 + 4 * N)
    limbs = S.raw_limb_planes(text0, sa0, n0, depth, K)
    entry('raw_limb_planes', f'{JAX_SEARCH}:862', SEARCH_SRC,
          max(err(limbs, S.raw_limb_planes_text_plain(text0, sa0, n0, depth,
                                                      K)),
              err(limbs, S.raw_limb_planes_plain(packed, sa0, n0, depth, K)),
              err(limbs, idx.limbs[0])),
          cuda_ms(lambda: S.raw_limb_planes(text0, sa0, n0, depth, K,
                                            out=limbs), 20),
          cuda_ms(lambda: S.raw_limb_planes_text_plain(text0, sa0, n0, depth,
                                                       K), 3),
          5 * N + 4 * K * N, gather_ms(packed, sa0, depth, 4, K))
    del pv, packed, limbs, table
    packed_np, lengths_np = S.pack_patterns(pats)
    lo_k, cnt_k = probe_kernel(idx, packed_np, lengths_np, check_only)
    gather = gather_kernel(idx, lo_k, cnt_k, check_only, 'raw ')
    del lo_k, cnt_k
    torch.cuda.empty_cache()

    derive_rows = check_derive_rows(idx, 'raw ')
    native0, native_end = native_future.result()
    native_pool.shutdown()
    native_s = native_end - native_t0
    check(np.array_equal(idx.sa[0, :n0].cpu().numpy(), native0),
          "raw row 0's derived SA equals the host's native SA-IS")
    log(f"raw row 0's derived SA equals native SA-IS on the host "
        f'({native_s:.2f} s for {n0} bytes, on a thread beside the card '
        'checks)')
    del native0

    host_search_s = check_answers(r, idx, pats, packed_np, lengths_np, res,
                                  lpats)
    del res
    check_boundaries(r, idx)
    p50 = probe_p50(idx, packed_np, lengths_np)
    nul_ms = nul_check_ms(packed_np, lengths_np, idx.num_chunks, p50)
    raw_kind_probe(dev)
    return {
        **result, 'kernels': entries, 'derive_rows': derive_rows,
        'native_sais_row0_s': native_s,
        'round1_ms': {'kernel': round_ms, 'plain': round_plain_ms, 'm': m},
        'round1': round1,
        'seed_table_ms': {'kernel': table_ms, 'plain': table_plain_ms},
        'resident_gib': torch.cuda.memory_allocated() / 2**30,
        'probe_p50_ms': p50, 'nul_check_ms': nul_ms,
        'host_search_s': host_search_s,
        'launches': launches, 'gather': gather,
    }


def run_upload(idx_path, pats, dev):
    """Phase 7: the upload path on the same container."""
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S

    lpats = line_batch(pats, DEEP_PATTERNS)
    strs = [p.decode('latin-1') for p in lpats]
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = pss.Reader(idx_path, index_mode='upload')
    check(r.wait_device_ready(), 'upload index ready')
    device_ready_s = time.perf_counter() - t0
    idx = r._index
    check(idx.mode == 'upload' and not idx.merged
          and idx.num_chunks == len(r._chunks), 'upload geometry')
    log(f'upload: device ready {device_ready_s:.2f} s; rows '
        f'{idx.num_chunks} x n_pad {idx.n_pad}, seed '
        f'{idx._base}^{idx._depth}, {idx.num_limbs} limbs; device memory '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB')
    after_multi, launches, e2e_s, phases, res = main_path(
        r, strs, lpats, ('probe', 'extract', 'hs-spans', 'hs-fanout'))
    lines = len(res)
    for name in UPLOAD_KERNELS:
        check(after_multi[name] > 0, f'upload path launched {name}')

    entry = kernel_check('upload ')
    aux_kernels(idx, 0, entry)
    packed_np, lengths_np = S.pack_patterns(pats)
    lo_k, cnt_k = probe_kernel(idx, packed_np, lengths_np, entry)
    bounds = (lo_k.cpu().numpy(), cnt_k.cpu().numpy())
    del lo_k, cnt_k
    host_search_s = check_answers(r, idx, pats, packed_np, lengths_np, res,
                                  lpats)
    del res
    # The single Reader's lines for the scale-out phase's patterns.
    shard_ref = r._search_batch(pats[:SHARD_PATTERNS])
    numbers = serving_numbers(r, idx, pats, packed_np, lengths_np,
                              host_search_s)
    split = load_split(r, ('index-alphabet', 'index-alloc', 'index-host-copy',
                           'index-h2d', 'index-aux'), 'upload')
    return {'device_ready_s': device_ready_s, 'load_split_s': split,
            'search_multiple_s': e2e_s, 'search_multiple_phases_s': phases,
            'lines': lines, 'launches': launches,
            'resident_gib': torch.cuda.memory_allocated() / 2**30,
            'bounds': bounds, 'shard_ref': shard_ref, **numbers}


def make_digit_corpus(mb, seed=0):
    """The lines of ``make_raw_corpus(mb // 2)`` encoded as UTF-16LE,
    ``\n`` included, as a UTF-16 log file is: 95 printable characters and
    the newline, every second byte NUL, so 97 distinct bytes with NUL, the
    digit kind.  The Writer splits at 0x0A, so every later line starts
    with the newline's 0x00."""
    return make_raw_corpus(mb // 2, seed).decode('ascii').encode('utf-16-le')


def sample_digit_patterns(corpus, nq):
    """Two batches over UTF-16 text.  The line batch: bench.py's sampler in
    characters, ``nq`` patterns of 4-12 characters (8-24 bytes) at random
    byte offsets (either parity, so half of them start with a NUL),
    newlines replaced; then 500 patterns of 4-12 bytes from the byte
    sampler and its 200 deep patterns of 23-200 bytes
    (:func:`sample_patterns`).  The count batch: bench.py's byte sampler
    itself, ``nq`` patterns of 4-12 bytes, whose 2-character patterns ask
    for far more hits than lines can be made of in the run; it is held by
    counts and by B11 and B8 against their plain versions."""
    import numpy as np

    rng = np.random.default_rng(1)
    offs = rng.integers(0, len(corpus) - 32, size=nq)
    lens = 2 * rng.integers(4, 13, size=nq)
    pats = [corpus[o: o + l].replace(b'\n', b'x')
            for o, l in zip(offs, lens)]
    return (pats + sample_patterns(corpus, 500),
            sample_patterns(corpus, nq)[:nq])


#: Digit patterns of 1-2 bytes, shorter than the bucket depth: two with
#: about 2.4 M hits each and two that UTF-16 of ASCII never holds.
DIGIT_SHORT = [b'~', b'\x00~', b'ab', b'\x00\x00']
#: Digit patterns holding a byte >= 0x80, which UTF-16 of ASCII never
#: holds: count 0.
DIGIT_HIGH = [b'\x80', b'\xff\xfe', b'q\x00\xe9', 'é'.encode('utf-16-le'),
              b'\x00\xc3\xa9']
#: Patterns of 1-2 bytes whose hits are every line of the corpus (NUL alone
#: hits every second byte, 262 M times): their counts are checked against
#: the host's and B11 against its plain version, but no lines are made.
DIGIT_COUNT_ONLY = [b'\x00', b'\n\x00', b'\x00\n']


def write_digit_container(pss, d, args):
    """The digit corpus written by the port's Writer at the default
    ``'auto'``, on the card: launch counts from 0 before it, B1b once for
    every chunk of at least 64 KiB after it, and every chunk's SA against
    native SA-IS (in a thread pool), timed.  Returns (container path,
    numbers, (the line batch, the count batch), the native SAs and the
    bytes of the first two chunks)."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np

    from pysubstringsearch_tpu_torch.container import read_container
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native
    from pysubstringsearch_tpu_torch.ops.suffix_array import (
        DEVICE_MIN_N, _device_build_worthwhile)

    kernels.reset_launches()
    path, build_s, pats = build_container(
        pss, lambda: make_digit_corpus(args.mb, args.seed), d, 'digit', args,
        backend='auto', sampler=sample_digit_patterns)
    launches = dict(kernels.LAUNCHES)
    chunks = read_container(path).chunks
    big = sum(c.data.size >= DEVICE_MIN_N
              and _device_build_worthwhile(c.data.size) for c in chunks)
    check(launches['sa_init_bytes'] == big > 0,
          f'the Writer built each of its {big} chunks that its rule sends to '
          f'the card there (B1b launched {launches["sa_init_bytes"]} times)')
    for name in WRITER_KERNELS:
        check(launches[name] > 0, f'the Writer launched {name}')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=8) as pool:
        native = list(pool.map(lambda c: suffix_array_native(c.data),
                               chunks))
    native_s = time.perf_counter() - t0
    for i, (c, sa) in enumerate(zip(chunks, native)):
        check(np.array_equal(c.suffix_array, sa),
              f'digit chunk {i} SA built on the card equals native SA-IS')
    log(f'digit Writer on the card: {len(chunks)} chunks ({big} built on '
        f'the card by the rule), {build_s:.2f} s for the whole Writer; '
        f'every chunk\'s SA equals native SA-IS, which took {native_s:.2f} s '
        f'for all chunks in 8 threads; launches {launches}')
    numbers = {'writer_s': build_s, 'native_sais_s': native_s,
               'chunks': len(chunks), 'device_chunks': big,
               'writer_launches': {k: launches[k] for k in WRITER_KERNELS}}
    line_pats, byte_pats = pats
    return (path, numbers, (line_pats + DIGIT_SHORT + DIGIT_HIGH, byte_pats),
            native[:2], [c.data for c in chunks[:2]])


def digit_aux_kernels(idx, entry, check_only):
    """B12d on row 0: K7 at base 258 (the bucket depth), K3 on its values
    and the offset-2 stride-3 limb planes from the text, against their
    plain versions and the index's own table and limbs, timed."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S

    n0 = int(idx.row_data[0].size)
    text0, sa0 = idx.text[0], idx.sa[0]
    N, depth, K = text0.shape[0], idx._depth, idx.num_limbs
    ident = idx.rank
    pv = S.seed_prefix(text0, n0, ident, 258, depth)
    check_only('seed_prefix', f'{JAX_SEARCH}:565', SEARCH_SRC,
               err(pv, S.seed_prefix_plain(text0, n0, ident, 258, depth)),
               cuda_ms(lambda: S.seed_prefix(text0, n0, ident, 258, depth,
                                             out=pv), 20),
               cuda_ms(lambda: S.seed_prefix_plain(text0, n0, ident, 258,
                                                   depth), 3), n0 + 4 * N)
    table = S.seed_table_from_prefix(pv, sa0, n0, 258, depth)
    check_only('seed_table', f'{JAX_SEARCH}:565', SEARCH_SRC,
               max(err(table, S.seed_table_from_prefix_plain(
                   pv, sa0, n0, 258, depth)), err(table, idx.tables[0])),
               cuda_ms(lambda: S.seed_table_from_prefix(
                   pv, sa0, n0, 258, depth, out=table), 20),
               cuda_ms(lambda: S.seed_table_from_prefix_plain(
                   pv, sa0, n0, 258, depth), 3), table_bytes(table),
               *searchsorted_ms(pv, sa0, n0, table.shape[0], 0))
    check_only('digit_bucket_table', f'{JAX_SEARCH}:565', SEARCH_SRC,
               err(S.digit_bucket_table(text0, sa0, n0, depth),
                   S.digit_bucket_table_plain(text0, sa0, n0, depth)),
               cuda_ms(lambda: S.digit_bucket_table(text0, sa0, n0, depth,
                                                    out=table, scratch=pv),
                       20),
               cuda_ms(lambda: S.digit_bucket_table_plain(text0, sa0, n0,
                                                          depth), 3),
               N + 4 * N + table_bytes(table))
    del table
    # The limbs from the text; the library gather beside them takes the
    # depth-3 K7 values, the stream the JAX program gathers.
    limbs = S.digit_limb_planes(text0, sa0, n0, K)
    pv = S.seed_prefix(text0, n0, ident, 258, 3, out=pv)
    entry('digit_limb_planes', f'{JAX_SEARCH}:535', SEARCH_SRC,
          max(err(limbs, S.digit_limb_planes_plain(text0, sa0, n0, K)),
              err(limbs, idx.limbs[0])),
          cuda_ms(lambda: S.digit_limb_planes(text0, sa0, n0, K, out=limbs),
                  20),
          cuda_ms(lambda: S.digit_limb_planes_plain(text0, sa0, n0, K), 3),
          5 * N + 4 * K * N, gather_ms(pv, sa0, 2, 3, K))
    del pv, limbs
    torch.cuda.empty_cache()


def digit_probe_kernel(idx, packed_np, lengths_np, entry):
    """B11 against its plain version on every row x the whole batch."""
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S

    dev = idx.device
    args = (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
            torch.from_numpy(packed_np).to(dev),
            torch.from_numpy(lengths_np).to(dev), idx.num_limbs)
    lo_k, cnt_k = S.probe_limbs(*args)
    lo_p, cnt_p = S.probe_limbs_plain(*args)
    entry('probe_limbs', f'{JAX_SEARCH}:384', SEARCH_SRC,
          max(err(cnt_k, cnt_p), err(lo_k, lo_p)),
          cuda_ms(lambda: S.probe_limbs(*args), 10),
          cuda_ms(lambda: S.probe_limbs_plain(*args), 2),
          probe_bytes(idx, packed_np))
    return lo_k, cnt_k


def digit_upload_check(dev, chunk_datas):
    """A digit index of two small chunks (the first 4 MiB of two container
    chunks, SA by native SA-IS) in ``mode='upload'``: the digit aux
    launched once a chunk (K7 and K3 for the table, the limb planes from
    the text), row 0's table and limbs equal the host builders', and B11
    over 2000 patterns equals its plain version."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.container import Chunk
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    datas = [np.array(d[: 4 << 20]) for d in chunk_datas]
    chunks = [Chunk(data=d, suffix_array=suffix_array_native(d))
              for d in datas]
    rng = np.random.default_rng(5)
    pats = [datas[i % 2][o: o + l].tobytes() for i, (o, l) in
            enumerate(zip(rng.integers(0, (4 << 20) - 64, size=2000),
                          rng.integers(1, 40, size=2000)))]
    before = dict(kernels.LAUNCHES)
    uidx = DeviceIndex(chunks, device=dev, mode='upload')
    check(uidx.kind == 'digit' and uidx.mode == 'upload'
          and uidx.num_chunks == 2 and uidx._depth == 2,
          f'digit upload index (got {uidx.kind}, {uidx.mode}, '
          f'{uidx.num_chunks} rows, depth {uidx._depth})')
    for name, per in (('seed_prefix', 1), ('seed_table', 1),
                      ('digit_limb_planes', 1), ('probe_limbs', 0)):
        check(kernels.LAUNCHES[name] - before[name] == 2 * per,
              f'digit upload launched {name} {per} time(s) a chunk')
    c0 = chunks[0]
    check(np.array_equal(uidx.tables[0].cpu().numpy(),
                         S.build_bucket_table_host(c0.data, c0.suffix_array,
                                                   2)),
          'digit upload row 0 bucket table equals the host builder')
    check(np.array_equal(uidx.limbs[0].cpu().numpy(), S.pad_limbs_host(
        S.build_limbs_host(c0.data, c0.suffix_array, uidx.num_limbs),
        uidx.n_pad)), 'digit upload row 0 limbs equal the host builder')
    rp, rl = S.pack_patterns(pats)
    args = (uidx.text, uidx.lengths, uidx.sa, uidx.tables, uidx.limbs,
            torch.from_numpy(rp).to(dev), torch.from_numpy(rl).to(dev),
            uidx.num_limbs)
    lo, cnt = S.probe_limbs(*args)
    lo_p, cnt_p = S.probe_limbs_plain(*args)
    e = max(err(cnt, cnt_p), err(lo, lo_p))
    check(e == 0, f'digit upload B11 equals plain (max err {e})')
    check(int((cnt > 0).sum()) > len(pats) // 2, 'digit upload patterns found')
    log(f'digit upload: 2 rows x n_pad {uidx.n_pad}, {uidx.num_limbs} limbs, '
        f'bucket depth 2; aux once a chunk; row 0 table and limbs equal the '
        f'host builders; B11 over {len(pats)} patterns equals plain, kernel '
        f'{cuda_ms(lambda: S.probe_limbs(*args), 10):.4f} ms, plain '
        f'{cuda_ms(lambda: S.probe_limbs_plain(*args), 2):.4f} ms')


def byte_sampler_check(r, idx, byte_pats):
    """bench.py's byte sampler over the digit corpus, on the Reader's
    index: B11 and B8 on every row x the whole batch against their plain
    versions, timed, and the exact counts (``count_matches``) against
    ``HostServing.probe``, pattern by pattern; no lines are made.  Returns
    its numbers."""
    import numpy as np

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    label = 'digit byte sampler '
    bp, bl = S.pack_patterns(byte_pats)
    times = {}

    def note(name, replaces, src, e, ms, plain_ms, nbytes, library_ms=None):
        kernel_check(label)(name, replaces, src, e, ms, plain_ms, nbytes,
                            library_ms)
        times[name] = {'kernel_ms': ms, 'plain_ms': plain_ms,
                       'library_ms': library_ms}

    lo_k, cnt_k = digit_probe_kernel(idx, bp, bl, note)
    hits = int(cnt_k.long().sum())
    times['gather'] = gather_kernel(idx, lo_k, cnt_k, note, label)
    del lo_k, cnt_k
    cm = idx.count_matches(bp, bl).sum(0)
    host = r._host_serving.probe(*pack_patterns_host(byte_pats))[1].sum(0)
    check(np.array_equal(cm, host),
          'byte sampler: counts equal the host, pattern by pattern')
    top = np.sort(cm)[::-1]
    log(f'{label}({len(byte_pats)} patterns of 4-12 bytes): {hits} suffix '
        f'hits on the merged rows, {int(cm.sum())} matches, equal to the host '
        f'pattern by pattern; the 10 largest counts {top[:10].tolist()}')
    return {'patterns': len(byte_pats), 'suffix_hits': hits,
            'matches': int(cm.sum()), **times}


def writer_chunk_init(data, entry):
    """B1b on one chunk the digit Writer built on the card, padded as
    ``suffix_array_torch`` pads it (N = _pad_len(n + 6)): against its plain
    version, timed as one launch beside ``torch.sort`` of its keys, with
    its path, device time by kernel and buckets."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    n = int(data.size)
    N = SA._pad_len(n + SA.BYTE_INIT_WIDTH)
    text = torch.zeros(N, dtype=torch.uint8, device='cuda')
    text[:n] = torch.from_numpy(np.array(data, dtype=np.uint8)).cuda()
    got = SA.sa_init_bytes(text, n)
    want = SA.sa_init_bytes_plain(text, n)
    e = max(err(a, b) for a, b in zip(got, want))
    del got, want
    ms = cuda_ms(lambda: SA.sa_init_bytes(text, n), 20)
    plain_ms = cuda_ms(lambda: SA.sa_init_bytes_plain(text, n), 3)
    lib_ms = sort_ms(SA._byte_key(text, n))
    entry('sa_init_bytes', f'{JAX_SA}:271', SA_SRC, e, ms, plain_ms, 13 * N,
          lib_ms)
    prof = init_profile(SA.sa_init_bytes, text, n, SA._byte_key,
                        SA.BYTE_KEY_BITS, SA.INIT_CUT_BYTES,
                        f'digit Writer chunk ({n} bytes, N {N}) ',
                        'sa_init_bytes')
    return {'n': n, 'N': N, 'ms': ms, 'plain_ms': plain_ms,
            'sort_keys_ms': lib_ms, **prof}


def run_digit(idx_path, pats, byte_pats, dev, chunk_datas):
    """The digit phase: ``Reader(path)`` derives the digit index (B1b and
    B2 from k = 6, B12d with one K7 pass a row, B11, B8) with launch counts
    from 0; geometry, kernels against their plain versions, bench.py's
    byte sampler by counts, every row's SA build, answers against the host
    path, probe p50, and the small upload index."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    lpats = line_batch(pats, DEEP_PATTERNS + len(DIGIT_SHORT)
                       + len(DIGIT_HIGH))
    r, launches, res, result = open_derive(idx_path, lpats, 'digit',
                                           DIGIT_KERNELS, 'digit ')
    idx = r._index
    n_pad = SA._pad_len(max(d.size for d in idx.row_data) + S.PAD_MARGIN)
    check(idx.num_chunks == 2 and idx._base == 258 and idx._depth == 3
          and idx.num_limbs == 5 and idx.n_pad == n_pad,
          f'digit geometry: 2 rows x n_pad {n_pad}, bucket 258^3, 5 limbs '
          f'(got {idx.num_chunks} x {idx.n_pad}, {idx._base}^{idx._depth}, '
          f'{idx.num_limbs})')
    check(launches['seed_prefix'] == idx.num_chunks,
          f'one K7 pass a row built the depth-3 tables, none the limbs (K7 '
          f'launched {launches["seed_prefix"]} times for {idx.num_chunks} '
          'rows)')
    for i, x in enumerate(result['rows']):
        log(f'digit row {i}: {x["rounds"]} B2 rounds from k = 6, tie counts '
            f'm {x["ties"]}')
    entries = []
    entry = kernel_check('', entries, launches)
    check_only = kernel_check('digit ')
    digit_aux_kernels(idx, entry, check_only)
    packed_np, lengths_np = S.pack_patterns(pats)
    lo_k, cnt_k = digit_probe_kernel(idx, packed_np, lengths_np, entry)
    gather = gather_kernel(idx, lo_k, cnt_k, check_only, 'digit ')
    n_high = len(DIGIT_HIGH)
    check(int(cnt_k[:, -n_high:].sum()) == 0,
          'patterns with a byte >= 0x80 count 0')
    del lo_k, cnt_k
    cp, cl = S.pack_patterns(DIGIT_COUNT_ONLY)
    digit_probe_kernel(idx, cp, cl, check_only)
    check(np.array_equal(idx.count_matches(cp, cl).sum(0),
                         r._host_serving.probe(
                             *pack_patterns_host(DIGIT_COUNT_ONLY))[1].sum(0)),
          'NUL and newline patterns: counts equal the host')
    log(f'count-only patterns {DIGIT_COUNT_ONLY}: counts '
        f'{idx.count_matches(cp, cl).sum(0).tolist()} equal the host')
    byte_sampler = byte_sampler_check(r, idx, byte_pats)
    torch.cuda.empty_cache()
    round1 = init_and_round(
        idx, SA.sa_init_bytes, SA.sa_init_bytes_plain, SA._byte_key,
        SA.BYTE_KEY_BITS, SA.INIT_CUT_BYTES, SA.BYTE_INIT_WIDTH, check_only,
        check_only, 'sa_init_bytes', 271, 'digit ')[3]
    chunk_init = writer_chunk_init(chunk_datas[0], check_only)
    derive_rows = check_derive_rows(idx, 'digit ')
    host_search_s = check_answers(r, idx, pats, packed_np, lengths_np, res,
                                  lpats)
    del res
    check_boundaries(r, idx)
    p50 = probe_p50(idx, packed_np, lengths_np)
    hs_cnt = r._host_serving.probe(*pack_patterns_host(pats))[1]
    check(int(hs_cnt[:, -n_high:].sum()) == 0,
          'the host path counts the >= 0x80 patterns 0 too')
    resident = torch.cuda.memory_allocated() / 2**30
    del r, idx
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    digit_upload_check(dev, chunk_datas)
    return {**result, 'kernels': entries, 'derive_rows': derive_rows,
            'resident_gib': resident, 'probe_p50_ms': p50,
            'host_search_s': host_search_s, 'launches': launches,
            'byte_sampler': byte_sampler, 'gather': gather,
            'round1': round1, 'chunk_init': chunk_init}


def run_b9(chunk_datas, native_sas, dev):
    """B9's paths with launch counts from 0: ``suffix_array_torch(algorithm
    ='full')`` on two 8 MiB digit chunks against native SA-IS, timed
    against ``'segmented'``, with the rounds of each build, and
    ``suffix_array_int(backend='torch')`` on an int array of k = 2^20
    against native; then B9's byte and integer inits and one round against
    their plain versions on chunk 0's row, each beside one ``torch.sort``
    of its keys, and the whole byte and integer doubling against plain,
    pad slots included, which must be [N - 1, ..., n]."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    kernels.reset_launches()
    times = {'full_s': [], 'segmented_s': [], 'full_rounds': []}
    for data, want in zip(chunk_datas, native_sas):
        before = kernels.LAUNCHES['sa_full_round']
        sa, full_s = wall_s(lambda: SA.suffix_array_torch(data,
                                                          algorithm='full'))
        times['full_rounds'].append(kernels.LAUNCHES['sa_full_round'] -
                                    before)
        check(np.array_equal(sa, want),
              'B9 full build of an 8 MiB chunk equals native SA-IS')
        sa, seg_s = wall_s(lambda: SA.suffix_array_torch(data))
        check(np.array_equal(sa, want), 'segmented build equals native')
        times['full_s'].append(full_s)
        times['segmented_s'].append(seg_s)
    k = 1 << 20
    vals = np.random.default_rng(7).integers(0, k, size=4 << 20,
                                             dtype=np.int32)
    vals[1::3] = vals[::3][: vals[1::3].size]  # repeats: several rounds
    before = kernels.LAUNCHES['sa_full_round']
    got, int_s = wall_s(lambda: SA.suffix_array_int(vals, k, 'torch'))
    times['int_rounds'] = kernels.LAUNCHES['sa_full_round'] - before
    t0 = time.perf_counter()
    want = SA.suffix_array_int(vals, k, 'native')
    int_native_s = time.perf_counter() - t0
    check(np.array_equal(got, want),
          'B9 integer form equals native SA-IS at k = 2^20')
    launches = dict(kernels.LAUNCHES)
    for name in B9_KERNELS:
        check(launches[name] > 0, f'B9 path launched {name}')
    log(f'B9: full build {times["full_s"]} s against segmented '
        f'{times["segmented_s"]} s per 8 MiB chunk (wall, upload and '
        f'readback included), both equal native SA-IS, B9 rounds '
        f'{times["full_rounds"]}; integer form at k = 2^20 over '
        f'{vals.size} values {int_s:.3f} s (native {int_native_s:.3f} s), '
        f'equal, {times["int_rounds"]} rounds after its init; launches '
        f'{ {n: launches[n] for n in B9_KERNELS} }')

    entries = []
    entry = kernel_check('', entries, launches)
    data = chunk_datas[0]
    n = data.size
    N = SA._pad_len(n + SA.BYTE_INIT_WIDTH)
    text = torch.zeros(N, dtype=torch.uint8, device=dev)
    text[:n] = torch.from_numpy(np.array(data))
    first = SA.sa_full_init_bytes(text, n)
    plain = SA.sa_full_init_bytes_plain(text, n)
    check(first[2] == plain[2], 'B9 init rank counts equal')
    entry('sa_full_init_bytes', f'{JAX_SA}:156', SA_SRC,
          max(err(a, b) for a, b in zip(first[:2], plain[:2])),
          cuda_ms(lambda: SA.sa_full_init_bytes(text, n), 5),
          cuda_ms(lambda: SA.sa_full_init_bytes_plain(text, n), 2),
          N + 8 * N, sort_ms(SA._byte_key(text, n)))
    W = SA._key_width(N)
    state = [t.clone() for t in first[:2]]
    pstate = [t.clone() for t in first[:2]]
    sorted_state = [t.clone() for t in first[:2]]
    c = SA.sa_full_round(*state, 6, W)
    pc = SA.sa_full_round_plain(*pstate, 6, W)
    check(c == pc, f'B9 round counts {c} {pc}')
    # The same round on its full-sort path, which the loop takes while few
    # ranks are distinct.
    check(SA._full_round(*sorted_state, 6, W, n, 0)[0] == pc,
          'B9 round counts on the full-sort path')
    round_err = max(err(a, b) for a, b in zip(state + sorted_state,
                                               pstate + pstate))
    del sorted_state

    def restore():
        for s_, t in zip(state, first[:2]):
            s_.copy_(t)

    r = first[1].long()
    keys = (r << W) | SA._shifted(r + 1, 6)
    entry('sa_full_round', f'{JAX_SA}:183', SA_SRC, round_err,
          cuda_ms(lambda: SA.sa_full_round(*state, 6, W), 5, restore),
          cuda_ms(lambda: SA.sa_full_round_plain(*state, 6, W), 2, restore),
          12 * N, sort_ms(keys))
    del keys, r, state, pstate, plain
    full_k = SA.sa_full_doubling(text, n)
    check(torch.equal(full_k, SA.sa_full_doubling_plain(text, n)),
          'B9 byte doubling equals its plain version, pad slots included')
    check(torch.equal(full_k[:N - n], pad_slots(N, n, dev)),
          'B9 byte doubling writes the pad slots [N - 1, ..., n]')
    m = vals.size
    ranks = torch.zeros(SA._pad_len(m), dtype=torch.int32, device=dev)
    ranks[:m] = torch.from_numpy(vals + 1)
    Ni = ranks.shape[0]
    iinit = SA.sa_full_init_int(ranks, m)
    piinit = SA.sa_full_init_int_plain(ranks, m)
    check(iinit[2:] == piinit[2:], 'B9 integer init counts equal')
    r = ranks.long()
    Wi = max(SA._key_width(Ni), int(r.max() + 1).bit_length())
    keys = (r << Wi) | SA._shifted(r + 1, 1)
    entry('sa_full_init_ranks', f'{JAX_SA}:632', SA_SRC,
          max(err(a, b) for a, b in zip(iinit[:2], piinit[:2])),
          cuda_ms(lambda: SA.sa_full_init_int(ranks, m), 5),
          cuda_ms(lambda: SA.sa_full_init_int_plain(ranks, m), 2),
          12 * Ni, sort_ms(keys))
    del keys, r, iinit, piinit
    full_i = SA.sa_full_doubling_int(ranks, m)
    check(torch.equal(full_i, SA.sa_full_doubling_int_plain(ranks, m)),
          'B9 integer doubling equals its plain version')
    check(torch.equal(full_i[:Ni - m], pad_slots(Ni, m, dev)),
          'B9 integer doubling writes the pad slots [N - 1, ..., n]')
    del full_i
    log(f'B9 on an {n}-byte row (N {N}): init, round, byte and integer '
        'doubling equal their plain versions')
    del full_k, ranks, text, first
    torch.cuda.empty_cache()
    return {'kernels': entries, 'launches': launches, **times,
            'int_s': int_s, 'int_native_s': int_native_s}


def row0_bwt_and_b15(r, idx, lo_k, cnt_k, entries):
    """B13 and B15's table and capped gather on the ranked derive index's
    row 0.  Launch counts from 0, then the path: ``bwt_from_sa_device`` on
    the row (``text[:n]``, ``sa[:n]`` of the rolled-front row) and on
    container chunk 0 (text and SA uploaded), and ``gather_hit_positions``
    of the batch's row-0 bounds at cap 64; every new kernel must have
    launched.  Then each against its plain version on the card, timed: B13
    also against the host ``bwt_from_sa`` of the same SA, ``unbwt_native``
    of chunk 0's U returns the chunk and ``bwt()`` of it (SA built on the
    card) gives the same U; the capped gather against the first min(count,
    64) positions of each query's B8 block; ``build_bucket_table`` at depth
    2 and 3 against its plain version.  Appends B13's and the gather's rows
    to ``entries``; returns the numbers."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.ops import bwt as BWT
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.native import unbwt_native

    dev = idx.device
    n0 = int(idx.row_data[0].size)
    text0, sa0 = idx.text[0, :n0], idx.sa[0, :n0]
    c0 = r._chunks[0]
    ctext = torch.from_numpy(np.array(c0.data)).to(dev)
    csa = torch.from_numpy(np.array(c0.suffix_array, dtype=np.int32)).to(dev)
    lo0, cnt0 = lo_k[0].contiguous(), cnt_k[0].contiguous()
    kernels.reset_launches()
    (u, p), b13_s = wall_s(lambda: BWT.bwt_from_sa_device(text0, sa0))
    cu, cp = BWT.bwt_from_sa_device(ctext, csa)
    capped = S.gather_hit_positions(idx.sa[0], lo0, cnt0, 64)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    check(launches['bwt_from_sa'] == 2 and launches['gather_hit_positions']
          == 1, f'B13 launched twice and the capped gather once ({launches})')
    entry = kernel_check('', entries, launches)

    u_p, p_p = BWT.bwt_from_sa_device_plain(text0, sa0)
    e = max(err(u, u_p), abs(int(p) - int(p_p)))
    del u_p
    t0 = time.perf_counter()
    u_h, p_h = BWT.bwt_from_sa(idx.row_data[0], sa0.cpu().numpy())
    host_s = time.perf_counter() - t0
    check(np.array_equal(u.cpu().numpy(), u_h) and int(p) == p_h,
          "B13 on row 0 equals the host bwt_from_sa of the row's SA")
    del u_h
    check(np.array_equal(unbwt_native(cu.cpu().numpy(), int(cp)), c0.data),
          'unbwt_native of chunk 0\'s device BWT returns the chunk')
    bu, bp = BWT.bwt(c0.data)
    check(np.array_equal(bu, cu.cpu().numpy()) and bp == int(cp),
          'bwt() of chunk 0 (SA built on the card) equals the device BWT')
    # The library call: one torch.take of the text at U's source slots,
    # made beforehand.
    iota = torch.arange(n0, device=dev)
    src = (sa0.long() - 1) % n0
    src = src[torch.where(iota <= int(p) - 1, iota - 1, iota) % n0]
    src[0] = n0 - 1
    del iota
    entry('bwt_from_sa', f'{JAX_BWT}:72', BWT_SRC, e,
          cuda_ms(lambda: BWT.bwt_from_sa_device(text0, sa0), 10),
          cuda_ms(lambda: BWT.bwt_from_sa_device_plain(text0, sa0), 2),
          6 * n0, cuda_ms(lambda: torch.take(text0, src), 5))
    del src
    torch.cuda.empty_cache()
    log(f'B13 on row 0 ({n0} bytes): {b13_s * 1e3:.3f} ms wall for the first '
        f'call, equal to its plain version and to the host bwt_from_sa '
        f'({host_s:.2f} s); chunk 0 ({c0.data.size} bytes): unbwt_native '
        'returns it, bwt() agrees')

    B = lo0.shape[0]
    plain = S.gather_hit_positions_plain(idx.sa[0], lo0, cnt0, 64)
    pos, _ = S.gather_hits_flat(idx.sa[0], lo0, cnt0)
    cnt64 = cnt0.long()
    off = torch.cumsum(cnt64, 0) - cnt64
    cols = torch.arange(64, device=dev)
    mask = cols[None, :] < cnt64.clamp(max=64)[:, None]
    blocks = pos[(off[:, None] + cols)[mask]]
    check(torch.equal(capped[mask], blocks) and bool((capped[~mask] == -1)
                                                     .all()),
          'each query\'s capped row equals the first min(count, 64) '
          'positions of its B8 block')
    slot = (lo0.long()[:, None] + cols).clamp(0, idx.n_pad - 1)
    kept = int(cnt64.clamp(max=64).sum())
    # A call takes some microseconds: many runs, and the device time of the
    # kernel alone and of torch.take's kernel from the profiler.
    call_ms = cuda_ms(lambda: S.gather_hit_positions(idx.sa[0], lo0, cnt0,
                                                     64), 200)
    take_ms = cuda_ms(lambda: torch.take(idx.sa[0], slot), 200)
    kernel_us = device_times(lambda: [S.gather_hit_positions(
        idx.sa[0], lo0, cnt0, 64) for _ in range(100)])
    take_us = device_times(lambda: [torch.take(idx.sa[0], slot)
                                    for _ in range(100)])
    gather_numbers = {
        'call_ms': call_ms, 'take_call_ms': take_ms,
        'kernel_device_ms': kernel_us[0] / 100 / 1e3,
        'take_device_ms': take_us[0] / 100 / 1e3,
        'kernels': [kernel_us[1], take_us[1]]}
    entry('gather_hit_positions', f'{JAX_SEARCH}:1603', SEARCH_SRC,
          err(capped, plain), call_ms,
          cuda_ms(lambda: S.gather_hit_positions_plain(idx.sa[0], lo0, cnt0,
                                                       64), 3),
          8 * B + 4 * kept + 4 * 64 * B, take_ms)
    del pos, blocks, slot, plain
    log(f'capped gather: {B} queries x 64 on row 0, {kept} positions kept; '
        f'whole call {call_ms:.4f} ms (torch.take {take_ms:.4f} ms); device '
        f'time a call: kernel {gather_numbers["kernel_device_ms"]:.5f} ms, '
        f'torch.take {gather_numbers["take_device_ms"]:.5f} ms '
        f'({json.dumps(gather_numbers["kernels"])})')


    tables = {}
    check_only = kernel_check('row 0 ')
    for depth in (2, 3):
        t = S.build_bucket_table(idx.text[0], n0, idx.sa[0], depth)
        t_p = S.digit_bucket_table_plain(idx.text[0], idx.sa[0], n0, depth)
        ms = cuda_ms(lambda: S.build_bucket_table(idx.text[0], n0, idx.sa[0],
                                                  depth), 10)
        plain_ms = cuda_ms(lambda: S.digit_bucket_table_plain(
            idx.text[0], idx.sa[0], n0, depth), 2)
        check_only(f'build_bucket_table depth {depth}', f'{JAX_SEARCH}:299',
                   SEARCH_SRC, err(t, t_p), ms, plain_ms,
                   idx.n_pad + 4 * n0 + table_bytes(t))
        tables[depth] = {'kernel_ms': ms, 'plain_ms': plain_ms,
                         'bound_ms': bound_ms(idx.n_pad + 4 * n0
                                              + table_bytes(t)),
                         'entries': int(t.shape[0])}
        del t, t_p
    torch.cuda.empty_cache()
    return {'b13_first_call_s': b13_s, 'host_bwt_s': host_s,
            'bucket_tables': tables, 'launches': launches,
            'capped_gather': gather_numbers}


MH_WORKER = r"""
import json, os, pickle, sys, time
rank, d, shards, device = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
from pysubstringsearch_tpu_torch.parallel import multihost
multihost.initialize('file://' + os.path.join(d, 'mh_rendezvous'), 2, rank,
                     'gloo')
t0 = time.perf_counter()
r = multihost.MultiHostReader(shards, device=device)
if device != 'cpu':
    assert r.wait_device_ready(), 'device index load failed'
ready_s = time.perf_counter() - t0
with open(os.path.join(d, 'mh_patterns.pkl'), 'rb') as f:
    pats = pickle.load(f)
t0 = time.perf_counter()
per = r._search_batch(pats)
search_s = time.perf_counter() - t0
if rank == 0:
    with open(os.path.join(d, 'mh_result.pkl'), 'wb') as f:
        pickle.dump(per, f)
idx = r._local._index
print(json.dumps({'rank': rank, 'chunks': len(r._local._chunks),
                  'rows': idx.num_chunks, 'mode': idx.mode,
                  'ready_s': ready_s, 'search_s': search_s,
                  'lines': sum(map(len, per)),
                  'jax_loaded': 'jax' in sys.modules}), flush=True)
import torch.distributed as dist
dist.destroy_process_group()
"""


def _repo_env():
    env = dict(os.environ)
    here = os.path.dirname(os.path.abspath(__file__))
    env['PYTHONPATH'] = here + os.pathsep + env.get('PYTHONPATH', '')
    return env, here


def run_multihost(shards, pats, ref, d, device):
    """Two worker processes (``python3 -c``, importing only the port) join
    a gloo group through ``file://``, each loads its own shard into a
    Reader on ``device`` (deriving its index there) and answers ``pats``;
    rank 0's merged result must equal ``ref`` pattern by pattern as a
    multiset.  A worker's non-zero exit or timeout fails the run."""
    import collections
    import pickle

    env, here = _repo_env()
    with open(os.path.join(d, 'mh_patterns.pkl'), 'wb') as f:
        pickle.dump(pats, f)
    log('MultiHostReader: 2 worker processes on one card; one card cannot '
        'hold two NCCL ranks, so the multi-process path runs its host '
        'gather (gloo), which is the path that spans processes here')
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, '-c', MH_WORKER, str(rank), d, shards, str(device)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=here) for rank in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    stats = []
    for rank, (p, out) in enumerate(zip(procs, outs)):
        check(p.returncode == 0,
              f'MultiHostReader worker {rank} exited {p.returncode}:\n'
              + out[-3000:])
        stats.append(json.loads(out.strip().splitlines()[-1]))
    check(not any(s['jax_loaded'] for s in stats), 'workers loaded no JAX')
    with open(os.path.join(d, 'mh_result.pkl'), 'rb') as f:
        merged = pickle.load(f)
    check(len(merged) == len(ref) and all(
        collections.Counter(a) == collections.Counter(b)
        for a, b in zip(merged, ref)),
          'MultiHostReader result multisets equal the single Reader\'s, '
          'pattern by pattern')
    log(f'MultiHostReader: 2 processes, {wall:.1f} s wall; per rank '
        f'{stats}; merged lines {sum(map(len, merged))} equal the single '
        'Reader\'s')
    return {'wall_s': wall, 'ranks': stats}


def run_cli(idx_path, pats, ref, shards, d):
    """``python3 -m pysubstringsearch_tpu_torch search <idx> <3 patterns>
    --count-only`` (a Reader on the card) and ``shard`` once, as
    subprocesses: the counts equal the single Reader's, and ``shard``
    writes the manifest and shard files ``convert_index`` wrote."""
    import shutil

    env, here = _repo_env()
    strs = [p.decode('latin-1') for p in pats[:3]]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'pysubstringsearch_tpu_torch', 'search',
         idx_path, *strs, '--count-only'], capture_output=True, text=True,
        env=env, cwd=here, timeout=WORKER_TIMEOUT_S)
    search_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'CLI search exited {proc.returncode}:\n'
          + proc.stderr[-3000:])
    got = [ln.rsplit('\t', 1) for ln in proc.stdout.splitlines()]
    check([(a, int(b)) for a, b in got]
          == [(s, len(x)) for s, x in zip(strs, ref)],
          f'CLI counts {got} equal the single Reader\'s')
    out_dir = os.path.join(d, 'cli_shards')
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, '-m', 'pysubstringsearch_tpu_torch', 'shard',
         idx_path, out_dir, '--shards', '2'], capture_output=True, text=True,
        env=env, cwd=here, timeout=WORKER_TIMEOUT_S)
    shard_s = time.perf_counter() - t0
    check(proc.returncode == 0, f'CLI shard exited {proc.returncode}:\n'
          + proc.stderr[-3000:])
    for name in sorted(os.listdir(shards)):
        a, b = os.path.join(out_dir, name), os.path.join(shards, name)
        if name.endswith('.json'):
            with open(a, 'rb') as f, open(b, 'rb') as g:
                check(f.read() == g.read(), f'CLI shard wrote {name} alike')
        else:
            check(os.path.getsize(a) == os.path.getsize(b),
                  f'CLI shard wrote {name} of the same size')
    shutil.rmtree(out_dir)
    log(f'CLI: search of 3 patterns {search_s:.1f} s (a process, a Reader '
        f'on the card), counts {got} equal; shard {shard_s:.1f} s, the '
        'manifest of convert_index')
    return {'search_s': search_s, 'shard_s': shard_s}


def run_parallel(idx_path, pats, dev, upload_bounds, ref, d,
                 backend='nccl'):
    """The scale-out path on the ranked container, after the upload index
    is freed.  A 1-process ``backend`` group (``file://`` in ``d``) and the
    mesh of this card; the container's chunks stacked as rows [C, N_pad]
    at the upload geometry.  Launch counts from 0, then the path:
    ``make_sharded_build`` (B9 a row), ``make_sharded_probe`` over the
    ranked batch (one B15 launch, then the all-gather) and
    ``make_full_step``; every kernel of the path must have launched.  Then
    every row's SA against the container's (native SA-IS), every B15 count
    (and lower bound where it hits) against K4's in the upload phase, B15
    against its plain version, the full step's bounds and totals, and the
    times of B15, B9 a row and each collective.  Then ``ShardedReader``,
    ``MultiHostReader`` (two processes) and the CLI over the first
    ``SHARD_PATTERNS`` patterns against the single Reader's lines ``ref``.
    """
    import collections

    import numpy as np
    import torch
    import torch.distributed as dist

    from pysubstringsearch_tpu_torch.container import read_container
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.suffix_array import _pad_len
    from pysubstringsearch_tpu_torch.parallel import mesh as M
    from pysubstringsearch_tpu_torch.parallel import manifest, multihost
    from pysubstringsearch_tpu_torch.parallel import sharded
    from pysubstringsearch_tpu_torch.parallel.reader import (
        ShardedIndex,
        ShardedReader,
    )

    chunks = read_container(idx_path).chunks
    C = len(chunks)
    N = _pad_len(max(c.data.size for c in chunks) + S.PAD_MARGIN)
    text_h = np.zeros((C, N), dtype=np.uint8)
    for i, c in enumerate(chunks):
        text_h[i, : c.data.size] = c.data
    n_h = np.array([c.data.size for c in chunks], dtype=np.int32)
    t0 = time.perf_counter()
    multihost.initialize('file://' + os.path.join(d, 'pg_rendezvous'), 1, 0,
                         backend)
    init_s = time.perf_counter() - t0
    out = {'rows': C, 'n_pad': N, 'init_s': init_s}
    try:
        mesh = M.make_mesh(dev)
        check(mesh.distributed and mesh.world == 1 and mesh.size == 1,
              f'a 1-process {backend} mesh')
        text = torch.from_numpy(text_h).to(dev)
        n = torch.from_numpy(n_h).to(dev)
        del text_h
        packed_np, lengths_np = S.pack_patterns(pats)
        patterns = torch.from_numpy(packed_np).to(dev)
        lengths = torch.from_numpy(lengths_np).to(dev)
        log(f'scale-out: {C} rows x N_pad {N} ({C * N / 1e9:.2f} GB of text, '
            f'{4 * C * N / 1e9:.2f} GB of SA), {len(pats)} patterns, '
            f'{backend} group of 1 in {init_s:.2f} s')

        # ---- the path, launch counts from 0 ----
        kernels.reset_launches()
        sa, build_s = wall_s(lambda: sharded.make_sharded_build(mesh)(text,
                                                                      n))
        build_rounds = kernels.LAUNCHES['sa_full_round']
        gathered, probe_s = wall_s(lambda: sharded.make_sharded_probe(mesh)(
            text, n, sa, patterns, lengths))
        (bounds, totals), step_s = wall_s(lambda: sharded.make_full_step(
            mesh)(text, n, patterns, lengths))
        launches = dict(kernels.LAUNCHES)
        for name in PARALLEL_KERNELS:
            check(launches[name] > 0, f'the scale-out path launched {name}')
        check(launches['probe_bytes'] == 2 and
              launches['sa_full_init_bytes'] == 2 * C,
              f'one B15 launch a probe and B9 once a row a build ({launches})')
        out['b9_rounds_per_row'] = build_rounds / C
        log(f'scale-out path: sharded build {build_s:.4f} s '
            f'({C / build_s:.2f} rows/s, B9 {build_rounds / C:.2f} rounds '
            f'a row), sharded probe {probe_s * 1e3:.2f} ms wall, full step '
            f'{step_s:.2f} s; launches '
            f'{ {k: launches[k] for k in PARALLEL_KERNELS} }')

        # ---- checks ----
        for i, c in enumerate(chunks):
            m = c.data.size
            want = torch.from_numpy(np.array(c.suffix_array,
                                             dtype=np.int32)).to(dev)
            check(torch.equal(sa[i, :m], want),
                  f'row {i}: the sharded build\'s SA equals native SA-IS')
            check(torch.equal(sa[i, m:], pad_slots(N, m, dev)),
                  f'row {i}: the pad slots are [N - 1, ..., n]')
        del want
        lo, cnt = gathered[..., 0], gathered[..., 1]
        up_lo, up_cnt = upload_bounds
        cnt_h = cnt.cpu().numpy()
        check(np.array_equal(cnt_h, up_cnt),
              'every B15 count equals K4\'s upload count, row by row')
        hit = up_cnt > 0
        check(np.array_equal(lo.cpu().numpy()[hit], up_lo[hit]),
              'B15 lower bounds equal K4\'s wherever a pattern hits')
        check(torch.equal(bounds, gathered),
              'the full step\'s bounds equal the sharded probe\'s')
        check(torch.equal(totals, cnt.sum(0).to(torch.int32)),
              'the full step\'s totals are the column sums')
        lo_p, cnt_p = S.probe_bytes_plain(text, n, sa, patterns, lengths)
        e = max(err(lo_p, lo), err(cnt_p, cnt))
        del lo_p, cnt_p
        log(f'every row\'s SA equals native SA-IS; {int(cnt_h.sum())} suffix '
            f'hits, counts equal K4\'s; the full step agrees')

        entries = []
        entry = kernel_check('', entries, launches)
        lens = lengths_np.astype(np.int64).clip(0, packed_np.shape[1])
        B = len(pats)
        # Patterns and lengths read, bounds written, and for every (row,
        # pattern) the two boundary suffixes each bisection ends on: their
        # SA entries and as many text bytes as the pattern.
        nbytes = (packed_np.size + 4 * B + 4 * C + 8 * C * B
                  + 2 * C * int((4 + lens).sum()))
        args = (text, n, sa, patterns, lengths)
        entry('probe_bytes', f'{JAX_SEARCH}:265', SEARCH_SRC, e,
              cuda_ms(lambda: S.probe_bytes(*args), 10),
              cuda_ms(lambda: S.probe_bytes_plain(*args), 1), nbytes)
        local = sharded.make_sharded_probe(mesh, gather=False)(*args)
        gather_ms = cuda_ms(lambda: M.all_gather_rows(local, mesh), 10)
        part = totals.clone()
        reduce_ms = cuda_ms(lambda: M.all_reduce_sum(part, mesh), 10)
        row_s = [wall_s(lambda: sharded.build_chunks(text[i: i + 1],
                                                     n[i: i + 1]))[1]
                 for i in (0, C - 1)]
        log(f'collectives ({backend}, world 1): all_gather of the [{C}, {B}, '
            f'2] bounds {gather_ms:.4f} ms, all_reduce of the [{B}] totals '
            f'{reduce_ms:.4f} ms; B9 alone on row 0 {row_s[0]:.3f} s, on row '
            f'{C - 1} {row_s[1]:.3f} s')
        out.update({'kernels': entries, 'launches': {
            k: launches[k] for k in PARALLEL_KERNELS}, 'build_s': build_s,
            'build_rows_per_s': C / build_s, 'probe_wall_s': probe_s,
            'full_step_s': step_s, 'all_gather_ms': gather_ms,
            'all_reduce_ms': reduce_ms, 'b9_row_s': row_s,
            'hits': int(cnt_h.sum())})
        del sa, gathered, bounds, totals, local, lo, cnt, text, n
        del patterns, lengths
        gc.collect()
        torch.cuda.empty_cache()

        # ---- ShardedReader on this card ----
        sub = pats[:SHARD_PATTERNS]
        strs = [p.decode('latin-1') for p in sub]
        t0 = time.perf_counter()
        sr = ShardedReader(idx_path, mesh)
        check(sr.wait_device_ready(), 'ShardedReader device index ready')
        ready_s = time.perf_counter() - t0
        sidx = sr._index
        check(isinstance(sidx, ShardedIndex) and len(sidx.parts) == 1
              and sidx.mode == 'derive' and sidx.merged
              and sr._C == sr._num_real,
              f'ShardedReader: one placement, derive over merged rows '
              f'({sr._C} rows)')
        res, sm_s = wall_s(lambda: sr.search_multiple(strs))
        off = 0
        for i, want in enumerate(ref):
            check(collections.Counter(res[off: off + len(want)])
                  == collections.Counter(want),
                  f'ShardedReader lines of pattern {i} equal the single '
                  'Reader\'s')
            off += len(want)
        check(off == len(res), 'ShardedReader returned no extra lines')
        log(f'ShardedReader on {[str(x) for x in mesh.devices]}: ready in '
            f'{ready_s:.2f} s, {sr._C} rows, search_multiple of {len(sub)} '
            f'patterns {sm_s:.2f} s, {len(res)} lines equal the single '
            'Reader\'s pattern by pattern')
        out['sharded_reader'] = {'ready_s': ready_s,
                                 'search_multiple_s': sm_s,
                                 'lines': len(res)}
        del sr, sidx, res
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    shards = os.path.join(d, 'shards')
    manifest.convert_index(idx_path, shards, 2)
    out['multihost'] = run_multihost(shards, sub, ref, d, dev)
    out['cli'] = run_cli(idx_path, sub, ref, shards, d)
    import shutil

    shutil.rmtree(shards)
    return out


def write_bigrow(pss, corpus, d):
    """The corpus written by the port's Writer at its defaults (one chunk
    of at most 512 MiB, suffix arrays by ``'auto'``, so B1b and B2 on the
    card), launch counts from 0.  Returns (container path, the chunk,
    Writer seconds, launches)."""
    from pysubstringsearch_tpu_torch.container import read_container
    from pysubstringsearch_tpu_torch.ops import kernels

    corpus_path = os.path.join(d, 'bigrow.txt')
    path = os.path.join(d, 'bigrow.idx')
    with open(corpus_path, 'wb') as f:
        f.write(corpus)
    kernels.reset_launches()
    t0 = time.perf_counter()
    with pss.Writer(path) as w:
        w.add_entries_from_file_lines(corpus_path)
    writer_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    os.remove(corpus_path)
    chunks = read_container(path).chunks
    check(len(chunks) == 1, f'the default Writer wrote one chunk '
          f'({len(chunks)})')
    check(launches['sa_init_bytes'] == 1 and launches['sa_init3_bytes'] == 0
          and all(launches[k] > 0 for k in WRITER_KERNELS),
          f'the Writer built the chunk on the card by B1b and B2 ({launches})')
    log(f'bigrow Writer at its defaults: one chunk of {chunks[0].data.size} '
        f'bytes in {writer_s:.2f} s ({len(corpus) / 1e6 / writer_s:.1f} '
        f'MB/s), SA on the card; launches '
        f'{ {k: launches[k] for k in WRITER_KERNELS} }')
    return path, chunks[0], writer_s, launches


def poison_row():
    """``POISON_ROW_BYTES`` of ``ab`` repeated: two 3-byte groups of half
    the row each, far over B10's window."""
    import numpy as np

    return np.frombuffer(b'ab' * (POISON_ROW_BYTES // 2), dtype=np.uint8)


def timed_native(data):
    """(native SA-IS of ``data``, its seconds); runs on a worker thread."""
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    t0 = time.perf_counter()
    sa = suffix_array_native(data)
    return sa, time.perf_counter() - t0


def rotating_kernels(text, n, entry):
    """B10's 3-byte init (its rows past 2^28), one pass from a copied init
    state (k = 3, off = 0) and the whole doubler against their plain
    versions on one row, equal exactly (both sorts are stable), each timed
    beside its bound and one stable ``torch.sort`` of its keys; returns the
    numbers and the kernels' SA."""
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    N = text.shape[0]
    first = SA.sa_init3_bytes(text, n)
    plain = SA.sa_init3_bytes_plain(text, n)
    entry('sa_init3_bytes', f'{JAX_SA}:485', SA_SRC,
          max(err(a, b) for a, b in zip(first, plain)),
          cuda_ms(lambda: SA.sa_init3_bytes(text, n), 3),
          cuda_ms(lambda: SA.sa_init3_bytes_plain(text, n), 1), 13 * N,
          sort_ms(SA._byte_key(text, n, 3)))
    del plain
    torch.cuda.empty_cache()
    state = [t.clone() for t in first]
    pstate = [t.clone() for t in first]
    got = SA.sa_rotating_pass(*state, 3, 0)
    want = SA.sa_rotating_pass_plain(*pstate, 3, 0)
    m = got[3]
    e = max([err(a, b) for a, b in zip(state, pstate)]
            + [0 if got == want else 1])
    del pstate
    half, W = SA._rotating_sizes(N)
    ctl = SA._new_ctl(N, 0, text.device)
    flags, dest = SA._window_bufs(N, text.device)
    SA.sa_window_scan_plain(first[2], ctl, flags, dest, half, W)
    keys = SA._round_keys(*first, 3, SA._span_mask(flags, 0, N))[2]
    del ctl, flags, dest

    def restore():
        for s, t in zip(state, first):
            s.copy_(t)

    entry('sa_rotating_pass', f'{JAX_SA}:518', SA_SRC, e,
          cuda_ms(lambda: SA.sa_rotating_pass(*state, 3, 0), 3, restore),
          cuda_ms(lambda: SA.sa_rotating_pass_plain(*state, 3, 0), 1,
                  restore), 4 * N + 24 * m, sort_ms(keys))
    del state, first, keys
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (sa_k, pois_k, ties_k), k_s = wall_s(
        lambda: SA.segmented_rotating_sa(text, n))
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    (sa_p, pois_p, ties_p), p_s = wall_s(
        lambda: SA.segmented_rotating_sa_plain(text, n))
    check(torch.equal(sa_k, sa_p) and pois_k == pois_p and ties_k == ties_p,
          'segmented_rotating_sa equals its plain version (SA, poisoned, '
          'every pass\'s m_w)')
    del sa_p
    log(f'segmented_rotating_sa on N {N}: kernels {k_s:.3f} s, plain '
        f'{p_s:.3f} s, equal; {sum(map(len, ties_k))} passes, peak '
        f'{peak:.2f} GiB above what was resident')
    return {'m_first_pass': m, 'doubler_s': k_s, 'doubler_plain_s': p_s,
            'doubler_peak_gib': peak, 'passes': [len(r) for r in ties_k]}, \
        sa_k


def run_bigrow(corpus, adv, refs, pats, d, dev):
    """The big-row derive: the Writer at its defaults, the B10 derive
    Reader over its one chunk with the kernels against their plain
    versions, B1b + B2 on the same row, the answers against the host, and
    the poisoning row ``adv`` re-derived by B9.  ``refs`` are the futures
    of :func:`timed_native` of the corpus and of ``adv``.  Returns its
    numbers and B10's kernel rows."""
    import numpy as np
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.container import Chunk
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.utils.profiling import PhaseProfiler

    path, chunk, writer_s, writer_launches = write_bigrow(pss, corpus, d)
    n = chunk.data.size
    check(chunk.data.tobytes() == corpus, 'the chunk holds the corpus')

    # ---- the derive, launch counts from 0 ----
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = pss.Reader(path)
    check(r.wait_device_ready(), 'bigrow device index ready')
    ready_s = time.perf_counter() - t0
    load_peak = torch.cuda.max_memory_allocated() / 2**30
    idx = r._index
    load = dict(kernels.LAUNCHES)
    N = idx.n_pad
    check(idx.mode == 'derive' and idx.num_chunks == 1 and not idx.merged
          and N > SA.SEGMENTED_MAX_N,
          f'one derive row past SEGMENTED_MAX_N (rows {idx.num_chunks}, '
          f'n_pad {N})')
    check(idx.sa_poisoned == [False], 'the big row is not poisoned')
    ties = idx.sa_ties[0]
    passes = [len(r) for r in ties]
    check(load['sa_init3_bytes'] == 1 and load['sa_rotating_pass']
          == sum(passes) and load['sa_window_scan'] == sum(passes) + 1
          and load['sa_init_ranked'] == 0 and load['sa_init_bytes'] == 0
          and load['sa_tie_scan'] == 0 and load['sa_full_init_bytes'] == 0
          and load['sa_roll_front'] == 1,
          f'the row derived through B10 alone ({load})')
    index_sa_s = r.profiler.totals['index-sa']
    log(f'bigrow device ready: {ready_s:.2f} s; 1 row of {n} bytes, n_pad '
        f'{N}; kind {idx.kind}, {idx.num_limbs} limbs; index-sa '
        f'{index_sa_s:.3f} s; peak {load_peak:.2f} GiB during the load, '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB resident; B10 '
        f'passes per round {passes}')
    k0 = 3 if N > 1 << 28 else SA.BYTE_INIT_WIDTH
    for i, ms in enumerate(ties):
        log(f'  B10 round {i} (k {k0 << i}): m_w per pass {ms}')
    split = load_split(r, ('index-alphabet', 'index-alloc', 'index-h2d',
                           'index-sa', 'index-aux'), 'bigrow')
    want = torch.from_numpy(np.array(chunk.suffix_array,
                                     dtype=np.int32)).to(dev)
    check(torch.equal(idx.sa[0, :n], want),
          'the derived SA equals the container\'s (built by B1b + B2)')
    del want

    # ---- the answers, the main path ----
    lpats = line_batch(pats, DEEP_PATTERNS)
    strs = [p.decode('latin-1') for p in lpats]
    after_multi, launches, e2e_s, phases, res = main_path(
        r, strs, lpats, ('probe', 'extract', 'hs-spans', 'hs-fanout'))
    for name in BIGROW_KERNELS:
        check(after_multi[name] > 0, f'bigrow path launched {name}')
    packed_np, lengths_np = S.pack_patterns(pats)
    host_search_s = check_answers(r, idx, pats, packed_np, lengths_np, res,
                                  lpats)
    del res
    p50 = probe_p50(idx, packed_np, lengths_np)
    lo_k, cnt_k = probe_kernel(idx, packed_np, lengths_np,
                               kernel_check('bigrow '))
    del lo_k, cnt_k

    # ---- B10's kernels against their plain versions on the row ----
    entries = []
    entry = kernel_check('', entries, launches)
    text0 = idx.text[0]
    numbers, sa_b10 = rotating_kernels(text0, n, entry)
    check(torch.equal(SA.sa_roll_front(sa_b10, n), idx.sa[0]),
          'the doubler\'s SA rolled equals the index row')

    # ---- B1b + B2, the route of rows up to SEGMENTED_MAX_N ----
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (sa_b2, ties_b2), b2_s = wall_s(lambda: SA.segmented_sa(text0, n))
    b2_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    check(torch.equal(sa_b2, sa_b10), 'B1b + B2 gives B10\'s SA')
    log(f'B1b + B2 on the same row: {b2_s:.3f} s wall, {len(ties_b2)} rounds '
        f'(m {ties_b2}), peak {b2_peak:.2f} GiB above what was resident; '
        f'B10 {numbers["doubler_s"]:.3f} s, peak '
        f'{numbers["doubler_peak_gib"]:.2f} GiB')
    del sa_b2, sa_b10
    native, native_s = refs[0].result()
    check(np.array_equal(chunk.suffix_array, native),
          'the Writer\'s SA of the chunk equals native SA-IS')
    log(f'native SA-IS of the {n}-byte chunk on the host: {native_s:.2f} s '
        '(a thread beside the card since the corpus was made), equal')
    del native, idx, r, text0, chunk
    gc.collect()
    torch.cuda.empty_cache()
    os.remove(path)

    # ---- the fallback: a period-2 row poisons B10, B9 re-derives it ----
    kernels.reset_launches()
    prof = PhaseProfiler()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # Derive mode never reads a chunk's SA: a zero-stride stand-in.
    aidx, adv_s = wall_s(lambda: DeviceIndex(
        [Chunk(data=adv, suffix_array=np.broadcast_to(np.int32(0),
                                                      adv.shape))],
        device=dev, mode='derive', profiler=prof))
    adv_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    fl = dict(kernels.LAUNCHES)
    check(aidx.sa_poisoned == [True] and aidx.n_pad > SA.SEGMENTED_MAX_N,
          f'the period-2 row (n_pad {aidx.n_pad}) is poisoned')
    for name in FALLBACK_KERNELS:
        check(fl[name] > 0, f'the poisoned row launched {name}')
    adv_native, adv_native_s = refs[1].result()
    check(np.array_equal(aidx.sa[0, :adv.size].cpu().numpy(), adv_native),
          'the B9 fallback\'s SA equals native SA-IS')
    check(torch.equal(aidx.sa[0, adv.size:],
                      pad_slots(aidx.n_pad, adv.size, dev)),
          'the B9 fallback\'s pad slots are [N - 1, ..., n]')
    log(f'poisoned row: {adv.size} bytes of "ab", n_pad {aidx.n_pad}: '
        f'DeviceIndex(mode="derive") {adv_s:.2f} s wall (index-sa '
        f'{prof.totals["index-sa"]:.2f} s), peak {adv_peak:.2f} GiB above '
        f'what was resident; B10 passes {aidx.sa_ties[0]} before the '
        f'poison, B9 rounds {fl["sa_full_round"]}; SA equals native SA-IS '
        f'({adv_native_s:.2f} s on the host); launches '
        f'{ {k: fl[k] for k in FALLBACK_KERNELS} }')
    adv_n_pad = aidx.n_pad
    del aidx, adv_native
    gc.collect()
    torch.cuda.empty_cache()
    small = torch.zeros(4096, dtype=torch.uint8, device=dev)
    small[:3000] = ord('a')
    check(SA.segmented_rotating_sa(small, 3000)[1]
          and SA.segmented_rotating_sa_plain(small, 3000)[1],
          'a row of 3000 a bytes is poisoned in kernel and plain')
    log('3000 a bytes at N 4096: poisoned in kernel and plain')
    return {
        'kernels': entries, 'writer_s': writer_s,
        'writer_launches': {k: writer_launches[k] for k in WRITER_KERNELS},
        'native_sais_s': native_s, 'device_ready_s': ready_s,
        'index_sa_s': index_sa_s, 'load_split_s': split,
        'load_peak_gib': load_peak, 'n_pad': N,
        'passes': passes, 'm_w': ties, 'search_multiple_s': e2e_s,
        'search_multiple_phases_s': phases, 'host_search_s': host_search_s,
        'probe_p50_ms': p50, 'b2_s': b2_s, 'b2_ties': ties_b2,
        'b2_peak_gib': b2_peak, **numbers,
        'fallback': {'n': int(adv.size), 'n_pad': adv_n_pad,
                     'wall_s': adv_s, 'index_sa_s': prof.totals['index-sa'],
                     'peak_gib': adv_peak, 'b9_rounds': fl['sa_full_round'],
                     'native_sais_s': adv_native_s},
    }


def period2_sa(N, dev):
    """The SA of ``ab`` repeated to an even N: the ``a`` suffixes from the
    shortest, then the ``b`` suffixes from the shortest."""
    import torch

    return torch.cat([torch.arange(N - 2, -1, -2, dtype=torch.int32,
                                   device=dev),
                      torch.arange(N - 1, 0, -2, dtype=torch.int32,
                                   device=dev)])


def giant_kernels(text, n, sa, S, entry):
    """B14g's kernels against their plain versions at the shapes of the
    big row split in ``S`` blocks (B = N / S), each timed beside its bound
    and, where one PyTorch call computes the same function, that call:
    (a) the byte keys of the last block and the round keys at k = 6 from
    the final ranks (the inverse of ``sa``), (b) the cuts of that block's
    sorted keys at S - 1 of its keys and the partition by owner of the
    sorted positions of slots [0, B) with their slots as group starts, (c)
    the flags of the sorted keys."""
    import torch

    from pysubstringsearch_tpu_torch.ops import suffix_array as SA

    N = text.shape[0]
    B = N // S
    s = S - 1
    p0 = s * B
    blk, halo = text[p0:], text[N:]
    got = SA.giant_byte_keys(blk, halo, p0, n)
    want = SA.giant_byte_keys_plain(blk, halo, p0, n)
    entry('giant_byte_keys', GIANT_SRC, SA_SRC,
          max(err(a, b) for a, b in zip(got, want)),
          cuda_ms(lambda: SA.giant_byte_keys(blk, halo, p0, n), 5),
          cuda_ms(lambda: SA.giant_byte_keys_plain(blk, halo, p0, n), 1),
          13 * B)
    del got, want
    inv = torch.empty(N, dtype=torch.int32, device=text.device)
    SA.scatter(torch.arange(N, dtype=torch.int32, device=text.device), sa,
               inv)
    rank = inv[p0:].clone()
    r2 = inv[p0 + 6:].clone()
    del inv
    W = SA._key_width(N)
    got = SA.giant_round_keys(rank, r2, W, p0)
    want = SA.giant_round_keys_plain(rank, r2, W, p0)
    entry('giant_round_keys', GIANT_SRC, SA_SRC,
          max(err(a, b) for a, b in zip(got, want)),
          cuda_ms(lambda: SA.giant_round_keys(rank, r2, W, p0), 5),
          cuda_ms(lambda: SA.giant_round_keys_plain(rank, r2, W, p0), 1),
          20 * B)
    del want, rank, r2
    keys, vals = got
    del got
    SA.radix_sort_pairs(keys, vals, 2 * W)
    pick = torch.tensor([r * B // S for r in range(1, S)],
                        device=text.device)
    skeys, spos = keys[pick], vals[pick]
    cuts = SA.giant_cuts(keys, vals, skeys, spos)
    entry('giant_cuts', GIANT_SRC, SA_SRC,
          err(cuts, SA.giant_cuts_plain(keys, vals, skeys, spos)),
          cuda_ms(lambda: SA.giant_cuts(keys, vals, skeys, spos), 20),
          cuda_ms(lambda: SA.giant_cuts_plain(keys, vals, skeys, spos), 1),
          (S - 1) * (12 + 12 * B.bit_length()) + 8 * (S - 1),
          cuda_ms(lambda: torch.searchsorted(keys, skeys), 20))
    log(f'giant_cuts: at most {SA.giant_cuts_rounds(B)} dependent rounds of '
        f'loads on {B} sorted pairs, where a binary search takes '
        f'{B.bit_length()}')
    pred = int(keys[0]) - 1
    v, st = SA.giant_flags(keys, B, pred, True, N - n)
    pv, pst = SA.giant_flags_plain(keys, B, pred, True, N - n)
    entry('giant_flags', GIANT_SRC, SA_SRC, max(err(v, pv), err(st, pst)),
          cuda_ms(lambda: SA.giant_flags(keys, B, pred, True, N - n), 5),
          cuda_ms(lambda: SA.giant_flags_plain(keys, B, pred, True, N - n),
                  1), 12 * B + 8)
    del keys, vals, v, pv
    pos = sa[:B].clone()
    gs = torch.arange(B, dtype=torch.int32, device=text.device)
    got = SA.giant_partition(pos, gs, 7, B, S)
    want = SA.giant_partition_plain(pos, gs, 7, B, S)
    entry('giant_partition', GIANT_SRC, SA_SRC,
          max(err(a, b) for a, b in zip(got, want)),
          cuda_ms(lambda: SA.giant_partition(pos, gs, 7, B, S), 5),
          cuda_ms(lambda: SA.giant_partition_plain(pos, gs, 7, B, S), 1),
          16 * B + 4 * S)
    del got, want, pos, gs
    torch.cuda.empty_cache()


def run_giant(corpus, native_ref, d, dev):
    """B14g, ``make_giant_chunk_build``: the big row (the ranked corpus,
    n = 524,288,061 in N = 512 Mi) on four placements of this card, launch
    counts from 0, against native SA-IS (``native_ref``, bigrow's future)
    and the pad slots in closed form, with its wall, rounds, memory peak
    and every sort's largest receive against 2B + S; then its kernels
    against their plain versions on that row's shapes; then a 1-process
    NCCL group (world 1, every exchange through ``all_to_all_single``) on
    an 8 MiB chunk of the corpus (against native SA-IS and B9) and a 64
    MiB period-2 row, all ties (against its closed form and B9).  Returns
    its numbers and the kernels' rows."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native
    from pysubstringsearch_tpu_torch.parallel import mesh as M
    from pysubstringsearch_tpu_torch.parallel import multihost, sharded

    S = GIANT_PLACEMENTS
    data = np.frombuffer(corpus, np.uint8)
    n = data.size
    N = SA._pad_len(n)
    text = torch.zeros(N, dtype=torch.uint8, device=dev)
    text[:n] = torch.from_numpy(data.copy()).to(dev)
    mesh = M.make_mesh([f'cuda:{torch.cuda.current_device()}'] * S)
    build = sharded.make_giant_chunk_build(mesh)
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the path, launch counts from 0 ----
    kernels.reset_launches()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sa, wall = wall_s(lambda: build(text, n))
    peak = torch.cuda.max_memory_allocated() - base
    launches = dict(kernels.LAUNCHES)
    st = dict(build.stats)
    for name in GIANT_KERNELS:
        check(launches[name] > 0, f'the giant build launched {name}')
    slot_bytes = (peak + N) / N
    check(slot_bytes <= SA.SA_BUILD_BYTES_PER_SLOT,
          f'the giant build peaks at {slot_bytes:.2f} bytes a slot, text '
          f'included, within {SA.SA_BUILD_BYTES_PER_SLOT}')
    check(max(st['max_recv']) <= st['recv_bound'],
          f'no shard received more than 2B + S ({st})')
    native, _ = native_ref.result()
    check(sa.shape == (N,) and sa.device == text.device,
          'the one-process build returns all of sa_full on the card')
    check(torch.equal(sa[N - n:], torch.from_numpy(native).to(dev)),
          'the giant build\'s SA equals native SA-IS')
    check(torch.equal(sa[: N - n], pad_slots(N, n, dev)),
          'the giant build\'s pad slots are [N - 1, ..., n]')
    del native
    log(f'giant build on {S} placements of one card, {n} bytes in N {N} '
        f'(B {N // S}): {wall:.3f} s wall, {st["rounds"]} rounds after the '
        f'init, peak {peak / 2**30:.2f} GiB above what was resident '
        f'({slot_bytes:.2f} bytes a slot with the text); largest receive a '
        f'sort {st["max_recv"]} against 2B + S = {st["recv_bound"]}; SA '
        f'equals native SA-IS, pads closed-form; launches '
        f'{ {k: launches[k] for k in GIANT_KERNELS} }')
    out = {'n': n, 'n_pad': N, 'placements': S, 'wall_s': wall,
           'rounds': st['rounds'], 'max_recv': st['max_recv'],
           'recv_bound': st['recv_bound'], 'peak_gib': peak / 2**30,
           'bytes_per_slot': slot_bytes,
           'launches': {k: launches[k] for k in GIANT_KERNELS}}

    # ---- the kernels against their plain versions ----
    entries = []
    giant_kernels(text, n, sa, S, kernel_check('giant ', entries, launches))
    del sa, text
    gc.collect()
    torch.cuda.empty_cache()

    # ---- a 1-process NCCL group: the exchanges through collectives ----
    multihost.initialize('file://' + os.path.join(d, 'giant_rendezvous'), 1,
                         0, 'nccl')
    try:
        mesh1 = M.make_mesh(dev)
        check(mesh1.distributed and mesh1.size == 1,
              'a 1-process NCCL mesh')
        build1 = sharded.make_giant_chunk_build(mesh1)
        # The group's first collectives set up its communicator: a 64-slot
        # row takes that cost, apart from the timed builds.
        tiny = torch.tensor(list(b'abracadabra'), dtype=torch.uint8,
                            device=dev)
        tiny = torch.cat([tiny, tiny.new_zeros(64 - tiny.shape[0])])
        got, first_s = wall_s(lambda: build1(tiny, 11))
        check(torch.equal(got, SA.sa_full_doubling(tiny, 11)),
              'the world-1 giant build of a 64-slot row equals B9')
        chunk = data[: GIANT_CHUNK_BYTES]
        Nc = SA._pad_len(chunk.size)
        row = torch.zeros(Nc, dtype=torch.uint8, device=dev)
        row[: chunk.size] = torch.from_numpy(chunk.copy()).to(dev)
        got, chunk_s = wall_s(lambda: build1(row, chunk.size))
        chunk_rounds = build1.stats['rounds']
        check(torch.equal(got, SA.sa_full_doubling(row, chunk.size)),
              'the world-1 giant build of an 8 MiB chunk equals B9')
        check(np.array_equal(got[Nc - chunk.size:].cpu().numpy(),
                             suffix_array_native(chunk)),
              'the world-1 giant build of an 8 MiB chunk equals native')
        ab = torch.tensor([97, 98], dtype=torch.uint8, device=dev).repeat(
            GIANT_PERIOD2_BYTES // 2)
        got, ab_s = wall_s(lambda: build1(ab, ab.shape[0]))
        ab_stats = dict(build1.stats)
        check(torch.equal(got, period2_sa(ab.shape[0], dev)),
              'the world-1 giant build of the period-2 row equals its '
              'closed form')
        check(torch.equal(got, SA.sa_full_doubling(ab, ab.shape[0])),
              'the world-1 giant build of the period-2 row equals B9')
        check(max(ab_stats['max_recv']) <= ab_stats['recv_bound'],
              'world 1: no receive over 2B + S')
        del got, ab, row, tiny
    finally:
        dist.destroy_process_group()
    log(f'giant build on a 1-process NCCL group: a 64-slot row first '
        f'{first_s:.3f} s (the communicator\'s set-up); an 8 MiB chunk '
        f'({chunk.size} bytes, N {Nc}) {chunk_s:.3f} s, {chunk_rounds} '
        f'rounds, equal to B9 and native SA-IS; {GIANT_PERIOD2_BYTES} bytes '
        f'of "ab" {ab_s:.3f} s, {ab_stats["rounds"]} rounds, equal to its '
        'closed form and B9')
    out.update({'kernels': entries, 'world1_first_s': first_s,
                'world1_chunk_s': chunk_s,
                'world1_chunk_rounds': chunk_rounds,
                'world1_period2_s': ab_s,
                'world1_period2_rounds': ab_stats['rounds']})
    torch.cuda.empty_cache()
    return out


def run_b16():
    """B16 through ``sort_bench`` at 2^24, 2^26 and 2^27 (the giant
    build's rank store) with launch counts from 0: the scatter kernel
    equal to its plain version, beside one
    ``torch.sort`` of (key, value) pairs and ``radix_sort_pairs``; the two
    sorts again at one B10 pass's shape (``measure_wide``); and B8 on a
    skewed batch (:func:`skewed_gather_check`).  Returns the numbers and
    B16's kernel row (at 2^27)."""
    import torch

    from pysubstringsearch_tpu_torch import sort_bench
    from pysubstringsearch_tpu_torch.ops import kernels

    kernels.reset_launches()
    runs = [sort_bench.measure(log2n) for log2n in
            (24, 26, sort_bench.GIANT_RANK_STORE_LOG2N)]
    launches = dict(kernels.LAUNCHES)
    check(launches['scatter'] > 0 and launches['radix_sort_pairs'] > 0,
          f'sort_bench launched the scatter and the radix sort ({launches})')
    for x in runs:
        check(x['radix_sort_max_abs_err'] == 0,
              f'radix_sort_pairs equals torch.sort at n {x["n"]}')
        check(x['blocked_scatter_max_abs_err'] == 0,
              f'scatter_blocked equals the plain scatter at n {x["n"]}')
        log(f'sort_bench n {x["n"]}: scatter {x["scatter_ms"]:.4f} ms (bound '
            f'{x["scatter_bound_ms"]:.4f}), blocked by destination '
            f'{x["blocked_scatter_ms"]:.4f}, plain '
            f'{x["plain_scatter_ms"]:.4f}, library scatter_ '
            f'{x["library_scatter_ms"]:.4f}; torch.sort pairs '
            f'{x["torch_sort_pairs_ms"]:.4f} ms, radix_sort_pairs '
            f'{x["radix_sort_pairs_ms"]:.4f} ms ({x["radix_sort_passes"]} '
            'passes)')
    wide = sort_bench.measure_wide()
    check(wide['radix_sort_max_abs_err'] == 0,
          f'radix_sort_pairs equals torch.sort at B10\'s pass shape '
          f'({wide["n"]} pairs, {wide["key_bits"]} bits)')
    log(f'sort_bench at B10\'s pass shape, {wide["n"]} pairs of '
        f'{wide["key_bits"]}-bit keys: radix_sort_pairs '
        f'{wide["radix_sort_pairs_ms"]:.4f} ms ({wide["radix_sort_passes"]} '
        f'passes), torch.sort pairs {wide["torch_sort_pairs_ms"]:.4f} ms, '
        f'bound {wide["sort_bound_ms"]:.4f} ms, equal')
    skewed = skewed_gather_check(torch.device('cuda'))
    entries = []
    big = runs[-1]
    kernel_check('b16 ', entries, launches)(
        'scatter', 'benchmarks/pallas_sort_bench.py:77', SA_SRC,
        max(x['scatter_max_abs_err'] for x in runs), big['scatter_ms'],
        big['plain_scatter_ms'], 12 * big['n'], big['library_scatter_ms'])
    return {'kernels': entries, 'runs': runs, 'wide': wide,
            'launches': launches['scatter'], 'b8_skewed': skewed}


if __name__ == '__main__':
    sys.exit(main())
