#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the root of a checkout on a machine with a CUDA card:

    python3 chip_smoke.py            # 500 MB corpus, 10k + 200 patterns

Phases (any failure raises and exits non-zero):

1. print the torch / CUDA / nvcc versions and the card; build the CUDA
   kernels from ``pysubstringsearch_tpu_torch/csrc`` and time the build;
2. build ``bench.make_corpus(--mb)`` into a container in 8 MiB chunks with
   the port's Writer (native SA-IS, host only);
3. the main path, with every kernel launch count set to 0 first:
   ``Reader(path)`` uploads the index and builds limbs and seed tables on
   the card (K1-K3), ``wait_device_ready()`` must be True, and
   ``search_multiple`` answers the 10k-pattern batch of ``bench.py`` plus
   200 patterns of 23-200 bytes (K4, deep phase included), and ``search``
   answers one pattern, which must launch K4 too; every kernel must have
   launched;
4. each kernel against its plain PyTorch version on the card, on the
   index's own tensors (K1-K3 on one row, K4 on every row x the whole
   batch, and K4 on a small raw-kind index), equal exactly, both timed
   with CUDA events;
5. the device path's answers against the host native path's: equal counts
   and lower bounds for every (row, pattern), equal result-list lengths
   for every pattern, equal result multisets for a sample of 200;
6. serving numbers: probe p50 for the whole batch, the device probe
   against the native host probe for batches of 1-8 patterns, and the
   split of the device load into the alphabet scan, allocation, host
   copies, uploads and K1-K3;
7. one JSON line of kernels, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

It exits non-zero, printing no result, when CUDA is unavailable or when
it is run outside a checkout of the repository.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time


def log(*a):
    print(*a, flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'check failed: {msg}')


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn`` over ``reps`` runs, CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


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
    log(f'kernel build: {kernel_build_s:.2f} s')

    # ---- 2. corpus and container (host) ----
    t0 = time.perf_counter()
    corpus, _ = make_corpus(args.mb, args.seed)
    log(f'corpus: {len(corpus)} bytes in {time.perf_counter() - t0:.1f} s')
    tmp_root = '/dev/shm' if os.path.isdir('/dev/shm') else None
    with tempfile.TemporaryDirectory(dir=tmp_root) as d:
        corpus_path = os.path.join(d, 'corpus.txt')
        idx_path = os.path.join(d, 'corpus.idx')
        with open(corpus_path, 'wb') as f:
            f.write(corpus)
        t0 = time.perf_counter()
        with pss.Writer(idx_path, max_chunk_len=args.chunk_mb << 20) as w:
            w.add_entries_from_file_lines(corpus_path)
        index_build_s = time.perf_counter() - t0
        log(f'index build (Writer, native SA-IS): {index_build_s:.2f} s, '
            f'{len(corpus) / 1e6 / index_build_s:.1f} MB/s')
        os.remove(corpus_path)
        result = run(args, corpus, idx_path, dev)
    result['kernel_build_s'] = kernel_build_s
    result['index_build_s'] = index_build_s
    result['total_s'] = time.perf_counter() - t_start
    kernel_rows = result.pop('kernels')
    log('summary: ' + json.dumps(result))
    log(json.dumps({'kernels': kernel_rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def run(args, corpus, idx_path, dev):
    """Phases 3-6 on the container at ``idx_path``; returns the numbers."""
    import numpy as np
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.container import Chunk
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host
    from pysubstringsearch_tpu_torch.ops.suffix_array import (
        build_suffix_array,
    )

    # ---- patterns: bench.py's sampler, plus deep ones ----
    rng = np.random.default_rng(1)
    nq = args.queries
    offs = rng.integers(0, len(corpus) - 16, size=nq)
    lens = rng.integers(4, 13, size=nq)
    pats = [corpus[o: o + l].replace(b'\n', b'x') for o, l in zip(offs, lens)]
    rng2 = np.random.default_rng(2)
    for o, l in zip(rng2.integers(0, len(corpus) - 256, size=200),
                    rng2.integers(23, 201, size=200)):
        pats.append(corpus[o: o + l])
    strs = [p.decode('latin-1') for p in pats]

    # ---- 3. the main path, launches counted ----
    kernels.reset_launches()
    t0 = time.perf_counter()
    r = pss.Reader(idx_path)
    check(r.wait_device_ready(), 'device index ready')
    device_ready_s = time.perf_counter() - t0
    idx = r._index
    log(f'device ready: {device_ready_s:.2f} s; rows {idx.num_chunks} x '
        f'n_pad {idx.n_pad}, kind {idx.kind}, bits {idx._bits}, seed '
        f'{idx._base}^{idx._depth}, {idx.num_limbs} limbs; device memory '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB')
    t0 = time.perf_counter()
    res = r.search_multiple(strs)
    e2e_s = time.perf_counter() - t0
    probes_before = kernels.LAUNCHES['probe_phased']
    one = r.search(strs[0])
    launches = dict(kernels.LAUNCHES)
    log(f'search_multiple({len(strs)}): {e2e_s:.3f} s, {len(res)} lines; '
        f'search(1 pattern): {len(one)} lines; launches {launches}')
    for name, count in launches.items():
        check(count > 0, f'kernel {name} launched on the main path')
    check(launches['probe_phased'] == probes_before + 1,
          'search() of one pattern probed on the device')
    check(sorted(one) == sorted(r._search_host_chunks([pats[0]])[0]),
          'search() of one pattern equals the host path')
    log('reader phases: ' + r.profiler.report().replace('\n', ' | '))
    del res

    # ---- 4. kernels against their plain versions on the card ----
    entries = []
    src = 'pysubstringsearch_tpu_torch/csrc/search_kernels.cu'

    def entry(name, replaces, err, ms, plain_ms):
        check(err == 0, f'{name} equals its plain version (max err {err})')
        entries.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
        })
        log(f'{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'max abs err {err}')

    def err(a, b):
        return int((a.long() - b.long()).abs().max()) if a.numel() else 0

    row = 0
    n0 = int(idx.lengths[row])
    text0, sa0 = idx.text[row], idx.sa[row]
    bits, depth, base, K = idx._bits, idx._depth, idx._base, idx.num_limbs
    packed = S.ranked_pack(text0, n0, idx.rank, bits)
    ref = S.ranked_pack_plain(text0, n0, idx.rank, bits)
    entry('ranked_pack', 'pysubstringsearch_tpu/ops/search.py:1166',
          err(packed, ref),
          cuda_ms(lambda: S.ranked_pack(text0, n0, idx.rank, bits,
                                        out=packed), 20),
          cuda_ms(lambda: S.ranked_pack_plain(text0, n0, idx.rank, bits), 3))
    limbs = S.ranked_limb_planes(packed, sa0, n0, depth, bits, K)
    entry('ranked_limb_planes', 'pysubstringsearch_tpu/ops/search.py:1188',
          max(err(limbs, S.ranked_limb_planes_plain(packed, sa0, n0, depth,
                                                     bits, K)),
              err(limbs, idx.limbs[row])),
          cuda_ms(lambda: S.ranked_limb_planes(packed, sa0, n0, depth, bits,
                                               K, out=limbs), 20),
          cuda_ms(lambda: S.ranked_limb_planes_plain(packed, sa0, n0, depth,
                                                     bits, K), 3))
    table = S.seed_table(packed, sa0, n0, base, depth, bits)
    entry('seed_table', 'pysubstringsearch_tpu/ops/search.py:896',
          max(err(table, S.seed_table_plain(packed, sa0, n0, base, depth,
                                            bits)),
              err(table, idx.tables[row])),
          cuda_ms(lambda: S.seed_table(packed, sa0, n0, base, depth, bits,
                                       out=table), 20),
          cuda_ms(lambda: S.seed_table_plain(packed, sa0, n0, base, depth,
                                             bits), 3))
    del packed, ref, limbs, table

    packed_np, lengths_np = S.pack_patterns(pats)
    P = torch.from_numpy(packed_np).to(dev)
    Lg = torch.from_numpy(lengths_np).to(dev)
    probe_args = (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
                  idx.rank, idx.present, P, Lg, K, base, depth, bits)
    lo_k, cnt_k = S.probe_phased(*probe_args)
    lo_p, cnt_p = S.probe_phased_plain(*probe_args)
    probe_ms = cuda_ms(lambda: S.probe_phased(*probe_args), 10)
    probe_plain_ms = cuda_ms(lambda: S.probe_phased_plain(*probe_args), 2)
    entry('probe_phased', 'pysubstringsearch_tpu/ops/search.py:1261',
          max(err(cnt_k, cnt_p), err(lo_k, lo_p)), probe_ms, probe_plain_ms)

    # K4 on a small raw-kind index (large NUL-free alphabet, raw limbs).
    rr = np.random.default_rng(3)
    raw_chunks = []
    for _ in range(2):
        body = rr.integers(1, 256, size=4 << 20, dtype=np.uint8)
        body[::61] = 0x0A
        body[-1] = 0x0A
        raw_chunks.append(Chunk(data=body,
                                suffix_array=build_suffix_array(body)))
    ridx = DeviceIndex(raw_chunks, device=dev)
    check(ridx.kind == 'raw', f'raw-kind index (got {ridx.kind})')
    rpats = [raw_chunks[i % 2].data[o: o + l].tobytes() for i, (o, l) in
             enumerate(zip(rr.integers(0, (4 << 20) - 64, size=2000),
                           rr.integers(1, 40, size=2000)))]
    rp, rl = S.pack_patterns(rpats)
    raw_args = (ridx.text, ridx.lengths, ridx.sa, ridx.tables, ridx.limbs,
                ridx.rank, ridx.present, torch.from_numpy(rp).to(dev),
                torch.from_numpy(rl).to(dev), ridx.num_limbs, ridx._base,
                ridx._depth, None)
    rlo, rcnt = S.probe_phased(*raw_args)
    rlo_p, rcnt_p = S.probe_phased_plain(*raw_args)
    raw_err = max(err(rcnt, rcnt_p), err(rlo, rlo_p))
    check(raw_err == 0, f'raw-kind probe equals plain (max err {raw_err})')
    check(int(rcnt.sum()) >= len(rpats), 'raw-kind patterns found')
    log(f'probe_phased raw kind ({ridx.num_chunks} rows x {len(rpats)}): '
        f'equal to plain, kernel '
        f'{cuda_ms(lambda: S.probe_phased(*raw_args), 10):.4f} ms, plain '
        f'{cuda_ms(lambda: S.probe_phased_plain(*raw_args), 2):.4f} ms')
    del ridx, raw_args, raw_chunks

    # ---- 5. device answers against the host native path ----
    hs = r._host_serving
    check(hs is not None, 'native host serving available')
    hp, hl = pack_patterns_host(pats)
    lo_h, cnt_h = hs.probe(hp, hl)
    lo_d, cnt_d = idx.probe(packed_np, lengths_np)
    check(np.array_equal(cnt_d, cnt_h), 'device counts equal host counts')
    hit = cnt_h > 0
    check(np.array_equal(lo_d[hit], lo_h[hit]), 'lower bounds equal')
    log(f'counts equal for all {cnt_h.size} (row, pattern) pairs, '
        f'{int(cnt_h.sum())} suffix hits')
    dev_lists = r._search_batch(pats)
    host_lists = r._search_host_chunks(pats)
    check([len(x) for x in dev_lists] == [len(x) for x in host_lists],
          'per-pattern result lengths equal the host path')
    sample = np.random.default_rng(4).choice(len(pats), 200, replace=False)
    for i in sample:
        check(sorted(dev_lists[i]) == sorted(host_lists[i]),
              f'result multiset of pattern {i}')
    del dev_lists, host_lists
    log('result lengths equal for every pattern; multisets equal for a '
        'sample of 200')

    # ---- 6. serving numbers ----
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        idx.probe(packed_np, lengths_np)
        ts.append(time.perf_counter() - t0)
    probe_p50_ms = sorted(ts)[len(ts) // 2] * 1e3
    log(f'probe p50 ({len(pats)} patterns, host arrays in and out): '
        f'{probe_p50_ms:.3f} ms')

    # Small batches: the device probe (patterns up, one K4 launch, bounds
    # down) against the native host bisection over every container chunk.
    small = {}
    for b in (1, 2, 4, 8):
        sp, sl = S.pack_patterns(pats[:b])
        hp, hl = pack_patterns_host(pats[:b])
        small[b] = (p50_ms(lambda: idx.probe(sp, sl)),
                    p50_ms(lambda: hs.probe(hp, hl)))
        log(f'probe of {b} pattern(s), p50 of 51: device {small[b][0]:.4f} '
            f'ms, native host {small[b][1]:.4f} ms')
    one_dev = p50_ms(lambda: r._search_batch([pats[1]]))
    one_host = p50_ms(lambda: r._search_host_chunks([pats[1]]))
    log(f'search of 1 pattern end to end, p50 of 51: device route '
        f'{one_dev:.4f} ms, host route {one_host:.4f} ms')

    tot = r.profiler.totals
    up_bytes = sum(5 * int(n) for n in idx.lengths.tolist())
    h2d_mbps = up_bytes / 1e6 / tot['index-h2d']
    split = ('index-alphabet', 'index-alloc', 'index-host-copy', 'index-h2d',
             'index-aux')
    rest_s = tot['device-load'] - sum(tot[k] for k in split)
    log(f'device load split: alphabet scan {tot["index-alphabet"]:.3f} s, '
        f'allocation {tot["index-alloc"]:.3f} s, host copy '
        f'{tot["index-host-copy"]:.3f} s, H2D {tot["index-h2d"]:.3f} s '
        f'({h2d_mbps:.0f} MB/s pageable), K1-K3 {tot["index-aux"]:.3f} s, '
        f'outside these {rest_s:.3f} s, of device-load '
        f'{tot["device-load"]:.3f} s')
    return {
        'kernels': entries, 'device_ready_s': device_ready_s,
        'device_load_s': tot['device-load'],
        'index_alphabet_s': tot['index-alphabet'],
        'index_alloc_s': tot['index-alloc'],
        'index_rest_s': rest_s,
        'index_host_copy_s': tot['index-host-copy'],
        'index_h2d_s': tot['index-h2d'], 'index_h2d_mbps': h2d_mbps,
        'index_aux_s': tot['index-aux'],
        'search_multiple_s': e2e_s, 'probe_p50_ms': probe_p50_ms,
        'probe_kernel_ms': probe_ms,
        'small_probe_ms': {b: {'device': d, 'host': h}
                           for b, (d, h) in small.items()},
        'search_1_ms': {'device': one_dev, 'host': one_host},
        'rows': idx.num_chunks, 'patterns': len(pats), 'mb': args.mb,
        'device_mem_gib': torch.cuda.max_memory_allocated() / 2**30,
    }


if __name__ == '__main__':
    sys.exit(main())
