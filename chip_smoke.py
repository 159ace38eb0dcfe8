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
   ``Reader(path)`` derives its index on the card over merged rows (text
   up, SA by B1 and B2, limbs and tables by K1-K3), ``wait_device_ready()``
   must be True, ``search_multiple`` answers the 10k-pattern batch of
   ``bench.py`` plus 200 patterns of 23-200 bytes (K4, then B8 on every
   merged row), and ``search`` answers one pattern, which must launch K4
   and B8 again; every kernel of the path must have launched;
4. each kernel against its plain PyTorch version on the card, on the
   index's own tensors, equal exactly, both timed with CUDA events: K1-K3
   and B1 and one B2 round on row 0, K4 and B8 on every row x the whole
   batch, the whole ``derive_sa`` of every row (and row 0's SA against the
   host's native SA-IS), and K4 on a small raw-kind index;
5. the device path's answers against the host native path's: per-pattern
   counts summed over rows and chunks, result-list lengths for every
   pattern, result multisets for a sample of 200, and one pattern across
   every container chunk boundary (which a merged row must not match);
6. serving numbers: probe p50 for the whole batch, the device probe
   against the native host probe for batches of 1-8 patterns, one timing
   of ``HostServing.search`` on the whole batch, the split of the device
   load, and where row 0's line extraction goes;
7. the upload path (``Reader(path, index_mode='upload')``) after the derive
   Reader is freed: launch counts from 0, K1-K4 against their plain
   versions, counts against the host, and the same serving numbers;
8. one JSON line of kernels, the card's name and power limit, and the
   result line ``{"ok": true, "device": {...}}`` last.

It exits non-zero, printing no result, when CUDA is unavailable or when
it is run outside a checkout of the repository.
"""

import argparse
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

SEARCH_SRC = 'pysubstringsearch_tpu_torch/csrc/search_kernels.cu'
SA_SRC = 'pysubstringsearch_tpu_torch/csrc/suffix_array_kernels.cu'
JAX_SEARCH = 'pysubstringsearch_tpu/ops/search.py'
JAX_SA = 'pysubstringsearch_tpu/ops/suffix_array.py'


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


def err(a, b):
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


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
    log(f'kernel build (every csrc/*.cu in parallel, then one link): '
        f'{kernel_build_s:.2f} s')

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
        pats = sample_patterns(corpus, args.queries)
        del corpus
        result = {'derive': run_derive(idx_path, pats, dev)}
        gc.collect()
        torch.cuda.empty_cache()
        result['upload'] = run_upload(idx_path, pats, dev)
    result['kernel_build_s'] = kernel_build_s
    result['index_build_s'] = index_build_s
    result['total_s'] = time.perf_counter() - t_start
    kernel_rows = result['derive'].pop('kernels')
    log('summary: ' + json.dumps(result))
    log(json.dumps({'kernels': kernel_rows}))
    log(card)
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


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


def check_answers(r, idx, pats, packed_np, lengths_np):
    """The device path's answers against the host native path's."""
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
    dev_lists = r._search_batch(pats)
    host_lists = r._search_host_chunks(pats)
    check([len(x) for x in dev_lists] == [len(x) for x in host_lists],
          'per-pattern result lengths equal the host path')
    sample = np.random.default_rng(4).choice(len(pats), 200, replace=False)
    for i in sample:
        check(sorted(dev_lists[i]) == sorted(host_lists[i]),
              f'result multiset of pattern {i}')
    log('result lengths equal for every pattern; multisets equal for a '
        'sample of 200')


def serving_numbers(r, idx, pats, packed_np, lengths_np):
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host

    hs = r._host_serving
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        idx.probe(packed_np, lengths_np)
        ts.append(time.perf_counter() - t0)
    probe_p50_ms = sorted(ts)[len(ts) // 2] * 1e3
    log(f'probe p50 ({len(pats)} patterns, host arrays in and out): '
        f'{probe_p50_ms:.3f} ms')
    small = {}
    for b in (1, 2, 4, 8):
        sp, sl = S.pack_patterns(pats[:b])
        hp, hl = pack_patterns_host(pats[:b])
        small[b] = {'device': p50_ms(lambda: idx.probe(sp, sl)),
                    'host': p50_ms(lambda: hs.probe(hp, hl))}
        log(f'probe of {b} pattern(s), p50 of 51: device '
            f'{small[b]["device"]:.4f} ms, native host '
            f'{small[b]["host"]:.4f} ms')
    one_dev = p50_ms(lambda: r._search_batch([pats[1]]))
    one_host = p50_ms(lambda: r._search_host_chunks([pats[1]]))
    log(f'search of 1 pattern end to end, p50 of 51: device route '
        f'{one_dev:.4f} ms, host route {one_host:.4f} ms')
    t0 = time.perf_counter()
    lists = hs.search(pats)
    host_search_s = time.perf_counter() - t0
    log(f'HostServing.search({len(pats)}) on the host, one run: '
        f'{host_search_s:.3f} s, {sum(map(len, lists))} lines')
    return {'probe_p50_ms': probe_p50_ms, 'small_probe_ms': small,
            'search_1_ms': {'device': one_dev, 'host': one_host},
            'host_search_s': host_search_s}


def main_path(r, strs, pats, prof_keys):
    """search_multiple of the batch and search of one pattern; returns
    (launch counts, e2e seconds, phase seconds of the search_multiple)."""
    from pysubstringsearch_tpu_torch.ops import kernels

    before = dict(r.profiler.totals)
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
    check(launches['probe_phased'] == after['probe_phased'] + 1,
          'search() of one pattern probed on the device')
    check(sorted(one) == sorted(r._search_host_chunks([pats[0]])[0]),
          'search() of one pattern equals the host path')
    log('phases of search_multiple: ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in phases.items()))
    return after, launches, e2e_s, phases, len(res)


def aux_kernels(idx, row, entry):
    """K1-K3 against their plain versions on one row of the index."""
    from pysubstringsearch_tpu_torch.ops import search as S

    n0 = int(idx.lengths[row])
    text0, sa0 = idx.text[row], idx.sa[row]
    bits, depth, base, K = idx._bits, idx._depth, idx._base, idx.num_limbs
    packed = S.ranked_pack(text0, n0, idx.rank, bits)
    ref = S.ranked_pack_plain(text0, n0, idx.rank, bits)
    entry('ranked_pack', f'{JAX_SEARCH}:1166', SEARCH_SRC, err(packed, ref),
          cuda_ms(lambda: S.ranked_pack(text0, n0, idx.rank, bits,
                                        out=packed), 20),
          cuda_ms(lambda: S.ranked_pack_plain(text0, n0, idx.rank, bits), 3))
    limbs = S.ranked_limb_planes(packed, sa0, n0, depth, bits, K)
    entry('ranked_limb_planes', f'{JAX_SEARCH}:1188', SEARCH_SRC,
          max(err(limbs, S.ranked_limb_planes_plain(packed, sa0, n0, depth,
                                                     bits, K)),
              err(limbs, idx.limbs[row])),
          cuda_ms(lambda: S.ranked_limb_planes(packed, sa0, n0, depth, bits,
                                               K, out=limbs), 20),
          cuda_ms(lambda: S.ranked_limb_planes_plain(packed, sa0, n0, depth,
                                                     bits, K), 3))
    table = S.seed_table(packed, sa0, n0, base, depth, bits)
    entry('seed_table', f'{JAX_SEARCH}:896', SEARCH_SRC,
          max(err(table, S.seed_table_plain(packed, sa0, n0, base, depth,
                                            bits)),
              err(table, idx.tables[row])),
          cuda_ms(lambda: S.seed_table(packed, sa0, n0, base, depth, bits,
                                       out=table), 20),
          cuda_ms(lambda: S.seed_table_plain(packed, sa0, n0, base, depth,
                                             bits), 3))


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
          cuda_ms(lambda: S.probe_phased_plain(*probe_args), 2))
    return lo_k, cnt_k


def raw_kind_probe(dev):
    """K4 on a small raw-kind index (large NUL-free alphabet, raw limbs)."""
    import numpy as np
    import torch

    from pysubstringsearch_tpu_torch.container import Chunk
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.suffix_array import (
        build_suffix_array,
    )

    rr = np.random.default_rng(3)
    raw_chunks = []
    for _ in range(2):
        body = rr.integers(1, 256, size=4 << 20, dtype=np.uint8)
        body[::61] = 0x0A
        body[-1] = 0x0A
        raw_chunks.append(Chunk(data=body,
                                suffix_array=build_suffix_array(body)))
    ridx = DeviceIndex(raw_chunks, device=dev)
    check(ridx.kind == 'raw' and ridx.mode == 'upload',
          f'raw-kind upload index (got {ridx.kind}, {ridx.mode})')
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


def lines_breakdown(idx, lo_k, cnt_k):
    """Where row 0's share of ``x-dev-lines`` goes, on a fresh LineTable
    (so its lazy line-id table is not built mid-measurement): the
    newline bisection of the hits in SA order and in sorted order, the
    dedup of the whole span step, the str materialisation, and the
    per-call fixed cost of a one-hit batch."""
    import numpy as np

    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.extract import LineTable

    pos_d, qid_d = S.gather_hits_flat(idx.sa[0], lo_k[0].contiguous(),
                                      cnt_k[0].contiguous())
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
    log(f'row 0 line extraction ({pos.size} hits, {table.num_lines} lines): '
        + ', '.join(f'{k} {v:.3f}' for k, v in out.items()))
    return out


def run_derive(idx_path, pats, dev):
    """Phases 3-6 on the derive main path; returns its numbers."""
    import numpy as np
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops import suffix_array as SA
    from pysubstringsearch_tpu_torch.ops.hostserve import pack_patterns_host
    from pysubstringsearch_tpu_torch.ops.native import suffix_array_native

    strs = [p.decode('latin-1') for p in pats]

    # ---- 3. the main path, launches counted ----
    kernels.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = pss.Reader(idx_path)
    check(r.wait_device_ready(), 'device index ready')
    device_ready_s = time.perf_counter() - t0
    load_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    idx = r._index
    check(idx.mode == 'derive' and idx.merged,
          f'derive index over merged rows (mode {idx.mode})')
    rows = [{'chunks': len(g), 'n': int(d.size), 'rounds': len(t),
             'ties': t}
            for g, d, t in zip(idx.groups, idx.row_data, idx.sa_ties)]
    log(f'device ready: {device_ready_s:.2f} s; {idx.num_chunks} merged '
        f'rows x n_pad {idx.n_pad} from {len(r._chunks)} chunks, chunks per '
        f'row {[x["chunks"] for x in rows]}, row bytes '
        f'{[x["n"] for x in rows]}; kind {idx.kind}, bits {idx._bits}, '
        f'seed {idx._base}^{idx._depth}, {idx.num_limbs} limbs; device '
        f'memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB resident, '
        f'{load_peak_gib:.2f} GiB peak during the load')
    for i, x in enumerate(rows):
        log(f'row {i}: {x["rounds"]} B2 rounds, tie counts m {x["ties"]}')
    after_multi, launches, e2e_s, phases, lines = main_path(
        r, strs, pats, ('probe', 'extract', 'x-dev-gather', 'x-dev-lines',
                        'line-tables'))
    for name in PATH_KERNELS:
        check(after_multi[name] > 0,
              f'kernel {name} launched by search_multiple on the main path')
    check(launches['gather_hits_flat'] > after_multi['gather_hits_flat'],
          'search() of one pattern gathered its hits on the device')
    log('reader phases: ' + r.profiler.report().replace('\n', ' | '))
    tot = r.profiler.totals
    split = ('index-alphabet', 'index-merge', 'index-alloc', 'index-h2d',
             'index-sa', 'index-aux')
    load_split = {k: tot[k] for k in split}
    load_split['outside'] = tot['device-load'] - sum(load_split.values())
    log('derive load split: ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in load_split.items())
        + f', of device-load {tot["device-load"]:.3f} s')

    # ---- 4. kernels against their plain versions on the card ----
    entries = []

    def entry(name, replaces, src, e, ms, plain_ms):
        check(e == 0, f'{name} equals its plain version (max err {e})')
        entries.append({
            'name': name, 'route': 'cuda', 'source': src,
            'replaces': replaces, 'launches': launches[name],
            'max_abs_err': e, 'ms': ms, 'plain_ms': plain_ms,
        })
        log(f'{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, '
            f'max abs err {e}')

    aux_kernels(idx, 0, entry)
    packed_np, lengths_np = S.pack_patterns(pats)
    lo_k, cnt_k = probe_kernel(idx, packed_np, lengths_np, entry)

    bits = idx._bits
    k0 = 2 * (30 // bits)
    n0 = int(idx.row_data[0].size)
    text0 = idx.text[0]
    init = SA.sa_init_ranked(text0, n0, idx.rank, bits)
    plain = SA.sa_init_ranked_plain(text0, n0, idx.rank, bits)
    entry('sa_init_ranked', f'{JAX_SA}:330', SA_SRC,
          max(err(a, b) for a, b in zip(init, plain)),
          cuda_ms(lambda: SA.sa_init_ranked(text0, n0, idx.rank, bits), 3),
          cuda_ms(lambda: SA.sa_init_ranked_plain(text0, n0, idx.rank, bits),
                  1))
    del plain
    state = [t.clone() for t in init]
    pstate = [t.clone() for t in init]
    m = SA.sa_refine_round(*state, k0)
    pm = SA.sa_refine_round_plain(*pstate, k0)
    check(m == pm == idx.sa_ties[0][0], f'round-1 tie counts {m} {pm}')
    round_err = max(err(a, b) for a, b in zip(state, pstate))
    del pstate

    def restore():
        for s, t in zip(state, init):
            s.copy_(t)

    entry('sa_refine_round', f'{JAX_SA}:394', SA_SRC, round_err,
          cuda_ms(lambda: SA.sa_refine_round(*state, k0), 3, restore),
          cuda_ms(lambda: SA.sa_refine_round_plain(*state, k0), 1, restore))
    del state, init
    torch.cuda.empty_cache()

    derive_rows = []
    for i, d in enumerate(idx.row_data):
        n = int(d.size)
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (sa_k, ties_k), k_s = wall_s(
            lambda: SA.derive_sa(idx.text[i], n, idx.rank, bits))
        peak = torch.cuda.max_memory_allocated() - base
        (sa_p, ties_p), p_s = wall_s(
            lambda: SA.derive_sa_plain(idx.text[i], n, idx.rank, bits))
        e = max(err(sa_k, sa_p), err(sa_k, idx.sa[i]))
        check(e == 0 and ties_k == ties_p == idx.sa_ties[i],
              f'derive_sa of row {i} equals its plain version and the index')
        derive_rows.append({'n': n, 'kernel_s': k_s, 'plain_s': p_s,
                            'peak_gib': peak / 2**30, 'ties': ties_k})
        log(f'derive_sa row {i} ({n} bytes, n_pad {idx.n_pad}): kernels '
            f'{k_s:.3f} s, plain {p_s:.3f} s, equal; SA-build peak '
            f'{peak / 2**30:.2f} GiB above the resident index')
        del sa_k, sa_p
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    native0 = suffix_array_native(idx.row_data[0])
    native_s = time.perf_counter() - t0
    check(np.array_equal(idx.sa[0, :n0].cpu().numpy(), native0),
          "row 0's derived SA equals the host's native SA-IS")
    log(f"row 0's derived SA equals native SA-IS on the host "
        f'({native_s:.2f} s for {n0} bytes)')
    del native0

    gather = []
    for i in range(idx.num_chunks):
        sa_i = idx.sa[i]
        lo_i, cnt_i = lo_k[i].contiguous(), cnt_k[i].contiguous()
        pos_k, qid_k = S.gather_hits_flat(sa_i, lo_i, cnt_i)
        pos_p, qid_p = S.gather_hits_flat_plain(sa_i, lo_i, cnt_i)
        check(pos_k.shape[0] == int(cnt_i.long().sum()), 'B8 total')
        gather.append((max(err(pos_k, pos_p), err(qid_k, qid_p)),
                       cuda_ms(lambda: S.gather_hits_flat(sa_i, lo_i, cnt_i),
                               5),
                       cuda_ms(lambda: S.gather_hits_flat_plain(sa_i, lo_i,
                                                                cnt_i), 2),
                       int(pos_k.shape[0])))
        del pos_k, qid_k, pos_p, qid_p
    log('gather_hits_flat per row (hits, kernel ms, plain ms): '
        + ', '.join(f'{g[3]} {g[1]:.4f} {g[2]:.4f}' for g in gather))
    entry('gather_hits_flat', f'{JAX_SEARCH}:1625', SEARCH_SRC,
          max(g[0] for g in gather), sum(g[1] for g in gather),
          sum(g[2] for g in gather))
    raw_kind_probe(dev)

    # ---- 5. device answers against the host native path ----
    check_answers(r, idx, pats, packed_np, lengths_np)
    hs = r._host_serving
    chunks = r._chunks
    bpats = [chunks[c].data[-6:].tobytes() + chunks[c + 1].data[:6].tobytes()
             for c in range(len(chunks) - 1)]
    bp, bl = S.pack_patterns(bpats)
    crossings = idx.boundary_crossings(bp, bl)
    check(int(crossings.sum()) > 0, 'boundary patterns cross merged rows')
    check(np.array_equal(idx.count_matches(bp, bl).sum(0),
                         hs.probe(*pack_patterns_host(bpats))[1].sum(0)),
          'boundary patterns: counts equal the host')
    dev_b = r._search_batch(bpats)
    host_b = r._search_host_chunks(bpats)
    check([sorted(x) for x in dev_b] == [sorted(x) for x in host_b],
          'boundary patterns: results equal the host path')
    log(f'{len(bpats)} chunk-boundary patterns: {int(crossings.sum())} '
        f'crossing occurrences dropped, results equal the host path')

    # ---- 6. serving numbers ----
    numbers = serving_numbers(r, idx, pats, packed_np, lengths_np)
    numbers['lines_row0_s'] = lines_breakdown(idx, lo_k, cnt_k)
    return {
        'kernels': entries, 'device_ready_s': device_ready_s,
        'load_split_s': load_split, 'load_peak_gib': load_peak_gib,
        'search_multiple_s': e2e_s, 'search_multiple_phases_s': phases,
        'lines': lines, 'rows': rows, 'n_pad': idx.n_pad,
        'derive_rows': derive_rows, 'native_sais_row0_s': native_s,
        'resident_gib': torch.cuda.memory_allocated() / 2**30,
        'seed': [idx._base, idx._depth], 'num_limbs': idx.num_limbs,
        **numbers,
    }


def run_upload(idx_path, pats, dev):
    """Phase 7: the upload path on the same container."""
    import torch

    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.ops import search as S

    strs = [p.decode('latin-1') for p in pats]
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
    after_multi, launches, e2e_s, phases, lines = main_path(
        r, strs, pats, ('probe', 'extract', 'hs-spans', 'hs-fanout'))
    for name in UPLOAD_KERNELS:
        check(after_multi[name] > 0, f'upload path launched {name}')

    def entry(name, replaces, src, e, ms, plain_ms):
        check(e == 0, f'upload {name} equals its plain version ({e})')
        log(f'upload {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms')

    aux_kernels(idx, 0, entry)
    packed_np, lengths_np = S.pack_patterns(pats)
    probe_kernel(idx, packed_np, lengths_np, entry)
    check_answers(r, idx, pats, packed_np, lengths_np)
    numbers = serving_numbers(r, idx, pats, packed_np, lengths_np)
    tot = r.profiler.totals
    split = ('index-alphabet', 'index-alloc', 'index-host-copy', 'index-h2d',
             'index-aux')
    load_split = {k: tot[k] for k in split}
    load_split['outside'] = tot['device-load'] - sum(load_split.values())
    log('upload load split: ' + ', '.join(
        f'{k} {v:.3f} s' for k, v in load_split.items())
        + f', of device-load {tot["device-load"]:.3f} s')
    return {'device_ready_s': device_ready_s, 'load_split_s': load_split,
            'search_multiple_s': e2e_s, 'search_multiple_phases_s': phases,
            'lines': lines, 'launches': launches,
            'resident_gib': torch.cuda.memory_allocated() / 2**30,
            **numbers}


if __name__ == '__main__':
    sys.exit(main())
