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
  what was resident; ``b10_init_peak_gib`` and ``b10_passes_peak_gib``
  split that peak between the init and the passes after it, each above
  the same base), B1b + B2 on the same row (wall, peak) and B2's round
  1 after B1b (k = 6) from a copy of B1b's state.

With ``--inits`` it also times the anchored inits on the rows
``chip_smoke.py`` derives (cached beside ``--corpus``): B1 on the first
268,400,000 bytes of ``bench.make_corpus(500)`` padded to 272 Mi slots,
B1b on as many bytes of ``make_raw_corpus(500)`` (272 Mi) and of
``make_digit_corpus(500)`` (256 Mi), and B1b on the digit corpus's first
8,388,563 bytes, the size of the digit Writer's first 8 MiB chunk, padded
as the Writer pads it (8 Mi slots), each beside one stable ``torch.sort``
of its keys.  On the ranked and digit rows it then derives the SA and
times K3 (``k3_ranked``: the 32^5 + 1 table from the ranked pack;
``k3_digit``: the 258^3 + 1 table from K7's values) beside one
``torch.searchsorted`` of every entry into the keys in SA order, gathered
beforehand (``_searchsorted_ms``) and with the gather timed too
(``_gather_searchsorted_ms``).  Then B9 on that digit chunk
(``b9_digit_chunk``) and on the ranked corpus's first 8,388,563 bytes at
the Writer's padding, 8 Mi (``b9_ranked_chunk``), and at the scale-out
rows', 16 Mi (``b9_ranked_chunk16``): its init and its round at k = 6 from
the init's state, each beside one stable ``torch.sort`` of its keys, and
the whole build (``sa_full_doubling``: wall seconds, the mean of ``REPS``
runs after a warm-up, and its rounds); and the whole B9 build of 400 MiB
of ``ab`` at 416 Mi slots, the row B10 poisons (``b9_ab_build_s``, one run
after a warm-up, and ``b9_ab_rounds``).

With ``--gathers`` it times the SA-order gathers on the same derive rows
(``GATHER_ROWS``, their SA derived on the card): K2 (``k2_ranked``, 3
planes), K6 (``k6_raw``, 3 planes) and B12d's limb planes
(``b12d_digit``, 5 planes), each a whole call (``_ms``) beside one
``torch.take`` of the same planes from the pack the JAX program gathers
(K1's, K5's, or K7's depth-3 base-258 values; indices made beforehand,
``_take_ms``) and that pack's own pass (``_pack_ms``); and B13 on the
ranked corpus's first 268,434,495 bytes (``b13_ms``) beside
``text[(sa - 1) % n]`` (``b13_library_ms``) and one ``torch.take`` at
indices made beforehand (``b13_take_ms``).  Beside each: the roofline
bound (``_bound_ms``: inputs read once, outputs written once at 3.35
TB/s) and the sector floor, the 32-byte sectors that these inputs'
scattered reads touch, summed over slots, over 3.35 TB/s: the limb
planes' for the text windows (``_sector_count_text``,
``_sector_floor_text_ms``) and for the pack's K words
(``_sector_count_pack``, ``_sector_floor_pack_ms``), B13's one a slot.
The same counted in 64-byte DRAM accesses, the unit a scattered read
that misses the L2 costs on the card (``_access_count_*``,
``_access_floor_*``), and the rate of them the timed call reached on its
own route (``_access_tbs``, TB/s).  A tree whose limb-plane wrappers take
the pack (``packed`` first) is timed on the pack, made beforehand (the
digit planes on K7's values, as its index builds them at depth 3).

With ``--packs`` it times the streaming packs on ``PACK_ROWS``: K1
(``k1_ranked``, bits 5 on the ranked 272 Mi row), K7 (``k7_raw`` at the
raw row's 128^3 table, 272 Mi; ``k7_digit`` at 258^3 with
``identity_rank()``, 256 Mi) and K5 (``k5_raw``, the raw pack on the raw
row, held against its plain version), and the same on one upload chunk
of each kind (8,388,563 bytes in a row of 16 Mi slots, ``_chunk``; the
digit chunk at 258^2, the depth its upload index picks), each beside its
bound
(``_bound_ms``: the n text bytes read and 4 bytes written a position of
the row, at 3.35 TB/s; no byte at or past n is needed) and
``text.to(torch.int32)`` of the same row (``_to_int32_ms``), a copy that
moves 5 bytes a position of the row: the card's streaming rate, not a
library call of the same function.  It uses only entry points that older
trees have too.

With ``--probe-bounds`` it recounts the probes' bounds at ``chip_smoke.py``'s
batches (about three minutes, most of it the three Writers): K4 on the
ranked derive index (``k4``), on the raw derive index (``k4_raw``) and on
the ranked container's 63 chunks in the upload geometry (``k4_upload``),
B15 on those chunks as rows and B11 on the digit derive index with the
line batch (``b11``) and the count batch (``b11_count``).  The plain
bisection runs on the card with each step recorded (``_SectorRecorder``),
and the distinct 32-byte sectors its steps read over the whole batch
(``_sectors``), with the patterns, lengths and bounds, over 3.35 TB/s make
the bound (``_bound_ms``; the patterns, lengths and bounds alone are
``_pattern_bound_ms``).  The recording replaces helpers of ``ops.search``
for the run and raises where the plain probes no longer bisect through
them as it expects.  Over the recorded byte-compare steps it also counts
the load instructions a byte loop (``_byte_loop_loads``: the SA word, a
pattern byte and a text byte for every byte compared) and a 16-byte
compare (``_chunk16_loads``: the SA word and the aligned 16-byte text
chunks of the same bytes) issue.

With ``--probes`` it first (before anything else, so that its profiler
session is the process's first) times the probes on the same indexes and
batches (``_probes``): K4 on the ranked derive batch (``k4``) and on its
patterns up to the key cover and past it (``k4_short``, ``k4_deep``), on
the raw derive index (``k4_raw``) and in the upload geometry with that
batch and with the 1200 patterns ``search_multiple`` probes there
(``k4_upload``, ``k4_upload_line``), B15's probe on the 63 chunk rows
and B11 on the line and count batches, each held against its plain
version, as a whole call (``_ms``), back to back (``_back_to_back_ms``)
and, with ``--profile``, by device time (``_device_us``); then ptxas's
registers, stack and spills of the probe kernels of ROOT's source
(``ptxas``).  The three containers are
written once beside ``--corpus`` and read by later runs of any tree.
``--no-base`` skips the default measurements above.

With ``--giant`` it first (before anything else, so that its profiler
session is the process's first) builds the suffix array of ``--corpus``
as one row of 512 Mi slots with ``make_giant_chunk_build`` (B14g) over 4
placements of the card: one build by device time a kernel and a step
(``giant_build_by_kernel_us``, ``giant_build_by_step_us``, the card's
busy span), the pairs each sort took (``giant_sorted``), its untraced
wall (``giant_build_s``), and its kernels at that row's shapes (B = 128
Mi), each by device time and as a whole call beside its bound: the keys,
the cuts beside ``torch.searchsorted``, the flags and the relabel on B9's
state at k = 6 (a tree before the relabel: the flags and the max scan
beside ``torch.cummax`` on the final ranks), the partition at 4, 64 and
256 owners and the merge of one shard's received runs at 4, 64 and 256
sources beside ``radix_sort_pairs`` and ``torch.sort`` of the same runs
(see ``_giant``).

With ``--roll`` it times the derived SA's roll (R, ``sa_roll_front``: a
pad-first SA of N slots rolled by n - N into a row of the index) on the
ranked derive index's row 0 (n 268,434,495 in 272 Mi slots, ``roll_272``)
and on the big row (n 524,288,061 in 512 Mi slots, ``roll_512``), and at
the other three shifts mod 4 at 272 Mi (``roll_272_shift<s>``), each a
whole call into a preallocated row (``_ms``) beside its bound
(``_bound_ms``: 4 bytes read and 4 written a slot at 3.35 TB/s), its plain
version (``_plain_ms``) and ``torch.roll`` into a fresh tensor
(``_torch_roll_ms``), the kernel's output equal to ``torch.roll``'s.

With ``--profile`` it first prints the device time by kernel
(``torch.profiler``'s ``key_averages``) of B10's init, of that first pass,
of B1b and of B2's round 1 on the 512 Mi row (and, with ``--inits``, of
each init row, each K3 table and B9's init and round; with ``--gathers``,
each gather; with ``--packs``, each pack), one ``PROFILE``
line each, the group sizes of round 1's tied groups (``HISTOGRAM``: groups
and slots of 2, 3-16, 17-256, 257-4096 and more members) and, with
``--inits``, each init row's buckets by the top 16, 24 and 32 bits of its
keys (``BUCKETS``: buckets and slots of 1, 2-32, 33-4096 and more
members).  Without a CUDA card it prints nothing to stdout and exits 2.
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


#: The init rows: (label, corpus maker in chip_smoke.py, bytes, slots).
INIT_ROWS = (('b1 ranked', 'ranked', 268_400_000, 272 << 20),
             ('b1b raw', 'raw', 268_400_000, 272 << 20),
             ('b1b digit', 'digit', 268_400_000, 1 << 28),
             ('b1b digit chunk', 'digit', 8_388_563, 8 << 20))


def _k3(torch, bench, out, tag, table, src, sa, n, shift, profile):
    """K3 (``table()``) beside ``torch.searchsorted`` of its entries into
    the keys ``src[sa[i]] >> shift`` of slots i < n, gathered beforehand,
    and with the gather timed too."""
    if profile:
        _profile(torch, f'k3 {tag}', table)
    out[f'k3_{tag}_ms'] = bench.cuda_ms(table, REPS)

    def gather():
        return src[sa[:n].long()].long() >> shift

    keys = gather()
    probes = torch.arange(table().shape[0], dtype=torch.int64,
                          device=src.device)
    out[f'k3_{tag}_searchsorted_ms'] = bench.cuda_ms(
        lambda: torch.searchsorted(keys, probes), REPS)
    out[f'k3_{tag}_gather_searchsorted_ms'] = bench.cuda_ms(
        lambda: torch.searchsorted(gather(), probes), REPS)


def _b9(torch, SA, kernels, bench, out, tag, text, n, profile):
    """B9's init and its round at k = 6 from the init's state, each beside
    one stable ``torch.sort`` of its keys, then the whole build (wall,
    rounds)."""
    N = text.shape[0]
    W = SA._key_width(N)
    first = SA.sa_full_init_bytes(text, n)[:2]
    state = [t.clone() for t in first]

    def restore():
        for st, t in zip(state, first):
            st.copy_(t)

    def init():
        return SA.sa_full_init_bytes(text, n)

    def round6():
        return SA.sa_full_round(*state, SA.BYTE_INIT_WIDTH, W)

    if profile:
        _profile(torch, f'b9 init {tag}', init)
        restore()
        _profile(torch, f'b9 round k6 {tag}', round6)
    out[f'b9_{tag}_init_ms'] = bench.cuda_ms(init, 10 * REPS)
    out[f'b9_{tag}_round_ms'] = bench.cuda_ms(round6, 10 * REPS, restore)
    key = SA._byte_key(text, n)
    out[f'b9_{tag}_init_sort_keys_ms'] = bench.cuda_ms(
        lambda: torch.sort(key, stable=True), REPS)
    r = first[1].long()
    key = (r << W) | SA._shifted(r + 1, SA.BYTE_INIT_WIDTH)
    out[f'b9_{tag}_round_sort_keys_ms'] = bench.cuda_ms(
        lambda: torch.sort(key, stable=True), REPS)
    del key, r, first, state
    SA.sa_full_doubling(text, n)  # warm-up: scratch sizes cached
    before = kernels.LAUNCHES['sa_full_round']
    total = 0.0
    for _ in range(REPS):
        total += _wall_s(torch, lambda: SA.sa_full_doubling(text, n))[1]
    out[f'b9_{tag}_build_s'] = total / REPS
    out[f'b9_{tag}_rounds'] = (kernels.LAUNCHES['sa_full_round'] -
                               before) // REPS


def _smoke():
    """This checkout's ``chip_smoke.py`` as a module (its corpus makers)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', os.path.join(root, 'chip_smoke.py'))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def _row(torch, np, smoke, args, cache, kind, nbytes, N):
    """(bytes, uint8 [N] text on the card) of the first ``nbytes`` of the
    ``kind`` corpus, zero-padded; the corpora are cached beside
    ``--corpus`` and in ``cache``."""
    if kind not in cache:
        path = os.path.join(os.path.dirname(args.corpus),
                            f'sa_bench_{kind}.npy')
        if kind == 'ranked':
            path = args.corpus
        if not os.path.exists(path):
            make = {'raw': smoke.make_raw_corpus,
                    'digit': smoke.make_digit_corpus}[kind]
            np.save(path, np.frombuffer(make(500), np.uint8))
        cache[kind] = np.load(path, mmap_mode='r')
    data = np.asarray(cache[kind][:nbytes])
    text = torch.zeros(N, dtype=torch.uint8, device='cuda')
    text[:nbytes] = torch.from_numpy(data).to('cuda')
    return data, text


#: The limb-plane rows: (tag, corpus, bytes, slots), as ``INIT_ROWS``.
GATHER_ROWS = (('k2_ranked', 'ranked', 268_400_000, 272 << 20),
               ('k6_raw', 'raw', 268_400_000, 272 << 20),
               ('b12d_digit', 'digit', 268_400_000, 1 << 28))
#: B13's row: the ranked corpus's first bytes as the ranked derive index's
#: row 0 holds them, in a row of 272 Mi slots.
B13_BYTES = 268_434_495
#: Bytes of a sector, of a DRAM access on the card (two sectors: the
#: access a scattered read that misses the L2 costs), and the card's
#: memory rate (bytes/s).
SECTOR = 32
DRAM_ACCESS = 64
HBM_BYTES_PER_S = 3.35e12


def _floor_ms(nbytes):
    return nbytes / HBM_BYTES_PER_S * 1e3


def _window_sectors(torch, base, sa, n, off, width, unit=SECTOR):
    """``unit``-byte blocks a slot's scattered reads of ``width`` bytes
    from byte address ``base + clip(sa[i]) + off`` touch, summed over
    slots i < n."""
    a = base + sa[:n].long() + off
    return int(((a + width - 1) // unit - a // unit + 1).sum())


def _pack_sectors(torch, base, sa, n, N, off, D, K, unit=SECTOR):
    """Distinct ``unit``-byte blocks of a slot's K 4-byte reads of a pack at
    byte address ``base``, positions ``min(clip(sa[i]) + off + D*j, N -
    1)``, summed over slots i < n (the positions never decrease in j)."""
    s = sa[:n].long().clamp(0, N - 1)
    total, prev = 0, None
    for j in range(K):
        sec = (base + 4 * (s + off + D * j).clamp(max=N - 1)) // unit
        total += n if prev is None else int((sec != prev).sum())
        prev = sec
    return total


def _gathers(torch, np, SA, S, bench, args, out):
    """The SA-order gathers: K2, K6 and B12d's limb planes on the derive
    rows and B13 on the ranked row, each a whole call beside the library
    call and the sector floor of its scattered reads (for the limb planes
    of both routes: the text windows the kernel reads now, and the pack's
    K words the JAX program gathers); with ``--profile`` each by kernel.
    Either tree's entry points: a ``packed`` first argument is the pack
    route, whose pack (K1, K5, or K7 at depth 3 for the digit kind) is made
    beforehand and timed on its own."""
    import inspect

    from pysubstringsearch_tpu_torch.ops import bwt as BWT

    smoke = _smoke()
    dev = torch.device('cuda')
    cache = {}
    for tag, kind, n, N in GATHER_ROWS:
        data, text = _row(torch, np, smoke, args, cache, kind, n, N)
        pres = np.bincount(data, minlength=256)[:256] > 0
        K = S.KEY_LIMBS if kind == 'digit' else S.RAW_LIMBS
        if kind == 'ranked':
            rank_np, sigma = S.alphabet_rank(pres)
            bits = S.ranked_bits(sigma)
            rank = torch.from_numpy(rank_np).to(dev)
            sa = SA.derive_sa(text, n, rank, bits)[0]
            depth = S.pick_table_params(sigma, n)[1]
            D, off = 30 // bits, depth
            pack = lambda: S.ranked_pack(text, n, rank, bits)
            fn = S.ranked_limb_planes
            args_text = (text, sa, n, rank, depth, bits, K)
            args_pack = lambda p: (p, sa, n, depth, bits, K)
        elif kind == 'raw':
            sa = SA.derive_sa(text, n)[0]
            rank_np, sigma = S.alphabet_rank(pres)
            depth = S.pick_table_params(sigma, n)[1]
            D, off = 4, depth
            pack = lambda: S.raw_pack(text, n)
            fn = S.raw_limb_planes
            args_text = (text, sa, n, depth, K)
            args_pack = lambda p: (p, sa, n, depth, K)
        else:
            sa = SA.derive_sa(text, n)[0]
            ident = torch.from_numpy(S.identity_rank()[0]).to(dev)
            D, off = 3, 2
            pack = lambda: S.seed_prefix(text, n, ident, 258, 3)
            fn = S.digit_limb_planes
            args_text = (text, sa, n, K)
        params = list(inspect.signature(fn).parameters)
        packed = pack()
        out[f'{tag}_pack_ms'] = bench.cuda_ms(pack, REPS)
        limbs = torch.empty(K * N, dtype=torch.int32, device=dev)
        if params[0] == 'packed':
            call = lambda: fn(*args_pack(packed), out=limbs)
        elif 'prefix' in params:  # the digit planes on K7's depth-3 values
            call = lambda: fn(*args_text, out=limbs, prefix=packed)
        else:
            call = lambda: fn(*args_text, out=limbs)
        if args.profile:
            _profile(torch, tag, call)
        out[f'{tag}_ms'] = bench.cuda_ms(call, REPS)
        # torch.take of the same planes from the pack, indices made
        # beforehand: the library call beside the kernel.
        idx = (sa.long().clamp(0, N - 1)[None, :] + off
               + D * torch.arange(K, device=dev)[:, None])
        idx = idx.clamp(max=N - 1).reshape(-1)
        out[f'{tag}_take_ms'] = bench.cuda_ms(
            lambda: torch.take(packed, idx), REPS)
        del idx
        for route, base in (('text', text.data_ptr()),
                            ('pack', packed.data_ptr())):
            for unit, name in ((SECTOR, 'sector'), (DRAM_ACCESS, 'access')):
                if route == 'text':
                    c = _window_sectors(torch, base, sa, n, off, D * K, unit)
                else:
                    c = _pack_sectors(torch, base, sa, n, N, off, D, K, unit)
                out[f'{tag}_{name}_count_{route}'] = c
                out[f'{tag}_{name}_floor_{route}_ms'] = _floor_ms(unit * c)
        # The rate of 64-byte accesses the timed call reached on its route.
        route = ('pack' if params[0] == 'packed' or 'prefix' in params
                 else 'text')
        out[f'{tag}_access_tbs'] = (DRAM_ACCESS
                                    * out[f'{tag}_access_count_{route}']
                                    / out[f'{tag}_ms'] / 1e9)
        out[f'{tag}_bound_ms'] = _floor_ms(5 * N + 4 * K * N)
        del sa, packed, limbs, text
        torch.cuda.empty_cache()

    # B13 on the ranked corpus's first B13_BYTES bytes and their SA.
    n = B13_BYTES
    data, text = _row(torch, np, smoke, args, cache, 'ranked', n, 272 << 20)
    rank_np, sigma = S.alphabet_rank(
        np.bincount(data, minlength=256)[:256] > 0)
    bits = S.ranked_bits(sigma)
    sa = SA.derive_sa(text, n, torch.from_numpy(rank_np).to(dev), bits)[0]
    t0, s0 = text[:n], sa[:n]
    call = lambda: BWT.bwt_from_sa_device(t0, s0)
    if args.profile:
        _profile(torch, 'b13', call)
    out['b13_ms'] = bench.cuda_ms(call, REPS)
    out['b13_library_ms'] = bench.cuda_ms(lambda: t0[(s0 - 1) % n], REPS)
    src = (s0.long() - 1) % n
    out['b13_take_ms'] = bench.cuda_ms(lambda: torch.take(t0, src), REPS)
    out['b13_sector_count'] = n
    out['b13_sector_floor_ms'] = _floor_ms(SECTOR * n)
    out['b13_access_floor_ms'] = _floor_ms(DRAM_ACCESS * n)
    out['b13_access_tbs'] = DRAM_ACCESS * n / out['b13_ms'] / 1e9
    out['b13_bound_ms'] = _floor_ms(6 * n)
    del src, sa, s0, t0, text
    torch.cuda.empty_cache()


#: The pack rows: (tag, corpus, bytes, slots).  The derive rows K1 and K7
#: stream on the main path, and one upload chunk of each kind: the digit
#: Writer's first chunk size, padded as the upload index pads its rows.
PACK_ROWS = (('k1_ranked', 'ranked', 268_400_000, 272 << 20),
             ('k7_raw', 'raw', 268_400_000, 272 << 20),
             ('k5_raw', 'raw', 268_400_000, 272 << 20),
             ('k7_digit', 'digit', 268_400_000, 1 << 28),
             ('k1_ranked_chunk', 'ranked', 8_388_563, 16 << 20),
             ('k7_raw_chunk', 'raw', 8_388_563, 16 << 20),
             ('k7_digit_chunk', 'digit', 8_388_563, 16 << 20))


def _packs(torch, np, S, bench, args, out):
    """K1, K7 and K5 on ``PACK_ROWS`` with the parameters their index picks
    (K1 at the alphabet's bits; K7 at the raw table's base and depth, or at
    base 258 and the digit bucket depth with ``identity_rank()``; K5 has
    none), each beside its bound (the n text bytes read and 4 bytes
    written a position of the row, ``_floor_ms``) and
    ``text.to(torch.int32)`` of the same row, a copy that moves 5 bytes a
    position of the row (the card's
    streaming rate, not a library call of the same function).  With
    ``--profile`` one ``PROFILE`` line of the device time by kernel of one
    call of each, all in one profiler session (in a process that opens
    several, only the first recorded these kernels)."""
    from pysubstringsearch_tpu_torch.models.index import DeviceIndex

    smoke = _smoke()
    dev = torch.device('cuda')
    cache = {}
    calls = []
    for tag, kind, n, N in PACK_ROWS:
        data, text = _row(torch, np, smoke, args, cache, kind, n, N)
        pres = np.bincount(data, minlength=256)[:256] > 0
        dst = torch.empty(N, dtype=torch.int32, device=dev)
        if kind == 'ranked':
            rank_np, sigma = S.alphabet_rank(pres)
            bits = S.ranked_bits(sigma)
            rank = torch.from_numpy(rank_np).to(dev)
            call = (lambda text=text, n=n, rank=rank, bits=bits, dst=dst:
                    S.ranked_pack(text, n, rank, bits, out=dst))
            out[f'{tag}_bits'] = bits
        elif tag.startswith('k5'):
            call = (lambda text=text, n=n, dst=dst:
                    S.raw_pack(text, n, out=dst))
            _expect(torch.equal(call(), S.raw_pack_plain(text, n)),
                    f'{tag} equals its plain version')
        else:
            if kind == 'raw':
                rank_np, sigma = S.alphabet_rank(pres)
                base, depth = S.pick_table_params(sigma, n)
            else:
                rank_np = S.identity_rank()[0]
                base = 258
                depth = 3 if n >= DeviceIndex.DEEP_TABLE_MIN_CHUNK else 2
            rank = torch.from_numpy(rank_np).to(dev)
            call = (lambda text=text, n=n, rank=rank, base=base, depth=depth,
                    dst=dst: S.seed_prefix(text, n, rank, base, depth,
                                           out=dst))
            out[f'{tag}_table'] = f'{base}^{depth}'
        out[f'{tag}_ms'] = bench.cuda_ms(call, 10 * REPS)
        out[f'{tag}_bound_ms'] = _floor_ms(n + 4 * N)
        out[f'{tag}_to_int32_ms'] = bench.cuda_ms(
            lambda: text.to(torch.int32), 10 * REPS)
        calls.append((tag, call))
    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _, call in calls:
                call()
                torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.name,
                          e.time_range.elapsed_us()) for e in prof.events()
                         if e.device_type == DeviceType.CUDA)
        labels = ([t for t, _ in calls] if len(kernels) == len(calls)
                  else ['packs'] * len(kernels))
        for label, (_, name, us) in zip(labels, kernels):
            print('PROFILE ' + json.dumps({
                'label': label, 'device_us': us, 'by_kernel_us': [[
                    name.replace('(anonymous namespace)::', '').split('(')[0],
                    us, 1]]}), flush=True)
    del calls
    torch.cuda.empty_cache()


def _expect(ok, what):
    """Raise unless ``ok``: the sector count no longer follows the plain
    probes."""
    if not ok:
        raise RuntimeError(f'--probe-bounds: {what}')


class _SectorRecorder:
    """The 32-byte sectors the plain probes' bisection steps read, gathered
    while they run: ``ops.search._first_true`` is replaced by the same
    bisection that first hands each step's (mid, active lanes) to
    ``on_step``, ``_cmp3_rows`` (B15's compare) records its lanes' reads
    before comparing, and ``_deep_refine_plain`` routes its steps to the
    byte compare's count.  A step reads, per active lane, what the kernel's
    own step must: one limb word (K4's phase), the limbs up to the first
    that differs from the target (B11), or the SA word and the text bytes
    up to the first that differs from the pattern, none at or past n (the
    byte compare).  Sectors are byte addresses // 32 on the card, so a
    sector read by many steps or lanes counts once.

    The count rests on the plain probes calling these helpers as they do
    now, so every departure raises: ``calls`` and ``deep_calls`` count the
    bisections (``_probe_sectors`` holds them to the probe's own number),
    ``steps`` the steps handed to ``on_step`` with an active lane and
    ``window_lanes`` the lanes whose byte-compare reads were recorded.

    For the byte compares it also counts load instructions per lane and
    step: ``byte_loads``, a byte loop's (the SA word, then a pattern byte
    and, below n, a text byte for every byte compared, up to the first that
    differs), and ``chunk_loads``, a 16-byte compare's (the SA word, then
    the aligned 16-byte text chunks that hold those text bytes)."""

    def __init__(self, torch, S):
        self.torch, self.S = torch, S
        self.sectors = []
        self.active = None
        self.on_step = None
        self.calls = 0
        self.deep_calls = 0
        self.steps = 0
        self.window_lanes = 0
        self.byte_loads = 0
        self.chunk_loads = 0

    def add(self, addr):
        self.sectors.append(self.torch.unique(addr // SECTOR))

    def count(self):
        if not self.sectors:
            return 0
        return int(self.torch.unique(self.torch.cat(self.sectors)).numel())

    def first_true(self, lo, hi, pred):
        torch = self.torch
        self.calls += 1
        while True:
            active = lo < hi
            if not bool(active.any()):
                self.active = None
                return lo
            mid = torch.div(lo + hi, 2, rounding_mode='floor')
            self.active = active
            if self.on_step is not None:
                self.steps += 1
                self.on_step(mid, active)
            p = pred(mid)
            hi = torch.where(active & p, mid, hi)
            lo = torch.where(active & ~p, mid + 1, lo)

    def windows(self, text, n, sa, slots, p1, jmask, active):
        """The byte compare's reads for lanes [C, M] of rows ``text`` [C,
        N] at SA ``slots`` (clipped to [0, n - 1]): each active lane's SA
        word, and its suffix's bytes up to the first that differs from the
        pattern (``p1``, byte + 1 inside ``jmask``), below n."""
        torch = self.torch
        C, N = text.shape
        M, L = p1.shape
        dev = text.device
        n = n.long()
        c = torch.minimum(slots.clamp(min=0), (n - 1).clamp(min=0)[:, None])
        rows = torch.arange(C, device=dev)[:, None]
        self.window_lanes += int(active.sum())
        self.add((sa.data_ptr() + 4 * (rows * sa.stride(0) + c))[active])
        starts = sa.gather(1, c).long()
        pos = starts[..., None] + torch.arange(L, device=dev)
        byte = text.gather(1, pos.clamp(0, N - 1).reshape(C, -1))
        s = torch.where(pos < n[:, None, None],
                        byte.reshape(C, M, L).long() + 1, 0)
        diff = (s != p1[None]) & jmask[None]
        need = torch.where(diff.any(-1),
                           diff.to(torch.int32).argmax(-1).long() + 1,
                           jmask.sum(1)[None, :])
        read = torch.minimum(need, (n[:, None] - starts).clamp(min=0))
        a0 = text.data_ptr() + rows * text.stride(0) + starts
        sel = active & (read > 0)
        self.byte_loads += int((1 + need + read)[active].sum())
        self.chunk_loads += int(active.sum()) + int(
            ((a0 + read - 1) // 16 - a0 // 16 + 1)[sel].sum())
        first = (a0 // SECTOR)[sel]
        span = ((a0 + read - 1) // SECTOR)[sel] - first + 1
        skip = torch.repeat_interleave(torch.cumsum(span, 0) - span, span)
        self.add(SECTOR * (torch.repeat_interleave(first, span)
                           + torch.arange(skip.numel(), device=dev) - skip))

    def patch(self):
        """Context: the recording helpers in ``ops.search``."""
        import contextlib

        S = self.S
        saved = (S._first_true, S._cmp3_rows, S._deep_refine_plain)
        cmp3, deep_refine = saved[1], saved[2]

        def cmp3_rows(text, n, sa, slots, p1, jmask):
            _expect(self.active is not None,
                    '_cmp3_rows called outside a recorded bisection')
            self.windows(text, n, sa, slots, p1, jmask, self.active)
            return cmp3(text, n, sa, slots, p1, jmask)

        def deep(text, n, sa, patterns, lengths, cover, A, Z):
            torch = self.torch
            sel = torch.nonzero(lengths.long() > cover).flatten()
            if not sel.numel():
                return deep_refine(text, n, sa, patterns, lengths, cover, A,
                                   Z)
            plen = lengths.long()[sel]
            jmask = (torch.arange(int(plen.max()), device=text.device)[None]
                     < plen[:, None])
            p1 = torch.where(jmask,
                             patterns[sel, :jmask.shape[1]].long() + 1, 0)
            prev = self.on_step
            self.on_step = lambda mid, act: self.windows(
                text, n, sa, mid, p1, jmask, act)
            calls, lanes = self.calls, self.window_lanes
            try:
                deep_refine(text, n, sa, patterns, lengths, cover, A, Z)
            finally:
                self.on_step = prev
            _expect(self.calls - calls == 2 and self.window_lanes > lanes,
                    f'the deep refine ran {self.calls - calls} bisections '
                    f'(2 expected) over {self.window_lanes - lanes} lanes')
            self.deep_calls += 2

        @contextlib.contextmanager
        def ctx():
            S._first_true, S._cmp3_rows, S._deep_refine_plain = (
                self.first_true, cmp3_rows, deep)
            try:
                yield self
            finally:
                S._first_true, S._cmp3_rows, S._deep_refine_plain = saved

        return ctx()


def _probe_sectors(torch, S, kind, args):
    """(distinct 32-byte sectors the plain bisection of ``kind`` reads,
    its lower bounds, its counts, the recorder) for ``args``, the probe's
    own arguments:
    ``'k4'`` (``probe_phased_plain``: the seed-table entries, one limb word
    a phase step, the deep byte compares), ``'b11'``
    (``probe_limbs_plain``: the bucket-table entries, the limbs a step
    compares, the deep byte compares) or ``'b15'`` (``probe_bytes_plain``:
    the byte compare at every step)."""
    rec = _SectorRecorder(torch, S)
    if kind == 'k4':
        (text, n, sa, tables, limbs, rank, present, patterns, lengths, K,
         base, depth, bits) = args
        C, N = text.shape
        rows = torch.arange(C, device=text.device)[:, None]
        b_lo, b_up, _, _, k, _ = S._lane_setup(
            patterns, lengths, rank, present, base, depth, K, bits)
        t0 = tables.data_ptr() + 4 * rows * tables.stride(0)
        rec.add((t0 + 4 * b_lo[None]).flatten())
        rec.add((t0 + 4 * b_up[None]).flatten())
        rec.add((t0 + 4 * (b_lo + 1)[None])[:, k >= 1].flatten())
        tables_only = rec.count()

        def step(mid, act):  # phase j = (call - 1) // 2: a, then z
            j = (rec.calls - 1) // 2
            _expect(j < K, f'K4 phase {j} of {K} limbs')
            rec.add((limbs.data_ptr() + 4 * (
                rows * limbs.stride(0) + j * N + mid.clamp(0, N - 1)))[act])
        rec.on_step = step
        with rec.patch():
            lower, count = S.probe_phased_plain(*args)
        phased = rec.calls - rec.deep_calls
        _expect(phased % 2 == 0 and 2 <= phased <= 2 * K and rec.steps,
                f'K4 ran {phased} phase bisections over {rec.steps} steps '
                f'(2 a phase, {K} phases at most)')
    elif kind == 'b11':
        text, n, sa, tables, limbs, patterns, lengths, K = args
        C, N = text.shape
        B = patterns.shape[0]
        dev = text.device
        rows = torch.arange(C, device=dev)[:, None]
        depth = S.bucket_depth(tables.shape[1])
        width = max(S.key_cover_bytes(K), depth)
        raw = torch.zeros((B, width), dtype=torch.int64, device=dev)
        cols = min(patterns.shape[1], width)
        raw[:, :cols] = patterns[:, :cols].long() + 1
        in_len = (torch.arange(width, device=dev)[None, :]
                  < lengths.long()[:, None])
        k = torch.div(lengths.long(), S.DIGIT_LIMB_STRIDE,
                      rounding_mode='floor').clamp(1, K)
        jj = torch.arange(K, device=dev)
        t0 = tables.data_ptr() + 4 * rows * tables.stride(0)
        targets = []
        for pad in (0, S._RADIX - 1):  # the lower's call, then the upper's
            dig = torch.where(in_len, raw, pad)
            bucket = torch.zeros(B, dtype=torch.int64, device=dev)
            for q in range(depth):
                bucket = bucket * S._RADIX + dig[:, q]
            rec.add((t0 + 4 * bucket[None]).flatten())
            rec.add((t0 + 4 * (bucket + 1)[None]).flatten())
            targets.append(torch.stack([
                (dig[:, o] * S._RADIX + dig[:, o + 1]) * S._RADIX
                + dig[:, o + 2]
                for o in (S.DIGIT_LIMB_OFFSET + S.DIGIT_LIMB_STRIDE * j
                          for j in range(K))], 1))

        def step(mid, act):
            t = targets[rec.calls - 1]
            idx = (jj * N + mid.clamp(0, N - 1)[..., None]).reshape(C, -1)
            v = limbs.gather(1, idx).reshape(C, B, K).long()
            used = jj[None, :] < k[:, None]
            diff = (v != t[None]) & used[None]
            planes = torch.where(diff.any(-1),
                                 diff.to(torch.int32).argmax(-1).long() + 1,
                                 k[None, :])
            read = act[..., None] & (jj < planes[..., None])
            addr = limbs.data_ptr() + 4 * (rows[..., None] * limbs.stride(0)
                                           + idx.reshape(C, B, K))
            rec.add(addr[read])
        tables_only = rec.count()
        rec.on_step = step
        with rec.patch():
            lower, count = S.probe_limbs_plain(*args)
        _expect(rec.calls - rec.deep_calls == 2 and rec.steps,
                f'B11 ran {rec.calls - rec.deep_calls} bisections over '
                f'{rec.steps} steps (2 expected)')
    else:
        text, n, sa, patterns, lengths = args
        B, L = patterns.shape
        step = max(1, (1 << 24) // max(1, 2 * B * max(L, 1)))
        blocks = -(-text.shape[0] // step)  # probe_bytes_plain's row blocks
        tables_only = 0
        with rec.patch():
            lower, count = S.probe_bytes_plain(*args)
        _expect(rec.calls == blocks and rec.window_lanes,
                f'B15 ran {rec.calls} bisections ({blocks} row blocks) over '
                f'{rec.window_lanes} lanes')
    sectors = rec.count()
    _expect(sectors > tables_only,
            f'{kind}: {sectors} sectors, {tables_only} of them table entries')
    return sectors, lower, count, rec


def _probe_containers(np, args):
    """``chip_smoke.py``'s three probe containers and batches: (the ranked
    container, its 10,200 patterns, the digit container, its line batch of
    10,709 patterns, its count batch of 10,000, the raw container, its
    10,206 patterns).  Each container is written by the port's Writer on
    the card (SA equal to native SA-IS) in 8 MiB chunks, as the script
    writes it, once: it is kept beside ``--corpus``
    (``sa_bench_probe_*.idx``) for the next run, of this tree or another;
    the batches are drawn again from the corpora each run."""
    import types

    import pysubstringsearch_tpu_torch as pss

    smoke = _smoke()
    ns = types.SimpleNamespace(chunk_mb=8, queries=10_000)
    d = os.path.dirname(os.path.abspath(args.corpus))
    made = {}
    for name, make in (('digit', lambda: smoke.make_digit_corpus(500)),
                       ('raw', lambda: smoke.make_raw_corpus(500))):
        npy = os.path.join(d, f'sa_bench_{name}.npy')
        if not os.path.exists(npy):
            np.save(npy, np.frombuffer(make(), np.uint8))
        made[name] = npy
    paths = []
    for name, npy, sampler in (
            ('sa_bench_probe_ranked', args.corpus, smoke.sample_patterns),
            ('sa_bench_probe_digit', made['digit'],
             smoke.sample_digit_patterns),
            ('sa_bench_probe_raw', made['raw'], smoke.sample_patterns)):
        corpus = np.load(npy).tobytes()
        path = os.path.join(d, f'{name}.idx')
        if os.path.exists(path):
            pats = sampler(corpus, ns.queries)
        else:
            path, _, pats = smoke.build_container(
                pss, lambda corpus=corpus: corpus, d, name, ns,
                backend='auto', sampler=sampler)
        paths.append((path, pats))
        del corpus
    (ranked, pats), (digit, (line, count)), (raw, raw_pats) = paths
    return (ranked, pats, digit,
            line + smoke.DIGIT_SHORT + smoke.DIGIT_HIGH, count, raw,
            raw_pats + smoke.odd_patterns(raw_pats))


def _probe_rows(torch, np, path):
    """(text, n, sa) of a container's chunks stacked as rows of the upload
    geometry (B15's rows in ``chip_smoke.py``'s scale-out phase)."""
    from pysubstringsearch_tpu_torch.container import read_container
    from pysubstringsearch_tpu_torch.ops import search as S
    from pysubstringsearch_tpu_torch.ops.suffix_array import _pad_len

    dev = torch.device('cuda')
    chunks = read_container(path).chunks
    N = _pad_len(max(c.data.size for c in chunks) + S.PAD_MARGIN)
    text = torch.zeros((len(chunks), N), dtype=torch.uint8, device=dev)
    sa = torch.zeros((len(chunks), N), dtype=torch.int32, device=dev)
    for i, c in enumerate(chunks):
        text[i, :c.data.size] = torch.from_numpy(np.array(c.data))
        sa[i, :c.data.size] = torch.from_numpy(
            np.array(c.suffix_array, dtype=np.int32))
    n = torch.tensor([c.data.size for c in chunks], dtype=torch.int32,
                     device=dev)
    return text, n, sa


#: The probe kernels' entry points, by their launch-count names.
PROBE_KERNELS = {'k4': 'probe_phased', 'k4_short': 'probe_phased',
                 'k4_deep': 'probe_phased', 'k4_raw': 'probe_phased',
                 'k4_upload': 'probe_phased',
                 'k4_upload_line': 'probe_phased', 'b15': 'probe_bytes',
                 'b11_line': 'probe_limbs', 'b11_count': 'probe_limbs'}


def _ptxas(tree):
    """nvcc -Xptxas -v of ``tree``'s ``search_kernels.cu``: {kernel: its
    registers, stack and spill lines} for the probe kernels."""
    import re
    import subprocess

    from pysubstringsearch_tpu_torch.ops import kernels

    src = os.path.join(tree, 'pysubstringsearch_tpu_torch', 'csrc',
                       'search_kernels.cu')
    with tempfile.TemporaryDirectory() as d:
        res = subprocess.run(
            [kernels.nvcc_path(), '-gencode', 'arch=compute_90a,code=sm_90a',
             '-std=c++17', '-O3', '-Xcompiler', '-fPIC', '-c', '-Xptxas',
             '-v', '-o', os.path.join(d, 'x.o'), src],
            capture_output=True, text=True, check=True)
    found, name = {}, None
    for line in res.stderr.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1) if 'probe' in m.group(1) else None
        elif name and ('registers' in line or 'stack frame' in line):
            found.setdefault(name, []).append(line.split('info    :')[-1]
                                              .strip())
    return found


def _k4_args(idx, patterns, lengths):
    """K4's arguments for index ``idx`` and a batch on its device."""
    return (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs, idx.rank,
            idx.present, patterns, lengths, idx.num_limbs, idx._base,
            idx._depth, idx._bits)


def _probes(torch, np, S, bench, args, out):
    """The probes on ``chip_smoke.py``'s indexes and batches: K4 on the
    ranked derive index (2 merged rows x 10,200 patterns; then the same
    rows with the patterns up to its key cover, ``k4_short``, and past it,
    ``k4_deep``), on the raw derive index (2 rows x 10,206, ``k4_raw``) and
    on the ranked container's 63 chunks in the upload geometry
    (``k4_upload``; with chip_smoke's line batch of 1200 patterns,
    ``k4_upload_line``), B15 on those chunks as rows (x 10,200), B11 on the
    digit derive index (2 rows) with the line batch (10,709) and the count
    batch (10,000).  Each is held against its plain version (lower and
    count, bit for bit) and timed as a whole call (``_ms``: CUDA events
    around one call after a synchronise, ``bench.cuda_ms``) and back to
    back (``_back_to_back_ms``: events around ``10 * REPS`` calls in a
    row, so the host's launch work overlaps the kernels); with
    ``--profile`` one profiler session runs each once (``PROFILE`` lines
    of the kernel's device time; the session is the process's first, as
    ``--probes`` runs before everything else).  Then ptxas's registers and
    spills of the probe kernels (``ptxas``)."""
    import pysubstringsearch_tpu_torch as pss
    from pysubstringsearch_tpu_torch.ops import kernels

    dev = torch.device('cuda')
    smoke = _smoke()
    ranked, pats, digit, line, count, raw, raw_pats = _probe_containers(
        np, args)

    def batch(p):
        packed, lengths = S.pack_patterns(p)
        return (torch.from_numpy(packed).to(dev),
                torch.from_numpy(lengths).to(dev))

    # (tag, kernel, plain version, arguments, the reader they come from):
    # each reader is dropped after its last call's check, so that the
    # plain versions (K4's holds its limbs as int64) find room.
    readers = [pss.Reader(ranked), pss.Reader(raw),
               pss.Reader(ranked, index_mode='upload'), pss.Reader(digit)]
    for r in readers:
        r.wait_device_ready()
    idx = readers[0]._index
    cover = S.ranked_cover_bytes(idx.num_limbs, idx._depth, idx._bits)
    calls = [(tag, S.probe_phased, S.probe_phased_plain,
              _k4_args(idx, *batch(part)), 0) for tag, part in (
                  ('k4', pats),
                  ('k4_short', [p for p in pats if len(p) <= cover]),
                  ('k4_deep', [p for p in pats if len(p) > cover]))]
    calls.append(('k4_raw', S.probe_phased, S.probe_phased_plain,
                  _k4_args(readers[1]._index, *batch(raw_pats)), 1))
    idx = readers[2]._index
    calls.append(('k4_upload', S.probe_phased, S.probe_phased_plain,
                  _k4_args(idx, *batch(pats)), 2))
    # The line batch that search_multiple probes (1200 patterns).
    calls.append(('k4_upload_line', S.probe_phased, S.probe_phased_plain,
                  _k4_args(idx, *batch(smoke.line_batch(
                      pats, smoke.DEEP_PATTERNS))), 2))
    # B15's rows are the upload index's own text and SA.
    calls.append(('b15', S.probe_bytes, S.probe_bytes_plain,
                  (idx.text, idx.lengths, idx.sa, *batch(pats)), 2))
    idx = readers[3]._index
    for tag, p in (('b11_line', line), ('b11_count', count)):
        calls.append((tag, S.probe_limbs, S.probe_limbs_plain,
                      (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
                       *batch(p), idx.num_limbs), 3))
    del idx
    if args.profile:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        for _, fn, _, a, _ in calls:  # warm-up: the library is built
            fn(*a)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            for _, fn, _, a, _ in calls:
                fn(*a)
                torch.cuda.synchronize()
        found = sorted((e.time_range.start, e.name,
                        e.time_range.elapsed_us()) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        labels = ([t for t, *_ in calls] if len(found) == len(calls)
                  else ['probes'] * len(found))
        for label, (_, name, us) in zip(labels, found):
            out[f'{label}_device_us'] = us
            print('PROFILE ' + json.dumps({
                'label': label, 'device_us': us, 'by_kernel_us': [[
                    name.replace('(anonymous namespace)::', '').split('(')[0],
                    us, 1]]}), flush=True)
    # The readers' builds leave cached blocks that K4's plain version
    # (its limbs as int64, 12.75 GiB on the derive rows) may not fit into.
    torch.cuda.empty_cache()
    while calls:
        tag, fn, plain, a, ri = calls.pop(0)
        before = kernels.LAUNCHES[PROBE_KERNELS[tag]]
        lo, cnt = fn(*a)
        torch.cuda.synchronize()
        _expect(kernels.LAUNCHES[PROBE_KERNELS[tag]] == before + 1,
                f'{tag}: one launch of {PROBE_KERNELS[tag]} a probe')
        lo_p, cnt_p = plain(*a)
        if not (torch.equal(lo, lo_p) and torch.equal(cnt, cnt_p)):
            raise RuntimeError(f'--probes: {tag} differs from its plain '
                               'version')
        out[f'{tag}_shape'] = [lo.shape[0], lo.shape[1]]
        out[f'{tag}_hits'] = int(cnt.long().sum())
        out[f'{tag}_ms'] = bench.cuda_ms(lambda: fn(*a), 10 * REPS)
        reps = 10 * REPS
        fn(*a)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(*a)
        end.record()
        torch.cuda.synchronize()
        out[f'{tag}_back_to_back_ms'] = start.elapsed_time(end) / reps
        print(f'PROBE {tag}: {lo.shape[0]} rows x {lo.shape[1]} patterns, '
              f'{out[f"{tag}_ms"]:.4f} ms a call, '
              f'{out[f"{tag}_back_to_back_ms"]:.4f} back to back',
              flush=True)
        del a, lo, cnt, lo_p, cnt_p
        if all(c[4] != ri for c in calls):
            readers[ri] = None
            torch.cuda.empty_cache()
    out['ptxas'] = _ptxas(args.tree)


def _probe_bounds(torch, np, S, args, out):
    """The probes' bounds recounted at ``chip_smoke.py``'s batches: K4 on
    the ranked derive index (2 merged rows, the 10,200 patterns), in the
    upload geometry (63 rows, ``k4_upload``) and on the raw derive index
    (2 rows, 10,206 patterns, ``k4_raw``), B11 on the digit derive index
    (2 rows; the line batch of 10,709 patterns and the count batch of
    10,000, ``b11_count``) and B15 on the ranked container's chunks
    stacked as rows at the upload geometry (63 rows, the 10,200 patterns),
    from ``_probe_containers``.  For each: the
    distinct 32-byte sectors its plain bisection reads
    (``_probe_sectors``, checked against the kernel's answers), the bytes
    they and the patterns, lengths and bounds make, and that over 3.35
    TB/s (``_bound_ms``)."""
    import pysubstringsearch_tpu_torch as pss

    dev = torch.device('cuda')

    def record(tag, kind, probe, probe_args, patterns_np):
        sectors, lo_p, cnt_p, rec = _probe_sectors(torch, S, kind,
                                                   probe_args)
        lo_k, cnt_k = probe(*probe_args)
        if not (torch.equal(lo_p, lo_k) and torch.equal(cnt_p, cnt_k)):
            raise RuntimeError(f'{tag}: the plain probe differs from the '
                               'kernel')
        C = probe_args[0].shape[0]
        B, L = patterns_np.shape
        nbytes = SECTOR * sectors + B * L + 4 * B + 8 * C * B
        out[f'{tag}_sectors'] = sectors
        out[f'{tag}_pattern_bound_ms'] = _floor_ms(B * L + 4 * B + 8 * C * B)
        out[f'{tag}_bound_ms'] = _floor_ms(nbytes)
        out[f'{tag}_compare_lane_steps'] = rec.window_lanes
        out[f'{tag}_byte_loop_loads'] = rec.byte_loads
        out[f'{tag}_chunk16_loads'] = rec.chunk_loads
        print(f'PROBE_BOUND {tag}: {C} rows x {B} patterns, {sectors} '
              f'sectors, bound {out[f"{tag}_bound_ms"]:.4f} ms', flush=True)

    ranked, pats, digit, line, count, raw, raw_pats = _probe_containers(
        np, args)
    packed_np, lengths_np = S.pack_patterns(pats)
    patterns = torch.from_numpy(packed_np).to(dev)
    lengths = torch.from_numpy(lengths_np).to(dev)
    for tag, path, mode, batch in (('k4', ranked, 'auto', None),
                                   ('k4_upload', ranked, 'upload', None),
                                   ('k4_raw', raw, 'auto', raw_pats)):
        r = pss.Reader(path, index_mode=mode)
        r.wait_device_ready()
        if batch is None:
            b_np, args_p = packed_np, (patterns, lengths)
        else:
            b_np, l_np = S.pack_patterns(batch)
            args_p = (torch.from_numpy(b_np).to(dev),
                      torch.from_numpy(l_np).to(dev))
        record(tag, 'k4', S.probe_phased,
               _k4_args(r._index, *args_p), b_np)
        del r, args_p
        torch.cuda.empty_cache()
    record('b15', 'b15', S.probe_bytes,
           (*_probe_rows(torch, np, ranked), patterns, lengths), packed_np)
    torch.cuda.empty_cache()
    r = pss.Reader(digit)
    r.wait_device_ready()
    idx = r._index
    for tag, batch in (('b11', line), ('b11_count', count)):
        packed_np, lengths_np = S.pack_patterns(batch)
        record(tag, 'b11', S.probe_limbs,
               (idx.text, idx.lengths, idx.sa, idx.tables, idx.limbs,
                torch.from_numpy(packed_np).to(dev),
                torch.from_numpy(lengths_np).to(dev), idx.num_limbs),
               packed_np)
    del r, idx
    torch.cuda.empty_cache()


#: Placements of one card the giant build splits the 512 Mi row over, as
#: ``chip_smoke.py``'s ``giant`` phase does.
GIANT_PLACEMENTS = 4
#: Owner counts the partition is timed at on the same 128 Mi pairs, and
#: source counts the merge of one shard's received pairs is timed at.
GIANT_PARTITION_S = (4, 64, 256)


def _received_runs(torch, rank, W, lo, hi, k, S):
    """``chip_smoke.received_runs``: the (keys, positions, run lengths) a
    shard holding group starts [lo, hi) receives in a round at ``k`` over
    ``S`` sources, from the distinct ranks ``rank``."""
    N = rank.shape[0]
    pos = torch.nonzero((rank >= lo) & (rank < hi)).flatten()
    low = torch.zeros_like(pos)
    inside = pos + k < N
    low[inside] = rank[pos[inside] + k].long() + 1
    keys = (rank[pos].long() << W) | low
    src = torch.div(pos, N // S, rounding_mode='floor')
    order = torch.sort(keys, stable=True).indices
    order = order[torch.sort(src[order], stable=True).indices]
    runs = torch.bincount(src, minlength=S).tolist()
    return keys[order], pos[order].to(torch.int32), runs
#: B14g's steps by the device activities that carry them (a part of the
#: kernel's or activity's name; the first step that matches); anything
#: else is ``other``.
GIANT_STEPS = (('radix sort', ('onesweep_',)),
               ('merge', ('giant_merge_',)),
               ('partition', ('giant_part_',)),
               ('cuts', ('giant_cuts',)),
               ('flags', ('giant_flags', 'giant_stats')),
               ('relabel', ('giant_relabel',)),
               ('keys', ('giant_byte_keys', 'giant_round_keys')),
               # B16: the direct store of older trees, or the count,
               # distribute and assemble kernels with the sum scan of the
               # bins' counts (the build's only sum scan).
               ('rank store', ('scatter_', 'SumOp')),
               # Older trees' max scan after the flags: the two-level
               # scan, or the look-back pass.
               ('max scan', ('scan_tile_kernel', 'scan_add_kernel',
                             'max_scan_kernel')),
               ('copies', ('Memcpy', 'CatArrayBatchedCopy')),
               ('memset', ('Memset',)))


def _kernel_name(name):
    return name.replace('(anonymous namespace)::', '').split('(')[0]


def _giant_step(name):
    for step, parts in GIANT_STEPS:
        if any(p in name for p in parts):
            return step
    return 'other'


def _merges(torch, SA, bench, inv, W, B, out):
    """The pairs shard 1 receives in a round at k = 6 (group starts [B,
    2B) of the final ranks ``inv``) over 4, 64 and 256 sources
    (``GIANT_PARTITION_S``): ``radix_sort_pairs`` of them, the sort a tree
    before the merge ran on them (``giant_merge_s<S>_radix_ms``), a stable
    ``torch.sort`` with the positions gathered (``_torch_sort_ms``, the
    library call), their bound (``_bound_ms``, 24 bytes a pair) and, where
    the tree has it, ``giant_merge`` held against its plain version
    (``_ms``); each call on copies restored before it, untimed (an even
    number of rounds merges in place)."""
    for S in GIANT_PARTITION_S:
        mk, mv, runs = _received_runs(torch, inv, W, B, 2 * B, 6, S)
        work = [mk.clone(), mv.clone()]

        def restore():
            work[0].copy_(mk)
            work[1].copy_(mv)

        tag = f'giant_merge_s{S}'
        out[f'{tag}_pairs'] = mk.shape[0]
        out[f'{tag}_bound_ms'] = _floor_ms(24 * mk.shape[0])
        out[f'{tag}_radix_ms'] = bench.cuda_ms(
            lambda: SA.radix_sort_pairs(work[0], work[1], 2 * W), REPS,
            restore)
        out[f'{tag}_torch_sort_ms'] = bench.cuda_ms(
            lambda: mv[torch.sort(mk, stable=True).indices], REPS)
        if hasattr(SA, 'giant_merge'):
            restore()
            got = SA.giant_merge(work[0], work[1], runs)
            want = SA.giant_merge_plain(mk, mv, runs)
            _expect(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f'{tag} equals its plain version')
            del got, want
            out[f'{tag}_ms'] = bench.cuda_ms(
                lambda: SA.giant_merge(work[0], work[1], runs), REPS,
                restore)
        del work, mk, mv
        torch.cuda.empty_cache()


def _full_calls(torch, SA, text, sa, rank, r2, n, S):
    """(tag, call, plain call, bytes) of a tree whose rounds key every
    position (one with the max scan, before the relabel): the byte keys
    of the last block, the round keys at k = 6 from the final ranks, the
    cuts of those keys sorted at S - 1 of them beside
    ``torch.searchsorted``, the flags, the max scan of the flags beside
    ``torch.cummax`` and the partition of the sorted positions of slots
    [0, B) at 4, 64 and 256 owners."""
    N = text.shape[0]
    B = N // S
    p0 = (S - 1) * B
    blk, halo = text[p0:], text[N:]
    W = SA._key_width(N)
    dev = text.device
    keys, vals = SA.giant_round_keys(rank, r2, W, p0)
    SA.radix_sort_pairs(keys, vals, 2 * W)
    pick = torch.tensor([r * B // S for r in range(1, S)], device=dev)
    skeys, spos = keys[pick], vals[pick]
    pred = int(keys[0]) - 1
    pos = sa[:B].clone()
    gs = torch.arange(B, dtype=torch.int32, device=dev)
    flags = SA.giant_flags(keys, B, pred, True, N - n)[0]
    calls = [
        ('giant_byte_keys', lambda: SA.giant_byte_keys(blk, halo, p0, n),
         lambda: SA.giant_byte_keys_plain(blk, halo, p0, n), 13 * B),
        ('giant_round_keys', lambda: SA.giant_round_keys(rank, r2, W, p0),
         lambda: SA.giant_round_keys_plain(rank, r2, W, p0), 20 * B),
        ('giant_cuts', lambda: SA.giant_cuts(keys, vals, skeys, spos),
         lambda: SA.giant_cuts_plain(keys, vals, skeys, spos),
         (S - 1) * (12 + 12 * B.bit_length()) + 8 * (S - 1)),
        ('giant_cuts_searchsorted', lambda: torch.searchsorted(keys, skeys),
         None, None),
        ('giant_flags', lambda: SA.giant_flags(keys, B, pred, True, N - n),
         lambda: SA.giant_flags_plain(keys, B, pred, True, N - n),
         12 * B + 8),
    ]
    calls += [
        ('scan_inclusive_max', lambda: SA.scan_inclusive_max(flags),
         lambda: SA.scan_inclusive_max_plain(flags), 8 * B),
        ('scan_cummax', lambda: torch.cummax(flags, 0), None, None),
    ]
    for s in GIANT_PARTITION_S:
        calls.append((
            f'giant_partition_s{s}',
            lambda s=s: SA.giant_partition(pos, gs, 7, N // s, s),
            lambda s=s: SA.giant_partition_plain(pos, gs, 7, N // s, s),
            16 * B + 4 * s))
    return calls


def _tied_calls(torch, SA, text, n, S, out):
    """(tag, call, plain call, bytes) of a tree whose rounds key only the
    tied positions, on B9's state at k = 6 (``chip_smoke.k6_ranks``): the
    byte keys of the last block, its compacted round keys (the unsettled
    share in ``giant_k6_unsettled``), and on their sorted list, a shard's
    list at k = 6: the cuts at S - 1 of its pairs beside
    ``torch.searchsorted``, the flags, the relabel and the partition of
    its positions with the relabel's group starts at 4, 64 and 256
    owners."""
    N = text.shape[0]
    B = N // S
    p0 = (S - 1) * B
    blk, halo = text[p0:], text[N:]
    W = SA._key_width(N)
    dev = text.device
    rank_all = _smoke().k6_ranks(text, n)
    rank, r2 = rank_all[p0:].clone(), rank_all[p0 + 6:].clone()
    del rank_all
    live = int((rank < 0).sum())
    out['giant_k6_unsettled'] = live
    keys, vals, _ = SA.giant_round_keys(rank, r2, W, p0, live)
    SA.radix_sort_pairs(keys, vals, 2 * W)
    m = keys.shape[0]
    pick = torch.tensor([r * m // S for r in range(1, S)], device=dev)
    skeys, spos = keys[pick], vals[pick]
    real_lo = (N - n) << W
    gs = SA.giant_relabel(keys, 0, None, None, W, -1, -1)
    calls = [
        ('giant_byte_keys', lambda: SA.giant_byte_keys(blk, halo, p0, n),
         lambda: SA.giant_byte_keys_plain(blk, halo, p0, n), 13 * B),
        ('giant_round_keys',
         lambda: SA.giant_round_keys(rank, r2, W, p0, live),
         lambda: SA.giant_round_keys_plain(rank, r2, W, p0),
         4 * B + 16 * live + 4),
        ('giant_cuts', lambda: SA.giant_cuts(keys, vals, skeys, spos),
         lambda: SA.giant_cuts_plain(keys, vals, skeys, spos),
         (S - 1) * (12 + 12 * m.bit_length()) + 8 * (S - 1)),
        ('giant_cuts_searchsorted', lambda: torch.searchsorted(keys, skeys),
         None, None),
        ('giant_flags',
         lambda: SA.giant_flags(keys, 0, None, None, W, real_lo),
         lambda: SA.giant_flags_plain(keys, 0, None, None, W, real_lo),
         8 * m + 12),
        ('giant_relabel',
         lambda: SA.giant_relabel(keys, 0, None, None, W, -1, -1),
         lambda: SA.giant_relabel_plain(keys, 0, None, None, W, -1, -1),
         12 * m),
    ]
    for s in GIANT_PARTITION_S:
        live_s = torch.empty(s, dtype=torch.int32, device=dev)
        calls.append((
            f'giant_partition_s{s}',
            lambda s=s, live_s=live_s: SA.giant_partition(
                vals, gs, N // s, s, live=live_s),
            lambda s=s: SA.giant_partition_plain(vals, gs, N // s, s),
            16 * m + 8 * s))
    return calls


def _giant(torch, np, SA, bench, args, out):
    """B14g on ``--corpus`` as one row of N = 512 Mi slots over
    ``GIANT_PLACEMENTS`` placements of the card (its pairs sorted a sort,
    ``giant_sorted``, where the tree reports them), and its kernels at
    that row's shapes (B = 128 Mi), as ``chip_smoke.py``'s
    ``giant_kernels`` makes their inputs: the merge of the runs shard 1
    receives at S = 4, 64 and 256 sources beside the radix sort it
    replaces (:func:`_merges`, outside the profiler session: the merge
    gives its inputs up), then :func:`_tied_calls` for a tree whose
    rounds key only the tied positions, :func:`_full_calls` for an older
    one.  One warm-up build gives the SA; then one profiler session, the
    process's first (G7), traces a second build and one call of every
    kernel, each opened by a marker kernel (``torch.cuda._sleep``) and
    closed by a synchronise: ``giant_build_by_kernel_us`` and
    ``giant_build_by_step_us`` sum the build's device activities by name
    and by step (``GIANT_STEPS``), ``giant_build_device_us`` all of them
    against the span from the first to the last (``giant_build_span_us``),
    and ``<kernel>_device_us`` each call's.  Outside the session: every
    kernel held against its plain version, its whole call (``_ms``, CUDA
    events around one call, ``bench.cuda_ms``), its bound (``_bound_ms``:
    inputs read once, outputs written once, at 3.35 TB/s), the cuts'
    dependent rounds against a binary search's, and the build's wall
    untraced (``giant_build_s``; the warm-up's ``giant_build_first_s``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from pysubstringsearch_tpu_torch.ops import kernels
    from pysubstringsearch_tpu_torch.parallel import mesh as M
    from pysubstringsearch_tpu_torch.parallel import sharded

    dev = torch.device('cuda')
    data = np.load(args.corpus)
    n = data.size
    N = SA._pad_len(n)
    S = GIANT_PLACEMENTS
    B = N // S
    text = torch.zeros(N, dtype=torch.uint8, device=dev)
    text[:n] = torch.from_numpy(data).to(dev)
    del data
    build = sharded.make_giant_chunk_build(
        M.make_mesh([f'cuda:{torch.cuda.current_device()}'] * S))
    sa, out['giant_build_first_s'] = _wall_s(torch, lambda: build(text, n))
    out['giant_rounds'] = build.stats['rounds']
    out['giant_max_recv'] = build.stats['max_recv']
    for key in ('sorted', 'tied_real', 'round_bound'):
        if key in build.stats:
            out[f'giant_{key}'] = build.stats[key]
    _expect(torch.equal(sa[: N - n], torch.arange(
        N - 1, n - 1, -1, dtype=torch.int32, device=dev)),
        'the giant build\'s pad slots are [N - 1, ..., n]')

    # Inputs at the row's shapes, as chip_smoke.giant_kernels makes them.
    p0 = (S - 1) * B
    inv = torch.empty(N, dtype=torch.int32, device=dev)
    SA.scatter(torch.arange(N, dtype=torch.int32, device=dev), sa, inv)
    rank, r2 = inv[p0:].clone(), inv[p0 + 6:].clone()
    W = SA._key_width(N)
    _merges(torch, SA, bench, inv, W, B, out)
    del inv
    if hasattr(SA, 'giant_relabel'):
        del rank, r2
        calls = _tied_calls(torch, SA, text, n, S, out)
    else:
        calls = _full_calls(torch, SA, text, sa, rank, r2, n, S)
        del rank, r2
    for _, fn, _, _ in calls:  # warm-up
        fn()
    torch.cuda.synchronize()

    # A marker kernel opens every traced section, so the device activities
    # split by order, whatever the skew between host and device clocks.
    labels = ['giant_build'] + [c[0] for c in calls]
    with profile(activities=[ProfilerActivity.CUDA], acc_events=True) as prof:
        torch.cuda._sleep(1)
        del sa
        sa = build(text, n)
        torch.cuda.synchronize()
        for _, fn, _, _ in calls:
            torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
    acts = sorted((e for e in prof.events()
                   if e.device_type == DeviceType.CUDA),
                  key=lambda e: e.time_range.start)
    sections = []
    for e in acts:
        if 'spin_kernel' in e.name:
            sections.append([])
        elif sections:
            sections[-1].append(e)
    _expect(len(sections) == len(labels),
            f'{len(sections)} traced sections for {len(labels)} calls')
    for label, section in zip(labels, sections):
        by_name = {}
        for e in section:
            name = _kernel_name(e.name)
            us, count = by_name.get(name, (0.0, 0))
            by_name[name] = (us + e.time_range.elapsed_us(), count + 1)
        total = sum(us for us, _ in by_name.values())
        out[f'{label}_device_us'] = total
        line = {'label': label, 'device_us': total,
                'by_kernel_us': sorted(([k, us, c] for k, (us, c)
                                        in by_name.items()),
                                       key=lambda r: -r[1])}
        if label == 'giant_build':
            steps = {}
            for e in section:
                step = _giant_step(e.name)
                steps[step] = steps.get(step, 0.0) + e.time_range.elapsed_us()
            span = (section[-1].time_range.end - section[0].time_range.start
                    if section else 0)
            out['giant_build_span_us'] = span
            out['giant_build_by_step_us'] = steps
            out['giant_build_by_kernel_us'] = line['by_kernel_us']
            line['by_step_us'] = steps
            line['span_us'] = span
        print('PROFILE ' + json.dumps(line), flush=True)

    for tag, fn, plain, nbytes in calls:
        if plain is not None:
            got, want = fn(), plain()
            if isinstance(got, torch.Tensor):
                got, want = (got,), (want,)
            _expect(all(torch.equal(a, b) for a, b in zip(got, want)),
                    f'{tag} equals its plain version')
            out[f'{tag}_bound_ms'] = _floor_ms(nbytes)
            del got, want
        out[f'{tag}_ms'] = bench.cuda_ms(
            fn, 20 if 'cuts' in tag or 'partition' in tag else REPS)
    out['giant_cuts_rounds'] = SA.giant_cuts_rounds(B) if hasattr(
        SA, 'giant_cuts_rounds') else None
    out['giant_cuts_binary_search_rounds'] = B.bit_length()
    out['giant_launches'] = {k: v for k, v in kernels.LAUNCHES.items()
                             if k.startswith('giant_')}
    del sa, calls
    torch.cuda.empty_cache()
    _, out['giant_build_s'] = _wall_s(torch, lambda: build(text, n))
    del text
    torch.cuda.empty_cache()


def _init_rows(torch, np, SA, S, bench, args, out):
    """B1 and B1b on ``INIT_ROWS``, timed beside ``torch.sort`` of their
    keys, K3 on the ranked and digit rows and B9 on 8 MiB chunks; with
    ``--profile`` also their device time by kernel and the inits' bucket
    sizes by the top 16, 24 and 32 key bits."""
    from pysubstringsearch_tpu_torch.ops import kernels

    smoke = _smoke()
    dev = torch.device('cuda')
    cache = {}
    for label, kind, nbytes, N in INIT_ROWS:
        data, text = _row(torch, np, smoke, args, cache, kind, nbytes, N)
        n = nbytes
        if kind == 'ranked':
            pres = np.bincount(data, minlength=256)[:256] > 0
            rank_np, sigma = S.alphabet_rank(pres)
            bits = S.ranked_bits(sigma)
            rank = torch.from_numpy(rank_np).to(dev)
            init = lambda: SA.sa_init_ranked(text, n, rank, bits)
            key, key_bits = SA._ranked_key(text, n, rank, bits), \
                2 * (30 // bits) * bits
        else:
            init = lambda: SA.sa_init_bytes(text, n)
            key, key_bits = SA._byte_key(text, n), 50
        tag = label.replace(' ', '_')
        if args.profile:
            hist = getattr(SA, 'bucket_histogram', None)
            if hist is not None:
                print('BUCKETS ' + json.dumps({
                    'label': label, 'n': n, 'N': N, 'key_bits': key_bits,
                    'by_cut': {cut: hist(key, key_bits, cut)
                               for cut in (16, 24, 32)}}), flush=True)
            _profile(torch, label, init)
        out[f'{tag}_ms'] = bench.cuda_ms(init, REPS)
        out[f'{tag}_sort_keys_ms'] = bench.cuda_ms(
            lambda: torch.sort(key, stable=True), REPS)
        del key
        if label == 'b1 ranked':  # K3 of the ranked derive row
            sa = SA.derive_sa(text, n, rank, bits)[0]
            base, depth = S.pick_table_params(sigma, n)
            packed = S.ranked_pack(text, n, rank, bits)
            tbl = S.seed_table(packed, sa, n, base, depth, bits)
            _k3(torch, bench, out, 'ranked', lambda: S.seed_table(
                packed, sa, n, base, depth, bits, out=tbl), packed, sa, n,
                (30 // bits - depth) * bits, args.profile)
            del sa, packed, tbl
        elif label == 'b1b digit':  # K3 of the digit derive row (K7's values)
            sa = SA.derive_sa(text, n)[0]
            ident = torch.from_numpy(S.identity_rank()[0]).to(dev)
            pv = S.seed_prefix(text, n, ident, 258, 3)
            tbl = S.seed_table_from_prefix(pv, sa, n, 258, 3)
            _k3(torch, bench, out, 'digit', lambda: S.seed_table_from_prefix(
                pv, sa, n, 258, 3, out=tbl), pv, sa, n, 0, args.profile)
            del sa, pv, tbl
        elif label == 'b1b digit chunk':  # B9 on the same chunk
            _b9(torch, SA, kernels, bench, out, 'digit_chunk', text, n,
                args.profile)
        del text
        torch.cuda.empty_cache()
    # B9 on the ranked corpus's first 8 MiB chunk, as the Writer pads it and
    # as the scale-out rows are padded.
    n = 8_388_563
    data = np.asarray(cache['ranked'][:n])
    for tag, N in (('ranked_chunk', 8 << 20), ('ranked_chunk16', 16 << 20)):
        text = torch.zeros(N, dtype=torch.uint8, device=dev)
        text[:n] = torch.from_numpy(data).to(dev)
        _b9(torch, SA, kernels, bench, out, tag, text, n, args.profile)
        del text
        torch.cuda.empty_cache()
    # B9 on B10's poisoned fallback: 400 MiB of "ab" at N = 416 Mi.
    n = 400 << 20
    text = torch.zeros(416 << 20, dtype=torch.uint8, device=dev)
    text[:n] = torch.tensor([97, 98], dtype=torch.uint8,
                            device=dev).repeat(n // 2)
    SA.sa_full_doubling(text, n)  # warm-up: scratch sizes cached
    before = kernels.LAUNCHES['sa_full_round']
    _, out['b9_ab_build_s'] = _wall_s(torch,
                                      lambda: SA.sa_full_doubling(text, n))
    out['b9_ab_rounds'] = kernels.LAUNCHES['sa_full_round'] - before
    del text
    torch.cuda.empty_cache()


#: The roll's rows: (tag, true length n, slots N), as ``chip_smoke.py``
#: derives them.
ROLL_ROWS = (('roll_272', 268_434_495, 272 << 20),
             ('roll_512', 524_288_061, 1 << 29))


def _roll(torch, SA, bench, out):
    """R on ``ROLL_ROWS`` (and the 272 Mi row at every shift mod 4) beside
    its bound, its plain version and ``torch.roll``."""
    rows = list(ROLL_ROWS)
    tag, n, N = ROLL_ROWS[0]
    rows += [(f'{tag}_shift{(N - m) % 4}', m, N)
             for m in (n + 1, n + 2, n + 3)]
    for tag, n, N in rows:
        sa_full = torch.arange(N, dtype=torch.int32, device='cuda')
        row = torch.empty_like(sa_full)
        SA.sa_roll_front(sa_full, n, out=row)
        _expect(torch.equal(row, torch.roll(sa_full, n - N)),
                f'{tag}: the roll equals torch.roll')
        out[f'{tag}_ms'] = bench.cuda_ms(
            lambda: SA.sa_roll_front(sa_full, n, out=row), 10 * REPS)
        out[f'{tag}_plain_ms'] = bench.cuda_ms(
            lambda: SA.sa_roll_front_plain(sa_full, n, out=row), REPS)
        out[f'{tag}_torch_roll_ms'] = bench.cuda_ms(
            lambda: torch.roll(sa_full, n - N), 10 * REPS)
        out[f'{tag}_bound_ms'] = _floor_ms(8 * N)
        del sa_full, row
        torch.cuda.empty_cache()


def _base(torch, np, SA, S, bench, args, out):
    """The default measurements: the sorts, B8 and B15's gather on the
    skewed batch, then B10, B1b and B2 on the ranked corpus as one 512 Mi
    row."""
    dev = torch.device('cuda')
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
    # The same peak split: the init alone, then the passes from its state.
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    first = SA.sa_init3_bytes(text, n)
    torch.cuda.synchronize()
    out['b10_init_peak_gib'] = (torch.cuda.max_memory_allocated()
                                - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    SA._rotating(SA._init6_any, lambda *_: first, SA.sa_window_scan,
                 SA._window_refine, text, n)
    torch.cuda.synchronize()
    out['b10_passes_peak_gib'] = (torch.cuda.max_memory_allocated()
                                  - base) / 2**30
    del first
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    _, out['b1b_b2_s'] = _wall_s(torch, lambda: SA.segmented_sa(text, n))
    out['b1b_b2_peak_gib'] = (torch.cuda.max_memory_allocated() - base) / 2**30
    # Again, with the scratch sizes already in PyTorch's cache.
    _, out['b1b_b2_warm_s'] = _wall_s(torch,
                                      lambda: SA.segmented_sa(text, n))
    if args.profile:
        _profile(torch, 'b1b 512 Mi', lambda: SA.sa_init_bytes(text, n))
    out['b1b_512_ms'] = bench.cuda_ms(lambda: SA.sa_init_bytes(text, n),
                                      REPS)
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
    del state, first, text
    torch.cuda.empty_cache()


def main(argv=None) -> int:
    own = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--tree', default=os.path.dirname(own),
                    help='checkout whose package to time (default: this one)')
    ap.add_argument('--profile', action='store_true')
    ap.add_argument('--inits', action='store_true',
                    help='also time B1 and B1b on the derive rows')
    ap.add_argument('--gathers', action='store_true',
                    help='also time the SA-order gathers (K2, K6, B12d, '
                    'B13)')
    ap.add_argument('--packs', action='store_true',
                    help='also time the streaming packs (K1, K7, K5)')
    ap.add_argument('--probe-bounds', action='store_true',
                    help="also count the sectors the probes' bisections "
                    'read (K4, B11, B15)')
    ap.add_argument('--probes', action='store_true',
                    help='first time the probes (K4, B15, B11) and print '
                    "ptxas's registers and spills of their kernels")
    ap.add_argument('--giant', action='store_true',
                    help='first profile one B14g build of the 512 Mi row '
                    'on 4 placements and time its kernels')
    ap.add_argument('--roll', action='store_true',
                    help="also time the derived SA's roll (R) at 272 Mi "
                    'and 512 Mi')
    ap.add_argument('--no-base', action='store_true',
                    help='skip the sorts, B8, the B15 gather, B10, B1b and '
                    'B2 on the 512 Mi row')
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

    out = {'tree': args.tree, 'device': torch.cuda.get_device_name(0)}
    if not os.path.exists(args.corpus):
        from bench import make_corpus  # the checkout's, on sys.path

        np.save(args.corpus, np.frombuffer(make_corpus(500, 0)[0], np.uint8))
    if args.giant:
        _giant(torch, np, SA, bench, args, out)
    if args.probes:
        _probes(torch, np, S, bench, args, out)
    if not args.no_base:
        _base(torch, np, SA, S, bench, args, out)
    if args.inits:
        _init_rows(torch, np, SA, S, bench, args, out)
    if args.gathers:
        _gathers(torch, np, SA, S, bench, args, out)
    if args.packs:
        _packs(torch, np, S, bench, args, out)
    if args.probe_bounds:
        _probe_bounds(torch, np, S, args, out)
    if args.roll:
        _roll(torch, SA, bench, out)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
