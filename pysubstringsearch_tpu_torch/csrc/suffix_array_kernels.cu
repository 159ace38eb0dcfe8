// Hand-written Hopper kernels of the device suffix-array build (derive
// mode): the anchored init sorts (B1 on rank digits, B1b on bytes), the
// tie-only doubling rounds (B2), the rotating windowed doubler of rows over
// 384 Mi (B10), the full-sort doubling of the Writer's 'full' build, of
// integer alphabets and of B10's poisoned rows (B9), and the building
// blocks they are made of
// -- a stable LSD radix sort of (uint64 key, int32 value) pairs, an
// exclusive sum scan and an inclusive max scan over int32 -- with the radix
// sort's store pass alone as a scatter (B16).  No library computes any of
// them: no cub::Device* routine, no Thrust, no torch operator.
//
// Built by pysubstringsearch_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c ... && nvcc -shared
// and bound through ctypes: every entry point takes raw device pointers and
// a cudaStream_t, launches on that stream, never synchronises, allocates
// nothing (the caller passes a scratch buffer of the size the matching
// pss_*_scratch_bytes function returns) and returns cudaGetLastError().
//
// The anchored form follows the JAX package (ops/suffix_array.py):
//   sa[slot]  = text position occupying SA slot `slot`
//   rank[pos] = slot of the first member of pos's group
//   gs[slot]  = rank[sa[slot]], the group start of every slot
// Rows are at most 2^31 - 1 slots; element counts and offsets are 64-bit
// where they index, 32-bit where they are stored.

#include <climits>
#include <cstddef>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRadixBits = 8;
constexpr int kRadix = 1 << kRadixBits;
static_assert(kRadix == kThreads, "one digit per thread in the sort passes");
constexpr int kSortTile = 4096;  // elements per block in a sort pass
constexpr int kScanItems = 8;
constexpr int kScanTile = kThreads * kScanItems;
constexpr unsigned kFull = 0xffffffffu;

inline long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Grid for a grid-stride loop over n elements.
inline unsigned grid_for(long long n) {
  long long b = cdiv(n, kThreads);
  if (b < 1) b = 1;
  if (b > 65536LL * 16) b = 65536LL * 16;
  return static_cast<unsigned>(b);
}

// Bump allocator over the caller's scratch buffer.  With a null base it
// only counts, so the pss_*_scratch_bytes functions run the same carving
// code as the kernels that use the buffer.
struct Arena {
  char* base;
  size_t off;
  template <class T>
  T* take(long long count) {
    size_t at = off;
    size_t bytes = sizeof(T) * static_cast<size_t>(count > 0 ? count : 1);
    off += (bytes + 255) & ~static_cast<size_t>(255);
    return base ? reinterpret_cast<T*>(base + at) : nullptr;
  }
};

// ---------------------------------------------------------------------------
// Scans.  A tile of kScanTile int32 per block (8 consecutive items per
// thread), a warp-shuffle scan of the thread totals, then the block totals
// are scanned the same way one level up and added back as carries.  Bound
// by memory: each level reads and writes its input once, and the levels
// shrink by 2048x, so a scan of n moves about 8n bytes.
// ---------------------------------------------------------------------------
struct SumOp {
  __device__ static int apply(int a, int b) { return a + b; }
  __device__ static int identity() { return 0; }
};

struct MaxOp {
  __device__ static int apply(int a, int b) { return a > b ? a : b; }
  __device__ static int identity() { return INT_MIN; }
};

// Exclusive scan of one value per thread across the block; *total gets
// the block's reduction.  Called once per kernel.
template <class Op>
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int s_warp[kWarps + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl = Op::apply(y, incl);
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = Op::identity();
    for (int w = 0; w < kWarps; ++w) {
      int t = s_warp[w];
      s_warp[w] = run;
      run = Op::apply(run, t);
    }
    s_warp[kWarps] = run;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::identity();
  *total = s_warp[kWarps];
  return Op::apply(s_warp[warp], excl);
}

// One tile per block; in == out is allowed (each thread reads its own
// items before any write).  sums, when not null, gets each block's total.
template <class Op>
__global__ void scan_tile_kernel(const int* in, int* out, long long n,
                                 int* sums, int exclusive) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kScanTile +
      static_cast<long long>(threadIdx.x) * kScanItems;
  int v[kScanItems];
  int acc = Op::identity();
  for (int j = 0; j < kScanItems; ++j) {
    long long i = base + j;
    v[j] = i < n ? in[i] : Op::identity();
    acc = Op::apply(acc, v[j]);
  }
  int total;
  int run = block_exclusive_scan<Op>(acc, &total);
  for (int j = 0; j < kScanItems; ++j) {
    long long i = base + j;
    int next = Op::apply(run, v[j]);
    if (i < n) out[i] = exclusive ? run : next;
    run = next;
  }
  if (sums != nullptr && threadIdx.x == 0) sums[blockIdx.x] = total;
}

// out[i] = carry of i's tile (op) out[i]; carries are the exclusive scan
// of the tile totals.
template <class Op>
__global__ void scan_add_kernel(int* out, long long n, const int* carries) {
  const int c = carries[blockIdx.x];
  long long i = static_cast<long long>(blockIdx.x) * kScanTile + threadIdx.x;
  for (int j = 0; j < kScanItems; ++j, i += kThreads) {
    if (i < n) out[i] = Op::apply(c, out[i]);
  }
}

// int32 entries of scratch a scan of n needs: one block total per tile at
// every level above the last.
long long scan_scratch_elems(long long n) {
  long long total = 0;
  while (n > kScanTile) {
    n = cdiv(n, kScanTile);
    total += n;
  }
  return total;
}

template <class Op>
void scan_levels(const int* in, int* out, long long n, bool exclusive,
                 int* scratch, cudaStream_t st) {
  if (n <= 0) return;
  const long long nb = cdiv(n, kScanTile);
  if (nb == 1) {
    scan_tile_kernel<Op><<<1, kThreads, 0, st>>>(in, out, n, nullptr,
                                                 exclusive ? 1 : 0);
    return;
  }
  int* sums = scratch;
  scan_tile_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      in, out, n, sums, exclusive ? 1 : 0);
  scan_levels<Op>(sums, sums, nb, true, scratch + nb, st);
  scan_add_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      out, n, sums);
}

// out[n] = the total of an exclusive sum scan of in[0, n).
__global__ void scan_total_kernel(const int* in, int* out, long long n) {
  out[n] = n > 0 ? out[n - 1] + in[n - 1] : 0;
}

// ---------------------------------------------------------------------------
// Stable LSD radix sort of (uint64 key, int32 value) pairs, 8 bits a pass,
// only as many passes as the key's bit width needs.  Each pass is three
// launches:
//   1. a per-tile digit histogram (shared-memory atomics: counts only, so
//      their order does not matter), stored digit-major;
//   2. an exclusive sum scan of the histograms, which gives every (digit,
//      tile) its first output slot in stable order;
//   3. a scatter that ranks each element within its tile without atomics:
//      the tile is walked in rounds of 256 elements in index order; inside
//      a warp __match_any_sync finds the lanes with the same digit and the
//      lower lanes among them give the rank; the per-warp counts are then
//      scanned across the 8 warps per digit.  Equal digits therefore keep
//      their input order, which is what makes every pass, and so the sort,
//      stable.
// Bound by memory on the card: a pass reads the keys twice and the values
// once and writes both, 32 bytes per element, and the scatter's writes
// land in up to 256 runs per round, so they coalesce poorly.  Simple
// first; a one-sweep decoupled-lookback sort is later work.
// ---------------------------------------------------------------------------
__global__ void radix_hist_kernel(const uint64_t* __restrict__ keys,
                                  long long n, int shift,
                                  int* __restrict__ hist, int tiles) {
  __shared__ int counts[kRadix];
  counts[threadIdx.x] = 0;
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long end = begin + kSortTile < n ? begin + kSortTile : n;
  for (long long i = begin + threadIdx.x; i < end; i += kThreads) {
    atomicAdd(&counts[(keys[i] >> shift) & (kRadix - 1)], 1);
  }
  __syncthreads();
  hist[static_cast<long long>(threadIdx.x) * tiles + blockIdx.x] =
      counts[threadIdx.x];
}

__global__ void radix_scatter_kernel(const uint64_t* __restrict__ kin,
                                     const int* __restrict__ vin,
                                     uint64_t* __restrict__ kout,
                                     int* __restrict__ vout, long long n,
                                     int shift,
                                     const int* __restrict__ offsets,
                                     int tiles) {
  __shared__ int base[kRadix];
  __shared__ int warp_counts[kWarps][kRadix];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  base[t] = offsets[static_cast<long long>(t) * tiles + blockIdx.x];
  for (int w = 0; w < kWarps; ++w) warp_counts[w][t] = 0;
  __syncthreads();
  const long long begin = static_cast<long long>(blockIdx.x) * kSortTile;
  const long long end = begin + kSortTile < n ? begin + kSortTile : n;
  const unsigned lower_lanes = (1u << lane) - 1u;
  for (long long start = begin; start < end; start += kThreads) {
    const long long i = start + t;
    const bool valid = i < end;
    uint64_t key = 0;
    int val = 0;
    int digit = kRadix;  // past every real digit: invalid lanes group apart
    if (valid) {
      key = kin[i];
      val = vin[i];
      digit = static_cast<int>((key >> shift) & (kRadix - 1));
    }
    const unsigned peers = __match_any_sync(kFull, digit);
    const int before = __popc(peers & lower_lanes);
    if (valid && before == 0) warp_counts[warp][digit] = __popc(peers);
    __syncthreads();
    // Thread t owns digit t: exclusive prefix of its count over the warps.
    int total = 0;
    for (int w = 0; w < kWarps; ++w) {
      int c = warp_counts[w][t];
      warp_counts[w][t] = total;
      total += c;
    }
    __syncthreads();
    if (valid) {
      const int dst = base[digit] + warp_counts[warp][digit] + before;
      kout[dst] = key;
      vout[dst] = val;
    }
    __syncthreads();
    base[t] += total;
    for (int w = 0; w < kWarps; ++w) warp_counts[w][t] = 0;
    __syncthreads();
  }
}

struct SortBufs {
  uint64_t* keys_alt;
  int* vals_alt;
  int* hist;
  int* scan;
};

SortBufs carve_sort(Arena& a, long long n) {
  const long long tiles = cdiv(n, kSortTile);
  SortBufs s;
  s.keys_alt = a.take<uint64_t>(n);
  s.vals_alt = a.take<int>(n);
  s.hist = a.take<int>(kRadix * tiles);
  s.scan = a.take<int>(scan_scratch_elems(kRadix * tiles));
  return s;
}

// Sorts (keys, vals)[0, n) by the low key_bits bits of the keys; the
// result is in keys / vals.
void radix_sort_pairs(uint64_t* keys, int* vals, long long n, int key_bits,
                      const SortBufs& s, cudaStream_t st) {
  if (n <= 1 || key_bits <= 0) return;
  const int tiles = static_cast<int>(cdiv(n, kSortTile));
  uint64_t* kin = keys;
  int* vin = vals;
  uint64_t* kout = s.keys_alt;
  int* vout = s.vals_alt;
  for (int shift = 0; shift < key_bits; shift += kRadixBits) {
    radix_hist_kernel<<<tiles, kThreads, 0, st>>>(kin, n, shift, s.hist,
                                                  tiles);
    scan_levels<SumOp>(s.hist, s.hist, static_cast<long long>(kRadix) * tiles,
                       true, s.scan, st);
    radix_scatter_kernel<<<tiles, kThreads, 0, st>>>(kin, vin, kout, vout, n,
                                                     shift, s.hist, tiles);
    uint64_t* kt = kin; kin = kout; kout = kt;
    int* vt = vin; vin = vout; vout = vt;
  }
  if (kin != keys) {
    cudaMemcpyAsync(keys, kin, sizeof(uint64_t) * n, cudaMemcpyDeviceToDevice,
                    st);
    cudaMemcpyAsync(vals, vin, sizeof(int) * n, cudaMemcpyDeviceToDevice, st);
  }
}

// ---------------------------------------------------------------------------
// B16, the store pass of an LSD radix sort on its own: out[dests[i]] =
// values[i].  Replaces pallas_scatter (benchmarks/pallas_sort_bench.py),
// which stored one element at a time from VMEM tiles of 8192 and never
// lowered.  One thread an element: the reads of values and dests coalesce,
// the 4-byte stores land wherever dests sends them, so a random
// permutation costs a 32-byte sector for each 4 bytes written.  Bound by
// memory: 12 bytes an element.  The dests must be distinct and inside out
// (a permutation in the benchmark); that is the caller's contract and is
// not checked here.
// ---------------------------------------------------------------------------
__global__ void scatter_kernel(const int* __restrict__ values,
                               const int* __restrict__ dests, long long n,
                               int* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[dests[i]] = values[i];
  }
}

// ---------------------------------------------------------------------------
// B1, the anchored init sort.  Replaces _init_round_anchored_ranked
// (pysubstringsearch_tpu/ops/suffix_array.py), which sorts two int32 limbs
// of D = 30 / bits rank digits with lax.sort.
//
// key[p] = the 2D rank digits of text[p .. p+2D-1] packed big-endian, 0 for
// a digit at or past n (so exactly limb0 << 30 | limb1, 60 bits), value p;
// the pairs are radix-sorted (8 passes); pad slots i < N - n hold
// N - 1 - i and every slot up to N - n starts a group, as in the JAX
// function; gs is the max-scan of the group-start slots and rank[sa[i]] =
// gs[i].  Bound by memory: the sort is about 8 x 32 bytes per slot, the
// rest a few passes of 4-12 bytes.
// ---------------------------------------------------------------------------
__global__ void init_keys_kernel(const uint8_t* __restrict__ text,
                                 long long N, long long n,
                                 const int* __restrict__ rank, int bits,
                                 uint64_t* __restrict__ keys,
                                 int* __restrict__ vals) {
  __shared__ int srank[256];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) srank[i] = rank[i];
  __syncthreads();
  const int width = 2 * (30 / bits);
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < N; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint64_t key = 0;
    if (p < n) {
      for (int d = 0; d < width; ++d) {
        long long q = p + d;
        uint64_t digit = q < n ? static_cast<uint64_t>(srank[text[q]]) : 0;
        key = (key << bits) | digit;
      }
    }
    keys[p] = key;
    vals[p] = static_cast<int>(p);
  }
}

// ---------------------------------------------------------------------------
// B1b, the 6-byte anchored init sort.  Replaces _init_round_anchored
// (pysubstringsearch_tpu/ops/suffix_array.py, reached through
// _segmented_kernel and _derive_sa_seg_jit), which sorts the pair (limb0,
// limb1) of three base-257 digits each with a 2-key lax.sort.
//
// Digit q of position p is text[p + q] + 1, or 0 at or past n, so a NUL
// byte stays above the past-end digit and the digit kind can reuse it.
// key[p] = limb0 << 25 | limb1: 257^3 < 2^25, so the pair is one 50-bit key
// that sorts as the JAX pair does, and the radix sort runs 7 passes (B1's
// 60-bit key takes 8).  The rest is B1's pipeline unchanged: the forced pad
// singletons, the group-start max-scan and the rank scatter.  Bound by
// memory like B1: the sort moves about 7 x 32 bytes per slot; the key pass
// reads 1 byte a slot (the 5 neighbours come from L1) and writes 12.
//
// Every digit read is masked at q < n, so the pad positions are exactly the
// all-zero key group for any 0 <= n <= N; the derive path's 6-byte margin
// is its own contract, not this kernel's (B10 runs it on rows without one).
// ---------------------------------------------------------------------------
constexpr int kByteKeyBits = 50;

// key[p] of the first kWidth digits (3 or 6): limb0 alone for 3, limb0 <<
// 25 | limb1 for 6.  A template, so the digit loop unrolls and the limbs
// stay in registers.
template <int kWidth>
__global__ void init_keys_bytes_kernel(const uint8_t* __restrict__ text,
                                       long long N, long long n,
                                       uint64_t* __restrict__ keys,
                                       int* __restrict__ vals) {
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       p < N; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint64_t limb[2] = {0, 0};
    if (p < n) {
#pragma unroll
      for (int d = 0; d < kWidth; ++d) {
        long long q = p + d;
        uint64_t digit = q < n ? static_cast<uint64_t>(text[q]) + 1 : 0;
        limb[d / 3] = limb[d / 3] * 257 + digit;
      }
    }
    keys[p] = kWidth > 3 ? (limb[0] << 25) | limb[1] : limb[0];
    vals[p] = static_cast<int>(p);
  }
}

__global__ void init_groups_kernel(const uint64_t* __restrict__ keys,
                                   const int* __restrict__ idx, long long N,
                                   long long npad, int* __restrict__ sa,
                                   int* __restrict__ starts) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    sa[i] = i < npad ? static_cast<int>(N - 1 - i) : idx[i];
    const bool changed = i <= npad || keys[i] != keys[i - 1];
    starts[i] = changed ? static_cast<int>(i) : 0;
  }
}

__global__ void scatter_rank_kernel(const int* __restrict__ sa,
                                    const int* __restrict__ gs, long long N,
                                    int* __restrict__ rank) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    rank[sa[i]] = gs[i];
  }
}

struct InitBufs {
  uint64_t* keys;
  int* vals;
  SortBufs sort;
  int* starts;
  int* scan;
};

InitBufs carve_init(Arena& a, long long N) {
  InitBufs b;
  b.keys = a.take<uint64_t>(N);
  b.vals = a.take<int>(N);
  b.sort = carve_sort(a, N);
  b.starts = a.take<int>(N);
  b.scan = a.take<int>(scan_scratch_elems(N));
  return b;
}

// The anchored init from (key, position) pairs already in b.keys / b.vals
// (B1 and B1b differ only in their keys): sort, group starts with the pad
// singletons forced, max-scan into gs, rank[sa[i]] = gs[i].
void init_from_keys(const InitBufs& b, long long N, long long n,
                    int key_bits, int* sa, int* rank, int* gs,
                    cudaStream_t st) {
  const unsigned grid = grid_for(N);
  radix_sort_pairs(b.keys, b.vals, N, key_bits, b.sort, st);
  init_groups_kernel<<<grid, kThreads, 0, st>>>(b.keys, b.vals, N, N - n, sa,
                                                b.starts);
  scan_levels<MaxOp>(b.starts, gs, N, false, b.scan, st);
  scatter_rank_kernel<<<grid, kThreads, 0, st>>>(sa, gs, N, rank);
}

// ---------------------------------------------------------------------------
// B2, one tie-only doubling round.  Replaces the body of _segmented_loop
// with _tied_flags and _relabel_and_scatter (ops/suffix_array.py).
//
// pss_sa_tie_scan flags every slot whose group has two or more members and
// scans the flags into each tied slot's buffer index; dest[N] is the tie
// count m, which the host reads once.  pss_sa_refine_round then, for
// exactly those m slots, in slot order:
//   - gathers pos = sa[slot], g = gs[slot], r2 = rank[pos + k] or -1 past
//     the row, and keys them (g << W) | (r2 + 1) with 2^W > N;
//   - radix-sorts (key, pos) on 2W bits;
//   - relabels: tied groups are whole and contiguous in both slot and
//     buffer order and the sort keeps them in g order, so buffer element b
//     belongs at the b-th tied slot itself; its new label is the slot of
//     the first element with its key (a max-scan of the key-change slots);
//   - scatters sa, rank and gs back.
// The JAX loop caps the buffer at N/8 and falls back to a full-size sort
// through lax.cond, because XLA allocates the larger branch statically;
// here the buffer is sized from m each round, so one branch serves both.
// Bound by memory: a round reads gs, flags and dest over the whole row
// (12 bytes a slot) and moves about 8 x 32 + 40 bytes per tied slot.
// ---------------------------------------------------------------------------
__global__ void tie_flags_kernel(const int* __restrict__ gs, long long N,
                                 int* __restrict__ flags) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = gs[i];
    const bool tied =
        (i + 1 < N && gs[i + 1] == g) || (i > 0 && gs[i - 1] == g);
    flags[i] = tied ? 1 : 0;
  }
}

__global__ void refine_gather_kernel(const int* __restrict__ flags,
                                     const int* __restrict__ dest,
                                     const int* __restrict__ sa,
                                     const int* __restrict__ rank,
                                     const int* __restrict__ gs, long long N,
                                     long long k, int W,
                                     int* __restrict__ slots,
                                     uint64_t* __restrict__ keys,
                                     int* __restrict__ vals) {
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < N; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!flags[s]) continue;
    const int b = dest[s];
    const long long pos = sa[s];
    const long long q = pos + k;
    const long long r2 = q < N ? rank[q] : -1;
    slots[b] = static_cast<int>(s);
    keys[b] = (static_cast<uint64_t>(static_cast<unsigned>(gs[s])) << W) |
              static_cast<uint64_t>(r2 + 1);
    vals[b] = static_cast<int>(pos);
  }
}

__global__ void refine_change_kernel(const uint64_t* __restrict__ keys,
                                     const int* __restrict__ slots,
                                     long long m, int* __restrict__ starts) {
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       b < m; b += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool change = b == 0 || keys[b] != keys[b - 1];
    starts[b] = change ? slots[b] : 0;
  }
}

__global__ void refine_scatter_kernel(const int* __restrict__ slots,
                                      const int* __restrict__ vals,
                                      const int* __restrict__ first_eq,
                                      long long m, int* __restrict__ sa,
                                      int* __restrict__ rank,
                                      int* __restrict__ gs) {
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       b < m; b += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int s = slots[b];
    const int p = vals[b];
    const int f = first_eq[b];
    sa[s] = p;
    rank[p] = f;
    gs[s] = f;
  }
}

struct RefineBufs {
  int* slots;
  uint64_t* keys;
  int* vals;
  SortBufs sort;
  int* starts;
  int* first_eq;
  int* scan;
};

RefineBufs carve_refine(Arena& a, long long m) {
  RefineBufs b;
  b.slots = a.take<int>(m);
  b.keys = a.take<uint64_t>(m);
  b.vals = a.take<int>(m);
  b.sort = carve_sort(a, m);
  b.starts = a.take<int>(m);
  b.first_eq = a.take<int>(m);
  b.scan = a.take<int>(scan_scratch_elems(m));
  return b;
}

// Bits W with 2^W > N: group starts and r2 + 1 both fit in W bits.
int key_width(long long N) {
  int w = 1;
  while ((1LL << w) <= N) ++w;
  return w;
}

// B2's refine body on the m slots that `flags` marks (dest their buffer
// indices): gather, radix sort on 2W bits, key-change starts, max-scan,
// scatter.  Each marked group must be a contiguous run of slots, marked
// from its first slot on.
void refine_marked(int* sa, int* rank, int* gs, long long N, long long k,
                   long long m, const int* flags, const int* dest,
                   const RefineBufs& b, cudaStream_t st) {
  const int W = key_width(N);
  refine_gather_kernel<<<grid_for(N), kThreads, 0, st>>>(
      flags, dest, sa, rank, gs, N, k, W, b.slots, b.keys, b.vals);
  radix_sort_pairs(b.keys, b.vals, m, 2 * W, b.sort, st);
  const unsigned grid = grid_for(m);
  refine_change_kernel<<<grid, kThreads, 0, st>>>(b.keys, b.slots, m,
                                                  b.starts);
  scan_levels<MaxOp>(b.starts, b.first_eq, m, false, b.scan, st);
  refine_scatter_kernel<<<grid, kThreads, 0, st>>>(b.slots, b.vals,
                                                   b.first_eq, m, sa, rank,
                                                   gs);
}

// ---------------------------------------------------------------------------
// B10, the rotating windowed doubler of rows over 384 Mi padded.  Replaces
// _init_round_anchored3, _rotating_init, _rotating_pass and the loop of
// _rotating_steps_jit / segmented_rotating_sa (ops/suffix_array.py), which
// the JAX derive_sa picks for those rows so that no sort exceeds S = N / 8
// elements (S/2 = half, W = the window of group starts, S/2).
//
// pss_sa_init3_bytes is B1b's pipeline on a 3-digit key (d0 * 257 + d1) *
// 257 + d2 < 2^25, so 4 radix passes.  One JAX pass is two launches that
// share a device control block ctl int32 [5] = {off, m_w, poisoned,
// any_tied, nxt}:
//   - pss_sa_window_scan marks the window at ctl[0]: every tied slot whose
//     group start g lies in [off, off + W) and whose member offset slot - g
//     is below half (so whole groups of at most half members, whose slots
//     the pass refines in place as B2 does).  flags, dest (their exclusive
//     scan) and ctl[1] = m_w; ctl[2] = 1 when some tied slot has a member
//     offset of half or more (a group too big for any window: the row is
//     poisoned, and its caller falls back to B9); ctl[3] = 1 when any slot
//     is tied.
//   - pss_sa_rotating_pass refines the m_w marked slots by the rank k
//     positions on (B2's body), then jumps: nxt = the least slot >= off + W
//     that starts a tied group (N if none, or if off + W >= N) -> ctl[4],
//     and ctl[0] = nxt < N ? nxt : 0.  The JAX pass samples a reverse
//     cummin at off + W; a min-reduction over [off + W, N) is the same.
// The host keeps k, reads ctl once a pass after the next window's scan,
// doubles k when ctl[0] is back at 0, and stops when k >= N at off 0, when
// nothing is tied, or at the first poisoned window.  Windows are swept in
// the JAX order, so earlier windows refine later windows' r2 alike.
// Bound by memory: a scan reads gs over the row and writes flags and dest
// (12 bytes a slot with the scan's levels); a pass moves B2's 8 x 32 + 40
// bytes per marked slot and reads gs from off + W on.
// ---------------------------------------------------------------------------
constexpr int kByte3KeyBits = 25;
enum { kCtlOff = 0, kCtlMw, kCtlPoisoned, kCtlAnyTied, kCtlNext, kCtlSize };

// flags[i] of the window at ctl[kCtlOff]; ctl[kCtlPoisoned] and
// ctl[kCtlAnyTied] must be 0 before the launch.
__global__ void window_flags_kernel(const int* __restrict__ gs, long long N,
                                    long long half, long long W,
                                    int* __restrict__ ctl,
                                    int* __restrict__ flags) {
  __shared__ int s_any, s_poisoned;
  if (threadIdx.x == 0) {
    s_any = 0;
    s_poisoned = 0;
  }
  __syncthreads();
  const long long off = ctl[kCtlOff];
  bool any = false, poisoned = false;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = gs[i];
    const bool tied =
        (i + 1 < N && gs[i + 1] == g) || (i > 0 && gs[i - 1] == g);
    bool sel = false;
    if (tied) {
      any = true;
      if (i - g >= half) {
        poisoned = true;
      } else {
        sel = g >= off && g < off + W;
      }
    }
    flags[i] = sel ? 1 : 0;
  }
  if (any) s_any = 1;
  if (poisoned) s_poisoned = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_any) ctl[kCtlAnyTied] = 1;
    if (s_poisoned) ctl[kCtlPoisoned] = 1;
  }
}

__global__ void window_total_kernel(const int* __restrict__ dest,
                                    long long N, int* __restrict__ ctl) {
  ctl[kCtlMw] = dest[N];
}

__global__ void next_init_kernel(long long N, int* __restrict__ ctl) {
  ctl[kCtlNext] = static_cast<int>(N);
}

// ctl[kCtlNext] = min(ctl[kCtlNext], the least slot >= off + W that starts
// a tied group).  A thread's first hit in its grid-stride walk is its least.
__global__ void next_start_kernel(const int* __restrict__ gs, long long N,
                                  long long W, int* __restrict__ ctl) {
  __shared__ int s_min;
  if (threadIdx.x == 0) s_min = INT_MAX;
  __syncthreads();
  const long long lo = static_cast<long long>(ctl[kCtlOff]) + W;
  for (long long i = lo + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int g = gs[i];
    const bool start = i == 0 || gs[i - 1] != g;
    const bool tied =
        (i + 1 < N && gs[i + 1] == g) || (i > 0 && gs[i - 1] == g);
    if (start && tied) {
      atomicMin(&s_min, static_cast<int>(i));
      break;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && s_min != INT_MAX) atomicMin(&ctl[kCtlNext], s_min);
}

__global__ void next_finish_kernel(long long N, int* __restrict__ ctl) {
  const int nxt = ctl[kCtlNext];
  ctl[kCtlOff] = nxt < N ? nxt : 0;
}

// ---------------------------------------------------------------------------
// B9, full-sort prefix doubling.  Replaces _doubling_kernel with _init_round
// and _doubling_round, and _int_doubling_kernel (ops/suffix_array.py),
// reached through suffix_array_jax(algorithm='full'), derive_sa_full_jit
// and suffix_array_int(backend='jax').
//
// Unlike B2, every round sorts all N positions:
//   - the byte init keys every position on B1b's 6 digits (byte + 1, 0 at
//     or past n; init_keys_bytes_kernel), the integer form starts from the
//     caller's ranks (value + 1, pad 0);
//   - a round keys position i as rank[i] << W | (rank[i + k] + 1), 0 past
//     the row, with 2^W above every rank and N, and radix-sorts (key, i) on
//     2W bits;
//   - the relabel gives the sorted positions dense ranks: a key-change flag
//     per slot, an inclusive sum scan of the flags, then sa[i] = pos and
//     rank[pos] = label; count = the last label + 1, which the host reads to
//     stop once every rank is distinct.
// The JAX sort is unstable and this one stable, so a round's sa may order a
// tie group differently; the dense ranks and the finished SA (every rank
// distinct) are the same.  Bound by memory: a round's sort moves about
// 2W / 8 x 24 bytes per slot (8 passes at W = 31), the key and relabel
// passes 12 and 16 bytes.
// ---------------------------------------------------------------------------
__global__ void full_keys_kernel(const int* __restrict__ rank, long long N,
                                 long long k, int W,
                                 uint64_t* __restrict__ keys,
                                 int* __restrict__ vals) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long q = i + k;
    const uint64_t r2 =
        q < N ? static_cast<uint64_t>(static_cast<unsigned>(rank[q])) + 1 : 0;
    keys[i] = (static_cast<uint64_t>(static_cast<unsigned>(rank[i])) << W) |
              r2;
    vals[i] = static_cast<int>(i);
  }
}

__global__ void full_flags_kernel(const uint64_t* __restrict__ keys,
                                  long long N, int* __restrict__ flags) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    flags[i] = (i > 0 && keys[i] != keys[i - 1]) ? 1 : 0;
  }
}

__global__ void full_relabel_kernel(const int* __restrict__ vals,
                                    const int* __restrict__ labels,
                                    long long N, int* __restrict__ sa,
                                    int* __restrict__ rank,
                                    int* __restrict__ count) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = vals[i];
    const int l = labels[i];
    sa[i] = p;
    rank[p] = l;
    if (i == N - 1) *count = l + 1;
  }
}

struct FullBufs {
  uint64_t* keys;
  int* vals;
  SortBufs sort;
  int* labels;
  int* scan;
};

FullBufs carve_full(Arena& a, long long N) {
  FullBufs b;
  b.keys = a.take<uint64_t>(N);
  b.vals = a.take<int>(N);
  b.sort = carve_sort(a, N);
  b.labels = a.take<int>(N);
  b.scan = a.take<int>(scan_scratch_elems(N));
  return b;
}

// Sort the (key, position) pairs in b, then relabel: sa, rank and count.
void full_relabel(const FullBufs& b, long long N, int key_bits, int* sa,
                  int* rank, int* count, cudaStream_t st) {
  const unsigned grid = grid_for(N);
  radix_sort_pairs(b.keys, b.vals, N, key_bits, b.sort, st);
  full_flags_kernel<<<grid, kThreads, 0, st>>>(b.keys, N, b.labels);
  scan_levels<SumOp>(b.labels, b.labels, N, false, b.scan, st);
  full_relabel_kernel<<<grid, kThreads, 0, st>>>(b.vals, b.labels, N, sa,
                                                 rank, count);
}

// The SA rolled to the front, as _derive_sa_seg_ranked_jit returns it
// (jnp.roll(sa_full, n - N)): out[j] = sa_full[(j + N - n) mod N].  A copy
// kernel, bound by memory (8 bytes a slot), that writes straight into the
// caller's row of the stacked index.
__global__ void roll_front_kernel(const int* __restrict__ src, long long N,
                                  long long n, int* __restrict__ out) {
  for (long long j = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       j < N; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    long long s = j + (N - n);
    if (s >= N) s -= N;
    out[j] = src[s];
  }
}

}  // namespace

extern "C" {

// ---- building blocks ------------------------------------------------------

long long pss_scan_scratch_bytes(long long n) {
  Arena a{nullptr, 0};
  a.take<int>(scan_scratch_elems(n));
  return static_cast<long long>(a.off);
}

// out int32 [n + 1]: out[i] = sum of in[0, i), out[n] = the total.
int pss_scan_exclusive_sum(const void* in, void* out, long long n,
                           void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  scan_levels<SumOp>(static_cast<const int*>(in), static_cast<int*>(out), n,
                     true, static_cast<int*>(scratch), st);
  scan_total_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(in),
                                     static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// out int32 [n]: out[i] = max of in[0, i].
int pss_scan_inclusive_max(const void* in, void* out, long long n,
                           void* scratch, void* stream) {
  scan_levels<MaxOp>(static_cast<const int*>(in), static_cast<int*>(out), n,
                     false, static_cast<int*>(scratch),
                     static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

long long pss_radix_sort_scratch_bytes(long long n) {
  Arena a{nullptr, 0};
  carve_sort(a, n);
  return static_cast<long long>(a.off);
}

// Sorts keys uint64 [n] with vals int32 [n] in place, stably, by the low
// key_bits bits of the keys.
int pss_radix_sort_pairs(void* keys, void* vals, long long n, int key_bits,
                         void* scratch, void* stream) {
  Arena a{static_cast<char*>(scratch), 0};
  SortBufs s = carve_sort(a, n);
  radix_sort_pairs(static_cast<uint64_t*>(keys), static_cast<int*>(vals), n,
                   key_bits, s, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// ---- B1 -------------------------------------------------------------------

long long pss_sa_init_scratch_bytes(long long N) {
  Arena a{nullptr, 0};
  carve_init(a, N);
  return static_cast<long long>(a.off);
}

// text uint8 [N] (true length n, n + 30/bits <= N), rank_map int32 [256];
// writes sa, rank, gs int32 [N].
int pss_sa_init_ranked(const void* text, long long N, long long n,
                       const void* rank_map, int bits, void* sa, void* rank,
                       void* gs, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  InitBufs b = carve_init(a, N);
  init_keys_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(text), N, n,
      static_cast<const int*>(rank_map), bits, b.keys, b.vals);
  init_from_keys(b, N, n, 2 * (30 / bits) * bits, static_cast<int*>(sa),
                 static_cast<int*>(rank), static_cast<int*>(gs), st);
  return static_cast<int>(cudaGetLastError());
}

// ---- B1b ------------------------------------------------------------------

// text uint8 [N] (true length n, n + 6 <= N); writes sa, rank, gs int32
// [N].  Scratch as pss_sa_init_scratch_bytes(N).
int pss_sa_init_bytes(const void* text, long long N, long long n, void* sa,
                      void* rank, void* gs, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  InitBufs b = carve_init(a, N);
  init_keys_bytes_kernel<6><<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(text), N, n, b.keys, b.vals);
  init_from_keys(b, N, n, kByteKeyBits, static_cast<int*>(sa),
                 static_cast<int*>(rank), static_cast<int*>(gs), st);
  return static_cast<int>(cudaGetLastError());
}

// ---- B2 -------------------------------------------------------------------

long long pss_sa_tie_scratch_bytes(long long N) {
  return pss_scan_scratch_bytes(N);
}

// flags int32 [N], dest int32 [N + 1]; dest[N] = the tie count m.
int pss_sa_tie_scan(const void* gs, long long N, void* flags, void* dest,
                    void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  tie_flags_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(gs), N, static_cast<int*>(flags));
  return pss_scan_exclusive_sum(flags, dest, N, scratch, stream);
}

long long pss_sa_refine_scratch_bytes(long long m) {
  Arena a{nullptr, 0};
  carve_refine(a, m);
  return static_cast<long long>(a.off);
}

// Refines the m tied slots (flags and dest from pss_sa_tie_scan) by the
// rank k positions on; sa, rank, gs int32 [N] are updated in place.
int pss_sa_refine_round(void* sa, void* rank, void* gs, long long N,
                        long long k, long long m, const void* flags,
                        const void* dest, void* scratch, void* stream) {
  if (m <= 0) return 0;
  Arena a{static_cast<char*>(scratch), 0};
  RefineBufs b = carve_refine(a, m);
  refine_marked(static_cast<int*>(sa), static_cast<int*>(rank),
                static_cast<int*>(gs), N, k, m,
                static_cast<const int*>(flags), static_cast<const int*>(dest),
                b, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

// ---- B9 -------------------------------------------------------------------

long long pss_sa_full_scratch_bytes(long long N) {
  Arena a{nullptr, 0};
  carve_full(a, N);
  return static_cast<long long>(a.off);
}

// text uint8 [N] (true length n <= N); writes sa, rank int32 [N] of the
// 6-byte init and count int32 [1], the number of distinct ranks.
int pss_sa_full_init_bytes(const void* text, long long N, long long n,
                           void* sa, void* rank, void* count, void* scratch,
                           void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  FullBufs b = carve_full(a, N);
  init_keys_bytes_kernel<6><<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(text), N, n, b.keys, b.vals);
  full_relabel(b, N, kByteKeyBits, static_cast<int*>(sa),
               static_cast<int*>(rank), static_cast<int*>(count), st);
  return static_cast<int>(cudaGetLastError());
}

// One full round at offset k on sa, rank int32 [N] in place (every rank
// below 2^W, 2^W > N); count int32 [1] gets the number of distinct ranks.
int pss_sa_full_round(void* sa, void* rank, long long N, long long k, int W,
                      void* count, void* scratch, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || W > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  FullBufs b = carve_full(a, N);
  full_keys_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(rank), N, k, W, b.keys, b.vals);
  full_relabel(b, N, 2 * W, static_cast<int*>(sa), static_cast<int*>(rank),
               static_cast<int*>(count), st);
  return static_cast<int>(cudaGetLastError());
}

// ---- B10 ------------------------------------------------------------------

// text uint8 [N] (true length 0 <= n <= N); writes sa, rank, gs int32 [N]
// of the 3-byte anchored init.  Scratch as pss_sa_init_scratch_bytes(N).
int pss_sa_init3_bytes(const void* text, long long N, long long n, void* sa,
                       void* rank, void* gs, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  InitBufs b = carve_init(a, N);
  init_keys_bytes_kernel<3><<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(text), N, n, b.keys, b.vals);
  init_from_keys(b, N, n, kByte3KeyBits, static_cast<int*>(sa),
                 static_cast<int*>(rank), static_cast<int*>(gs), st);
  return static_cast<int>(cudaGetLastError());
}

// Marks the window at ctl[0] (see the B10 section): flags int32 [N], dest
// int32 [N + 1] (dest[N] = m_w), ctl int32 [5].  Scratch as
// pss_sa_tie_scratch_bytes(N).
int pss_sa_window_scan(const void* gs, long long N, long long half,
                       long long W, void* ctl, void* flags, void* dest,
                       void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(ctl);
  cudaMemsetAsync(c + kCtlPoisoned, 0, 2 * sizeof(int), st);
  window_flags_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(gs), N, half, W, c, static_cast<int*>(flags));
  scan_levels<SumOp>(static_cast<const int*>(flags), static_cast<int*>(dest),
                     N, true, static_cast<int*>(scratch), st);
  scan_total_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(flags),
                                     static_cast<int*>(dest), N);
  window_total_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(dest), N, c);
  return static_cast<int>(cudaGetLastError());
}

// Refines the m marked slots of the last window scan by the rank k
// positions on, in place, then moves ctl[0] to the next window.  Scratch as
// pss_sa_refine_scratch_bytes(m).
int pss_sa_rotating_pass(void* sa, void* rank, void* gs, long long N,
                         long long k, long long m, long long W,
                         const void* flags, const void* dest, void* ctl,
                         void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(ctl);
  if (m > 0) {
    Arena a{static_cast<char*>(scratch), 0};
    RefineBufs b = carve_refine(a, m);
    refine_marked(static_cast<int*>(sa), static_cast<int*>(rank),
                  static_cast<int*>(gs), N, k, m,
                  static_cast<const int*>(flags),
                  static_cast<const int*>(dest), b, st);
  }
  next_init_kernel<<<1, 1, 0, st>>>(N, c);
  next_start_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(gs), N, W, c);
  next_finish_kernel<<<1, 1, 0, st>>>(N, c);
  return static_cast<int>(cudaGetLastError());
}

// ---- B16 ------------------------------------------------------------------

// out[dests[i]] = values[i] for i < n (dests distinct, inside out).
int pss_scatter(const void* values, const void* dests, long long n, void* out,
                void* stream) {
  if (n <= 0) return 0;
  scatter_kernel<<<grid_for(n), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(values), static_cast<const int*>(dests), n,
      static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// out int32 [N] = the anchored sa_full [N] rolled so that slots [0, n) hold
// the SA of the text and the tail holds N - 1, ..., n.
int pss_sa_roll_front(const void* sa_full, long long N, long long n,
                      void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  roll_front_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(sa_full), N, n, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
