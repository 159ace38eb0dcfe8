// Hand-written Hopper kernels of the device suffix-array build (derive
// mode): the anchored init sorts (B1 on rank digits, B1b on bytes), the
// tie-only doubling rounds (B2), the rotating windowed doubler of rows over
// 384 Mi (B10), the full-sort doubling of the Writer's 'full' build, of
// integer alphabets and of B10's poisoned rows (B9), and the building
// blocks they are made of -- a stable one-sweep LSD radix sort of (uint64
// key, int32 value) pairs, an exclusive sum scan and an inclusive max scan
// over int32 -- with the radix sort's store pass alone as a scatter (B16).
// No library computes any of them: no cub::Device* routine, no Thrust, no
// torch operator.
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

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One tile per block; in == out is allowed (each thread reads its own
// items before any write).  sums, when not null, gets each block's total.
// A thread's 8 items are two 16-byte loads and stores where both buffers
// are aligned (vec), so a warp moves 1 KB at a time.
template <class Op>
__global__ void scan_tile_kernel(const int* in, int* out, long long n,
                                 int* sums, int exclusive, int vec) {
  const long long base =
      static_cast<long long>(blockIdx.x) * kScanTile +
      static_cast<long long>(threadIdx.x) * kScanItems;
  const bool whole = vec && base + kScanItems <= n;
  int v[kScanItems];
  if (whole) {
    const int4 a = *reinterpret_cast<const int4*>(in + base);
    const int4 b = *reinterpret_cast<const int4*>(in + base + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
    for (int j = 0; j < kScanItems; ++j) {
      const long long i = base + j;
      v[j] = i < n ? in[i] : Op::identity();
    }
  }
  int acc = Op::identity();
  for (int j = 0; j < kScanItems; ++j) acc = Op::apply(acc, v[j]);
  int total;
  int run = block_exclusive_scan<Op>(acc, &total);
  for (int j = 0; j < kScanItems; ++j) {
    const int next = Op::apply(run, v[j]);
    v[j] = exclusive ? run : next;
    run = next;
  }
  if (whole) {
    *reinterpret_cast<int4*>(out + base) = make_int4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<int4*>(out + base + 4) =
        make_int4(v[4], v[5], v[6], v[7]);
  } else {
    for (int j = 0; j < kScanItems; ++j) {
      if (base + j < n) out[base + j] = v[j];
    }
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
  const int vec = aligned16(in) && aligned16(out) ? 1 : 0;
  if (nb == 1) {
    scan_tile_kernel<Op><<<1, kThreads, 0, st>>>(in, out, n, nullptr,
                                                 exclusive ? 1 : 0, vec);
    return;
  }
  int* sums = scratch;
  scan_tile_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      in, out, n, sums, exclusive ? 1 : 0, vec);
  scan_levels<Op>(sums, sums, nb, true, scratch + nb, st);
  scan_add_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      out, n, sums);
}

// out[n] = the total of an exclusive sum scan of in[0, n).
__global__ void scan_total_kernel(const int* in, int* out, long long n) {
  out[n] = n > 0 ? out[n - 1] + in[n - 1] : 0;
}

// ---------------------------------------------------------------------------
// Stable LSD radix sort of (uint64 key, int32 value) pairs, 8 bits a digit
// pass, only as many passes as the key's bit width needs: a one-sweep sort
// after Adinets and Merrill, "Onesweep: A Faster Least Significant Digit
// Radix Sort for GPUs" (2022), written here without CUB.
//   1. onesweep_hist_kernel reads the keys once and counts every pass's
//      digits: shared-memory counts (a thread merges runs of one digit
//      into one atomic, so keys whose high digits are all equal do not
//      serialise on one counter), then global atomics.
//      onesweep_bins_kernel scans each pass's 256 counts into the first
//      output slot of every digit.
//   2. onesweep_pass_kernel, one launch a pass.  A block takes the next
//      tile of kSortTile pairs from the pass's atomic counter, so every
//      earlier tile already runs on some SM and the look-back below cannot
//      wait on a block that was never scheduled.  Each warp holds 16
//      groups of 32 consecutive pairs in registers (warp-striped), so
//      item j of lane l comes before item j of lane l + 1 and before item
//      j + 1 of every lane; ranking items j in order with
//      __match_any_sync, lanes with the same digit count up in lane
//      order: the rank is stable within the warp.  The per-warp counts
//      are scanned across warps (warp w's keys precede warp w + 1's), so
//      the tile's order is stable too.
//      Decoupled look-back: thread d publishes the tile's count of digit d
//      (an aggregate), then walks back over earlier tiles' words, summing
//      aggregates until it meets an inclusive prefix, and publishes its
//      own inclusive prefix.  A word is 64 bits: the value (below 2^31)
//      in the low half and a tag in the high half, 2 * pass + 1 for an
//      aggregate and 2 * pass + 2 for a prefix, so an earlier pass's word
//      reads as not yet published and the words are zeroed once a sort.
//      The tile is then staged in shared memory in digit order and
//      written out so that consecutive threads store consecutive slots of
//      one digit's run, keys first, then values through the same buffer.
// Every count, counter and status word lives in the caller's scratch and
// is zeroed on the caller's stream, so sorts on several streams or threads
// never share state.  Bound by memory: the histogram reads 8 bytes a pair,
// each pass reads and writes 12; the status words add 0.5 bytes a pair.
// ---------------------------------------------------------------------------
constexpr int kSortItems = 16;                    // pairs a thread holds
constexpr int kSortTile = kThreads * kSortItems;  // pairs a block sorts
constexpr int kWarpItems = 32 * kSortItems;
constexpr int kMaxPasses = 8;                     // 64 key bits
constexpr int kHistBlocks = 512;

__global__ void __launch_bounds__(kThreads)
onesweep_hist_kernel(const uint64_t* __restrict__ keys, long long n,
                     int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned counts[kMaxPasses][kRadix];
  for (int p = 0; p < kMaxPasses; ++p) counts[p][threadIdx.x] = 0;
  __syncthreads();
  for (long long base = static_cast<long long>(blockIdx.x) * kSortTile;
       base < n; base += static_cast<long long>(gridDim.x) * kSortTile) {
    uint64_t key[kSortItems];
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const long long i = base + r * kThreads + threadIdx.x;
      key[r] = i < n ? keys[i] : 0;
    }
    // Item r is in the row when r * kThreads < left.
    const long long left = n - base - threadIdx.x;
#pragma unroll
    for (int p = 0; p < kMaxPasses; ++p) {
      if (p >= passes) break;
      int prev = -1;
      unsigned run = 0;
#pragma unroll
      for (int r = 0; r < kSortItems; ++r) {
        if (r * kThreads >= left) break;
        const int d = static_cast<int>((key[r] >> (kRadixBits * p)) &
                                       (kRadix - 1));
        if (d != prev) {
          if (run) atomicAdd(&counts[p][prev], run);
          prev = d;
          run = 0;
        }
        ++run;
      }
      if (run) atomicAdd(&counts[p][prev], run);
    }
  }
  __syncthreads();
  for (int p = 0; p < passes; ++p) {
    const unsigned c = counts[p][threadIdx.x];
    if (c) atomicAdd(&hist[p * kRadix + threadIdx.x], c);
  }
}

// Block p turns pass p's 256 digit counts into their first output slots.
__global__ void onesweep_bins_kernel(unsigned* __restrict__ hist) {
  unsigned* h = hist + blockIdx.x * kRadix;
  int total;
  const int first =
      block_exclusive_scan<SumOp>(static_cast<int>(h[threadIdx.x]), &total);
  h[threadIdx.x] = static_cast<unsigned>(first);
}

__device__ __forceinline__ void status_store(unsigned long long* word,
                                             unsigned tag, unsigned value) {
  *reinterpret_cast<volatile unsigned long long*>(word) =
      (static_cast<unsigned long long>(tag) << 32) | value;
}

__global__ void __launch_bounds__(kThreads)
onesweep_pass_kernel(const uint64_t* __restrict__ kin,
                     const int* __restrict__ vin, uint64_t* __restrict__ kout,
                     int* __restrict__ vout, long long n, int pass,
                     const unsigned* __restrict__ bins,
                     unsigned long long* status, int* counter) {
  __shared__ int s_tile;
  __shared__ unsigned s_warp[kWarps][kRadix];  // per-warp counts, then offsets
  __shared__ int s_local[kRadix];  // staged index of each digit's first pair
  __shared__ int s_base[kRadix];   // its output slot minus that index
  __shared__ union {
    uint64_t keys[kSortTile];
    int vals[kSortTile];
  } s_stage;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_base = tile * kSortTile;
  const long long warp_base = tile_base + warp * kWarpItems + lane;
  const int shift = kRadixBits * pass;
  uint64_t key[kSortItems];
  int val[kSortItems];
  int slot[kSortItems];  // rank within the warp, then the staged index
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const long long i = warp_base + 32 * j;
    key[j] = i < n ? kin[i] : 0;
    val[j] = i < n ? vin[i] : 0;
  }
  const unsigned lower_lanes = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    const bool valid = warp_base + 32 * j < n;
    // Past the end: a digit of its own, never counted.
    const int d = valid ? static_cast<int>((key[j] >> shift) & (kRadix - 1))
                        : kRadix;
    const unsigned peers = __match_any_sync(kFull, d);
    const unsigned below = peers & lower_lanes;
    const unsigned before = valid ? s_warp[warp][d] : 0;
    __syncwarp();
    if (valid && below == 0) s_warp[warp][d] = before + __popc(peers);
    __syncwarp();
    slot[j] = static_cast<int>(before) + __popc(below);
  }
  __syncthreads();
  // Thread t owns digit t: its per-warp counts become per-warp offsets.
  unsigned count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][t];
    s_warp[w][t] = count;
    count += c;
  }
  unsigned long long* mine = status + tile * kRadix + t;
  const unsigned tag_agg = 2 * pass + 1;
  const unsigned tag_prefix = 2 * pass + 2;
  status_store(mine, tile == 0 ? tag_prefix : tag_agg,
               tile == 0 ? bins[t] + count : count);
  int tile_total;
  const int local = block_exclusive_scan<SumOp>(static_cast<int>(count),
                                                &tile_total);
  unsigned first = bins[t];
  if (tile > 0) {
    first = 0;
    for (long long p = tile - 1;; --p) {
      const volatile unsigned long long* w =
          reinterpret_cast<const volatile unsigned long long*>(
              status + p * kRadix + t);
      unsigned long long word;
      do {
        word = *w;
      } while (static_cast<unsigned>(word >> 32) < tag_agg);
      first += static_cast<unsigned>(word);
      if (static_cast<unsigned>(word >> 32) == tag_prefix) break;
    }
    status_store(mine, tag_prefix, first + count);
  }
  s_local[t] = local;
  s_base[t] = static_cast<int>(first) - local;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (warp_base + 32 * j < n) {
      const int d = static_cast<int>((key[j] >> shift) & (kRadix - 1));
      slot[j] += s_local[d] + static_cast<int>(s_warp[warp][d]);
      s_stage.keys[slot[j]] = key[j];
    }
  }
  __syncthreads();
  const long long rest = n - tile_base;
  const int valid_count = rest < kSortTile ? static_cast<int>(rest)
                                           : kSortTile;
  int dst[kSortItems];
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int i = r * kThreads + t;
    if (i < valid_count) {
      const uint64_t k = s_stage.keys[i];
      dst[r] = s_base[(k >> shift) & (kRadix - 1)] + i;
      kout[dst[r]] = k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kSortItems; ++j) {
    if (warp_base + 32 * j < n) s_stage.vals[slot[j]] = val[j];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kSortItems; ++r) {
    const int i = r * kThreads + t;
    if (i < valid_count) vout[dst[r]] = s_stage.vals[i];
  }
}

struct SortBufs {
  uint64_t* keys_alt;
  int* vals_alt;
  unsigned long long* status;  // [tiles][kRadix]
  unsigned* hist;              // [kMaxPasses][kRadix], then the counters
};

constexpr int kSortCounters = kMaxPasses * kRadix + kMaxPasses;

SortBufs carve_sort(Arena& a, long long n) {
  SortBufs s;
  s.keys_alt = a.take<uint64_t>(n);
  s.vals_alt = a.take<int>(n);
  s.status = a.take<unsigned long long>(kRadix * cdiv(n, kSortTile));
  s.hist = a.take<unsigned>(kSortCounters);
  return s;
}

// Where a sort left its pairs: the caller's buffers or the alternates.
struct Pairs {
  uint64_t* keys;
  int* vals;
};

// Sorts (keys, vals)[0, n) by the low key_bits bits of the keys (every key
// below 2^key_bits); returns the buffers that hold the result.
Pairs radix_sort_pairs(uint64_t* keys, int* vals, long long n, int key_bits,
                       const SortBufs& s, cudaStream_t st) {
  Pairs in{keys, vals};
  if (n <= 1 || key_bits <= 0) return in;
  const int passes = (key_bits + kRadixBits - 1) / kRadixBits;
  const long long tiles = cdiv(n, kSortTile);
  cudaMemsetAsync(s.status, 0, sizeof(unsigned long long) * kRadix * tiles,
                  st);
  cudaMemsetAsync(s.hist, 0, sizeof(unsigned) * kSortCounters, st);
  const long long hist_blocks = tiles < kHistBlocks ? tiles : kHistBlocks;
  onesweep_hist_kernel<<<static_cast<unsigned>(hist_blocks), kThreads, 0,
                         st>>>(keys, n, passes, s.hist);
  onesweep_bins_kernel<<<passes, kThreads, 0, st>>>(s.hist);
  int* counters = reinterpret_cast<int*>(s.hist + kMaxPasses * kRadix);
  Pairs out{s.keys_alt, s.vals_alt};
  for (int p = 0; p < passes; ++p) {
    onesweep_pass_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        in.keys, in.vals, out.keys, out.vals, n, p, s.hist + p * kRadix,
        s.status, counters + p);
    const Pairs t = in;
    in = out;
    out = t;
  }
  return in;
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
// gs[i].  Bound by memory: the sort is about 8 + 8 x 24 bytes per slot, the
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
// memory like B1: the sort moves about 8 + 7 x 24 bytes per slot; the key pass
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
  const Pairs sorted = radix_sort_pairs(b.keys, b.vals, N, key_bits, b.sort,
                                        st);
  init_groups_kernel<<<grid, kThreads, 0, st>>>(sorted.keys, sorted.vals, N,
                                                N - n, sa, b.starts);
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
//   - radix-sorts (key, pos) on 2W bits (B10 keys g - off, fewer bits);
//   - relabels: tied groups are whole and contiguous in both slot and
//     buffer order and the sort keeps them in g order, so buffer element b
//     belongs at the b-th tied slot itself; its new label is the slot of
//     the first element with its key (a max-scan of the key-change slots);
//   - scatters sa, rank and gs back.
// The JAX loop caps the buffer at N/8 and falls back to a full-size sort
// through lax.cond, because XLA allocates the larger branch statically;
// here the buffer is sized from m each round, so one branch serves both.
// Bound by memory: a round reads gs, flags and dest over the whole row
// (12 bytes a slot) and moves about 8 + 8 x 24 + 40 bytes per tied slot.
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

enum { kCtlOff = 0, kCtlMw, kCtlPoisoned, kCtlAnyTied, kCtlNext, kCtlSize };

// The marked slots of the span [off, off + span): flags and dest are
// indexed from off, which is ctl[kCtlOff] (B10's window) or 0 without ctl
// (B2, span N).  Keys (g - off) << W | (r2 + 1): every marked g is at least
// off, and the order is that of (g, r2).
__global__ void refine_gather_kernel(const int* __restrict__ flags,
                                     const int* __restrict__ dest,
                                     const int* __restrict__ sa,
                                     const int* __restrict__ rank,
                                     const int* __restrict__ gs, long long N,
                                     long long span, long long k, int W,
                                     const int* __restrict__ ctl,
                                     int* __restrict__ slots,
                                     uint64_t* __restrict__ keys,
                                     int* __restrict__ vals) {
  const long long off = ctl != nullptr ? ctl[kCtlOff] : 0;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < span; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!flags[t]) continue;
    const long long s = off + t;
    const int b = dest[t];
    const long long pos = sa[s];
    const long long q = pos + k;
    const long long r2 = q < N ? rank[q] : -1;
    slots[b] = static_cast<int>(s);
    keys[b] = (static_cast<uint64_t>(gs[s] - off) << W) |
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

// A member whose new label f is its group's old start g keeps its rank
// (rank[p] = gs[slot] = g before the round), so only the members of the
// later subgroups of a split group pay the random rank store.
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
    if (f != gs[s]) {
      rank[p] = f;
      gs[s] = f;
    }
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

// B2's refine body on the m slots that `flags` marks over the span (dest
// their buffer indices; see refine_gather_kernel): gather, radix sort on
// high_bits + W bits (g - off below 2^high_bits), key-change starts,
// max-scan, scatter.  Each marked group must be a contiguous run of slots,
// marked from its first slot on.
void refine_marked(int* sa, int* rank, int* gs, long long N, long long k,
                   long long m, const int* flags, const int* dest,
                   long long span, int high_bits, const int* ctl,
                   const RefineBufs& b, cudaStream_t st) {
  const int W = key_width(N);
  refine_gather_kernel<<<grid_for(span), kThreads, 0, st>>>(
      flags, dest, sa, rank, gs, N, span, k, W, ctl, b.slots, b.keys,
      b.vals);
  const Pairs sorted = radix_sort_pairs(b.keys, b.vals, m, high_bits + W,
                                        b.sort, st);
  const unsigned grid = grid_for(m);
  refine_change_kernel<<<grid, kThreads, 0, st>>>(sorted.keys, b.slots, m,
                                                  b.starts);
  scan_levels<MaxOp>(b.starts, b.first_eq, m, false, b.scan, st);
  refine_scatter_kernel<<<grid, kThreads, 0, st>>>(b.slots, sorted.vals,
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
//     the pass refines in place as B2 does).  Every such slot lies in the
//     span [off, off + L), L = min(N, W + half), so flags and dest (their
//     exclusive scan, dest[L] = m_w = ctl[1]) cover the span alone,
//     indexed from off, with 0 past N.  One read of gs over the whole row
//     also gives ctl[2] = 1 when some tied slot has a member offset of
//     half or more (a group too big for any window: the row is poisoned,
//     and its caller falls back to B9) and ctl[3] = 1 when any slot is
//     tied, exactly as the JAX pass reduces them.
//   - pss_sa_rotating_pass refines the m_w marked slots by the rank k
//     positions on (B2's body over the span, keyed on g - off, which is
//     below W), then jumps: nxt = the least slot >= off + W that starts a
//     tied group (N if none, or if off + W >= N) -> ctl[4], and ctl[0] =
//     nxt < N ? nxt : 0.  The JAX pass samples a reverse cummin at off + W;
//     a min-reduction over [off + W, N) is the same.
// The host keeps k, reads ctl once a pass after the next window's scan,
// doubles k when ctl[0] is back at 0, and stops when k >= N at off 0, when
// nothing is tied, or at the first poisoned window.  Windows are swept in
// the JAX order, so earlier windows refine later windows' r2 alike.
// Bound by memory: a scan reads gs over the row (4 bytes a slot) and
// writes flags and dest over the span (8 bytes a span slot with the scan's
// levels); a pass moves B2's sort bytes per marked slot and reads gs from
// off + W on.
// ---------------------------------------------------------------------------
constexpr int kByte3KeyBits = 25;

// Blocks of the two whole-row walks of a pass (the window scan's
// reductions and the jump): a grid of a few waves whose threads loop,
// instead of one short block per 256 slots, which at N = 512 Mi spent more
// time scheduling blocks than reading gs.
constexpr unsigned kWalkBlocks = 4096;

unsigned walk_grid(long long n) {
  const unsigned g = grid_for(n);
  return g < kWalkBlocks ? g : kWalkBlocks;
}

// The span a window's marked slots lie in: [off, off + L).
long long window_span(long long N, long long half, long long W) {
  return W + half < N ? W + half : N;
}

// flags[t] for slot off + t of the window at ctl[kCtlOff] (0 past N), and
// the whole row's poisoned and any-tied, which must be 0 before the
// launch.  A thread takes 4 consecutive slots a step, one 16-byte load of
// gs (with its two neighbours from the cache), so enough bytes are in
// flight to keep the memory busy.
__global__ void window_flags_kernel(const int* __restrict__ gs, long long N,
                                    long long half, long long W,
                                    long long span, int* __restrict__ ctl,
                                    int* __restrict__ flags) {
  __shared__ int s_any, s_poisoned;
  if (threadIdx.x == 0) {
    s_any = 0;
    s_poisoned = 0;
  }
  __syncthreads();
  const long long off = ctl[kCtlOff];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first = blockIdx.x * static_cast<long long>(blockDim.x) +
                          threadIdx.x;
  const bool aligned = aligned16(gs);
  bool any = false, poisoned = false;
  for (long long i0 = 4 * first; i0 < N; i0 += 4 * stride) {
    int g[6];  // gs[i0 - 1 .. i0 + 4], -1 outside the row
    g[0] = i0 > 0 ? gs[i0 - 1] : -1;
    if (aligned && i0 + 4 <= N) {
      const int4 v = *reinterpret_cast<const int4*>(gs + i0);
      g[1] = v.x;
      g[2] = v.y;
      g[3] = v.z;
      g[4] = v.w;
    } else {
      for (int j = 0; j < 4; ++j) g[1 + j] = i0 + j < N ? gs[i0 + j] : -1;
    }
    g[5] = i0 + 4 < N ? gs[i0 + 4] : -1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long i = i0 + j;
      if (i >= N) break;
      const int gi = g[1 + j];
      const bool tied = g[j] == gi || g[2 + j] == gi;
      bool sel = false;
      if (tied) {
        any = true;
        if (i - gi >= half) {
          poisoned = true;
        } else {
          sel = gi >= off && gi < off + W;
        }
      }
      if (i >= off && i < off + span) flags[i - off] = sel ? 1 : 0;
    }
  }
  for (long long t = (N - off) + first; t < span; t += stride) flags[t] = 0;
  if (any) s_any = 1;
  if (poisoned) s_poisoned = 1;
  __syncthreads();
  if (threadIdx.x == 0) {
    if (s_any) ctl[kCtlAnyTied] = 1;
    if (s_poisoned) ctl[kCtlPoisoned] = 1;
  }
}

__global__ void window_total_kernel(const int* __restrict__ dest,
                                    long long span, int* __restrict__ ctl) {
  ctl[kCtlMw] = dest[span];
}

__global__ void next_init_kernel(long long N, int* __restrict__ ctl) {
  ctl[kCtlNext] = static_cast<int>(N);
}

// ctl[kCtlNext] = min(ctl[kCtlNext], the least slot >= off + W that starts
// a tied group).  A thread's first hit in its grid-stride walk is its least,
// and a thread stops as soon as its block or some other block has a hit at
// or below its slot, so once the first stride finds the answer the rest of
// the row is not read.
__global__ void next_start_kernel(const int* __restrict__ gs, long long N,
                                  long long W, int* __restrict__ ctl) {
  __shared__ int s_min;
  if (threadIdx.x == 0) s_min = INT_MAX;
  __syncthreads();
  const volatile int* block_min = &s_min;
  const volatile int* known = ctl + kCtlNext;
  const long long lo = static_cast<long long>(ctl[kCtlOff]) + W;
  for (long long i = lo + blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i >= *block_min || i >= *known) break;
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
  if (threadIdx.x == 0 && s_min < *known) atomicMin(&ctl[kCtlNext], s_min);
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
// 8 + 2W / 8 x 24 bytes per slot (8 passes at W = 31), the key and relabel
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
  const Pairs sorted = radix_sort_pairs(b.keys, b.vals, N, key_bits, b.sort,
                                        st);
  full_flags_kernel<<<grid, kThreads, 0, st>>>(sorted.keys, N, b.labels);
  scan_levels<SumOp>(b.labels, b.labels, N, false, b.scan, st);
  full_relabel_kernel<<<grid, kThreads, 0, st>>>(sorted.vals, b.labels, N, sa,
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  SortBufs s = carve_sort(a, n);
  const Pairs sorted = radix_sort_pairs(static_cast<uint64_t*>(keys),
                                        static_cast<int*>(vals), n, key_bits,
                                        s, st);
  if (sorted.keys != keys) {
    cudaMemcpyAsync(keys, sorted.keys, sizeof(uint64_t) * n,
                    cudaMemcpyDeviceToDevice, st);
    cudaMemcpyAsync(vals, sorted.vals, sizeof(int) * n,
                    cudaMemcpyDeviceToDevice, st);
  }
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
                N, key_width(N), nullptr, b,
                static_cast<cudaStream_t>(stream));
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

// Marks the window at ctl[0] (see the B10 section): flags int32 [L], dest
// int32 [L + 1] (dest[L] = m_w) over the window's span of L = min(N, W +
// half) slots from off, ctl int32 [5].  Scratch as
// pss_sa_tie_scratch_bytes(L).
int pss_sa_window_scan(const void* gs, long long N, long long half,
                       long long W, void* ctl, void* flags, void* dest,
                       void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(ctl);
  const long long span = window_span(N, half, W);
  cudaMemsetAsync(c + kCtlPoisoned, 0, 2 * sizeof(int), st);
  window_flags_kernel<<<walk_grid(cdiv(N, 4)), kThreads, 0, st>>>(
      static_cast<const int*>(gs), N, half, W, span, c,
      static_cast<int*>(flags));
  scan_levels<SumOp>(static_cast<const int*>(flags), static_cast<int*>(dest),
                     span, true, static_cast<int*>(scratch), st);
  scan_total_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(flags),
                                     static_cast<int*>(dest), span);
  window_total_kernel<<<1, 1, 0, st>>>(static_cast<const int*>(dest), span,
                                       c);
  return static_cast<int>(cudaGetLastError());
}

// Refines the m marked slots of the last window scan (same N, half and W)
// by the rank k positions on, in place, then moves ctl[0] to the next
// window.  Scratch as pss_sa_refine_scratch_bytes(m).
int pss_sa_rotating_pass(void* sa, void* rank, void* gs, long long N,
                         long long k, long long m, long long half,
                         long long W, const void* flags, const void* dest,
                         void* ctl, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(ctl);
  if (m > 0) {
    Arena a{static_cast<char*>(scratch), 0};
    RefineBufs b = carve_refine(a, m);
    refine_marked(static_cast<int*>(sa), static_cast<int*>(rank),
                  static_cast<int*>(gs), N, k, m,
                  static_cast<const int*>(flags),
                  static_cast<const int*>(dest), window_span(N, half, W),
                  key_width(W - 1), c, b, st);
  }
  next_init_kernel<<<1, 1, 0, st>>>(N, c);
  next_start_kernel<<<walk_grid(N), kThreads, 0, st>>>(
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
