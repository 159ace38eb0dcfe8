// Hand-written Hopper kernels of the device suffix-array build (derive
// mode): the anchored init sorts (B1 on rank digits, B1b on bytes), the
// tie-only doubling rounds (B2), the rotating windowed doubler of rows over
// 384 Mi (B10), the full-sort doubling of the Writer's 'full' build, of
// integer alphabets and of B10's poisoned rows (B9), and the building
// blocks they are made of -- a stable one-sweep LSD radix sort of (uint64
// key, int32 value) pairs and an exclusive sum scan over int32 -- with the
// radix sort's store pass alone as a scatter (B16), binned in shared memory
// and blocked by destination, and the per-shard steps of one row's B9
// split over a mesh (B14g).
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
#include <cooperative_groups.h>
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
template <class Op, int NW = kWarps>
__device__ int block_exclusive_scan(int x, int* total) {
  __shared__ int s_warp[NW + 1];
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
    for (int w = 0; w < NW; ++w) {
      int t = s_warp[w];
      s_warp[w] = run;
      run = Op::apply(run, t);
    }
    s_warp[NW] = run;
  }
  __syncthreads();
  int excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = Op::identity();
  *total = s_warp[NW];
  return Op::apply(s_warp[warp], excl);
}

__host__ __device__ inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// One tile per block; in == out is allowed (each thread reads its own
// items before any write).  sums, when not null, gets each block's total.
// With dn not null the scan covers min(n, *dn) items (a count known only
// on the device; n is the host's bound): later items read as the identity
// and are not written, and a block past the count returns at once (no
// block before it reads its total).
// A thread's 8 items are two 16-byte loads and stores where both buffers
// are aligned (vec), so a warp moves 1 KB at a time.
template <class Op>
__global__ void scan_tile_kernel(const int* in, int* out, long long n,
                                 const int* dn, int* sums, int exclusive,
                                 int vec) {
  if (dn != nullptr) {
    if (*dn < n) n = *dn;
    if (static_cast<long long>(blockIdx.x) * kScanTile >= n) return;
  }
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
__global__ void scan_add_kernel(int* out, long long n, const int* dn,
                                const int* carries) {
  if (dn != nullptr && *dn < n) n = *dn;
  if (static_cast<long long>(blockIdx.x) * kScanTile >= n) return;
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

// A scan of n items, or of min(n, *dn) with a device count dn.
template <class Op>
void scan_levels(const int* in, int* out, long long n, bool exclusive,
                 int* scratch, cudaStream_t st, const int* dn = nullptr) {
  if (n <= 0) return;
  const long long nb = cdiv(n, kScanTile);
  const int vec = aligned16(in) && aligned16(out) ? 1 : 0;
  if (nb == 1) {
    scan_tile_kernel<Op><<<1, kThreads, 0, st>>>(in, out, n, dn, nullptr,
                                                 exclusive ? 1 : 0, vec);
    return;
  }
  int* sums = scratch;
  scan_tile_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      in, out, n, dn, sums, exclusive ? 1 : 0, vec);
  scan_levels<Op>(sums, sums, nb, true, scratch + nb, st);
  scan_add_kernel<Op><<<static_cast<unsigned>(nb), kThreads, 0, st>>>(
      out, n, dn, sums);
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
//   3. A pass whose 256 counts put every pair in one bin would move the
//      pairs without reordering them: onesweep_bins_kernel marks it, and its
//      kernel returns at once.  Each pass kernel reads its pairs from the
//      buffer the earlier executed passes left them in (the parity of
//      their number), and onesweep_fix_kernel copies the result into the
//      buffer the host expects from the full pass count, only when one
//      skipped pass made that parity differ.
// The count of pairs may be known only on the device (dn, with n the
// host's bound: B2's large groups); every kernel reads it there.
// Every count, counter and status word lives in the caller's scratch and
// is zeroed on the caller's stream, so sorts on several streams or threads
// never share state.  Bound by memory: the histogram reads 8 bytes a pair,
// each executed pass reads and writes 12; the status words add 0.5 bytes a
// pair.
// ---------------------------------------------------------------------------
constexpr int kSortItems = 16;                    // pairs a thread holds
constexpr int kSortTile = kThreads * kSortItems;  // pairs a block sorts
constexpr int kWarpItems = 32 * kSortItems;
constexpr int kMaxPasses = 8;                     // 64 key bits
constexpr int kHistBlocks = 512;

__global__ void __launch_bounds__(kThreads)
onesweep_hist_kernel(const uint64_t* __restrict__ keys, long long n,
                     const int* dn, int passes, unsigned* __restrict__ hist) {
  __shared__ unsigned counts[kMaxPasses][kRadix];
  if (dn != nullptr && *dn < n) n = *dn;
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

// Block p turns pass p's 256 digit counts into their first output slots,
// and sets skip[p] when one digit holds every pair.
__global__ void onesweep_bins_kernel(unsigned* __restrict__ hist,
                                     int* __restrict__ skip) {
  __shared__ int s_one_bin;
  unsigned* h = hist + blockIdx.x * kRadix;
  if (threadIdx.x == 0) s_one_bin = 0;
  const unsigned c = h[threadIdx.x];
  int total;
  const int first = block_exclusive_scan<SumOp>(static_cast<int>(c), &total);
  if (static_cast<int>(c) == total) s_one_bin = 1;
  h[threadIdx.x] = static_cast<unsigned>(first);
  __syncthreads();
  if (threadIdx.x == 0) skip[blockIdx.x] = s_one_bin;
}

// Executed passes before pass p: their parity says which buffer holds the
// pairs.
__device__ __forceinline__ int executed_before(const int* skip, int p) {
  int e = 0;
  for (int q = 0; q < p; ++q) e += skip[q] ? 0 : 1;
  return e;
}

__device__ __forceinline__ void status_store(unsigned long long* word,
                                             unsigned tag, unsigned value) {
  *reinterpret_cast<volatile unsigned long long*>(word) =
      (static_cast<unsigned long long>(tag) << 32) | value;
}

// Pass `pass` of a sort sorts by the 8-bit digit at `shift`; its skip flag,
// its tags and the parity of the executed passes before it use `pass`.
// K is the key's type: uint64_t for every sort but B10's init, whose 25-bit
// keys take uint32_t (4 bytes a pair less to move, and to hold).
template <class K>
__global__ void __launch_bounds__(kThreads)
onesweep_pass_kernel(K* kmain, int* vmain, K* kalt,
                     int* valt, long long n, const int* dn, int pass,
                     int shift, const unsigned* __restrict__ bins,
                     const int* __restrict__ skip,
                     unsigned long long* status, int* counter) {
  __shared__ int s_tile;
  __shared__ unsigned s_warp[kWarps][kRadix];  // per-warp counts, then offsets
  __shared__ int s_local[kRadix];  // staged index of each digit's first pair
  __shared__ int s_base[kRadix];   // its output slot minus that index
  __shared__ union {
    K keys[kSortTile];
    int vals[kSortTile];
  } s_stage;
  if (skip[pass]) return;
  if (dn != nullptr) {
    if (*dn < n) n = *dn;
    if (n <= 0) return;  // a sort of nothing, or a path not taken
  }
  const bool odd = executed_before(skip, pass) & 1;
  const K* __restrict__ kin = odd ? kalt : kmain;
  const int* __restrict__ vin = odd ? valt : vmain;
  K* __restrict__ kout = odd ? kmain : kalt;
  int* __restrict__ vout = odd ? vmain : valt;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_base = tile * kSortTile;
  if (tile_base >= n) return;  // past a device count: no later tile waits
  const long long warp_base = tile_base + warp * kWarpItems + lane;
  K key[kSortItems];
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
      const K k = s_stage.keys[i];
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

// Copies the pairs into the buffers the host expects from `passes` (odd:
// the alternates) when the executed passes left them in the other ones.
__global__ void onesweep_fix_kernel(uint64_t* kmain, int* vmain,
                                    uint64_t* kalt, int* valt, long long n,
                                    const int* dn, int passes,
                                    const int* __restrict__ skip) {
  const bool in_alt = executed_before(skip, passes) & 1;
  if (in_alt == static_cast<bool>(passes & 1)) return;
  if (dn != nullptr && *dn < n) n = *dn;
  const uint64_t* ks = in_alt ? kalt : kmain;
  const int* vs = in_alt ? valt : vmain;
  uint64_t* kd = in_alt ? kmain : kalt;
  int* vd = in_alt ? vmain : valt;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
}

struct SortBufs {
  uint64_t* keys_alt;
  int* vals_alt;
  unsigned long long* status;  // [tiles][kRadix]
  unsigned* hist;  // [kMaxPasses][kRadix], the counters, the skip flags
};

constexpr int kSortCounters = kMaxPasses * kRadix + 2 * kMaxPasses;

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

// The histogram and the passes of radix_sort_pairs, without the copy
// back: returns the device skip flags, whose executed passes' parity says
// where the pairs are.  n >= 1, key_bits >= 1.
const int* radix_sort_passes(uint64_t* keys, int* vals, long long n,
                             int key_bits, const SortBufs& s, cudaStream_t st,
                             const int* dn) {
  const int passes = (key_bits + kRadixBits - 1) / kRadixBits;
  const long long tiles = cdiv(n, kSortTile);
  cudaMemsetAsync(s.status, 0, sizeof(unsigned long long) * kRadix * tiles,
                  st);
  cudaMemsetAsync(s.hist, 0, sizeof(unsigned) * kSortCounters, st);
  const long long hist_blocks = tiles < kHistBlocks ? tiles : kHistBlocks;
  onesweep_hist_kernel<<<static_cast<unsigned>(hist_blocks), kThreads, 0,
                         st>>>(keys, n, dn, passes, s.hist);
  int* counters = reinterpret_cast<int*>(s.hist + kMaxPasses * kRadix);
  int* skip = counters + kMaxPasses;
  onesweep_bins_kernel<<<passes, kThreads, 0, st>>>(s.hist, skip);
  for (int p = 0; p < passes; ++p) {
    onesweep_pass_kernel<uint64_t>
        <<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
            keys, vals, s.keys_alt, s.vals_alt, n, dn, p, kRadixBits * p,
            s.hist + p * kRadix, skip, s.status, counters + p);
  }
  return skip;
}

// Sorts (keys, vals)[0, n) by the low key_bits bits of the keys (every key
// below 2^key_bits); returns the buffers that hold the result: the
// alternates after an odd number of passes.  With dn the device holds the
// count, at most n.
Pairs radix_sort_pairs(uint64_t* keys, int* vals, long long n, int key_bits,
                       const SortBufs& s, cudaStream_t st,
                       const int* dn = nullptr) {
  if ((dn == nullptr && n <= 1) || n <= 0 || key_bits <= 0) {
    return Pairs{keys, vals};
  }
  const int passes = (key_bits + kRadixBits - 1) / kRadixBits;
  const int* skip = radix_sort_passes(keys, vals, n, key_bits, s, st, dn);
  onesweep_fix_kernel<<<grid_for(n) < 4096 ? grid_for(n) : 4096, kThreads, 0,
                        st>>>(keys, vals, s.keys_alt, s.vals_alt, n, dn,
                              passes, skip);
  return passes & 1 ? Pairs{s.keys_alt, s.vals_alt} : Pairs{keys, vals};
}

// ---------------------------------------------------------------------------
// B16, the store pass of an LSD radix sort on its own: out[dests[i]] =
// values[i].  Replaces pallas_scatter (benchmarks/pallas_sort_bench.py),
// which stored one element at a time from VMEM tiles of 8192 and never
// lowered; the giant build's rank store (parallel/sharded.py _send_home)
// runs it on each shard's rank block.  The dests must be distinct (a
// permutation in the benchmark and the rank store); that is the caller's
// contract and is not checked.  A dest outside out is dropped, and a slot
// no dest names keeps what out held.
//
// Bound by memory: 12 bytes an element.  Stored one element at a time, a
// random permutation of a 256-512 MiB destination (5-10x the L2) costs a
// partial 32-byte sector in DRAM for every 4 bytes (about 0.16 TB/s of
// useful bytes on an H100).  So the store is binned: the destination
// range is cut into bins of kBinSlots = 2^16 slots, which a cluster of
// kBinBlocks = 2 blocks assembles in its shared memory (128 KiB a block),
// and three kernels write each byte of out once, in whole 16-byte stores:
//   1. scatter_count_kernel counts the pairs of every bin (shared-memory
//      counters, one global add a block and bin); the exclusive scan of
//      the counts gives each bin's first slot in an 8-byte (dest, value)
//      scratch.
//   2. scatter_distribute_kernel takes a tile of kDistTile = 16384 pairs,
//      counts them by bin in shared memory (the shared atomic gives each
//      pair its rank in its bin), claims each present bin's run of the
//      scratch with one global atomicAdd, stages the tile in bin order and
//      writes its runs contiguously.  The dests are distinct, so the order
//      inside a bin is free: no stable ranking, no look-back.
//   3. scatter_assemble_kernel: the cluster of a bin loads out's range
//      first only where the bin has fewer pairs than slots, puts every
//      value at dest - bin start (half of them into the other block's
//      shared memory) and writes the range out whole.
// A permutation moves 4 + 16 + 12 = 32 bytes an element, 2.7x the bound.
// The distribute sets the pace: the shorter its runs, the slower (about 8
// pairs a run at 2^27 slots).  Measured on an H100 (PERF.md): one block a
// bin of 2^15 slots (runs half as long) lost more in the distribute than
// the cluster's remote stores cost; clusters of 4 (2^17 slots) lost as
// much in the assemble's remote stores as they gained; tiles of 8192
// pairs and a distribute that loads its next tile while it writes the
// last were slower.  The bins of one pass cover at most kScatterPassBins *
// kBinSlots = 2^29 slots; a larger out is stored in windows of that many
// slots, each pass reading every pair again.
// ---------------------------------------------------------------------------
constexpr int kBinBlockLog = 15;                       // slots a block owns
constexpr int kBinBlockSlots = 1 << kBinBlockLog;      // 128 KiB of int32
constexpr int kBinBlocks = 2;                          // a bin's cluster
constexpr int kBinLog = kBinBlockLog + 1;
static_assert(kBinBlocks << kBinBlockLog == 1 << kBinLog, "bin geometry");
constexpr int kDistThreads = 512;
constexpr int kDistItems = 32;                         // pairs a thread
constexpr int kDistTile = kDistThreads * kDistItems;   // 16384 pairs
constexpr int kAsmThreads = 1024;
constexpr int kCountThreads = 1024;
// Bins one pass counts: a distribute tile stages 8 bytes a pair and keeps
// two ints a bin, within a block's 227 KiB of shared memory.
constexpr int kScatterPassBins = 8192;
constexpr int kDistSmem = 8 * kDistTile + 8 * kScatterPassBins;
static_assert(kDistSmem <= 232448, "a distribute block's shared memory");

__device__ __forceinline__ void count_dest(int* sc, int d, long long lo,
                                           long long span) {
  const long long o = static_cast<long long>(d) - lo;
  if (static_cast<unsigned long long>(o) <
      static_cast<unsigned long long>(span))
    atomicAdd(&sc[static_cast<int>(o >> kBinLog)], 1);
}

// counts[b] += the dests in bin b of the window [lo, lo + span), b < nb.
__global__ void __launch_bounds__(kCountThreads)
scatter_count_kernel(const int* __restrict__ dests, long long n, long long lo,
                     long long span, int nb, int vec,
                     int* __restrict__ counts) {
  extern __shared__ int sc[];
  for (int i = threadIdx.x; i < nb; i += kCountThreads) sc[i] = 0;
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kCountThreads;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * kCountThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const int4* d4 = reinterpret_cast<const int4*>(dests);
    for (long long i = t0; i < n4; i += stride) {
      const int4 d = d4[i];
      count_dest(sc, d.x, lo, span);
      count_dest(sc, d.y, lo, span);
      count_dest(sc, d.z, lo, span);
      count_dest(sc, d.w, lo, span);
    }
    tail = n4 << 2;
  }
  for (long long i = tail + t0; i < n; i += stride)
    count_dest(sc, dests[i], lo, span);
  __syncthreads();
  for (int i = threadIdx.x; i < nb; i += kCountThreads)
    if (sc[i]) atomicAdd(&counts[i], sc[i]);
}

// Tile blockIdx.x of the pairs into its bins' runs of `pairs` (values null:
// each pair's value is its index i): offsets[b]
// is bin b's first pair, fill[b] the pairs claimed so far.  Thread t holds
// pairs 4 (k kDistThreads + t) + 0..3 of the tile, k < kDistItems / 4,
// loaded 16 bytes at a time where the tile is whole and both inputs are
// aligned.  nvcc -Xptxas -v (sm_90a): 123 registers, no spills; one block
// an SM.
__global__ void __launch_bounds__(kDistThreads)
scatter_distribute_kernel(const int* __restrict__ values,
                          const int* __restrict__ dests, long long n,
                          long long lo, long long span, int nb, int vec,
                          const int* __restrict__ offsets,
                          int* __restrict__ fill, int2* __restrict__ pairs) {
  constexpr int kWarpsD = kDistThreads / 32;
  extern __shared__ int4 dist_smem[];
  int2* stage = reinterpret_cast<int2*>(dist_smem);
  int* off = reinterpret_cast<int*>(stage + kDistTile);  // counts, firsts
  int* delta = off + nb;                                  // run - tile first
  __shared__ int s_warp[kWarpsD + 1];
  for (int i = threadIdx.x; i < nb; i += kDistThreads) off[i] = 0;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * kDistTile;
  int d[kDistItems], v[kDistItems], r[kDistItems];
  if (vec && base + kDistTile <= n) {
#pragma unroll
    for (int k = 0; k < kDistItems / 4; ++k) {
      const long long i = base + 4LL * (k * kDistThreads + threadIdx.x);
      const int4 dd = *reinterpret_cast<const int4*>(dests + i);
      d[4 * k] = dd.x; d[4 * k + 1] = dd.y; d[4 * k + 2] = dd.z;
      d[4 * k + 3] = dd.w;
      if (values) {
        const int4 vv = *reinterpret_cast<const int4*>(values + i);
        v[4 * k] = vv.x; v[4 * k + 1] = vv.y; v[4 * k + 2] = vv.z;
        v[4 * k + 3] = vv.w;
      } else {  // each pair's own index
#pragma unroll
        for (int e = 0; e < 4; ++e) v[4 * k + e] = static_cast<int>(i + e);
      }
    }
  } else {
    // A pair past n gets dest lo - 1, outside every bin.
    const int none = static_cast<int>(lo - 1);
#pragma unroll
    for (int k = 0; k < kDistItems / 4; ++k) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const long long i = base + 4LL * (k * kDistThreads + threadIdx.x) + j;
        d[4 * k + j] = i < n ? dests[i] : none;
        v[4 * k + j] = i >= n ? 0 : values ? values[i] : static_cast<int>(i);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kDistItems; ++k) {
    const long long o = static_cast<long long>(d[k]) - lo;
    r[k] = static_cast<unsigned long long>(o) <
                   static_cast<unsigned long long>(span)
               ? atomicAdd(&off[static_cast<int>(o >> kBinLog)], 1)
               : -1;
  }
  __syncthreads();
  // Exclusive scan of the tile's counts in place, a warp a run of bins
  // (lane-strided, so no bank conflicts), and one claim a present bin.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int per = (nb + 32 * kWarpsD - 1) / (32 * kWarpsD) * 32;
  const int b0 = warp * per;
  int sum = 0;
  for (int b = b0 + lane; b < b0 + per && b < nb; b += 32) sum += off[b];
  sum = __reduce_add_sync(kFull, sum);
  if (lane == 0) s_warp[warp] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int w = 0; w < kWarpsD; ++w) {
      const int t = s_warp[w];
      s_warp[w] = run;
      run += t;
    }
    s_warp[kWarpsD] = run;
  }
  __syncthreads();
  int carry = s_warp[warp];
  for (int b = b0 + lane; b < b0 + per; b += 32) {
    const int c = b < nb ? off[b] : 0;
    int incl = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int first = carry + incl - c;
    if (c) {
      off[b] = first;
      delta[b] = offsets[b] + atomicAdd(&fill[b], c) - first;
    }
    carry += __shfl_sync(kFull, incl, 31);
  }
  const int total = s_warp[kWarpsD];
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kDistItems; ++k) {
    if (r[k] >= 0) {
      const int b = static_cast<int>((static_cast<long long>(d[k]) - lo) >>
                                     kBinLog);
      stage[off[b] + r[k]] = make_int2(d[k], v[k]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < total; j += kDistThreads) {
    const int2 p = stage[j];
    const int b =
        static_cast<int>((static_cast<long long>(p.x) - lo) >> kBinLog);
    pairs[static_cast<long long>(delta[b]) + j] = p;
  }
}

// int32 [len] between shared and global memory, 16 bytes at a time where
// vec (both 16-byte aligned).
__device__ __forceinline__ void copy_ints(int* __restrict__ to,
                                          const int* __restrict__ from,
                                          int len, int vec) {
  int done = 0;
  if (vec) {
    const int len4 = len >> 2;
    const int4* f4 = reinterpret_cast<const int4*>(from);
    int4* t4 = reinterpret_cast<int4*>(to);
#pragma unroll 4
    for (int i = threadIdx.x; i < len4; i += kAsmThreads) t4[i] = f4[i];
    done = len4 << 2;
  }
  for (int i = done + threadIdx.x; i < len; i += kAsmThreads) to[i] = from[i];
}

// Bin blockIdx.x / kBinBlocks of the window at lo: its counts[b] pairs from
// offsets[b] into out.  Block q of the bin's cluster owns slots [q
// kBinBlockSlots, (q + 1) kBinBlockSlots) of it and reads a kBinBlocks-th
// of its pairs, storing each value into the owner's shared memory.
__global__ void __cluster_dims__(kBinBlocks, 1, 1)
__launch_bounds__(kAsmThreads)
scatter_assemble_kernel(const int2* __restrict__ pairs,
                        const int* __restrict__ offsets,
                        const int* __restrict__ counts, long long lo,
                        long long span, int vec, int* __restrict__ out) {
  extern __shared__ int4 asm_smem[];
  int* slots = reinterpret_cast<int*>(asm_smem);
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int bin = blockIdx.x / kBinBlocks;
  const int q = static_cast<int>(cluster.block_rank());
  const int cnt = counts[bin];
  if (cnt == 0) return;  // the whole cluster returns
  const long long s0 = lo + (static_cast<long long>(bin) << kBinLog);
  long long blen = lo + span - s0;
  if (blen > (1LL << kBinLog)) blen = 1LL << kBinLog;
  long long mlen = blen - static_cast<long long>(q) * kBinBlockSlots;
  mlen = mlen < 0 ? 0 : (mlen > kBinBlockSlots ? kBinBlockSlots : mlen);
  int* dst = out + s0 + static_cast<long long>(q) * kBinBlockSlots;
  if (cnt < blen) copy_ints(slots, dst, static_cast<int>(mlen), vec);
  cluster.sync();  // every block of the cluster runs, its range loaded
  int* owner[kBinBlocks];
#pragma unroll
  for (int k = 0; k < kBinBlocks; ++k)
    owner[k] = cluster.map_shared_rank(slots, k);
  auto put = [&](int dest, int value) {
    const int o = static_cast<int>(static_cast<long long>(dest) - s0);
    owner[o >> kBinBlockLog][o & (kBinBlockSlots - 1)] = value;
  };
  // Pairs [a, e): 16-byte loads of two pairs from the first even index,
  // the odd ends one pair each.
  const long long beg = offsets[bin];
  const long long a = beg + static_cast<long long>(cnt) * q / kBinBlocks;
  const long long e = beg + static_cast<long long>(cnt) * (q + 1) / kBinBlocks;
  long long a2 = (a + 1) & ~1LL;
  if (a2 > e) a2 = e;
  long long e2 = e & ~1LL;
  if (e2 < a2) e2 = a2;
  if (threadIdx.x == 0 && a < a2) {
    const int2 p = pairs[a];
    put(p.x, p.y);
  }
  if (threadIdx.x == 1 && e2 < e) {
    const int2 p = pairs[e2];
    put(p.x, p.y);
  }
  const int4* p4 = reinterpret_cast<const int4*>(pairs);
  const long long v0 = a2 >> 1, v1 = e2 >> 1;
  for (long long i = v0 + threadIdx.x; i < v1; i += 4 * kAsmThreads) {
    int4 x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (i + u * kAsmThreads < v1) x[u] = p4[i + u * kAsmThreads];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i + u * kAsmThreads < v1) {
        put(x[u].x, x[u].y);
        put(x[u].z, x[u].w);
      }
    }
  }
  cluster.sync();  // every value is in place; no remote store follows
  copy_ints(dst, slots, static_cast<int>(mlen), vec);
}

// The same store blocked by destination (sort_bench's point of
// comparison): the (dest, value) pairs are first partitioned by dest's top
// 8 bits with one one-sweep pass (keys bin << 32 | dest), so that the
// stores of the second kernel walk the 256 bins in order and each bin's
// stores meet in a few MB of L2 instead of landing anywhere in the row.
// About 68 bytes an element instead of 12, traded for stores that L2 can
// merge: the anchored inits' rank[sa[i]] = gs[i], a full permutation,
// takes this form in their own kernels; B2's rank stores, a subset beside
// other work, do not.
__global__ void scatter_bin_keys_kernel(const int* __restrict__ values,
                                        const int* __restrict__ dests,
                                        long long n, int shift,
                                        uint64_t* __restrict__ keys,
                                        int* __restrict__ vals) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned d = static_cast<unsigned>(dests[i]);
    keys[i] = (static_cast<uint64_t>(d >> shift) << 32) | d;
    vals[i] = values[i];
  }
}

// Every pass before `pass` is marked skipped, so the pass reads the pairs
// where the key kernel wrote them.
__global__ void skip_below_kernel(int* skip, int pass) {
  if (threadIdx.x < pass) skip[threadIdx.x] = 1;
}

__global__ void scatter_binned_kernel(const uint64_t* __restrict__ keys,
                                      const int* __restrict__ vals,
                                      long long n, int* __restrict__ out) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    out[static_cast<unsigned>(keys[i])] = vals[i];
  }
}

// out[dests[i]] = values[i] for n distinct dests below `range`, blocked by
// destination, with keys / vals [n] and the sort's buffers s as scratch.
void blocked_scatter(const int* values, const int* dests, long long n,
                     long long range, int* out, uint64_t* keys, int* vals,
                     const SortBufs& s, cudaStream_t st) {
  if (n <= 0) return;
  int top = 0;  // dest >> top is the dest's 8-bit bin
  while ((range - 1) >> (top + kRadixBits) > 0) ++top;
  scatter_bin_keys_kernel<<<grid_for(n), kThreads, 0, st>>>(values, dests, n,
                                                            top, keys, vals);
  constexpr int kBinPass = 4;  // key bits 32-39: the bin
  const long long tiles = cdiv(n, kSortTile);
  cudaMemsetAsync(s.status, 0, sizeof(unsigned long long) * kRadix * tiles,
                  st);
  cudaMemsetAsync(s.hist, 0, sizeof(unsigned) * kSortCounters, st);
  onesweep_hist_kernel<<<tiles < kHistBlocks ? static_cast<unsigned>(tiles)
                                             : kHistBlocks,
                         kThreads, 0, st>>>(keys, n, nullptr, kBinPass + 1,
                                            s.hist);
  int* counters = reinterpret_cast<int*>(s.hist + kMaxPasses * kRadix);
  int* skip = counters + kMaxPasses;
  onesweep_bins_kernel<<<kBinPass + 1, kThreads, 0, st>>>(s.hist, skip);
  skip_below_kernel<<<1, 32, 0, st>>>(skip, kBinPass);
  onesweep_pass_kernel<uint64_t>
      <<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
          keys, vals, s.keys_alt, s.vals_alt, n, nullptr, kBinPass,
          kRadixBits * kBinPass, s.hist + kBinPass * kRadix, skip, s.status,
          counters + kBinPass);
  // A pass that found one bin leaves the pairs where they were.
  onesweep_fix_kernel<<<grid_for(n) < 4096 ? grid_for(n) : 4096, kThreads, 0,
                        st>>>(keys, vals, s.keys_alt, s.vals_alt, n, nullptr,
                              kBinPass + 1, skip);
  scatter_binned_kernel<<<grid_for(n), kThreads, 0, st>>>(
      s.keys_alt, s.vals_alt, n, out);
}

// B16's scratch: the (dest, value) pairs, a pass's counts and claims,
// their scan and the scan's own scratch.
struct ScatterBufs {
  int2* pairs;
  int* counts;  // [kScatterPassBins], then the claims [kScatterPassBins]
  int* offsets;
  int* scan;
};

ScatterBufs carve_scatter(Arena& a, long long n) {
  ScatterBufs b;
  b.pairs = a.take<int2>(n);
  b.counts = a.take<int>(2LL * kScatterPassBins);
  b.offsets = a.take<int>(kScatterPassBins);
  b.scan = a.take<int>(scan_scratch_elems(kScatterPassBins));
  return b;
}

// out[dests[i]] = values[i] for i < n into out [out_len] (see B16 above).
void scatter_binned(const int* values, const int* dests, long long n,
                    int* out, long long out_len, const ScatterBufs& b,
                    cudaStream_t st) {
  constexpr long long kWindow = static_cast<long long>(kScatterPassBins)
                                << kBinLog;
  constexpr int kAsmSmem = static_cast<int>(sizeof(int)) * kBinBlockSlots;
  if (out_len > (1LL << 31)) out_len = 1LL << 31;  // int32 dests
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  // Set on every call: the attribute is the current device's.
  cudaFuncSetAttribute(scatter_distribute_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kDistSmem);
  cudaFuncSetAttribute(scatter_assemble_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, kAsmSmem);
  const int in_vec = aligned16(values) && aligned16(dests) ? 1 : 0;
  const int out_vec = aligned16(out) ? 1 : 0;
  long long count_grid = cdiv(n, 8LL * kCountThreads);
  if (count_grid > 2LL * sms) count_grid = 2LL * sms;
  const unsigned dist_grid = static_cast<unsigned>(cdiv(n, kDistTile));
  int* fill = b.counts + kScatterPassBins;
  for (long long lo = 0; lo < out_len; lo += kWindow) {
    const long long span = out_len - lo < kWindow ? out_len - lo : kWindow;
    const int nb = static_cast<int>(cdiv(span, 1LL << kBinLog));
    cudaMemsetAsync(b.counts, 0, sizeof(int) * nb, st);
    cudaMemsetAsync(fill, 0, sizeof(int) * nb, st);
    scatter_count_kernel<<<static_cast<unsigned>(count_grid), kCountThreads,
                           sizeof(int) * nb, st>>>(dests, n, lo, span, nb,
                                                   in_vec, b.counts);
    scan_levels<SumOp>(b.counts, b.offsets, nb, true, b.scan, st);
    scatter_distribute_kernel<<<dist_grid, kDistThreads,
                                8 * kDistTile + 8 * nb, st>>>(
        values, dests, n, lo, span, nb, in_vec, b.offsets, fill, b.pairs);
    scatter_assemble_kernel<<<static_cast<unsigned>(nb) * kBinBlocks,
                              kAsmThreads, kAsmSmem, st>>>(
        b.pairs, b.offsets, b.counts, lo, span, out_vec, out);
  }
}

// ---------------------------------------------------------------------------
// The anchored inits' keys.  B1's key of position p is the 2D rank digits
// of text[p .. p+2D-1] (D = 30 / bits) packed big-endian, 0 for a digit at
// or past n: exactly the JAX limb0 << 30 | limb1, 60 bits.  The byte key
// (B1b, B9's init, B10's init) has digit q = text[p + q] + 1, or 0 at or
// past n, so a NUL byte stays above the past-end digit and the digit kind
// can reuse it; its 6 digits are keyed limb0 << 25 | limb1 (three base-257
// digits a limb, 257^3 < 2^25), one 50-bit key that sorts as the JAX pair
// (limb0, limb1) does, and its 3 digits limb0 alone.  Every digit read is
// masked at q < n, so the pad positions are exactly the all-zero key group
// for any 0 <= n <= N; the derive path's margin is its own contract, not
// the kernels' (B10 runs them on rows without one).  B1, B1b and B10 make
// their keys inside init_hist_kernel (section "B1 and B1b"); B9's init
// keys the same digits through the text's byte map (section "B9").
// ---------------------------------------------------------------------------
constexpr int kByteKeyBits = 50;

// ---------------------------------------------------------------------------
// B2, one tie-only doubling round.  Replaces the body of _segmented_loop
// with _tied_flags and _relabel_and_scatter (ops/suffix_array.py).
//
// The round refines every tied group (two or more members) by r2 = rank[pos
// + k], -1 past the row: new label = slot of the first member with its
// (group, r2) in sorted order.  The JAX body sorts (g, r2) over the tied
// buffer because XLA has no segmented sort; but the buffer, filled in slot
// order, is already ordered by g, so all that is left is to order r2
// within each group: a segmented sort, which never sorts g's bits.
//   - pss_sa_tie_scan (launch 1) compacts the round's tied slots into the
//     list tl (slot order): a count kernel and an emit kernel over the
//     candidates, whose per-tile counts are scanned in between, so no flag
//     or offset array over the candidates is written.  The candidates are
//     the whole row in the first round, else the last round's list, since
//     groups only ever split.  counts[0] = m, which the host reads once.
//   - pss_sa_refine_round (launch 2) reads every member's r2, group start
//     and position first (seg_gather_kernel: the JAX round reads the old
//     ranks), and classes its group by size from gs: tiny (at most kTiny
//     members), medium (at most kSegT) or large.  A tiny member finds its
//     place by counting the smaller r2 in its group (seg_tiny_kernel, a
//     thread each, no sort); a block sorts the medium groups that start in
//     its kSegT list positions in shared memory (seg_small_kernel); the
//     large members are compacted and keyed (large-group ordinal, r2 + 1)
//     -- the ordinal is the member's group start in the large list over
//     kSegT, distinct because each large group has more than kSegT members
//     -- and go through the one-sweep sort on their device count, W +
//     log2(m / kSegT) bits instead of 2W; then key changes, a max-scan and
//     the scatter.  Every path stores rank only where the label changed.
// The returned tl is the next round's candidate list.  Bound by memory and
// by the random rank gather and store: the tie scan reads gs around each
// candidate twice and writes 4 bytes a member; a tiny or medium member is
// read once and written once (about 40 bytes with two random 4-byte
// accesses), a large one moves the sort's 24 bytes a pass.
// ---------------------------------------------------------------------------
enum { kCtlOff = 0, kCtlMw, kCtlPoisoned, kCtlAnyTied, kCtlNext, kCtlSize };

constexpr int kTiny = 32;             // a tiny group has at most kTiny members
constexpr int kSegLogT = 12;
constexpr int kSegT = 1 << kSegLogT;  // a medium one at most kSegT
constexpr int kSegThreads = 512;
constexpr int kSegWarps = kSegThreads / 32;
constexpr int kSegItems = 16;
constexpr int kSegCap = kSegThreads * kSegItems;  // members a block may take
static_assert(kSegCap == 2 * kSegT, "a block takes the groups starting in "
              "its kSegT positions, each of at most kSegT members");
// A block's staged word: the member's offset from the block's first list
// position above its sort key (group << W | key, at most 13 + 38 bits).
constexpr int kSegIdxShift = 51;
constexpr uint64_t kSegKeyMask = (1ull << kSegIdxShift) - 1;
constexpr unsigned kClassBit = 0x80000000u;  // gl: large; r2b: tiny
constexpr size_t kSegSmem = sizeof(uint64_t) * kSegCap +
                            sizeof(unsigned) * kSegWarps * kRadix;

// Bits W with 2^W > N: group starts and r2 + 1 both fit in W bits.
int key_width(long long N) {
  int w = 1;
  while ((1LL << w) <= N) ++w;
  return w;
}

int bit_length(long long x) {
  int b = 0;
  while (x > 0) {
    ++b;
    x >>= 1;
  }
  return b;
}

unsigned walk_grid(long long n);

// Group g has more than `size` members: slot g + size is in it.
__device__ __forceinline__ bool group_above(const int* gs, long long N, int g,
                                            int size) {
  const long long q = static_cast<long long>(g) + size;
  return q < N && gs[q] == g;
}

// Stream compaction in two passes over n items, kCompactTile a block: the
// count kernel writes each tile's count of items for which p.test(i)
// holds, those counts are scanned (offs, with the total at offs[tiles]),
// and the emit kernel recounts its tile and calls p.emit(i, o) with o the
// item's place among them, in order.  Item q of thread t is base + q *
// kThreads + t, so neighbouring threads read neighbouring items; the emit
// kernel places them with one ballot a warp and item.  With dn the device
// holds the count.
constexpr int kCompactItems = 8;
constexpr int kCompactTile = kThreads * kCompactItems;

template <class P>
__global__ void compact_count_kernel(P p, long long n, const int* dn,
                                     int* __restrict__ counts) {
  if (dn != nullptr && *dn < n) n = *dn;
  const long long base = static_cast<long long>(blockIdx.x) * kCompactTile +
                         threadIdx.x;
  int c = 0;
#pragma unroll
  for (int q = 0; q < kCompactItems; ++q) {
    const long long i = base + q * kThreads;
    c += i < n && p.test(i) ? 1 : 0;
  }
  int total;
  block_exclusive_scan<SumOp>(c, &total);
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

template <class P>
__global__ void compact_emit_kernel(P p, long long n, const int* dn,
                                    const int* __restrict__ offs) {
  __shared__ int s_off[kCompactItems * kWarps];  // item-major, then warp
  if (dn != nullptr && *dn < n) n = *dn;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kCompactTile +
                         threadIdx.x;
  unsigned ballot[kCompactItems];
#pragma unroll
  for (int q = 0; q < kCompactItems; ++q) {
    const long long i = base + q * kThreads;
    ballot[q] = __ballot_sync(kFull, i < n && p.test(i));
    if (lane == 0) s_off[q * kWarps + warp] = __popc(ballot[q]);
  }
  __syncthreads();
  if (warp == 0) {  // exclusive scan of the 64 counts, two a lane
    static_assert(kCompactItems * kWarps == 64, "two counts a lane");
    const int a = s_off[2 * lane];
    const int b = s_off[2 * lane + 1];
    int incl = a + b;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int excl = incl - a - b;
    s_off[2 * lane] = excl;
    s_off[2 * lane + 1] = excl + a;
  }
  __syncthreads();
  const long long first = offs[blockIdx.x];
  const unsigned lower_lanes = (1u << lane) - 1u;
#pragma unroll
  for (int q = 0; q < kCompactItems; ++q) {
    if (ballot[q] >> lane & 1u) {
      p.emit(base + q * kThreads,
             first + s_off[q * kWarps + warp] + __popc(ballot[q] & lower_lanes));
    }
  }
}

struct CompactBufs {
  int* counts;  // [tiles]
  int* offs;    // [tiles + 1]
  int* scan;
};

CompactBufs carve_compact(Arena& a, long long n) {
  const long long tiles = cdiv(n, kCompactTile);
  CompactBufs b;
  b.counts = a.take<int>(tiles);
  b.offs = a.take<int>(tiles + 1);
  b.scan = a.take<int>(scan_scratch_elems(tiles));
  return b;
}

// Compacts n items (at most n; *dn on the device when given); the number
// emitted ends up at b.offs + tiles, returned.
template <class P>
const int* compact(const P& p, long long n, const int* dn,
                   const CompactBufs& b, cudaStream_t st) {
  const long long tiles = cdiv(n, kCompactTile);
  if (tiles > 0) {
    compact_count_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        p, n, dn, b.counts);
    scan_levels<SumOp>(b.counts, b.offs, tiles, true, b.scan, st);
  }
  scan_total_kernel<<<1, 1, 0, st>>>(b.counts, b.offs, tiles);
  if (tiles > 0) {
    compact_emit_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
        p, n, dn, b.offs);
  }
  return b.offs + tiles;
}

// Candidate b is slot cand[b], or b without a list; it is kept when tied.
struct TiePred {
  const int* gs;
  long long N;
  const int* cand;
  int* tl;
  __device__ long long slot(long long b) const {
    return cand != nullptr ? cand[b] : b;
  }
  __device__ bool test(long long b) const {
    const long long s = slot(b);
    const int g = gs[s];
    return (s + 1 < N && gs[s + 1] == g) || (s > 0 && gs[s - 1] == g);
  }
  __device__ void emit(long long b, long long o) const {
    tl[o] = static_cast<int>(slot(b));
  }
};

// The members of a segmented sort, list position t each, as the block
// kernel and the large path read them (M): slot(t) its slot, group(t) the
// slot of its group's first member (groups are runs of consecutive slots,
// listed in slot order), key(t) its sort key within the group (M::Key),
// pos(t) the position that lands in its slot, large(t) whether its group
// has more than kSegT members, and load() a block's items at once.  B2
// reads the gathered round (RoundMembers), the anchored inits the top-bits
// buckets (InitMembers).
//
// A sink (Out) stores each member's result: put(slot, p, f, g) with f its
// new label, g its group's start, and label(s) the label slot s holds
// before the stage.
struct RoundMembers {
  using Key = unsigned;
  const int* tl;
  const unsigned* r2b;  // r2 + 1, | kClassBit for a tiny group
  const unsigned* gl;   // g, | kClassBit for a large group
  const int* posb;
  __device__ long long slot(long long t) const { return tl[t]; }
  __device__ long long group(long long t) const { return gl[t] & ~kClassBit; }
  __device__ Key key(long long t) const { return r2b[t] & ~kClassBit; }
  __device__ int pos(long long t) const { return posb[t]; }
  __device__ bool large(long long t) const { return (gl[t] & kClassBit) != 0; }
  // Items i0 .. i0 + kSegItems - 1 (i0 a multiple of kSegItems): off[q] =
  // the member's offset in its group for a medium group's member, else -1,
  // and its key.  16-byte loads where the items are all in the list.
  __device__ void load(long long i0, long long m, int* off, Key* key) const {
    unsigned gv[kSegItems], rv[kSegItems];
    int tv[kSegItems];
    if (i0 + kSegItems <= m) {
#pragma unroll
      for (int v = 0; v < kSegItems / 4; ++v) {
        const uint4 a = reinterpret_cast<const uint4*>(gl + i0)[v];
        const uint4 b = reinterpret_cast<const uint4*>(r2b + i0)[v];
        const int4 c = reinterpret_cast<const int4*>(tl + i0)[v];
        gv[4 * v] = a.x; gv[4 * v + 1] = a.y; gv[4 * v + 2] = a.z; gv[4 * v + 3] = a.w;
        rv[4 * v] = b.x; rv[4 * v + 1] = b.y; rv[4 * v + 2] = b.z; rv[4 * v + 3] = b.w;
        tv[4 * v] = c.x; tv[4 * v + 1] = c.y; tv[4 * v + 2] = c.z; tv[4 * v + 3] = c.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kSegItems; ++q) {
        const bool in = i0 + q < m;
        gv[q] = in ? gl[i0 + q] : kClassBit;
        rv[q] = in ? r2b[i0 + q] : 0;
        tv[q] = in ? tl[i0 + q] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) {
      const bool medium = !(gv[q] & kClassBit) && !(rv[q] & kClassBit);
      off[q] = medium ? tv[q] - static_cast<int>(gv[q]) : -1;
      key[q] = rv[q];
    }
  }
};

// B2's stores: sa always, gs and rank only where the label changed (a
// member whose label stays its group's start keeps both).  B9 relabels
// every slot after the refine and passes no rank.
struct RoundOut {
  int* sa;
  int* rank;
  int* gs;
  __device__ int label(long long s) const { return gs[s]; }
  __device__ void put(long long slot, int p, int f, long long g) const {
    sa[slot] = p;
    if (f != g) {
      gs[slot] = f;
      if (rank != nullptr) rank[p] = f;
    }
  }
};

// List position t is kept when its group is large, as the sort's pair at
// its place o among the large members: key (its group's start in that
// order >> kSegLogT) << W | its key, value its position; lslot[o] gets its
// slot.  Places from cap on are not written (the inits' capacity; their
// caller then drops the large path).
template <class M>
struct LargePred {
  M mem;
  int W;
  uint64_t* keys;
  int* vals;
  int* lslot;
  long long cap;
  __device__ bool test(long long t) const { return mem.large(t); }
  __device__ void emit(long long t, long long o) const {
    if (o >= cap) return;
    const long long s = mem.slot(t);
    const long long lstart = o - (s - mem.group(t));
    keys[o] = (static_cast<uint64_t>(lstart >> kSegLogT) << W) | mem.key(t);
    vals[o] = mem.pos(t);
    lslot[o] = static_cast<int>(s);
  }
};

__global__ void copy_count_kernel(const int* from, int* to) { *to = *from; }

// The members' reads, before the round stores anything.
struct SegGather {
  const int* sa;
  const int* rank;
  const int* gs;
  long long N;
  long long k;
  unsigned* r2b;
  unsigned* gl;
  int* posb;
  // List position t holds slot s: r2b = r2 + 1 (| kClassBit for a tiny
  // group), gl = g (| kClassBit for a large group), posb = the position.
  __device__ void operator()(long long t, int s) const {
    const int g = gs[s];
    const int pos = sa[s];
    const long long q = static_cast<long long>(pos) + k;
    const long long r2 = q < N ? rank[q] : -1;
    const bool tiny = !group_above(gs, N, g, kTiny);
    r2b[t] = static_cast<unsigned>(r2 + 1) | (tiny ? kClassBit : 0);
    gl[t] = static_cast<unsigned>(g) |
            (!tiny && group_above(gs, N, g, kSegT) ? kClassBit : 0);
    posb[t] = pos;
  }
};

__global__ void seg_gather_kernel(const int* __restrict__ tl, long long m,
                                  const int* dm, SegGather read) {
  if (dm != nullptr && *dm < m) m = *dm;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < m; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    read(t, tl[t]);
  }
}

// B10's window: the marked span slots (flags, dest from the window scan,
// slot off + b for flags[b]) are listed into tl as they are read.
__global__ void seg_gather_marks_kernel(const int* __restrict__ flags,
                                        const int* __restrict__ dest,
                                        long long span, const int* ctl,
                                        int* __restrict__ tl,
                                        SegGather read) {
  const long long off = ctl[kCtlOff];
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       b < span; b += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (!flags[b]) continue;
    const int t = dest[b];
    const int s = static_cast<int>(off + b);
    tl[t] = s;
    read(t, s);
  }
}

// A window's marks, for the refine that lists them itself.
struct Marks {
  const int* flags;
  const int* dest;
  long long span;
  const int* ctl;
};

// A tiny member's new slot is g + (members with a smaller r2) + (earlier
// members with its r2), its label g + (members with a smaller r2): one
// thread a member, reading its group's r2 (at most kTiny, from cache).
__global__ void seg_tiny_kernel(const int* __restrict__ tl, long long m,
                                const int* dm,
                                const unsigned* __restrict__ r2b,
                                const unsigned* __restrict__ gl,
                                const int* __restrict__ posb,
                                int* __restrict__ sa, int* __restrict__ rank,
                                int* __restrict__ gs) {
  if (dm != nullptr && *dm < m) m = *dm;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < m; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const unsigned w = r2b[t];
    if (!(w & kClassBit)) continue;
    const unsigned r = w & ~kClassBit;
    const unsigned g = gl[t];  // a tiny group is never large
    const long long b0 = t - (tl[t] - static_cast<long long>(g));
    const long long end = b0 + kTiny < m ? b0 + kTiny : m;
    int lt = 0, eq = 0;
    for (long long j = b0; j < end && gl[j] == g; ++j) {
      const unsigned rj = r2b[j] & ~kClassBit;
      lt += rj < r ? 1 : 0;
      eq += rj == r && j < t ? 1 : 0;
    }
    const int p = posb[t];
    const int slot = static_cast<int>(g) + lt + eq;
    sa[slot] = p;
    if (lt) {
      const int f = static_cast<int>(g) + lt;
      gs[slot] = f;
      if (rank != nullptr) rank[p] = f;
    }
  }
}

__device__ __forceinline__ unsigned long long warp_or64(unsigned long long x) {
  const unsigned lo = __reduce_or_sync(kFull, static_cast<unsigned>(x));
  const unsigned hi = __reduce_or_sync(kFull, static_cast<unsigned>(x >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

__device__ __forceinline__ unsigned long long warp_and64(unsigned long long x) {
  const unsigned lo = __reduce_and_sync(kFull, static_cast<unsigned>(x));
  const unsigned hi = __reduce_and_sync(kFull, static_cast<unsigned>(x >> 32));
  return (static_cast<unsigned long long>(hi) << 32) | lo;
}

// Block b refines the medium groups whose first list position lies in [b *
// kSegT, (b + 1) * kSegT): fewer than kSegCap members.  It compacts them
// into shared memory as (offset, group << W | key) words, group being the
// member's group's first index there, and radix-sorts the words 8 bits a
// pass, stably
// (warp-striped items ranked with __match_any_sync, as the one-sweep pass
// ranks them), skipping every digit that no two of its keys differ in.
// Each member's run start (a max-scan of the key changes: per warp with
// shuffles, then across warps) gives its new label, and the sink stores
// it.
template <class M, class Out>
__global__ void __launch_bounds__(kSegThreads, 2)
seg_small_kernel(M mem, long long m, const int* dm, int W, Out out) {
  extern __shared__ uint4 seg_smem[];
  uint64_t* stage = reinterpret_cast<uint64_t*>(seg_smem);
  unsigned* swarp = reinterpret_cast<unsigned*>(stage + kSegCap);
  __shared__ unsigned long long s_or, s_and;
  __shared__ int s_digit[kRadix];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (dm != nullptr && *dm < m) m = *dm;
  const long long base = static_cast<long long>(blockIdx.x) * kSegT;
  if (base >= m) return;
  if (t == 0) {
    s_or = 0;
    s_and = ~0ull;
  }
  // Members: thread t tests positions base + 16 t .. base + 16 t + 15.
  const long long i0 = base + static_cast<long long>(t) * kSegItems;
  int off[kSegItems];
  typename M::Key kv[kSegItems];
  mem.load(i0, m, off, kv);
  unsigned mine = 0;
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    if (off[q] >= 0) {
      const long long b0 = i0 + q - off[q];
      if (b0 >= base && b0 < base + kSegT) mine |= 1u << q;
    }
  }
  int cnt;
  int ci = block_exclusive_scan<SumOp, kSegWarps>(__popc(mine), &cnt);
  if (cnt == 0) return;
  unsigned long long kor = 0, kand = ~0ull;
#pragma unroll
  for (int q = 0; q < kSegItems; ++q) {
    if (!(mine >> q & 1u)) continue;
    const long long i = i0 + q;
    const long long grp = ci - off[q];
    const uint64_t key = (static_cast<uint64_t>(grp) << W) | kv[q];
    stage[ci++] = (static_cast<uint64_t>(i - base) << kSegIdxShift) | key;
    kor |= key;
    kand &= key;
  }
  kor = warp_or64(kor);
  kand = warp_and64(kand);
  if (lane == 0) {
    atomicOr(&s_or, kor);
    atomicAnd(&s_and, kand);
  }
  __syncthreads();
  const uint64_t vary = s_or ^ s_and;
  // Each warp takes a contiguous run of 32 jn members (its items j < jn),
  // jn the fewest that cover cnt, so every warp has work however few
  // members the block holds, and warp order stays member order.
  const int jn = (cnt + kSegThreads - 1) / kSegThreads;
  const int wbase = warp * 32 * jn + lane;
  const unsigned lower_lanes = (1u << lane) - 1u;
  for (int shift = 0; shift < kSegIdxShift; shift += kRadixBits) {
    if (((vary >> shift) & (kRadix - 1)) == 0) continue;  // one digit
    uint64_t item[kSegItems];
    unsigned slot2[kSegItems / 2];  // two 16-bit ranks a word
    for (int x = t; x < kSegWarps * kRadix; x += kSegThreads) swarp[x] = 0;
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      const int idx = wbase + 32 * j;
      item[j] = j < jn && idx < cnt ? stage[idx] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (j >= jn) break;
      const bool valid = wbase + 32 * j < cnt;
      const int d = valid ? static_cast<int>((item[j] >> shift) &
                                             (kRadix - 1))
                          : kRadix;
      const unsigned peers = __match_any_sync(kFull, d);
      const unsigned below = peers & lower_lanes;
      const unsigned before = valid ? swarp[warp * kRadix + d] : 0;
      __syncwarp();
      if (valid && below == 0) {
        swarp[warp * kRadix + d] = before + __popc(peers);
      }
      __syncwarp();
      const unsigned r = before + __popc(below);
      if (j & 1) {
        slot2[j >> 1] |= r << 16;
      } else {
        slot2[j >> 1] = r;
      }
    }
    __syncthreads();
    unsigned count = 0;
    if (t < kRadix) {
      for (int w = 0; w < kSegWarps; ++w) {
        const unsigned x = swarp[w * kRadix + t];
        swarp[w * kRadix + t] = count;
        count += x;
      }
    }
    int total;
    const int start = block_exclusive_scan<SumOp, kSegWarps>(
        t < kRadix ? static_cast<int>(count) : 0, &total);
    if (t < kRadix) s_digit[t] = start;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kSegItems; ++j) {
      if (j >= jn) break;
      if (wbase + 32 * j < cnt) {
        const int d = static_cast<int>((item[j] >> shift) & (kRadix - 1));
        const int r = static_cast<int>((slot2[j >> 1] >> (16 * (j & 1))) &
                                       0xffffu);
        stage[s_digit[d] + static_cast<int>(swarp[warp * kRadix + d]) + r] =
            item[j];
      }
    }
    __syncthreads();
  }
  // Run starts in sorted order, warp-striped: index wbase + 32 j.
  int run[kSegItems];
  int carry = INT_MIN;
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    const int idx = wbase + 32 * j;
    int v = INT_MIN;
    if (j < jn && idx < cnt &&
        (idx == 0 || ((stage[idx] ^ stage[idx - 1]) & kSegKeyMask) != 0)) {
      v = idx;
    }
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, v, o);
      if (lane >= o && y > v) v = y;
    }
    run[j] = v > carry ? v : carry;
    carry = __shfl_sync(kFull, run[j], 31);
  }
  int total;
  const int prefix = __shfl_sync(
      kFull, block_exclusive_scan<MaxOp, kSegWarps>(
                 lane == 31 ? carry : INT_MIN, &total), 0);
#pragma unroll
  for (int j = 0; j < kSegItems; ++j) {
    const int idx = wbase + 32 * j;
    if (j >= jn || idx >= cnt) break;
    const uint64_t w = stage[idx];
    const int r = run[j] > prefix ? run[j] : prefix;
    const long long i = base + static_cast<long long>(w >> kSegIdxShift);
    const long long g = mem.group(i);
    const int grp = static_cast<int>((w & kSegKeyMask) >> W);
    out.put(g + (idx - grp), mem.pos(i), static_cast<int>(g + (r - grp)),
            g);
  }
}

// One launch of seg_small_kernel over m list positions, kSegT a block,
// with the shared memory it asks for.
template <class M, class Out>
void launch_seg_small(const M& mem, long long m, const int* dm, int W,
                      const Out& out, cudaStream_t st) {
  static bool smem_set = false;
  if (!smem_set) {
    cudaFuncSetAttribute(seg_small_kernel<M, Out>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(kSegSmem));
    smem_set = true;
  }
  seg_small_kernel<<<static_cast<unsigned>(cdiv(m, kSegT)), kSegThreads,
                     kSegSmem, st>>>(mem, m, dm, W, out);
}

__global__ void refine_change_kernel(const uint64_t* __restrict__ keys,
                                     const int* __restrict__ slots,
                                     long long m, const int* dn,
                                     int* __restrict__ starts) {
  if (dn != nullptr && *dn < m) m = *dn;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       b < m; b += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool change = b == 0 || keys[b] != keys[b - 1];
    starts[b] = change ? slots[b] : 0;
  }
}

// In B2 a member whose new label f is its group's old start g keeps its
// rank (rank[p] = gs[slot] = g before the round), so only the members of
// the later subgroups of a split group pay the random rank store.
template <class Out>
__global__ void refine_scatter_kernel(const int* __restrict__ slots,
                                      const int* __restrict__ vals,
                                      const int* __restrict__ first_eq,
                                      long long m, const int* dn, Out out) {
  if (dn != nullptr && *dn < m) m = *dn;
  for (long long b = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       b < m; b += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int s = slots[b];
    out.put(s, vals[b], first_eq[b], out.label(s));
  }
}

// The refine's buffers over m members.  r2b, gl and posb are dead once the
// large keys are made and the tiny and medium members stored, so the
// sort's alternate buffers reuse them.
struct SegBufs {
  unsigned* r2b;
  unsigned* gl;
  int* posb;
  int* lslot;
  int* first_eq;
  uint64_t* keys;
  int* vals;
  SortBufs sort;
  CompactBufs compact;
  int* scan;
  int* tl;  // the list, when the caller keeps none (B10)
};

SegBufs carve_seg(Arena& a, long long m, bool own_list) {
  SegBufs b;
  const size_t x = a.off;
  Arena gather{a.base, x};
  b.r2b = gather.take<unsigned>(m);
  b.gl = gather.take<unsigned>(m);
  b.posb = gather.take<int>(m);
  Arena alt{a.base, x};
  b.sort.keys_alt = alt.take<uint64_t>(m);
  b.sort.vals_alt = alt.take<int>(m);
  a.off = gather.off > alt.off ? gather.off : alt.off;
  b.lslot = a.take<int>(m);
  b.first_eq = a.take<int>(m);
  b.keys = a.take<uint64_t>(m);
  b.vals = a.take<int>(m);
  b.sort.status = a.take<unsigned long long>(kRadix * cdiv(m, kSortTile));
  b.sort.hist = a.take<unsigned>(kSortCounters);
  b.compact = carve_compact(a, m);
  b.scan = a.take<int>(scan_scratch_elems(m));
  b.tl = own_list ? a.take<int>(m) : nullptr;
  return b;
}

// The refine of the m listed members (see the B2 section); counts[1] gets
// the large members' count.  With marks, the list tl is written from them
// first, by the gather.  With dm the device holds the count (m its bound);
// without store_rank the ranks are read for r2 and never written.
void seg_refine(int* sa, int* rank, int* gs, long long N, long long k,
                int* tl, long long m, int* counts, const SegBufs& b,
                cudaStream_t st, const Marks* marks = nullptr,
                const int* dm = nullptr, bool store_rank = true) {
  if (m <= 0) return;
  const int W = key_width(N);
  const unsigned grid = grid_for(m);
  int* rank_out = store_rank ? rank : nullptr;
  const SegGather read{sa, rank, gs, N, k, b.r2b, b.gl, b.posb};
  if (marks != nullptr) {
    seg_gather_marks_kernel<<<grid_for(marks->span), kThreads, 0, st>>>(
        marks->flags, marks->dest, marks->span, marks->ctl, tl, read);
  } else {
    seg_gather_kernel<<<grid, kThreads, 0, st>>>(tl, m, dm, read);
  }
  const RoundMembers mem{tl, b.r2b, b.gl, b.posb};
  const RoundOut out{sa, rank_out, gs};
  const int* ml = compact(
      LargePred<RoundMembers>{mem, W, b.keys, b.vals, b.lslot, m}, m, dm,
      b.compact, st);
  copy_count_kernel<<<1, 1, 0, st>>>(ml, counts + 1);
  seg_tiny_kernel<<<grid, kThreads, 0, st>>>(tl, m, dm, b.r2b, b.gl, b.posb,
                                             sa, rank_out, gs);
  launch_seg_small(mem, m, dm, W, out, st);
  const Pairs sorted = radix_sort_pairs(
      b.keys, b.vals, m, W + bit_length((m - 1) >> kSegLogT), b.sort, st,
      ml);
  // The large path's grid-stride kernels run on a few waves of blocks: its
  // count is on the device, often 0, and a grid sized by m would spend
  // its time scheduling blocks that exit at once.
  const unsigned large_grid = walk_grid(m);
  int* first_eq = b.first_eq;
  refine_change_kernel<<<large_grid, kThreads, 0, st>>>(
      sorted.keys, b.lslot, m, ml, first_eq);
  scan_levels<MaxOp>(first_eq, first_eq, m, false, b.scan, st, ml);
  refine_scatter_kernel<<<large_grid, kThreads, 0, st>>>(
      b.lslot, sorted.vals, first_eq, m, ml, out);
}

// ---------------------------------------------------------------------------
// B1 and B1b, the anchored init sorts.  B1 replaces
// _init_round_anchored_ranked (pysubstringsearch_tpu/ops/suffix_array.py),
// which sorts two int32 limbs of D = 30 / bits rank digits with lax.sort;
// B1b replaces _init_round_anchored (reached through _segmented_kernel and
// _derive_sa_seg_jit), which sorts the pair (limb0, limb1) of three
// base-257 byte digits each.  Both return, bit for bit, the stable sort of
// their keys (see "The anchored inits' keys"): pad slots i < N - n hold
// N - 1 - i, every slot up to N - n starts a group, gs is the max-scan of
// the group starts and rank[sa[i]] = gs[i].  B10's init (pss_sa_init3_bytes,
// a 25-bit key of 3 byte digits) is the same function by the full path's
// steps alone (its key has no low bits worth a bucket stage), on 32-bit
// keys inside its own outputs (section "B10").
//
// A full LSD sort of the 60- or 50-bit keys runs 8 or 7 passes of 12-byte
// pairs; here the key is split at its top `cut` bits instead:
//   1. init_hist_kernel makes every (key, position) pair from the text (1
//      byte a slot, the neighbours from L1), writes it and counts the
//      digits of the top passes; for every 17th position it also counts
//      the top bits' bucket in a hashed table, from which
//      init_decide_kernel estimates the slots in buckets of more than kSegT
//      members.
//   2. Where that estimate is at most 1 / kCrossDiv of the row (the hybrid
//      path), ceil(cut / 8) one-sweep passes sort the pairs by the top bits
//      alone, none skipped, so the buffer they end in is known to the host.
//      Each top-bits bucket is then a run of slots in position order, and
//      the low bits are sorted within it by B2's segmented stages
//      (InitMembers): a bucket of at most kSegT members in a block's shared
//      memory, a larger one by the one-sweep sort on (its ordinal in the
//      large list, the low bits), at most cap members.  The stages write sa
//      and gs (InitOut): no groups kernel, no whole-row max-scan of the
//      sorted keys, only the bucket starts'.
//   3. Otherwise, or where more than cap members turned out large (the
//      estimate samples), the full path: a one-sweep sort of the whole key
//      (one-bin digits skipped), the groups read from whichever buffer the
//      executed passes left (no copy back) and the max-scan.  The digit
//      kind's UTF-16 rows take it: 3
//      characters fill their 50-bit key, and nearly every slot lies in a
//      large bucket.
//   4. rank[sa[i]] = gs[i], blocked by destination without a sort pass:
//      the pad slots (the top-bits bucket 0, exactly the positions past n)
//      are closed-form, rank included, since their positions are
//      contiguous; the real slots' (position, label) pairs are appended to
//      their position's bin (RankBins: each position is one destination,
//      so bin b holds exactly the positions [b << bshift, (b + 1) <<
//      bshift) below n and starts there), then stored bin by bin, so that
//      a bin's stores meet in a few MB of L2.
// A path not taken costs its launches: each of its kernels reads a device
// count (ctl) that is 0 for it.  Bound by memory: the hybrid path moves
// 1 + 12 bytes a slot to make the pairs, (cut / 8) x 24 in its top passes,
// about 40 in the bucket stages (the pairs twice, the bucket starts, sa
// and gs) and 28 in the rank store, against 12 + 8 + 7 x 24 + 60 for a
// full sort, its groups and a blocked store.
// ---------------------------------------------------------------------------
enum { kIPath = 0, kIEst, kILarge, kIHybridN, kIFullN, kICtl };

constexpr int kSampleStride = 17;  // odd: the digit kind alternates bytes
constexpr int kCrossDiv = 8;
constexpr int kCutRanked = 24;  // B1: 3 top passes, 36 low bits
constexpr int kCutBytes = 32;   // B1b: 4 top passes, 18 low bits

// A thread's text window for the keys of positions p0 .. p0 + 15 (p0 a
// multiple of 16): the bytes p0 .. p0 + 31 (two 16-byte loads where they
// lie in the row and the text is 16-byte aligned, else byte loads),
// byte(j) = text[p0 + j] (0 past the row) and real(j) = p0 + j < n.
// Indexed only by constants once the callers' loops unroll, so the words
// stay in registers.
struct TextWindow {
  unsigned w[8];
  long long p0;
  long long n;
  __device__ TextWindow(const uint8_t* text, long long N, long long n_,
                        long long p) : p0(p), n(n_) {
    if (p0 + 32 <= N && aligned16(text)) {
      const uint4 a = reinterpret_cast<const uint4*>(text + p0)[0];
      const uint4 b = reinterpret_cast<const uint4*>(text + p0)[1];
      w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
      w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
    } else {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        unsigned word = 0;
        for (int j = 0; j < 4; ++j) {
          const long long q = p0 + 4 * v + j;
          word |= static_cast<unsigned>(q < N ? text[q] : 0) << (8 * j);
        }
        w[v] = word;
      }
    }
  }
  __device__ int byte(int j) const {
    return static_cast<int>((w[j >> 2] >> (8 * (j & 3))) & 0xffu);
  }
  __device__ bool real(int j) const { return p0 + j < n; }
};

// B1's key source: kWidth = 2D digits of 60 / kWidth bits through the byte
// -> rank map; 16 consecutive keys shift one digit in each.
template <int kWidth>
struct RankedSrc {
  static constexpr bool kRankMap = true;
  static constexpr int bits = 60 / kWidth;
  const uint8_t* text;
  long long n;
  const int* rank;
  __device__ void keys16(const TextWindow& tw, const int* srank,
                         uint64_t* key) const {
    constexpr int width = kWidth;
    constexpr uint64_t mask = (1ull << (width * bits)) - 1;
    uint64_t k = 0;
#pragma unroll
    for (int d = 0; d < width - 1; ++d) {
      k = (k << bits) |
          (tw.real(d) ? static_cast<uint64_t>(srank[tw.byte(d)]) : 0);
    }
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const int j = r + width - 1;
      k = ((k << bits) |
           (tw.real(j) ? static_cast<uint64_t>(srank[tw.byte(j)]) : 0)) &
          mask;
      key[r] = tw.real(r) ? k : 0;
    }
  }
};

// B1b's key source (kWidth 6: limb0 << 25 | limb1) and B10's (kWidth 3:
// limb0 alone), from a window of the digits that slides one byte a key.
template <int kWidth>
struct ByteSrc {
  static constexpr bool kRankMap = false;
  const uint8_t* text;
  long long n;
  const int* rank;  // unused
  __device__ void keys16(const TextWindow& tw, const int*,
                         uint64_t* key) const {
    uint64_t d[kWidth];
#pragma unroll
    for (int j = 0; j < kWidth - 1; ++j) {
      d[j + 1] = tw.real(j) ? static_cast<uint64_t>(tw.byte(j)) + 1 : 0;
    }
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
#pragma unroll
      for (int j = 0; j < kWidth - 1; ++j) d[j] = d[j + 1];
      const int last = r + kWidth - 1;
      d[kWidth - 1] =
          tw.real(last) ? static_cast<uint64_t>(tw.byte(last)) + 1 : 0;
      const uint64_t limb0 = (d[0] * 257 + d[1]) * 257 + d[2];
      uint64_t k = limb0;
      if constexpr (kWidth == 6) {
        k = (limb0 << 25) |
            ((d[kWidth - 3] * 257 + d[kWidth - 2]) * 257 + d[kWidth - 1]);
      }
      key[r] = tw.real(r) ? k : 0;
    }
  }
};

__device__ __forceinline__ unsigned sample_bin(uint64_t top, int bits) {
  return static_cast<unsigned>((top * 0x9E3779B97F4A7C15ull) >> (64 - bits));
}

// The pairs (key, position) of every slot, the counts of the `sets`
// digits at low, low + 8, ... (runs of one digit merged as in
// onesweep_hist_kernel) and, unless samp is null, the sampled bucket
// counts.  A thread makes the
// keys of 16 consecutive positions from one text window; they are staged
// in shared memory (padded a word every 16, so the lanes' stores and loads
// meet no bank twice) and stored in the pass kernels' striped order, as K
// (B10's 25-bit keys as uint32_t).
template <class Src, class K = uint64_t>
__global__ void __launch_bounds__(kThreads)
init_hist_kernel(Src src, long long N, int low, int sets,
                 K* __restrict__ keys, int* __restrict__ vals,
                 int* __restrict__ samp, int samp_bits,
                 unsigned* __restrict__ hist) {
  __shared__ unsigned counts[kMaxPasses][kRadix];
  __shared__ uint64_t s_keys[kSortTile + kSortTile / kSortItems];
  __shared__ int s_rank[Src::kRankMap ? kRadix : 1];
  const int t = threadIdx.x;
  for (int c = 0; c < kMaxPasses; ++c) counts[c][t] = 0;
  if constexpr (Src::kRankMap) s_rank[t] = src.rank[t];
  __syncthreads();
  for (long long base = static_cast<long long>(blockIdx.x) * kSortTile;
       base < N; base += static_cast<long long>(gridDim.x) * kSortTile) {
    const long long p0 = base + static_cast<long long>(t) * kSortItems;
    uint64_t key[kSortItems];
    src.keys16(TextWindow(src.text, N, src.n, p0), s_rank, key);
    const long long left = N - p0;
    for (int c = 0; c < sets; ++c) {
      const int shift = low + kRadixBits * c;
      int prev = -1;
      unsigned run = 0;
#pragma unroll
      for (int r = 0; r < kSortItems; ++r) {
        if (r >= left) break;
        const int d = static_cast<int>((key[r] >> shift) & (kRadix - 1));
        if (d != prev) {
          if (run) atomicAdd(&counts[c][prev], run);
          prev = d;
          run = 0;
        }
        ++run;
      }
      if (run) atomicAdd(&counts[c][prev], run);
    }
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const long long i = p0 + r;
      if (samp != nullptr && i < src.n &&
          static_cast<unsigned>(i) % kSampleStride == 0) {
        atomicAdd(&samp[sample_bin(key[r] >> low, samp_bits)], 1);
      }
      s_keys[t * (kSortItems + 1) + r] = key[r];
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const int e = r * kThreads + t;
      const long long i = base + e;
      if (i < N) {
        keys[i] = static_cast<K>(s_keys[e + e / kSortItems]);
        vals[i] = static_cast<int>(i);
      }
    }
    __syncthreads();
  }
  __syncthreads();
  for (int c = 0; c < sets; ++c) {
    const unsigned x = counts[c][t];
    if (x) atomicAdd(&hist[c * kRadix + t], x);
  }
}

// Every top pass runs, so the host knows where they leave the pairs.
__global__ void init_skips_kernel(int* skip, int passes) {
  if (static_cast<int>(threadIdx.x) < passes) skip[threadIdx.x] = 0;
}

// ctl[kIEst] += the samples in table bins whose bucket, scaled up, has more
// than kSegT members.
__global__ void samp_large_kernel(const int* __restrict__ samp,
                                  long long size, int* __restrict__ ctl) {
  int sum = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < size; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int c = samp[i];
    if (static_cast<long long>(c) * kSampleStride > kSegT) sum += c;
  }
  int total;
  block_exclusive_scan<SumOp>(sum, &total);
  if (threadIdx.x == 0 && total) atomicAdd(&ctl[kIEst], total);
}

// The path: the hybrid one where the estimate allows it, else the full
// sort.
__global__ void init_decide_kernel(int* ctl, long long N, long long n) {
  const long long est = static_cast<long long>(ctl[kIEst]) * kSampleStride;
  const bool hybrid = est * kCrossDiv <= n;
  ctl[kIEst] = static_cast<int>(est < INT_MAX ? est : INT_MAX);
  ctl[kIPath] = hybrid ? 1 : 2;
  ctl[kIHybridN] = hybrid ? static_cast<int>(N) : 0;
  ctl[kIFullN] = hybrid ? 0 : static_cast<int>(N);
}

// After the large members are counted: more than cap turns the hybrid path
// off (path 3) and the full one on.
__global__ void init_guard_kernel(int* ml, long long cap, long long N,
                                  int* ctl) {
  const int large = *ml;
  ctl[kILarge] = large;
  if (large > cap) {
    *ml = 0;
    ctl[kIPath] = 3;
    ctl[kIHybridN] = 0;
    ctl[kIFullN] = static_cast<int>(N);
  }
}

// starts[i] = i where slot i starts a bucket (its top bits differ from
// slot i - 1's, or i <= npad), else 0; the max-scan gives each slot its
// bucket's start.
__global__ void bucket_starts_kernel(const uint64_t* __restrict__ keys,
                                     long long N, long long npad, int low,
                                     const int* dn, int* __restrict__ starts) {
  if (*dn == 0) return;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const bool start = i <= npad || (keys[i] >> low) != (keys[i - 1] >> low);
    starts[i] = start ? static_cast<int>(i) : 0;
  }
}

// The inits' members: the real slots (npad and on) of the top-bits-sorted
// pairs, its bucket the group (bs, the bucket starts), its low key bits
// the key.  Every bucket of at most kSegT members goes to the block kernel,
// a single member included (the tiny kernel is B2's alone).
struct InitMembers {
  using Key = uint64_t;
  const uint64_t* keys;
  const int* vals;
  const int* bs;
  long long N;
  long long npad;
  uint64_t mask;
  __device__ long long slot(long long t) const { return t; }
  __device__ long long group(long long t) const { return bs[t]; }
  __device__ Key key(long long t) const { return keys[t] & mask; }
  __device__ int pos(long long t) const { return vals[t]; }
  __device__ bool large(long long t) const {
    return group_above(bs, N, bs[t], kSegT);
  }
  __device__ void load(long long i0, long long m, int* off, Key* key) const {
    int g[kSegItems];
    uint64_t k[kSegItems];
    if (i0 + kSegItems <= m) {
#pragma unroll
      for (int v = 0; v < kSegItems / 4; ++v) {
        const int4 a = reinterpret_cast<const int4*>(bs + i0)[v];
        g[4 * v] = a.x; g[4 * v + 1] = a.y; g[4 * v + 2] = a.z; g[4 * v + 3] = a.w;
      }
#pragma unroll
      for (int v = 0; v < kSegItems / 2; ++v) {
        const uint4 a = reinterpret_cast<const uint4*>(keys + i0)[v];
        k[2 * v] = (static_cast<uint64_t>(a.y) << 32) | a.x;
        k[2 * v + 1] = (static_cast<uint64_t>(a.w) << 32) | a.z;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kSegItems; ++q) {
        const bool in = i0 + q < m;
        g[q] = in ? bs[i0 + q] : -1;
        k[q] = in ? keys[i0 + q] : 0;
      }
    }
#pragma unroll
    for (int q = 0; q < kSegItems; ++q) {
      const bool member =
          g[q] >= npad && !group_above(bs, N, g[q], kSegT);
      off[q] = member ? static_cast<int>(i0 + q - g[q]) : -1;
      key[q] = k[q] & mask;
    }
  }
};

// The inits' stores: sa and gs of every slot (the rank store's pairs are
// made from them afterwards).
struct InitOut {
  int* sa;
  int* gs;
  __device__ int label(long long) const { return 0; }
  __device__ void put(long long slot, int p, int f, long long) const {
    sa[slot] = p;
    gs[slot] = f;
  }
};

// The destinations' bins of the rank store: a position's top 8 bits; bin b
// holds the positions [b << shift, (b + 1) << shift) below n, each one
// destination, so its run of pairs starts at b << shift.
struct RankBins {
  uint64_t* pairs;
  unsigned* cursor;  // [kRadix]: the pairs each bin holds so far
  int shift;
  __device__ unsigned bin(int p) const {
    return static_cast<unsigned>(p) >> shift;
  }
  // The index of the first of c pairs that join bin b.
  __device__ unsigned claim(int b, unsigned c) const {
    return c ? (static_cast<unsigned>(b) << shift) + atomicAdd(&cursor[b], c)
             : 0;
  }
  __device__ bool holds(int) const { return true; }
};

// B10's rank store in parts: the bins of the positions [lo, hi) alone, bin b
// holding [lo + (b << shift), lo + ((b + 1) << shift)), so that a part's
// pairs fill hi - lo places, a fraction of the row.
struct RankPart {
  uint64_t* pairs;
  unsigned* cursor;
  int shift;
  int lo;
  int hi;
  __device__ unsigned bin(int p) const {
    return static_cast<unsigned>(p - lo) >> shift;
  }
  __device__ unsigned claim(int b, unsigned c) const {
    return c ? (static_cast<unsigned>(b) << shift) + atomicAdd(&cursor[b], c)
             : 0;
  }
  __device__ bool holds(int p) const { return p >= lo && p < hi; }
};

// The full path's groups, from the buffers its executed passes left the
// pairs in; starts as bucket_starts_kernel's.
__global__ void init_groups_parity_kernel(
    const uint64_t* __restrict__ kmain, const int* __restrict__ vmain,
    const uint64_t* __restrict__ kalt, const int* __restrict__ valt,
    const int* __restrict__ skip, int passes, long long N, long long npad,
    const int* dn, int* __restrict__ sa, int* __restrict__ starts) {
  if (*dn == 0) return;
  const bool odd = executed_before(skip, passes) & 1;
  const uint64_t* keys = odd ? kalt : kmain;
  const int* idx = odd ? valt : vmain;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    sa[i] = i < npad ? static_cast<int>(N - 1 - i) : idx[i];
    const bool changed = i <= npad || keys[i] != keys[i - 1];
    starts[i] = changed ? static_cast<int>(i) : 0;
  }
}

// The rank store's pairs (position << 32 | label) of the real slots npad
// .. N - 1 whose position the bins hold (RankBins: all) into their bins,
// kSortTile slots a block at a time: the tile's pairs are counted by bin,
// each bin's run claimed once, and the pairs staged in shared memory in bin
// order, so that neighbouring threads store neighbouring places of a run.
template <class Bins>
__global__ void __launch_bounds__(kThreads)
init_bin_pairs_kernel(const int* __restrict__ sa, const int* __restrict__ gs,
                      long long N, long long npad, Bins out) {
  __shared__ unsigned s_bin[kRadix];  // counts, then each bin's first index
  __shared__ unsigned s_at[kRadix];   // each bin's run in out.pairs
  __shared__ uint64_t s_pairs[kSortTile];
  const int t = threadIdx.x;
  for (long long base = npad + static_cast<long long>(blockIdx.x) *
                                   kSortTile;
       base < N; base += static_cast<long long>(gridDim.x) * kSortTile) {
    s_bin[t] = 0;
    __syncthreads();
    unsigned loc[kSortItems];
#pragma unroll
    for (int q = 0; q < kSortItems; ++q) {
      const long long i = base + q * kThreads + t;
      loc[q] = i < N && out.holds(sa[i])
                   ? atomicAdd(&s_bin[out.bin(sa[i])], 1u)
                   : 0;
    }
    __syncthreads();
    const unsigned c = s_bin[t];
    int total;
    const int first = block_exclusive_scan<SumOp>(static_cast<int>(c), &total);
    s_at[t] = out.claim(t, c);
    s_bin[t] = static_cast<unsigned>(first);
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kSortItems; ++q) {
      const long long i = base + q * kThreads + t;
      if (i < N && out.holds(sa[i])) {
        const int p = sa[i];
        s_pairs[s_bin[out.bin(p)] + loc[q]] =
            (static_cast<uint64_t>(static_cast<unsigned>(p)) << 32) |
            static_cast<unsigned>(gs[i]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kSortItems; ++r) {
      const int e = r * kThreads + t;
      if (e < total) {
        const uint64_t w = s_pairs[e];
        const unsigned bin = out.bin(static_cast<int>(w >> 32));
        out.pairs[s_at[bin] + (e - s_bin[bin])] = w;
      }
    }
    __syncthreads();
  }
}

// The pad slots s < npad, closed-form: position N - 1 - s, a group each.
__global__ void init_pads_kernel(long long N, long long npad,
                                 int* __restrict__ sa, int* __restrict__ rank,
                                 int* __restrict__ gs) {
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < npad; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    sa[s] = static_cast<int>(N - 1 - s);
    gs[s] = static_cast<int>(s);
    rank[N - 1 - s] = static_cast<int>(s);
  }
}

// rank[p] = label for the n binned pairs.
__global__ void rank_store_kernel(const uint64_t* __restrict__ pairs,
                                  long long n, int* __restrict__ rank) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint64_t w = pairs[i];
    rank[w >> 32] = static_cast<int>(static_cast<unsigned>(w));
  }
}

struct InitBufs {
  uint64_t* keys;  // the sorts' pairs and their alternates
  int* vals;
  uint64_t* keys_alt;
  int* vals_alt;
  unsigned long long* status;
  unsigned* hist;   // the top passes' counts, pass counters and skip flags
  unsigned* lhist;  // the large sort's and the full sort's
  unsigned* cursor;
  int* ctl;
  int* samp;
  int samp_bits;
  long long cap;  // large members the hybrid path takes
  uint64_t* lkeys;
  int* lvals;
  int* lslot;
  CompactBufs compact;
  int* scan;
};

InitBufs carve_init(Arena& a, long long N) {
  InitBufs b{};
  b.keys = a.take<uint64_t>(N);
  b.vals = a.take<int>(N);
  b.keys_alt = a.take<uint64_t>(N);
  b.vals_alt = a.take<int>(N);
  b.status = a.take<unsigned long long>(kRadix * cdiv(N, kSortTile));
  b.hist = a.take<unsigned>(kSortCounters);
  b.lhist = a.take<unsigned>(kSortCounters);
  b.cursor = a.take<unsigned>(kRadix);
  b.ctl = a.take<int>(kICtl);
  b.scan = a.take<int>(scan_scratch_elems(N));
  const int bits = bit_length(N) - 6;
  b.samp_bits = bits < 10 ? 10 : bits > 22 ? 22 : bits;
  b.samp = a.take<int>(1LL << b.samp_bits);
  b.cap = cdiv(N, 4);
  b.lkeys = a.take<uint64_t>(b.cap);
  b.lvals = a.take<int>(b.cap);
  b.lslot = a.take<int>(b.cap);
  b.compact = carve_compact(a, N);
  return b;
}

// The anchored init of `key_bits`-bit keys made by src, split at the top
// `cut` bits (see the section's head); stats, when not null, gets int32
// [3]: the path taken (1 hybrid, 2 full, 3 full after the cap), the
// estimated large members, the counted ones (0 on the full path).
template <class Src>
void anchored_init(const Src& src, long long N, long long n, int key_bits,
                   int cut, int* sa, int* rank, int* gs, const InitBufs& b,
                   int* stats, cudaStream_t st) {
  const long long npad = N - n;
  const int P = (key_bits + kRadixBits - 1) / kRadixBits;
  const int Q = (cut + kRadixBits - 1) / kRadixBits;
  const int low = key_bits - cut;
  const long long tiles = cdiv(N, kSortTile);
  const unsigned walk = walk_grid(N);
  int bshift = 0;  // a destination's bin is its top 8 bits
  while ((N - 1) >> (bshift + kRadixBits) > 0) ++bshift;
  int* counters = reinterpret_cast<int*>(b.hist + kMaxPasses * kRadix);
  int* skip = counters + kMaxPasses;
  const int* hyb_n = b.ctl + kIHybridN;
  const int* full_n = b.ctl + kIFullN;
  const bool in_alt = Q & 1;  // where the top passes leave the pairs
  uint64_t* kin = in_alt ? b.keys_alt : b.keys;
  int* vin = in_alt ? b.vals_alt : b.vals;
  const InitOut out{sa, gs};

  // 1. the pairs, their top digits' counts, the sampled buckets, the path
  cudaMemsetAsync(b.cursor, 0, sizeof(unsigned) * kRadix, st);
  cudaMemsetAsync(b.ctl, 0, sizeof(int) * kICtl, st);
  cudaMemsetAsync(b.status, 0, sizeof(unsigned long long) * kRadix * tiles,
                  st);
  cudaMemsetAsync(b.hist, 0, sizeof(unsigned) * kSortCounters, st);
  cudaMemsetAsync(b.samp, 0, sizeof(int) << b.samp_bits, st);
  init_hist_kernel<<<tiles < kHistBlocks ? static_cast<unsigned>(tiles)
                                         : kHistBlocks,
                     kThreads, 0, st>>>(src, N, low, Q, b.keys, b.vals,
                                        b.samp, b.samp_bits, b.hist);
  onesweep_bins_kernel<<<Q, kThreads, 0, st>>>(b.hist, skip);
  init_skips_kernel<<<1, 32, 0, st>>>(skip, Q);
  samp_large_kernel<<<walk_grid(1LL << b.samp_bits), kThreads, 0, st>>>(
      b.samp, 1LL << b.samp_bits, b.ctl);
  init_decide_kernel<<<1, 1, 0, st>>>(b.ctl, N, n);

  // 2. the hybrid path: the top passes, then the bucket stages
  for (int q = 0; q < Q; ++q) {
    onesweep_pass_kernel<uint64_t>
        <<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
            b.keys, b.vals, b.keys_alt, b.vals_alt, N, hyb_n, q,
            low + kRadixBits * q, b.hist + q * kRadix, skip, b.status,
            counters + q);
  }
  // The bucket starts live in rank, which is written last.
  bucket_starts_kernel<<<walk, kThreads, 0, st>>>(kin, N, npad, low, hyb_n,
                                                  rank);
  scan_levels<MaxOp>(rank, rank, N, false, b.scan, st, hyb_n);
  const InitMembers mem{kin, vin, rank, N, npad, (1ull << low) - 1};
  int* ml = const_cast<int*>(compact(
      LargePred<InitMembers>{mem, low, b.lkeys, b.lvals, b.lslot, b.cap}, N,
      hyb_n, b.compact, st));
  init_guard_kernel<<<1, 1, 0, st>>>(ml, b.cap, N, b.ctl);
  launch_seg_small(mem, N, hyb_n, low, out, st);
  // The large members' sort, its alternates in the sorted pairs' buffers,
  // which the stages above have read.
  const Pairs sorted = radix_sort_pairs(
      b.lkeys, b.lvals, b.cap, low + bit_length((b.cap - 1) >> kSegLogT),
      SortBufs{kin, vin, b.status, b.lhist}, st, ml);
  int* first_eq = reinterpret_cast<int*>(sorted.keys == b.lkeys ? kin
                                                                : b.lkeys);
  const unsigned large_grid = walk_grid(b.cap);
  refine_change_kernel<<<large_grid, kThreads, 0, st>>>(
      sorted.keys, b.lslot, b.cap, ml, first_eq);
  scan_levels<MaxOp>(first_eq, first_eq, b.cap, false, b.scan, st, ml);
  refine_scatter_kernel<<<large_grid, kThreads, 0, st>>>(
      b.lslot, sorted.vals, first_eq, b.cap, ml, out);

  // 3. the full path: the sort, the groups (starts in rank), the max-scan
  const int* skip_full = radix_sort_passes(
      b.keys, b.vals, N, key_bits,
      SortBufs{b.keys_alt, b.vals_alt, b.status, b.lhist}, st, full_n);
  init_groups_parity_kernel<<<walk, kThreads, 0, st>>>(
      b.keys, b.vals, b.keys_alt, b.vals_alt, skip_full, P, N, npad, full_n,
      sa, rank);
  scan_levels<MaxOp>(rank, gs, N, false, b.scan, st, full_n);

  // 4. rank[sa[i]] = gs[i]: the pads closed-form, the real slots' pairs
  // appended to their bins (in the sorted pairs' keys buffer, which both
  // paths have read), then stored bin by bin
  const RankBins bins{in_alt ? b.keys_alt : b.keys, b.cursor, bshift};
  init_bin_pairs_kernel<<<walk_grid(cdiv(N, kSortItems)), kThreads, 0, st>>>(
      sa, gs, N, npad, bins);
  init_pads_kernel<<<walk_grid(npad), kThreads, 0, st>>>(N, npad, sa, rank,
                                                         gs);
  rank_store_kernel<<<grid_for(n), kThreads, 0, st>>>(bins.pairs, n, rank);
  if (stats != nullptr) {
    cudaMemcpyAsync(stats, b.ctl, 3 * sizeof(int), cudaMemcpyDeviceToDevice,
                    st);
  }
}

// ---------------------------------------------------------------------------
// B10, the rotating windowed doubler of rows over 384 Mi padded.  Replaces
// _init_round_anchored3, _rotating_init, _rotating_pass and the loop of
// _rotating_steps_jit / segmented_rotating_sa (ops/suffix_array.py), which
// the JAX derive_sa picks for those rows so that no sort exceeds S = N / 8
// elements (S/2 = half, W = the window of group starts, S/2).
//
// pss_sa_init3_bytes is the anchored init of a 3-digit key (d0 * 257 + d1) *
// 257 + d2 < 2^25 on B1b's full path, sorted inside its own outputs (see
// init3_bytes below).  One JAX pass is two launches that
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
//   - pss_sa_rotating_pass compacts the m_w marked slots into a list and
//     refines them by the rank k positions on with B2's segmented refine
//     (whole groups of at most half members), then jumps: nxt = the least slot >= off + W that starts a
//     tied group (N if none, or if off + W >= N) -> ctl[4], and ctl[0] =
//     nxt < N ? nxt : 0.  The JAX pass samples a reverse cummin at off + W;
//     a min-reduction over [off + W, N) is the same.
// The host keeps k, reads ctl once a pass after the next window's scan,
// doubles k when ctl[0] is back at 0, and stops when k >= N at off 0, when
// nothing is tied, or at the first poisoned window.  Windows are swept in
// the JAX order, so earlier windows refine later windows' r2 alike.
// Bound by memory: a scan reads gs over the row (4 bytes a slot) and
// writes flags and dest over the span (8 bytes a span slot with the scan's
// levels); a pass moves B2's refine bytes per marked slot and reads gs
// from off + W on.
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

// B10's init sorts inside the three rows it returns, so that its scratch is
// 4.5 bytes a slot (the part buffer and the status words): its load of a
// 512 Mi row would otherwise set the Reader's peak, with 64-bit keys and
// positions in buffers of their own (24.5 bytes a slot).  Its key is below
// 2^25, a uint32_t, sorted in at most 4 one-sweep passes (a pass whose
// digit is one for every pair is skipped on the device) between two pair
// buffers: (keys in rank, positions in sa) and (keys in the scratch's part
// buffer, positions in gs).  Then
//   - init3_groups_kernel reads the pairs from the buffers the executed
//     passes left them in (so the host never learns which), writes sa and
//     each slot's group start flag into gs, and the max-scan turns gs into
//     the group starts in place;
//   - rank[sa[i]] = gs[i] is stored in kRankParts parts: a part bins the
//     real slots whose positions lie in its share of [0, n), as RankBins
//     bins the whole row, into the part buffer, whose keys are read by
//     then, and stores them; the pads are closed-form.
// Bound by memory: 1 + 8 bytes a slot to make the pairs and count every
// pass's digits in one read of the text, 16 a pass, 16 for the groups, 8 +
// the levels for the max-scan, and 8 a part to read sa and gs, with 20 to
// bin and store the pairs once.
constexpr int kRankParts = 2;
static_assert(kRankParts <= 2, "the part buffer holds the alternate keys");

// B10's groups: sa from the positions, gs[i] = i where slot i starts a
// group (its key differs from slot i - 1's, or i <= npad), else 0.  The
// positions lie in sa or gs, each slot's read and written by one thread,
// and the keys in rank or the part buffer, which nothing here writes.
__global__ void init3_groups_kernel(const int* __restrict__ skip, int passes,
                                    long long N, long long npad,
                                    const uint32_t* kpart, const int* rank,
                                    int* sa, int* gs) {
  const bool odd = executed_before(skip, passes) & 1;
  const uint32_t* keys =
      odd ? kpart : reinterpret_cast<const uint32_t*>(rank);
  const int* pos = odd ? gs : sa;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int p = i < npad ? static_cast<int>(N - 1 - i) : pos[i];
    const bool changed = i <= npad || keys[i] != keys[i - 1];
    sa[i] = p;
    gs[i] = changed ? static_cast<int>(i) : 0;
  }
}

struct Init3Bufs {
  uint64_t* part;  // the alternate keys (uint32_t [N]), then a part's pairs
  unsigned long long* status;
  unsigned* hist;  // every pass's counts, the pass counters, the skip flags
  unsigned* cursor;
  int* scan;
};

Init3Bufs carve_init3(Arena& a, long long N) {
  Init3Bufs b;
  b.part = a.take<uint64_t>(cdiv(N, kRankParts));
  b.status = a.take<unsigned long long>(kRadix * cdiv(N, kSortTile));
  b.hist = a.take<unsigned>(kSortCounters);
  b.cursor = a.take<unsigned>(kRadix);
  b.scan = a.take<int>(scan_scratch_elems(N));
  return b;
}

void init3_bytes(const uint8_t* text, long long N, long long n, int* sa,
                 int* rank, int* gs, const Init3Bufs& b, cudaStream_t st) {
  constexpr int P = (kByte3KeyBits + kRadixBits - 1) / kRadixBits;
  const long long npad = N - n;
  const long long tiles = cdiv(N, kSortTile);
  uint32_t* kmain = reinterpret_cast<uint32_t*>(rank);
  uint32_t* kalt = reinterpret_cast<uint32_t*>(b.part);
  int* counters = reinterpret_cast<int*>(b.hist + kMaxPasses * kRadix);
  int* skip = counters + kMaxPasses;

  // 1. the pairs and every pass's digit counts, then the passes
  cudaMemsetAsync(b.status, 0, sizeof(unsigned long long) * kRadix * tiles,
                  st);
  cudaMemsetAsync(b.hist, 0, sizeof(unsigned) * kSortCounters, st);
  init_hist_kernel<ByteSrc<3>, uint32_t>
      <<<tiles < kHistBlocks ? static_cast<unsigned>(tiles) : kHistBlocks,
         kThreads, 0, st>>>(ByteSrc<3>{text, n, nullptr}, N, 0, P, kmain, sa,
                            nullptr, 0, b.hist);
  onesweep_bins_kernel<<<P, kThreads, 0, st>>>(b.hist, skip);
  for (int p = 0; p < P; ++p) {
    onesweep_pass_kernel<uint32_t>
        <<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
            kmain, sa, kalt, gs, N, nullptr, p, kRadixBits * p,
            b.hist + p * kRadix, skip, b.status, counters + p);
  }

  // 2. sa and the group starts
  init3_groups_kernel<<<walk_grid(N), kThreads, 0, st>>>(skip, P, N, npad,
                                                         kalt, rank, sa, gs);
  scan_levels<MaxOp>(gs, gs, N, false, b.scan, st);

  // 3. rank[sa[i]] = gs[i]: the pads closed-form, the real slots by parts
  init_pads_kernel<<<walk_grid(npad), kThreads, 0, st>>>(N, npad, sa, rank,
                                                         gs);
  if (n == 0) return;
  const long long h = cdiv(n, kRankParts);
  int shift = 0;  // a part's bins split its h positions by their top 8 bits
  while ((h - 1) >> (shift + kRadixBits) > 0) ++shift;
  for (long long lo = 0; lo < n; lo += h) {
    const long long hi = lo + h < n ? lo + h : n;
    cudaMemsetAsync(b.cursor, 0, sizeof(unsigned) * kRadix, st);
    init_bin_pairs_kernel<<<walk_grid(cdiv(N, kSortItems)), kThreads, 0,
                            st>>>(sa, gs, N, npad,
                                  RankPart{b.part, b.cursor, shift,
                                           static_cast<int>(lo),
                                           static_cast<int>(hi)});
    rank_store_kernel<<<grid_for(hi - lo), kThreads, 0, st>>>(b.part,
                                                              hi - lo, rank);
  }
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
// B9, prefix doubling with dense ranks.  Replaces _doubling_kernel with
// _init_round and _doubling_round, and _int_doubling_kernel
// (ops/suffix_array.py), reached through suffix_array_jax(algorithm='full'),
// derive_sa_full_jit and suffix_array_int(backend='jax').
//
// The ranks are the JAX functions': rank[pos] = the number of distinct keys
// below pos's, sa the positions in key order, ties in position order (every
// sort here is stable, so every init and round leaves them so).  count
// int32 [2] gets the number of distinct ranks and the rank of slot npad = N
// - n, the first real slot (the count again when n = 0).  Pad keys are 0,
// below every real key, so the pads hold ranks [0, count[1]) and the host
// stops once the real slots hold n distinct ranks: one readback a round.
//   - The byte init sorts B1b's 6 digits through the text's byte map:
//     full_present_kernel marks the bytes that occur and
//     full_keys_bytes_kernel keys each position on 6 digits of b bits, b =
//     bit_length(distinct bytes), bytes numbered 1.. in order and 0 at or
//     past n as B1b's digits: the same order and ties as the 50-bit key in
//     6b bits.  The sort skips every pass whose digit is one bin, so text
//     of at most 31 distinct bytes (lowercase words) sorts 30 bits in 4
//     passes where B1b's byte digits take 7.  The relabel reads the pairs
//     wherever the executed passes left them: no copy back.
//   - The integer init (the JAX first round, k = 1 on value + 1) keys
//     rank[i] << W | (rank[i + 1] + 1) and sorts 2W bits.
//   - A round never sorts the rank bits again while at least N / 8 ranks
//     are distinct (the host knows their count): sa already lists every
//     group (one rank) as a run of slots.  full_starts_kernel marks the runs'
//     first slots and a max-scan gives every slot its group's start (gs,
//     the anchored form); B2's tie scan lists the tied slots, and B2's
//     segmented refine orders each group by r2 = rank[pos + k] + 1 (0 past
//     the row) -- tiny groups by counting, medium ones in a block's shared
//     memory, large ones by the one-sweep sort on (ordinal, r2) -- on the
//     device's count of tied slots, updating sa and gs in place.  The new
//     groups' first slots (gs[s] == s) are then counted by an inclusive
//     scan into the dense ranks.  With fewer distinct ranks most slots lie
//     in large groups, whose refine is a sort of them with more traffic a
//     slot (a gather, a compaction, the scatter) than the integer init's
//     sort of every slot on 2W bits, which such a round runs instead (a
//     400 MiB period-2 row, B10's poisoned fallback, stays there for most
//     of its 27 rounds).
//   - Both store rank[sa[s]] = label blocked by destination: the pairs go
//     to their position's bin (the inits' RankBins, no sort pass), then a
//     block takes 32 Ki positions of a bin and writes their labels from
//     shared memory in position order (rank_stage_kernel), where a direct
//     store would pay a 32-byte sector for every 4 bytes.
// Bound by memory: the byte init reads the text twice, then writes 12
// bytes a slot, moves 24 a pass (4 passes for lowercase text), 20 to
// relabel and 28 to store the ranks; a round gathers one random rank a
// slot for the group starts, scans (8 bytes a slot), lists the tied slots
// (8), refines them (about 40 bytes each, B2's), relabels (12) and stores
// the ranks (28).
// ---------------------------------------------------------------------------
static_assert(kThreads == 256, "one byte value a thread");

// mask bit b (word b >> 5) is set for every byte b of text[0, n); the
// mask is zeroed by the caller.  A thread reads 16 consecutive bytes, one
// 16-byte load where they lie in the text and it is aligned, and stores
// only bytes not yet seen: most of a block's stores would hit a few words
// (UTF-16 text is half NUL).
__global__ void full_present_kernel(const uint8_t* __restrict__ text,
                                    long long n, unsigned* __restrict__ mask) {
  __shared__ unsigned char seen[kThreads];
  seen[threadIdx.x] = 0;
  __syncthreads();
  const bool vec = aligned16(text);
  for (long long p = 16 * (blockIdx.x * static_cast<long long>(blockDim.x) +
                           threadIdx.x);
       p < n; p += 16 * static_cast<long long>(gridDim.x) * blockDim.x) {
    if (vec && p + 16 <= n) {
      const uint4 w = *reinterpret_cast<const uint4*>(text + p);
      const unsigned words[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int q = 0; q < 16; ++q) {
        const unsigned b = (words[q >> 2] >> (8 * (q & 3))) & 255;
        if (!seen[b]) seen[b] = 1;
      }
    } else {
      for (long long q = p; q < p + 16 && q < n; ++q) {
        if (!seen[text[q]]) seen[text[q]] = 1;
      }
    }
  }
  __syncthreads();
  // Warp w holds bytes 32 w .. 32 w + 31: one atomic a word a block.
  const unsigned word = __ballot_sync(kFull, seen[threadIdx.x] != 0);
  if ((threadIdx.x & 31) == 0 && word != 0) {
    atomicOr(&mask[threadIdx.x >> 5], word);
  }
}

// Blocks of full_present_kernel: a few waves, each thread looping, so the
// blocks' atomics on the mask stay few.
constexpr unsigned kPresentBlocks = 512;

__global__ void full_keys_bytes_kernel(const uint8_t* __restrict__ text,
                                       long long N, long long n,
                                       const unsigned* __restrict__ mask,
                                       uint64_t* __restrict__ keys,
                                       int* __restrict__ vals) {
  __shared__ unsigned short digit[kThreads];
  __shared__ int s_bits;
  const int t = threadIdx.x;
  int below = __popc(mask[t >> 5] & ((1u << (t & 31)) - 1u));
  for (int w = 0; w < (t >> 5); ++w) below += __popc(mask[w]);
  digit[t] = static_cast<unsigned short>(below + 1);
  if (t == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += __popc(mask[w]);
    s_bits = 32 - __clz(total);
  }
  __syncthreads();
  const int b = s_bits;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + t;
       p < N; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    uint64_t key = 0;
    if (p < n) {
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        const long long q = p + d;
        key = (key << b) | (q < n ? digit[text[q]] : 0u);
      }
    }
    keys[p] = key;
    vals[p] = static_cast<int>(p);
  }
}

// Bits of the mapped 6-digit key: 9 a digit at most (256 distinct bytes).
constexpr int kFullByteKeyBits = 6 * 9;

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

// sa[i] = the sorted positions and flags[i] = 1 where sorted key i
// differs from key i - 1, the pairs read from the buffers the executed
// passes left them in.
__global__ void full_flags_kernel(const uint64_t* __restrict__ kmain,
                                  const uint64_t* __restrict__ kalt,
                                  const int* __restrict__ vmain,
                                  const int* __restrict__ valt,
                                  const int* __restrict__ skip, int passes,
                                  long long N, int* __restrict__ sa,
                                  int* __restrict__ flags) {
  const bool odd = executed_before(skip, passes) & 1;
  const uint64_t* keys = odd ? kalt : kmain;
  const int* vals = odd ? valt : vmain;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < N; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    sa[i] = vals[i];
    flags[i] = (i > 0 && keys[i] != keys[i - 1]) ? 1 : 0;
  }
}

// labels: the dense rank of every slot (0 at slot 0).
__global__ void full_counts_kernel(const int* __restrict__ labels,
                                   long long N, long long npad,
                                   int* __restrict__ count) {
  count[0] = labels[N - 1] + 1;
  count[1] = npad < N ? labels[npad] : labels[N - 1] + 1;
}

// gs[s] = s where slot s starts a group (its rank differs from slot s -
// 1's), else 0: the max-scan makes it every slot's group start.  One
// gather a slot: a warp's lanes hold consecutive slots and pass their
// ranks up, and lane 0 reads its predecessor's.
__global__ void full_starts_kernel(const int* __restrict__ sa,
                                   const int* __restrict__ rank, long long N,
                                   int* __restrict__ gs) {
  const int lane = threadIdx.x & 31;
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s - lane < N; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = s < N ? rank[sa[s]] : 0;
    int prev = __shfl_up_sync(kFull, r, 1);
    if (lane == 0 && s > 0 && s < N) prev = rank[sa[s - 1]];
    if (s < N) gs[s] = s == 0 || prev != r ? static_cast<int>(s) : 0;
  }
}

// flags[s] = 1 where slot s > 0 starts a group after the refine: their
// inclusive scan is every slot's dense rank.
__global__ void full_group_flags_kernel(const int* __restrict__ gs,
                                        long long N, int* __restrict__ flags) {
  for (long long s = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       s < N; s += static_cast<long long>(gridDim.x) * blockDim.x) {
    flags[s] = s > 0 && gs[s] == s ? 1 : 0;
  }
}

// rank[p] = label for the binned (position << 32 | label) pairs of all N
// positions, kStagePos positions a block: bin b holds exactly the
// positions [b << shift, (b + 1) << shift) at those places, so the block
// reads the bins its positions lie in, keeps its own pairs in shared
// memory and writes them out in position order, whole sectors at a time.
// Where a bin is wider than a block, each of its blocks reads all of it.
constexpr int kStagePos = 1 << 15;  // 128 KB of labels a block
constexpr int kStageThreads = 1024;

__global__ void __launch_bounds__(kStageThreads)
rank_stage_kernel(const uint64_t* __restrict__ pairs, long long N, int shift,
                  int* __restrict__ rank) {
  extern __shared__ int stage_smem[];
  const long long lo = static_cast<long long>(blockIdx.x) * kStagePos;
  const long long hi = lo + kStagePos < N ? lo + kStagePos : N;
  const long long bin0 = (lo >> shift) << shift;
  long long bin1 = (((hi - 1) >> shift) + 1) << shift;
  if (bin1 > N) bin1 = N;
  for (long long i = bin0 + threadIdx.x; i < bin1; i += kStageThreads) {
    const uint64_t w = pairs[i];
    const long long p = static_cast<long long>(w >> 32) - lo;
    if (p >= 0 && p < kStagePos) {
      stage_smem[p] = static_cast<int>(static_cast<unsigned>(w));
    }
  }
  __syncthreads();
  for (long long p = lo + threadIdx.x; p < hi; p += kStageThreads) {
    rank[p] = stage_smem[p - lo];
  }
}

struct FullBufs {
  uint64_t* keys;
  int* vals;
  SortBufs sort;
  int* labels;
  int* scan;
  unsigned* mask;    // [8]
  unsigned* cursor;  // [kRadix]
};

FullBufs carve_full(Arena& a, long long N) {
  FullBufs b;
  b.keys = a.take<uint64_t>(N);
  b.vals = a.take<int>(N);
  b.sort = carve_sort(a, N);
  b.labels = a.take<int>(N);
  b.scan = a.take<int>(scan_scratch_elems(N));
  b.mask = a.take<unsigned>(kThreads / 32);
  b.cursor = a.take<unsigned>(kRadix);
  return b;
}

struct FullRoundBufs {
  int* gs;
  int* counts;       // [2], the refine's
  unsigned* cursor;  // [kRadix]
  CompactBufs tie;
  SegBufs seg;
};

FullRoundBufs carve_full_round(Arena& a, long long N) {
  FullRoundBufs b;
  b.gs = a.take<int>(N);
  b.counts = a.take<int>(2);
  b.cursor = a.take<unsigned>(kRadix);
  b.tie = carve_compact(a, N);
  b.seg = carve_seg(a, N, true);
  return b;
}

// rank[sa[i]] = labels[i] for all N slots, blocked by destination: the
// pairs go to their position's bin (top 8 bits, init_bin_pairs_kernel),
// then each bin is stored from shared memory where a bin spans at most
// two blocks' positions, else straight from the bins (rank_store_kernel).
void full_rank_store(const int* sa, const int* labels, long long N,
                     uint64_t* pairs, unsigned* cursor, int* rank,
                     cudaStream_t st) {
  int shift = 0;
  while ((N - 1) >> (shift + kRadixBits) > 0) ++shift;
  cudaMemsetAsync(cursor, 0, sizeof(unsigned) * kRadix, st);
  init_bin_pairs_kernel<<<walk_grid(cdiv(N, kSortItems)), kThreads, 0, st>>>(
      sa, labels, N, 0, RankBins{pairs, cursor, shift});
  if ((1LL << shift) <= 2LL * kStagePos) {
    static bool smem_set = false;
    const int bytes = static_cast<int>(sizeof(int)) * kStagePos;
    if (!smem_set) {
      cudaFuncSetAttribute(rank_stage_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
      smem_set = true;
    }
    rank_stage_kernel<<<static_cast<unsigned>(cdiv(N, kStagePos)),
                        kStageThreads, bytes, st>>>(pairs, N, shift, rank);
  } else {
    rank_store_kernel<<<grid_for(N), kThreads, 0, st>>>(pairs, N, rank);
  }
}

// Sort the (key, position) pairs in b on key_bits, then relabel: sa, rank
// and count.
void full_relabel(const FullBufs& b, long long N, long long npad,
                  int key_bits, int* sa, int* rank, int* count,
                  cudaStream_t st) {
  const unsigned grid = grid_for(N);
  const int passes = (key_bits + kRadixBits - 1) / kRadixBits;
  const int* skip = radix_sort_passes(b.keys, b.vals, N, key_bits, b.sort,
                                      st, nullptr);
  full_flags_kernel<<<grid, kThreads, 0, st>>>(
      b.keys, b.sort.keys_alt, b.vals, b.sort.vals_alt, skip, passes, N, sa,
      b.labels);
  scan_levels<SumOp>(b.labels, b.labels, N, false, b.scan, st);
  full_counts_kernel<<<1, 1, 0, st>>>(b.labels, N, npad, count);
  // The sorted pairs are dead: their keys buffer takes the rank pairs.
  full_rank_store(sa, b.labels, N, b.keys, b.cursor, rank, st);
}

void full_round(int* sa, int* rank, long long N, long long k, long long npad,
                int* count, const FullRoundBufs& b, cudaStream_t st) {
  const unsigned grid = grid_for(N);
  full_starts_kernel<<<grid, kThreads, 0, st>>>(sa, rank, N, b.gs);
  scan_levels<MaxOp>(b.gs, b.gs, N, false, b.seg.scan, st);
  const int* m = compact(TiePred{b.gs, N, nullptr, b.seg.tl}, N, nullptr,
                         b.tie, st);
  seg_refine(sa, rank, b.gs, N, k, b.seg.tl, N, b.counts, b.seg, st,
             nullptr, m, false);
  int* labels = b.seg.first_eq;
  full_group_flags_kernel<<<grid, kThreads, 0, st>>>(b.gs, N, labels);
  scan_levels<SumOp>(labels, labels, N, false, b.seg.scan, st);
  full_counts_kernel<<<1, 1, 0, st>>>(labels, N, npad, count);
  // The refine's keys are dead: they take the rank pairs.
  full_rank_store(sa, labels, N, b.seg.keys, b.cursor, rank, st);
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

// ---------------------------------------------------------------------------
// B14g: the per-shard steps of one row's B9 split over S shards.  Replaces
// make_giant_chunk_build (pysubstringsearch_tpu/parallel/sharded.py:93-115),
// where XLA partitions the lax.sort of every B9 round into a distributed
// sort; there is no such partitioner here, so parallel/sharded.py runs each
// round as a sample sort over torch.distributed (or device copies between
// the placements of one process), on this file's radix sort (a shard's
// local pairs) and scatter, and on these kernels for the steps none of
// them does.  A round sorts only the unsettled positions, those whose
// group still has two members or more, as B9 refines only its tied groups:
// the owner's rank block keeps a settled position's final slot, and an
// unsettled one's group start with the int32 sign bit set (group starts
// are below N < 2^31).
//   (a) giant_byte_keys_kernel: B9's 6-byte init key (B1b's layout, limb0
//       << 25 | limb1, 50 bits) of one shard's block of B positions, from
//       the block's text and the 5 bytes past it, with the positions as
//       values; giant_round_keys_kernel: a round's key rank[i] << W |
//       (rank[i + k] + 1) (0 past the row, the marks cleared) of the
//       block's unsettled positions only, compacted in position order in
//       one pass of decoupled look-back, and their count.
//   (b) giant_cuts_kernel: where the S - 1 (key, position) splitters cut a
//       shard sorted by (key, position) (the pieces of a sorted shard are
//       contiguous, so nothing moves); and giant_part_hist_kernel +
//       giant_part_scatter_kernel: (position, group start) pairs
//       partitioned by owner shard, position / B, stably, into per-owner
//       slices, positions made local to the owner's block, with the count
//       of unsettled pairs an owner receives.  Both are redesigns for this
//       card; see their own notes.
//   (c) giant_flags_kernel and giant_relabel_kernel: the relabel of a
//       shard's sorted list in slot space (see their note).
//   (d) giant_merge_rank_kernel + giant_merge_segments_kernel: the S
//       sorted runs a shard receives merged into its (key, position)
//       order (see their own notes).
// (a), (c) and the partition are bound by memory: (a) writes 12 bytes an
// unsettled position and reads 1 or 4-8, the partition reads 8 bytes a
// pair and writes 8 (and reads the positions once more), (c) reads 8 twice
// and writes 4.  The cuts move next to nothing; their floor is their
// dependent rounds of loads.
// ---------------------------------------------------------------------------
constexpr int kGiantMaxShards = 256;
static_assert(kGiantMaxShards == kThreads, "one owner a thread");
constexpr int kPartItems = 16;                    // pairs a thread places
constexpr int kPartTile = kThreads * kPartItems;  // pairs a block places
constexpr int kPartWarpItems = 32 * kPartItems;
constexpr int kPartMinBlocks = 3;  // blocks of the look-back pass an SM
constexpr int kPartHistBlocks = 1024;  // blocks of the histogram, at most

__global__ void giant_byte_keys_kernel(const uint8_t* __restrict__ text,
                                       long long m,
                                       const uint8_t* __restrict__ halo,
                                       long long h, long long p0, long long n,
                                       uint64_t* __restrict__ keys,
                                       int* __restrict__ vals) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    unsigned limb[2] = {0u, 0u};
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const long long j = i + d;
      unsigned e = 0u;
      if (p0 + j < n) {
        if (j < m) {
          e = text[j] + 1u;
        } else if (j - m < h) {
          e = halo[j - m] + 1u;
        }
      }
      limb[d / 3] = limb[d / 3] * 257u + e;
    }
    keys[i] = (static_cast<uint64_t>(limb[0]) << 25) | limb[1];
    vals[i] = static_cast<int>(p0 + i);
  }
}

// The single-pass look-back of the compaction below: warp 0 of tile `tile`
// reads its predecessors' status words 32 at a time (lane 0 the nearest)
// back to the nearest inclusive prefix (tag 2), summing the tile counts
// (tag 1) on the way and waiting where a word is not written yet (tag 0);
// a word holds the value in its low half and the tag in its high half.
// Tiles take their index from an atomic counter in launch order, so every
// predecessor already runs.  Returns the exclusive prefix on every lane.
__device__ __forceinline__ int lookback_sum(const unsigned long long* status,
                                            long long tile) {
  const int lane = threadIdx.x & 31;
  int before = 0;
  for (long long q = tile - 1;; q -= 32) {
    const long long at = q - lane;
    unsigned long long w =
        at >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
                      status + at)
                : 2ull << 32;  // before tile 0: a prefix of 0
    while (__any_sync(kFull, static_cast<unsigned>(w >> 32) == 0u)) {
      if (static_cast<unsigned>(w >> 32) == 0u) {
        w = *reinterpret_cast<const volatile unsigned long long*>(status +
                                                                  at);
      }
    }
    const unsigned prefixes =
        __ballot_sync(kFull, static_cast<unsigned>(w >> 32) == 2u);
    int x = static_cast<int>(static_cast<unsigned>(w));
    if (prefixes && lane > __ffs(prefixes) - 1) x = 0;
    before += __reduce_add_sync(kFull, x);
    if (prefixes) return before;
  }
}

// (a) in a round: the block's unsettled positions (rank[i] < 0, the mark)
// in position order, keys[j] = g << W | low with g = rank[i] & INT_MAX and
// low = (r2[i] & INT_MAX) + 1 for i < c, else 0; vals[j] = p0 + i; count
// the number of them (only the first cap are written).  A block takes a
// tile of kKeyTile positions from an atomic counter, loads its ranks
// warp-striped (position warp base + 32 j + lane for item j), ballots the
// unsettled ones item by item, publishes its count (one status word a
// tile) and, after warp 0's look-back, writes each item's unsettled
// positions contiguously, so a warp's stores of one item are one run.  The
// shifted ranks are read only for unsettled positions (a late round, where
// few are left, reads 4 bytes a position), issued before the look-back so
// that it hides them.
constexpr int kKeyItems = 16;
constexpr int kKeyTile = kThreads * kKeyItems;
constexpr int kKeyWarpItems = 32 * kKeyItems;

__global__ void __launch_bounds__(kThreads)
    giant_round_keys_kernel(const int* __restrict__ rank,
                            const int* __restrict__ r2, long long m,
                            long long c, int W, long long p0, long long cap,
                            uint64_t* __restrict__ keys,
                            int* __restrict__ vals, int* __restrict__ count,
                            unsigned long long* status, int* counter) {
  __shared__ int s_tile;
  __shared__ int s_warp[kWarps];
  __shared__ long long s_first;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long tile = s_tile;
  const long long first = tile * kKeyTile + warp * kKeyWarpItems + lane;
  int r[kKeyItems];
  int low[kKeyItems];  // r2 + 1 of the unsettled ones, in flight early
  unsigned ballot[kKeyItems];
  int warp_count = 0;
#pragma unroll
  for (int j = 0; j < kKeyItems; ++j) {
    const long long i = first + 32 * j;
    r[j] = i < m ? __ldcs(rank + i) : 0;
    ballot[j] = __ballot_sync(kFull, r[j] < 0);
    warp_count += __popc(ballot[j]);
  }
#pragma unroll
  for (int j = 0; j < kKeyItems; ++j) {
    const long long i = first + 32 * j;
    low[j] = r[j] < 0 && i < c ? (__ldcs(r2 + i) & INT_MAX) + 1 : 0;
  }
  if (lane == 0) s_warp[warp] = warp_count;
  __syncthreads();
  if (t < 32) {
    // Warp 0: the warps' offsets, the tile's count out at once (tag 1, or
    // 2 for tile 0), then the look-back and the inclusive prefix (tag 2).
    const int x = lane < kWarps ? s_warp[lane] : 0;
    int incl = x;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    if (lane < kWarps) s_warp[lane] = incl - x;
    if (lane == 0) {
      status_store(status + tile, tile == 0 ? 2u : 1u,
                   static_cast<unsigned>(total));
    }
    const int before = tile > 0 ? lookback_sum(status, tile) : 0;
    if (lane == 0) {
      if (tile > 0) {
        status_store(status + tile, 2u, static_cast<unsigned>(before + total));
      }
      s_first = before;
      if (tile == gridDim.x - 1) *count = before + total;
    }
  }
  __syncthreads();
  long long at = s_first + s_warp[warp];
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kKeyItems; ++j) {
    if (r[j] < 0) {
      const long long dst = at + __popc(ballot[j] & lower);
      if (dst < cap) {
        keys[dst] = (static_cast<uint64_t>(r[j] & INT_MAX) << W) |
                    static_cast<unsigned>(low[j]);
        vals[dst] = static_cast<int>(p0 + first + 32 * j);
      }
    }
    at += __popc(ballot[j]);
  }
}

// cuts[j] = the number of pairs of (keys, vals)[0, m), sorted by (key,
// value), below splitter j = (skeys[j], spos[j]).  Bound by dependent
// loads, not bytes: a binary search a thread would leave S - 1 threads of
// the card waiting out log2(m) DRAM round trips one after another (27 at
// m = 128 Mi).  So a block takes a splitter and searches 256-ary: each round its threads test 256
// evenly spaced pairs of the interval still open, key and value loaded
// together, and __syncthreads_count of those below the splitter narrows
// the interval to fewer than step = ceil(len / 256) pairs; a round with
// step 1 tests every pair left and ends the search.  That is at most
// ceil(log256 m) + 1 dependent rounds (4 at m = 128 Mi, giant_cuts_rounds
// on the host).  A wider round measured slower (4 probes a thread,
// 1024-ary in 3 rounds): one SM issues every probe of a splitter as a
// separate sector request.  Keys compare as int64, as torch orders them.
__global__ void __launch_bounds__(kThreads)
    giant_cuts_kernel(const long long* __restrict__ keys,
                      const int* __restrict__ vals, long long m,
                      const long long* __restrict__ skeys,
                      const int* __restrict__ spos,
                      long long* __restrict__ cuts) {
  const long long sk = skeys[blockIdx.x];
  const int sp = spos[blockIdx.x];
  long long lo = 0, hi = m;  // the cut lies in [lo, hi]
  while (lo < hi) {
    const long long step = (hi - lo + kThreads - 1) / kThreads;
    // Probe t tests pair lo + (t + 1) * step - 1; the probes below the
    // splitter are a prefix of them, as the pairs below it are of the
    // shard.
    const long long i = lo + (threadIdx.x + 1) * step - 1;
    bool below = false;
    if (i < hi) {
      const long long k = keys[i];
      const int v = vals[i];
      below = k < sk || (k == sk && v < sp);
    }
    const long long c = __syncthreads_count(below);
    lo += c * step;
    hi = lo + step - 1 < hi ? lo + step - 1 : hi;
  }
  if (threadIdx.x == 0) cuts[blockIdx.x] = lo;
}

// The partition by owner d = p / B: a stable multi-split in two passes over
// tiles of kPartTile pairs, 16 a thread:
//   1. giant_part_hist_kernel reads the positions as 16-byte vectors and
//      adds every owner's count into totals;
//   2. giant_part_scatter_kernel takes its tile in launch order from an
//      atomic counter, loads its positions warp-striped (pair j of a lane
//      at warp base + 32 j + lane: 128-byte rows, and the rank order is
//      the load order), ranks each pair among its tile's pairs of the same
//      owner as onesweep_pass_kernel ranks a digit (the warp's peers, a
//      running count a warp, the warps' counts scanned, one block scan
//      over the owners), finds its tile's offset within every owner by
//      decoupled look-back over status words, stages the tile in shared
//      memory in owner order, and stores each owner's run with
//      consecutive threads on consecutive slots.
// Bound by memory: 16 bytes a pair moved once, and the positions read a
// second time.  The look-back pass is bound by the tiles it keeps in
// flight, so what it holds in registers decides its speed: the group
// starts are loaded only after the ranking, which lets three blocks share
// an SM (two, with them loaded beside the positions, measured slower);
// the look-back reads a window of predecessors at once.
// The owner is p / B in 32-bit arithmetic: the host passes rcp = floor((2^32
// - 1) / B), and for p < 2^31 __umulhi(p, rcp) is p / B or one less
// (p / B - p * rcp / 2^32 < p (B + 1) / (B 2^32) + 1 < 2), which one
// compare corrects.
__device__ __forceinline__ unsigned part_owner(unsigned p, unsigned B,
                                               unsigned rcp,
                                               unsigned* local) {
  unsigned d = __umulhi(p, rcp);
  unsigned r = p - d * B;
  if (r >= B) {
    ++d;
    r -= B;
  }
  *local = r;
  return d;
}

// Lanes of the warp whose pair is valid and has owner d, from one ballot a
// bit of the owner (bits = ceil(log2 S)): cheaper than __match_any_sync,
// and warp-uniform since bits is.
__device__ __forceinline__ unsigned owner_peers(unsigned d, bool valid,
                                                int bits) {
  unsigned peers = __ballot_sync(kFull, valid);
  for (int b = 0; b < bits; ++b) {
    const bool set = (d >> b) & 1u;
    const unsigned with = __ballot_sync(kFull, set);
    peers &= set ? with : ~with;
  }
  return peers;
}

// KC > 0 (S <= KC): a thread counts its pairs' owners in KC registers,
// with no vote and no atomic a pair, and the warp sums them at the end;
// KC = 0: a leader a distinct owner of the warp adds its peers into
// shared memory.
template <int KC>
__global__ void __launch_bounds__(kThreads)
    giant_part_hist_kernel(const int* __restrict__ pos, long long m,
                           unsigned B, unsigned rcp, int bits,
                           int* __restrict__ totals) {
  __shared__ int hist[kGiantMaxShards];
  const int t = threadIdx.x;
  const unsigned lower = (1u << (t & 31)) - 1u;
  hist[t] = 0;
  __syncthreads();
  int counts[KC > 0 ? KC : 1] = {};
  const bool vec = aligned16(pos);
  const long long tiles = (m + kPartTile - 1) / kPartTile;
  for (long long tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    // Pair e of vector q of a thread: base + 4 (t + kThreads q) + e.
    const long long base = tile * kPartTile;
    const bool whole = base + kPartTile <= m;
    unsigned p[kPartItems];
    if (vec && whole) {
      const int4* v = reinterpret_cast<const int4*>(pos + base) + t;
#pragma unroll
      for (int q = 0; q < kPartItems / 4; ++q) {
        const int4 x = __ldcs(v + kThreads * q);
        p[4 * q] = x.x;
        p[4 * q + 1] = x.y;
        p[4 * q + 2] = x.z;
        p[4 * q + 3] = x.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPartItems; ++j) {
        const long long i = base + 4 * (t + kThreads * (j / 4)) + j % 4;
        p[j] = i < m ? pos[i] : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kPartItems; ++j) {
      const bool valid =
          whole || base + 4 * (t + kThreads * (j / 4)) + j % 4 < m;
      unsigned local;
      const unsigned d = part_owner(p[j], B, rcp, &local);
      if (KC > 0) {
#pragma unroll
        for (int k = 0; k < (KC > 0 ? KC : 1); ++k) {
          counts[k] += valid && d == static_cast<unsigned>(k);
        }
      } else {
        const unsigned peers = owner_peers(d, valid, bits);
        if (valid && (peers & lower) == 0) {
          atomicAdd(&hist[d], __popc(peers));
        }
      }
    }
  }
  if (KC > 0) {
#pragma unroll
    for (int k = 0; k < (KC > 0 ? KC : 1); ++k) {
      const int c = __reduce_add_sync(kFull, counts[k]);
      if ((t & 31) == 0 && c) atomicAdd(&hist[k], c);
    }
  }
  __syncthreads();
  if (hist[t]) atomicAdd(&totals[t], hist[t]);
}

// Tile `tile`'s exclusive prefix for owner t: the counts of its owner in
// tiles 0..tile-1, from the status words of its predecessors, read
// kPartWindow at a time with every load in flight; the walk stops at the
// nearest inclusive prefix (tag 2), summing the tile counts (tag 1) on
// the way and waiting where a word is not yet written (tag 0).  A walk a
// word at a time, as one-sweep passes take it, costs one L2 round trip a
// predecessor, and with hundreds of tiles in flight a tile finds the
// nearest prefix several tiles back.
constexpr int kPartWindow = 8;

__device__ __forceinline__ unsigned part_lookback(
    const unsigned long long* status, long long tile, int S, int t) {
  unsigned before = 0;
  for (long long q = tile - 1;; q -= kPartWindow) {
    unsigned long long w[kPartWindow];
#pragma unroll
    for (int k = 0; k < kPartWindow; ++k) {
      w[k] = q - k >= 0
                 ? *reinterpret_cast<const volatile unsigned long long*>(
                       status + (q - k) * S + t)
                 : 2ull << 32;  // before tile 0: a prefix of 0
    }
    bool done = false;
#pragma unroll
    for (int k = 0; k < kPartWindow; ++k) {
      if (!done) {
        unsigned long long word = w[k];
        while (static_cast<unsigned>(word >> 32) == 0u) {
          word = *reinterpret_cast<const volatile unsigned long long*>(
              status + (q - k) * S + t);
        }
        before += static_cast<unsigned>(word);
        done = static_cast<unsigned>(word >> 32) == 2u;
      }
    }
    if (done) return before;
  }
}

__global__ void __launch_bounds__(kThreads, kPartMinBlocks)
    giant_part_scatter_kernel(const int* __restrict__ pos,
                              const int* __restrict__ gs, long long m,
                              unsigned B, unsigned rcp, int bits, int S,
                              const int* __restrict__ totals,
                              unsigned long long* status, int* counter,
                              int* __restrict__ out_pos,
                              int* __restrict__ out_gs,
                              int* __restrict__ live) {
  __shared__ int s_tile;
  __shared__ unsigned s_warp[kWarps][kGiantMaxShards];  // counts, offsets
  __shared__ int s_local[kGiantMaxShards];  // staged index of owner's first
  __shared__ int s_base[kGiantMaxShards];   // its output slot minus that
  __shared__ int s_live[kGiantMaxShards];   // unsettled pairs of each owner
  __shared__ int s_pos[kPartTile];
  __shared__ int s_gs[kPartTile];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  for (int w = 0; w < kWarps; ++w) s_warp[w][t] = 0;
  s_live[t] = 0;
  __syncthreads();
  const long long tile = s_tile;
  const long long tile_base = tile * kPartTile;
  const long long rest = m - tile_base;
  const int valid_count = rest < kPartTile ? static_cast<int>(rest)
                                           : kPartTile;
  // Pair j of a lane: warp's first + 32 j + lane, 32-bit offsets from it.
  const int first = warp * kPartWarpItems + lane;
  const int* __restrict__ pt = pos + tile_base + first;
  const int* __restrict__ gt = gs + tile_base + first;
  int p[kPartItems];
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    p[j] = first + 32 * j < valid_count ? __ldcs(pt + 32 * j) : 0;
  }
  // Owner t's first output slot, while the tile's loads are in flight.
  int total;
  const int start = block_exclusive_scan<SumOp>(t < S ? totals[t] : 0,
                                                &total);
  unsigned slot[kPartItems];  // rank within the warp, then the staged index
  const unsigned lower = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    const bool valid = first + 32 * j < valid_count;
    unsigned local;
    const unsigned d = part_owner(p[j], B, rcp, &local);
    const unsigned peers = owner_peers(d, valid, bits);
    const unsigned below = peers & lower;
    const unsigned before = valid ? s_warp[warp][d] : 0u;
    __syncwarp();
    if (valid && below == 0) s_warp[warp][d] = before + __popc(peers);
    __syncwarp();
    slot[j] = before + __popc(below);
  }
  __syncthreads();
  // Thread t owns owner t: its per-warp counts become per-warp offsets,
  // and its count in this tile goes out at once (tag 1: the tile's count,
  // 2: the count in tiles 0..tile; 0, the caller's zeroed scratch, not yet
  // written), before the staging and the look-back.
  unsigned count = 0;
  for (int w = 0; w < kWarps; ++w) {
    const unsigned c = s_warp[w][t];
    s_warp[w][t] = count;
    count += c;
  }
  unsigned long long* mine = status + tile * S + t;
  if (t < S) status_store(mine, tile == 0 ? 2u : 1u, count);
  int tile_total;
  const int local = block_exclusive_scan<SumOp>(static_cast<int>(count),
                                                &tile_total);
  s_local[t] = local;
  __syncthreads();
  // Stage the positions in owner order, then issue the group starts'
  // loads (kept out of registers until now, so that three blocks fit an
  // SM) and stage them once the look-back, which needs only `count`, is
  // done.
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    if (first + 32 * j < valid_count) {
      unsigned loc;
      const unsigned d = part_owner(p[j], B, rcp, &loc);
      slot[j] += s_local[d] + s_warp[warp][d];
      s_pos[slot[j]] = p[j];
    }
  }
  int g[kPartItems];
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    g[j] = first + 32 * j < valid_count ? __ldcs(gt + 32 * j) : 0;
  }
  if (t < S) {
    unsigned before_tile = 0;
    if (tile > 0) {
      before_tile = part_lookback(status, tile, S, t);
      status_store(mine, 2u, before_tile + count);
    }
    s_base[t] = start + static_cast<int>(before_tile) - local;
  }
#pragma unroll
  for (int j = 0; j < kPartItems; ++j) {
    if (first + 32 * j < valid_count) s_gs[slot[j]] = g[j];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < kPartItems; ++r) {
    const int i = r * kThreads + t;
    if (i < valid_count) {
      unsigned loc;
      const unsigned d = part_owner(s_pos[i], B, rcp, &loc);
      const int dst = s_base[d] + i;
      out_pos[dst] = static_cast<int>(loc);
      out_gs[dst] = s_gs[i];
    }
  }
  if (live) {
    // The staged pairs again, consecutive ones mostly of one owner: a
    // leader a warp and owner counts the unsettled ones (group start < 0)
    // into shared memory, one global add a block and owner.
    for (int r = 0; r < kPartItems; ++r) {
      const int i = r * kThreads + t;
      bool unsettled = false;
      unsigned d = 0;
      if (i < valid_count) {
        unsigned loc;
        d = part_owner(s_pos[i], B, rcp, &loc);
        unsettled = s_gs[i] < 0;
      }
      const unsigned peers = owner_peers(d, unsettled, bits);
      if (unsettled && (peers & lower) == 0) {
        atomicAdd(&s_live[d], __popc(peers));
      }
    }
    __syncthreads();
    if (t < S && s_live[t]) atomicAdd(&live[t], s_live[t]);
  }
}

// (c) The relabel of a shard's merged list in slot space.  The list holds
// m pairs at global list indices J = off + i, sorted by key; a key's old
// group start is g = key >> shift (a round's rank[i], shift = W; the init
// passes shift = 63, one old group from 0).  Every member of an old group
// is in the list, contiguous, so with f the list index of the group's
// first member, pair J sits at slot J + (g - f); a new group starts where
// the key differs from its predecessor's, and its start is its slot.  So
// two inclusive max scans along the list give every pair its new group
// start: a of g - J at the old groups' first members (g - f rises along
// the list: it counts the settled slots below g) and b of J at the new
// groups' first members; the start is b + a.  A pair is settled when its
// own and its successor's keys both start groups (for the last pair the
// first key of the next non-empty shard, succ).  The predecessor of pair 0
// is pred, the last key of the nearest non-empty earlier shard; the scans
// carry in the last a and b of the earlier shards (carry_a, carry_b).
//   giant_flags_kernel: stats[0], stats[1] = the shard's largest a and b
//     candidates (-1 if none: its carries out), stats[2] = its unsettled
//     real pairs (keys >= real_lo), read back with every shard's before
//     the relabel; the build stops when no real pair is left unsettled
//     (B9's settled stop).
//   giant_relabel_kernel: one pass of decoupled look-back over tiles of
//     kRelabelTile pairs, 16 consecutive pairs a thread, both scans in one
//     status word a tile (tag in bits 62-63, a + 1 and b + 1 in 31 bits
//     each), writing each pair's new group start with the sign bit set
//     where it is unsettled.
// Together 20 bytes a pair, as the one-value candidates and max scan
// they replace.
__global__ void giant_stats_init_kernel(int* stats) {
  stats[0] = -1;
  stats[1] = -1;
  stats[2] = 0;
}

__global__ void __launch_bounds__(kThreads)
    giant_flags_kernel(const uint64_t* __restrict__ keys, long long m,
                       long long off, uint64_t pred, int has_pred,
                       uint64_t succ, int has_succ, int shift,
                       uint64_t real_lo, int* __restrict__ stats) {
  int best_a = -1;
  int best_b = -1;
  int tied = 0;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < m; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const uint64_t k = keys[i];
    const bool first = i == 0 && !has_pred;
    const uint64_t prev = i > 0 ? keys[i - 1] : pred;
    const bool ns = first || k != prev;
    const bool next_ns = i + 1 < m ? keys[i + 1] != k : !has_succ || succ != k;
    const long long J = off + i;
    if (first || (k >> shift) != (prev >> shift)) {
      const int a = static_cast<int>(static_cast<long long>(k >> shift) - J);
      best_a = a > best_a ? a : best_a;
    }
    if (ns) best_b = static_cast<int>(J);  // J grows along a thread's loop
    tied += !(ns && next_ns) && k >= real_lo ? 1 : 0;
  }
  for (int o = 16; o > 0; o >>= 1) {
    const int a = __shfl_down_sync(kFull, best_a, o);
    best_a = a > best_a ? a : best_a;
    const int b = __shfl_down_sync(kFull, best_b, o);
    best_b = b > best_b ? b : best_b;
    tied += __shfl_down_sync(kFull, tied, o);
  }
  if ((threadIdx.x & 31) == 0) {
    if (best_a >= 0) atomicMax(&stats[0], best_a);
    if (best_b >= 0) atomicMax(&stats[1], best_b);
    if (tied) atomicAdd(&stats[2], tied);
  }
}

constexpr int kRelabelItems = 16;
constexpr int kRelabelTile = kThreads * kRelabelItems;

__device__ __forceinline__ unsigned long long relabel_word(unsigned tag,
                                                           int a, int b) {
  return (static_cast<unsigned long long>(tag) << 62) |
         (static_cast<unsigned long long>(static_cast<unsigned>(a + 1))
          << 31) |
         static_cast<unsigned>(b + 1);
}

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// Warp 0's look-back for tile `tile`: the max of a and of b over tiles
// [0, tile), as lookback_sum walks, into *pa and *pb on every lane.
__device__ __forceinline__ void lookback_relabel(
    const unsigned long long* status, long long tile, int* pa, int* pb) {
  const int lane = threadIdx.x & 31;
  int ca = -1, cb = -1;
  for (long long q = tile - 1;; q -= 32) {
    const long long at = q - lane;
    unsigned long long w =
        at >= 0 ? *reinterpret_cast<const volatile unsigned long long*>(
                      status + at)
                : 2ull << 62;  // before tile 0: a prefix of (-1, -1)
    while (__any_sync(kFull, (w >> 62) == 0ull)) {
      if ((w >> 62) == 0ull) {
        w = *reinterpret_cast<const volatile unsigned long long*>(status +
                                                                  at);
      }
    }
    const unsigned prefixes = __ballot_sync(kFull, (w >> 62) == 2ull);
    int a = static_cast<int>((w >> 31) & 0x7fffffffull) - 1;
    int b = static_cast<int>(w & 0x7fffffffull) - 1;
    if (prefixes && lane > __ffs(prefixes) - 1) a = b = -1;
    for (int o = 16; o > 0; o >>= 1) {
      a = imax(a, __shfl_xor_sync(kFull, a, o));
      b = imax(b, __shfl_xor_sync(kFull, b, o));
    }
    ca = imax(ca, a);
    cb = imax(cb, b);
    if (prefixes) break;
  }
  *pa = ca;
  *pb = cb;
}

__global__ void __launch_bounds__(kThreads)
    giant_relabel_kernel(const uint64_t* __restrict__ keys, long long m,
                         long long off, uint64_t pred, int has_pred,
                         uint64_t succ, int has_succ, int shift, int carry_a,
                         int carry_b, int vec, int* __restrict__ out,
                         unsigned long long* status, int* counter) {
  __shared__ int s_tile;
  __shared__ int s_a[kWarps + 1];
  __shared__ int s_b[kWarps + 1];
  __shared__ int s_carry[2];
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  if (t == 0) s_tile = atomicAdd(counter, 1);
  __syncthreads();
  const long long tile = s_tile;
  const long long base =
      tile * kRelabelTile + static_cast<long long>(t) * kRelabelItems;
  const bool whole = vec && base + kRelabelItems <= m;
  uint64_t k[kRelabelItems];
  if (whole) {
    const ulonglong2* src = reinterpret_cast<const ulonglong2*>(keys + base);
#pragma unroll
    for (int q = 0; q < kRelabelItems / 2; ++q) {
      const ulonglong2 x = src[q];
      k[2 * q] = x.x;
      k[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRelabelItems; ++j) {
      k[j] = base + j < m ? keys[base + j] : 0ull;
    }
  }
  const uint64_t before = base > 0 && base - 1 < m ? keys[base - 1] : pred;
  const uint64_t after = base + kRelabelItems < m ? keys[base + kRelabelItems]
                                                  : succ;
  unsigned ns = 0, os = 0;  // bit j: pair base + j starts a new, old group
  int acc_a = -1, acc_b = -1;
#pragma unroll
  for (int j = 0; j < kRelabelItems; ++j) {
    const long long i = base + j;
    if (i < m) {
      const bool first = i == 0 && !has_pred;
      const uint64_t prev = j > 0 ? k[j - 1] : before;
      const long long J = off + i;
      if (first || k[j] != prev) {
        ns |= 1u << j;
        acc_b = static_cast<int>(J);
      }
      if (first || (k[j] >> shift) != (prev >> shift)) {
        os |= 1u << j;
        acc_a = imax(acc_a, static_cast<int>(
                                static_cast<long long>(k[j] >> shift) - J));
      }
    }
  }
  // The block's exclusive max scans of (a, b) and its totals.
  int ia = acc_a, ib = acc_b;
  for (int o = 1; o < 32; o <<= 1) {
    const int ya = __shfl_up_sync(kFull, ia, o);
    const int yb = __shfl_up_sync(kFull, ib, o);
    if (lane >= o) {
      ia = imax(ia, ya);
      ib = imax(ib, yb);
    }
  }
  if (lane == 31) {
    s_a[warp] = ia;
    s_b[warp] = ib;
  }
  __syncthreads();
  if (t == 0) {
    int ra = -1, rb = -1;
    for (int w = 0; w < kWarps; ++w) {
      const int xa = s_a[w], xb = s_b[w];
      s_a[w] = ra;
      s_b[w] = rb;
      ra = imax(ra, xa);
      rb = imax(rb, xb);
    }
    s_a[kWarps] = ra;
    s_b[kWarps] = rb;
  }
  __syncthreads();
  unsigned long long* mine = status + tile;
  if (t < 32) {
    const int ta = s_a[kWarps], tb = s_b[kWarps];
    if (lane == 0) {
      *reinterpret_cast<volatile unsigned long long*>(mine) =
          relabel_word(tile == 0 ? 2u : 1u, ta, tb);
    }
    int pa = -1, pb = -1;
    if (tile > 0) {
      lookback_relabel(status, tile, &pa, &pb);
      if (lane == 0) {
        *reinterpret_cast<volatile unsigned long long*>(mine) =
            relabel_word(2u, imax(pa, ta), imax(pb, tb));
      }
    }
    if (lane == 0) {
      s_carry[0] = imax(pa, carry_a);
      s_carry[1] = imax(pb, carry_b);
    }
  }
  __syncthreads();
  int xa = __shfl_up_sync(kFull, ia, 1);
  int xb = __shfl_up_sync(kFull, ib, 1);
  if (lane == 0) xa = xb = -1;
  int ra = imax(imax(s_a[warp], xa), s_carry[0]);
  int rb = imax(imax(s_b[warp], xb), s_carry[1]);
  int v[kRelabelItems];
#pragma unroll
  for (int j = 0; j < kRelabelItems; ++j) {
    const long long i = base + j;
    const long long J = off + i;
    if ((os >> j) & 1u) {
      ra = imax(ra, static_cast<int>(static_cast<long long>(k[j] >> shift) -
                                     J));
    }
    if ((ns >> j) & 1u) rb = imax(rb, static_cast<int>(J));
    bool next_ns;
    if (i + 1 >= m) {
      next_ns = !has_succ || succ != k[j];
    } else if (j + 1 < kRelabelItems) {
      next_ns = (ns >> (j + 1)) & 1u;
    } else {
      next_ns = after != k[j];
    }
    const int gs = rb + ra;
    v[j] = ((ns >> j) & 1u) && next_ns ? gs : gs | INT_MIN;
  }
  if (whole) {
    int4* dst = reinterpret_cast<int4*>(out + base);
#pragma unroll
    for (int q = 0; q < kRelabelItems / 4; ++q) {
      dst[q] = make_int4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kRelabelItems; ++j) {
      if (base + j < m) out[base + j] = v[j];
    }
  }
}

// Step 4's merge of the S runs a shard receives (giant_merge).  Each run
// is sorted by (key, position), and the runs come in source order, which
// is position order, so the shard's (key, position) order is the stable
// sort of their concatenation, (key, run, index): a merge.  A round merges
// consecutive runs kMergeWays at a time, pairs (run 2g with run 2g + 1),
// reading and writing each pair once (24 bytes a pair), until one run is
// left: ceil(log2 S) rounds, 2 at S = 4 and 8 at 256, where the radix sort
// it replaces makes 6-8 passes of 24 bytes and a histogram.  A round:
//   1. giant_merge_rank_kernel: every run of a group of w runs gives a
//      sample every gap = kMergeTile / w pairs, and each sample's co-rank
//      in each run of its group -- the run's pairs before it: keys <= its
//      key in an earlier run, < in a later one, its own index in its own
//      run -- by a binary search a lane, w lanes a sample.  The samples
//      before it in (key, run, index) order are the sum over the runs of
//      ceil(co-rank / gap), which is where its co-ranks go in the group's
//      list: the list comes out sorted, with no sort.
//   2. giant_merge_segments_kernel: a block a listed sample merges the
//      pairs from it up to the next one (or the group's end).  Between two
//      consecutive samples no run has a sample of its own, so each run
//      gives at most gap pairs and the segment at most kMergeTile; its
//      first output slot is the group's first plus the sum of its
//      co-ranks.  The block loads the sub-runs into shared memory
//      (consecutive threads on consecutive pairs, every load of a thread
//      in flight at once), merges them there (merge_level: a merge-path
//      search a thread, then a serial merge of its kMergeItems slots; for
//      w > 2, ceil(log2 w) such levels), carrying each pair's slot in the
//      segment so that its value moves once, and writes the segment out in
//      order.
// Measured on an H100 at 128 Mi pairs (PERF.md): merging 4 or 16 runs in
// one round (w = 4 or 16, the levels in shared memory) was slower than
// pairs at S = 4, 64 and 256, though at S = 4 it moves half the bytes: a
// round is held by its blocks' chains of latency (the list rows, then the
// pairs, then the levels), not by its bytes, and a segment holds
// kMergeTile / w pairs on average.  Ranking each pair by a binary search
// in every other sub-run, the first form, spent most of its time in the
// searches' issue slots; a serial merge spends a compare a pair.  Keys
// compare as int64, as torch orders them.
constexpr int kMergeWays = 2;
constexpr int kMergeTile = 2048;
constexpr int kMergeThreads = 256;
constexpr int kMergeItems = kMergeTile / kMergeThreads;  // pairs a thread
constexpr int kMergeMaxRuns = kGiantMaxShards;
static_assert(kMergeTile % kMergeThreads == 0, "whole items a thread");
static_assert(kMergeTile <= 65536, "a segment's slots fit 16 bits");

// One round's runs, by value in the kernels' parameters: run c holds pairs
// [off[c], off[c + 1]) and its samples are list rows [smp[c], smp[c + 1]).
struct MergeRound {
  long long off[kMergeMaxRuns + 1];
  int smp[kMergeMaxRuns + 1];
  int runs;
  int ways;  // runs a group merges; the last group may have fewer
  int gap;   // pairs between a run's samples
};

// The run whose samples hold list row (or sample) s: the last c with
// smp[c] <= s, for 0 <= s < smp[runs].
__device__ __forceinline__ int merge_run_of(const MergeRound& r,
                                            long long s) {
  int lo = 0, hi = r.runs;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (r.smp[mid] <= s) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// The pairs of sorted keys[lo, lo + n) before key: those <= key when upper
// (an earlier run), those < key otherwise.
template <class Keys>
__device__ __forceinline__ long long merge_count(Keys keys, long long lo,
                                                 long long n, long long key,
                                                 bool upper) {
  const long long first = lo;
  while (n > 0) {
    const long long half = n >> 1;
    const long long k = keys[lo + half];
    if (upper ? k <= key : k < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo - first;
}

// lanes = 2^lanes_log >= ways lanes a sample, in one warp; list row
// (smp[first run of the group] + samples before it), column i, gets the
// sample's co-rank in run i of its group.
__global__ void __launch_bounds__(kThreads)
    giant_merge_rank_kernel(const long long* __restrict__ keys,
                            const __grid_constant__ MergeRound r,
                            int lanes_log, int* __restrict__ list) {
  const long long tid =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  const long long s = tid >> lanes_log;
  const int i = static_cast<int>(tid & ((1 << lanes_log) - 1));
  const bool live = s < r.smp[r.runs];
  int first = 0, ways = 0;
  long long co = 0;
  int before = 0;
  if (live) {
    const int c = merge_run_of(r, s);
    const int g = c / r.ways;
    first = g * r.ways;
    ways = (r.runs - first < r.ways ? r.runs - first : r.ways);
    const int j = c - first;
    const long long own = (s - r.smp[c]) * r.gap;
    if (i == j) {
      co = own;
    } else if (i < ways) {
      const long long key = keys[r.off[c] + own];
      co = merge_count(keys, r.off[first + i],
                       r.off[first + i + 1] - r.off[first + i], key, i < j);
    }
    if (i < ways) before = static_cast<int>((co + r.gap - 1) / r.gap);
  }
  for (int o = 1; o < (1 << lanes_log); o <<= 1) {
    before += __shfl_xor_sync(kFull, before, o);
  }
  if (live && i < ways) {
    list[(static_cast<long long>(r.smp[first]) + before) * r.ways + i] =
        static_cast<int>(co);
  }
}

// The sub-run of segment slot e: the last j < ways with so[j] <= e (never
// an empty one, since so[ways] > e).
__device__ __forceinline__ int merge_sub_run(const int* so, int ways, int e) {
  int lo = 0, hi = ways;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (so[mid] <= e) {
      lo = mid;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// A segment's keys lie in shared memory at msw(slot): the slot's low 4
// bits XORed with its next 8, so that threads reading slots 2, 4, 8 or 16
// apart (the serial merges' heads, the merge-path searches) hit distinct
// 8-byte bank pairs where slot order would put them all on a few.
__device__ __forceinline__ int msw(int i) {
  return i ^ (((i >> 4) ^ (i >> 8)) & 15);
}

// Where slot o of a merge level falls: the pair of lists (2g, 2g + 1) whose
// span [xs, ye) holds it (the earlier list [xs, xe)), and how many of the
// pair's first o - xs slots come from each list (ia, ib): a merge-path
// search, ties to the earlier list, which holds the lower runs.
__device__ __forceinline__ void merge_path(const long long* s_key,
                                           const int* so, int p, int o,
                                           int* xs, int* xe, int* ye, int* ia,
                                           int* ib) {
  int g = 0;  // the last pair whose span starts at or before o
  while (2 * g + 2 < p && so[2 * g + 2] <= o) ++g;
  *xs = so[2 * g];
  *xe = so[2 * g + 1 < p ? 2 * g + 1 : p];
  *ye = so[2 * g + 2 < p ? 2 * g + 2 : p];
  const int nx = *xe - *xs, ny = *ye - *xe;
  const int d = o - *xs;
  int lo = d - ny > 0 ? d - ny : 0;
  int hi = d < nx ? d : nx;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool before =
        s_key[msw(*xs + mid)] <= s_key[msw(*xe + d - 1 - mid)];
    lo = before ? mid + 1 : lo;
    hi = before ? hi : mid;
  }
  *ia = *xs + lo;  // the heads, as slots
  *ib = *xe + d - lo;
}

// One level of the segment's merge tree in shared memory: the p sorted
// lists at so[0..p] (list i holds slots [so[i], so[i + 1])) are merged in
// pairs, list 2g with list 2g + 1 (the last alone when p is odd), each
// pair into its own span.  Thread t makes the level's slots [t E, t E + E)
// (E = kMergeItems): a merge-path search where its first slot (or a
// pair's first slot inside its range) falls, then a serial merge with the
// two heads' keys in registers, one shared load a slot and no branch; its
// keys and original slots stay in registers until a barrier, then go back
// in place.
__device__ __forceinline__ void merge_level(long long* s_key,
                                            unsigned short* s_idx,
                                            const int* so, int p, int size) {
  long long rk[kMergeItems];
  unsigned short ri[kMergeItems];
  const int o0 = threadIdx.x * kMergeItems;
  int xe = 0, ye = 0, ia = 0, ib = 0;
  long long ka = 0, kb = 0;
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const int o = o0 + q;
    if (o < size) {
      if (q == 0 || o >= ye) {
        int xs;
        merge_path(s_key, so, p, o, &xs, &xe, &ye, &ia, &ib);
        ka = ia < xe ? s_key[msw(ia)] : 0;
        kb = ib < ye ? s_key[msw(ib)] : 0;
      }
      const bool take_x = ib >= ye || (ia < xe && ka <= kb);
      const int at = take_x ? ia : ib;
      rk[q] = take_x ? ka : kb;
      ri[q] = s_idx[at];
      ia += take_x ? 1 : 0;
      ib += take_x ? 0 : 1;
      const int next = at + 1;
      const long long k =
          next < (take_x ? xe : ye) ? s_key[msw(next)] : 0;
      ka = take_x ? k : ka;
      kb = take_x ? kb : k;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    if (o0 + q < size) {
      s_key[msw(o0 + q)] = rk[q];
      s_idx[o0 + q] = ri[q];
    }
  }
}

__global__ void __launch_bounds__(kMergeThreads)
    giant_merge_segments_kernel(const long long* __restrict__ keys,
                                const int* __restrict__ vals,
                                const __grid_constant__ MergeRound r,
                                const int* __restrict__ list,
                                long long* __restrict__ out_keys,
                                int* __restrict__ out_vals) {
  __shared__ long long s_key[kMergeTile];
  __shared__ int s_val[kMergeTile];
  __shared__ unsigned short s_idx[kMergeTile];
  __shared__ int s_lo[kMergeWays];
  __shared__ int s_so[kMergeWays + 1];  // the lists' starts in the segment
  __shared__ long long s_src[kMergeWays];
  __shared__ long long s_dst;
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const int first = merge_run_of(r, b) / r.ways * r.ways;
  const int ways = r.runs - first < r.ways ? r.runs - first : r.ways;
  const int end = r.smp[first + ways];
  if (t < ways) {
    const int lo = list[b * r.ways + t];
    const long long hi =
        b + 1 < end ? list[(b + 1) * r.ways + t]
                    : r.off[first + t + 1] - r.off[first + t];
    s_lo[t] = lo;
    s_so[t + 1] = static_cast<int>(hi - lo);
    s_src[t] = r.off[first + t] + lo;
  }
  __syncthreads();
  if (t == 0) {
    long long below = 0;
    int acc = 0;
    for (int i = 0; i < ways; ++i) {
      below += s_lo[i];
      const int len = s_so[i + 1];
      s_so[i] = acc;
      acc += len;
    }
    s_so[ways] = acc;
    s_dst = r.off[first] + below;
  }
  __syncthreads();
  const int size = s_so[ways];
  // Every load of a thread in flight before the first is used: slot
  // t + q * kMergeThreads, consecutive threads on consecutive pairs.
  long long key[kMergeItems];
  int val[kMergeItems];
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const int e = t + q * kMergeThreads;
    if (e < size) {
      const int j = merge_sub_run(s_so, ways, e);
      const long long at = s_src[j] + (e - s_so[j]);
      key[q] = keys[at];
      val[q] = vals[at];
    }
  }
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const int e = t + q * kMergeThreads;
    if (e < size) {
      s_key[msw(e)] = key[q];
      s_val[e] = val[q];
      s_idx[e] = static_cast<unsigned short>(e);
    }
  }
  __syncthreads();
  // ceil(log2 ways) levels of pairwise merges; s_so then holds the merged
  // lists' starts.
  for (int p = ways; p > 1; p = (p + 1) >> 1) {
    merge_level(s_key, s_idx, s_so, p, size);
    __syncthreads();
    if (t == 0) {
      for (int g = 0; 2 * g < p; ++g) s_so[g] = s_so[2 * g];
      s_so[(p + 1) >> 1] = size;
    }
    __syncthreads();
  }
  const long long dst = s_dst;
#pragma unroll
  for (int q = 0; q < kMergeItems; ++q) {
    const int o = t + q * kMergeThreads;
    if (o < size) {
      out_keys[dst + o] = s_key[msw(o)];
      out_vals[dst + o] = s_val[s_idx[o]];
    }
  }
}

// The list of the largest round: at most m / gap + runs rows of w columns,
// gap = kMergeTile / w, for the first round's w (the widest).
int* carve_merge(Arena& a, long long m, long long runs) {
  const long long w = runs < kMergeWays ? runs : kMergeWays;
  const long long gap = w > 0 ? kMergeTile / w : 1;
  return a.take<int>((m / gap + runs + 1) * (w > 0 ? w : 1));
}

// The partition's scratch: status words and the tile counter.
struct PartBufs {
  unsigned long long* status;  // [tiles][S]
  int* counter;
};

PartBufs carve_part(Arena& a, long long m, long long S) {
  PartBufs b;
  b.status = a.take<unsigned long long>(cdiv(m, kPartTile) * S);
  b.counter = a.take<int>(1);
  return b;
}

// The scratch of a one-pass look-back over tiles: a status word a tile and
// the tile counter (the round keys' compaction, the relabel).
struct TileBufs {
  unsigned long long* status;
  int* counter;
};

TileBufs carve_tiles(Arena& a, long long tiles) {
  TileBufs b;
  b.status = a.take<unsigned long long>(tiles);
  b.counter = a.take<int>(1);
  return b;
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

// ---- B1 and B1b -----------------------------------------------------------

long long pss_sa_hybrid_scratch_bytes(long long N) {
  Arena a{nullptr, 0};
  carve_init(a, N);
  return static_cast<long long>(a.off);
}

// text uint8 [N] (true length 0 <= n <= N), rank_map int32 [256] (every
// byte of the text ranked 1 or more); writes sa, rank, gs int32 [N]; the
// device picks the path; stats, when not null, int32 [3] (see
// anchored_init).
// Scratch as pss_sa_hybrid_scratch_bytes(N).
int pss_sa_init_ranked(const void* text, long long N, long long n,
                       const void* rank_map, int bits, void* sa, void* rank,
                       void* gs, void* scratch, void* stats,
                       void* stream) {
  if (N <= 0) return 0;
  if (bits != 5 && bits != 6) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  const InitBufs b = carve_init(a, N);
  const uint8_t* t = static_cast<const uint8_t*>(text);
  const int* map = static_cast<const int*>(rank_map);
  int* out[3] = {static_cast<int*>(sa), static_cast<int*>(rank),
                 static_cast<int*>(gs)};
  // 2D digits of `bits` bits: 60 key bits either way.
  if (bits == 5) {
    anchored_init(RankedSrc<12>{t, n, map}, N, n, 60, kCutRanked, out[0],
                  out[1], out[2], b, static_cast<int*>(stats), st);
  } else {
    anchored_init(RankedSrc<10>{t, n, map}, N, n, 60, kCutRanked, out[0],
                  out[1], out[2], b, static_cast<int*>(stats), st);
  }
  return static_cast<int>(cudaGetLastError());
}

// text uint8 [N] (true length 0 <= n <= N); as pss_sa_init_ranked on the
// 6-byte key.
int pss_sa_init_bytes(const void* text, long long N, long long n, void* sa,
                      void* rank, void* gs, void* scratch, void* stats,
                      void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  const InitBufs b = carve_init(a, N);
  const ByteSrc<6> src{static_cast<const uint8_t*>(text), n, nullptr};
  anchored_init(src, N, n, kByteKeyBits, kCutBytes, static_cast<int*>(sa),
                static_cast<int*>(rank), static_cast<int*>(gs), b,
                static_cast<int*>(stats), st);
  return static_cast<int>(cudaGetLastError());
}

// ---- B2 -------------------------------------------------------------------

long long pss_sa_tie_scratch_bytes(long long N) {
  return pss_scan_scratch_bytes(N);
}

long long pss_sa_round_scratch_bytes(long long c) {
  Arena a{nullptr, 0};
  carve_compact(a, c);
  return static_cast<long long>(a.off);
}

// The round's tie scan over c candidates: the slots cand int32 [c], or
// every slot of the row when cand is null (c = N).  Writes the tied list
// tl int32 [c] (its first m entries, in slot order) and counts[0] = m.
// Scratch as pss_sa_round_scratch_bytes(c).
int pss_sa_tie_scan(const void* gs, long long N, const void* cand,
                    long long c, void* tl, void* counts, void* scratch,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  const CompactBufs b = carve_compact(a, c);
  const int* m = compact(TiePred{static_cast<const int*>(gs), N,
                                 static_cast<const int*>(cand),
                                 static_cast<int*>(tl)},
                         c, nullptr, b, st);
  copy_count_kernel<<<1, 1, 0, st>>>(m, static_cast<int*>(counts));
  return static_cast<int>(cudaGetLastError());
}

long long pss_sa_refine_scratch_bytes(long long m) {
  Arena a{nullptr, 0};
  carve_seg(a, m, false);
  return static_cast<long long>(a.off);
}

// Refines the m listed slots (tl from pss_sa_tie_scan) by the rank k
// positions on; sa, rank, gs int32 [N] are updated in place; counts[1]
// gets the members of groups over kSegT.  Scratch as
// pss_sa_refine_scratch_bytes(m).
int pss_sa_refine_round(void* sa, void* rank, void* gs, long long N,
                        long long k, long long m, void* tl, void* counts,
                        void* scratch, void* stream) {
  if (m <= 0) return 0;
  Arena a{static_cast<char*>(scratch), 0};
  const SegBufs b = carve_seg(a, m, false);
  seg_refine(static_cast<int*>(sa), static_cast<int*>(rank),
             static_cast<int*>(gs), N, k, static_cast<int*>(tl), m,
             static_cast<int*>(counts), b, static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

long long pss_sa_pass_scratch_bytes(long long m) {
  Arena a{nullptr, 0};
  carve_seg(a, m, true);
  a.take<int>(2);
  return static_cast<long long>(a.off);
}

// ---- B9 -------------------------------------------------------------------

long long pss_sa_full_scratch_bytes(long long N) {
  Arena a{nullptr, 0};
  carve_full(a, N);
  Arena r{nullptr, 0};
  carve_full_round(r, N);
  return static_cast<long long>(a.off > r.off ? a.off : r.off);
}

// text uint8 [N] (true length n <= N); writes sa, rank int32 [N] of the
// 6-byte init and count int32 [2] (see the B9 section).
int pss_sa_full_init_bytes(const void* text, long long N, long long n,
                           void* sa, void* rank, void* count, void* scratch,
                           void* stream) {
  if (N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  FullBufs b = carve_full(a, N);
  const uint8_t* t = static_cast<const uint8_t*>(text);
  cudaMemsetAsync(b.mask, 0, sizeof(unsigned) * (kThreads / 32), st);
  const unsigned pgrid = grid_for(cdiv(n, 16));
  full_present_kernel<<<pgrid < kPresentBlocks ? pgrid : kPresentBlocks,
                        kThreads, 0, st>>>(t, n, b.mask);
  full_keys_bytes_kernel<<<grid_for(N), kThreads, 0, st>>>(t, N, n, b.mask,
                                                           b.keys, b.vals);
  full_relabel(b, N, N - n, kFullByteKeyBits, static_cast<int*>(sa),
               static_cast<int*>(rank), static_cast<int*>(count), st);
  return static_cast<int>(cudaGetLastError());
}

// rank int32 [N]: value + 1 of the first N - npad positions, 0 after, every
// value below 2^W; the JAX first round at k = 1, in place, with sa int32
// [N] and count int32 [2].
int pss_sa_full_init_ranks(void* sa, void* rank, long long N, long long npad,
                           int W, void* count, void* scratch, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || W > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  FullBufs b = carve_full(a, N);
  full_keys_kernel<<<grid_for(N), kThreads, 0, st>>>(
      static_cast<const int*>(rank), N, 1, W, b.keys, b.vals);
  full_relabel(b, N, npad, 2 * W, static_cast<int*>(sa),
               static_cast<int*>(rank), static_cast<int*>(count), st);
  return static_cast<int>(cudaGetLastError());
}

// One round at offset k on sa, rank int32 [N] in place (dense ranks, sa
// their order with ties in position order, as every init and round leaves
// them); count int32 [2] as the B9 section says, npad = N - n.  With sort
// set, the round sorts every slot on 2W bits (every rank below 2^W - 1)
// instead of refining the groups.
int pss_sa_full_round(void* sa, void* rank, long long N, long long k, int W,
                      long long npad, int sort, void* count, void* scratch,
                      void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || W > 31) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  int* r = static_cast<int*>(rank);
  int* c = static_cast<int*>(count);
  if (sort) {
    FullBufs b = carve_full(a, N);
    full_keys_kernel<<<grid_for(N), kThreads, 0, st>>>(r, N, k, W, b.keys,
                                                       b.vals);
    full_relabel(b, N, npad, 2 * W, static_cast<int*>(sa), r, c, st);
  } else {
    FullRoundBufs b = carve_full_round(a, N);
    full_round(static_cast<int*>(sa), r, N, k, npad, c, b, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- B10 ------------------------------------------------------------------

long long pss_sa_init_scratch_bytes(long long N) {
  Arena a{nullptr, 0};
  carve_init3(a, N);
  return static_cast<long long>(a.off);
}

// text uint8 [N] (true length 0 <= n <= N); writes sa, rank, gs int32 [N]
// of the 3-byte anchored init, sorting inside them.  Scratch as
// pss_sa_init_scratch_bytes(N).
int pss_sa_init3_bytes(const void* text, long long N, long long n, void* sa,
                       void* rank, void* gs, void* scratch, void* stream) {
  if (N <= 0) return 0;
  Arena a{static_cast<char*>(scratch), 0};
  init3_bytes(static_cast<const uint8_t*>(text), N, n, static_cast<int*>(sa),
              static_cast<int*>(rank), static_cast<int*>(gs),
              carve_init3(a, N), static_cast<cudaStream_t>(stream));
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
// by the rank k positions on, in place (B2's tie scan over the window's
// marks, then its refine), then moves ctl[0] to the next window.  Scratch
// as pss_sa_pass_scratch_bytes(m).
int pss_sa_rotating_pass(void* sa, void* rank, void* gs, long long N,
                         long long k, long long m, long long half,
                         long long W, const void* flags, const void* dest,
                         void* ctl, void* scratch, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* c = static_cast<int*>(ctl);
  if (m > 0) {
    const long long span = window_span(N, half, W);
    Arena a{static_cast<char*>(scratch), 0};
    const SegBufs b = carve_seg(a, m, true);
    const Marks marks{static_cast<const int*>(flags),
                      static_cast<const int*>(dest), span, c};
    seg_refine(static_cast<int*>(sa), static_cast<int*>(rank),
               static_cast<int*>(gs), N, k, b.tl, m, a.take<int>(2), b, st,
               &marks);
  }
  next_init_kernel<<<1, 1, 0, st>>>(N, c);
  next_start_kernel<<<walk_grid(N), kThreads, 0, st>>>(
      static_cast<const int*>(gs), N, W, c);
  next_finish_kernel<<<1, 1, 0, st>>>(N, c);
  return static_cast<int>(cudaGetLastError());
}

// ---- B16 ------------------------------------------------------------------

long long pss_scatter_scratch_bytes(long long n) {
  Arena a{nullptr, 0};
  carve_scatter(a, n);
  return static_cast<long long>(a.off);
}

// out[dests[i]] = values[i] for i < n into out [out_len] (dests distinct;
// one outside out is dropped; values null: out[dests[i]] = i); scratch of
// pss_scatter_scratch_bytes(n).
int pss_scatter(const void* values, const void* dests, long long n, void* out,
                long long out_len, void* scratch, void* stream) {
  if (n <= 0 || out_len <= 0) return 0;
  Arena a{static_cast<char*>(scratch), 0};
  scatter_binned(static_cast<const int*>(values),
                 static_cast<const int*>(dests), n, static_cast<int*>(out),
                 out_len, carve_scatter(a, n),
                 static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

long long pss_scatter_blocked_scratch_bytes(long long n) {
  Arena a{nullptr, 0};
  a.take<uint64_t>(n);
  a.take<int>(n);
  carve_sort(a, n);
  return static_cast<long long>(a.off);
}

// out[dests[i]] = values[i] as pss_scatter, blocked by destination.
int pss_scatter_blocked(const void* values, const void* dests, long long n,
                        void* out, void* scratch, void* stream) {
  if (n <= 0) return 0;
  Arena a{static_cast<char*>(scratch), 0};
  uint64_t* keys = a.take<uint64_t>(n);
  int* vals = a.take<int>(n);
  const SortBufs s = carve_sort(a, n);
  blocked_scatter(static_cast<const int*>(values),
                  static_cast<const int*>(dests), n, n, static_cast<int*>(out),
                  keys, vals, s, static_cast<cudaStream_t>(stream));
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

// ---- B14g -----------------------------------------------------------------

// keys uint64 [m], vals int32 [m]: B9's 6-byte init key of positions p0 +
// i of a row of true length n, from text uint8 [m] (the block) and halo
// uint8 [h] (the bytes after it, h <= 5, fewer at the row's end).
int pss_giant_byte_keys(const void* text, long long m, const void* halo,
                        long long h, long long p0, long long n, void* keys,
                        void* vals, void* stream) {
  if (m <= 0) return 0;
  giant_byte_keys_kernel<<<grid_for(m), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(text), m,
      static_cast<const uint8_t*>(halo), h, p0, n,
      static_cast<uint64_t*>(keys), static_cast<int*>(vals));
  return static_cast<int>(cudaGetLastError());
}

long long pss_giant_keys_scratch_bytes(long long m) {
  Arena a{nullptr, 0};
  carve_tiles(a, cdiv(m, kKeyTile));
  return static_cast<long long>(a.off);
}

// keys uint64 [cap], vals int32 [cap]: the unsettled positions (rank[i] <
// 0) of the block rank int32 [m] in position order, keys (rank[i] &
// INT_MAX) << W | (i < c ? (r2[i] & INT_MAX) + 1 : 0), vals p0 + i; count
// int32 [1] their number (only the first cap are written).  The scratch
// holds pss_giant_keys_scratch_bytes(m) bytes and is zeroed here.
int pss_giant_round_keys(const void* rank, const void* r2, long long m,
                         long long c, int W, long long p0, long long cap,
                         void* keys, void* vals, void* count, void* scratch,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(count, 0, sizeof(int), st);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  Arena a{static_cast<char*>(scratch), 0};
  const long long tiles = cdiv(m, kKeyTile);
  const TileBufs b = carve_tiles(a, tiles);
  cudaMemsetAsync(scratch, 0, a.off, st);
  giant_round_keys_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const int*>(rank), static_cast<const int*>(r2), m, c, W,
      p0, cap, static_cast<uint64_t*>(keys), static_cast<int*>(vals),
      static_cast<int*>(count), b.status, b.counter);
  return static_cast<int>(cudaGetLastError());
}

// cuts int64 [ns]: where each (skeys, spos) splitter cuts the sorted pairs.
int pss_giant_cuts(const void* keys, const void* vals, long long m,
                   const void* skeys, const void* spos, int ns, void* cuts,
                   void* stream) {
  if (ns <= 0) return 0;
  giant_cuts_kernel<<<ns, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(vals), m,
      static_cast<const long long*>(skeys), static_cast<const int*>(spos),
      static_cast<long long*>(cuts));
  return static_cast<int>(cudaGetLastError());
}

long long pss_giant_part_scratch_bytes(long long m, long long S) {
  Arena a{nullptr, 0};
  carve_part(a, m, S);
  return static_cast<long long>(a.off);
}

// out_pos, out_gs int32 [m]: the pairs (pos[i] - d * B, gs[i]) stably
// partitioned by owner d = pos[i] / B < S <= 256; totals int32 [S] their
// counts and, when not null, live int32 [S] the counts of those with gs[i]
// < 0.  The scratch holds pss_giant_part_scratch_bytes(m, S) bytes and is
// zeroed here.
int pss_giant_partition(const void* pos, const void* gs, long long m,
                        long long B, int S, void* out_pos, void* out_gs,
                        void* totals, void* live, void* scratch,
                        void* stream) {
  if (S < 1 || S > kGiantMaxShards || B < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(totals, 0, sizeof(int) * S, st);
  if (live) cudaMemsetAsync(live, 0, sizeof(int) * S, st);
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  // Positions are below 2^31, so a B past 2^32 - 1 owns them all as
  // 2^32 - 1 does.
  const unsigned b32 = B > 0xffffffffLL ? 0xffffffffu
                                        : static_cast<unsigned>(B);
  const unsigned rcp = 0xffffffffu / b32;
  int bits = 0;
  while ((1 << bits) < S) ++bits;
  Arena a{static_cast<char*>(scratch), 0};
  const PartBufs b = carve_part(a, m, S);
  cudaMemsetAsync(scratch, 0, a.off, st);
  const long long tiles = cdiv(m, kPartTile);
  const unsigned hist_blocks = static_cast<unsigned>(
      tiles < kPartHistBlocks ? tiles : kPartHistBlocks);
  const int* p = static_cast<const int*>(pos);
  int* tot = static_cast<int*>(totals);
  if (S <= 4) {
    giant_part_hist_kernel<4><<<hist_blocks, kThreads, 0, st>>>(
        p, m, b32, rcp, bits, tot);
  } else if (S <= 8) {
    giant_part_hist_kernel<8><<<hist_blocks, kThreads, 0, st>>>(
        p, m, b32, rcp, bits, tot);
  } else {
    giant_part_hist_kernel<0><<<hist_blocks, kThreads, 0, st>>>(
        p, m, b32, rcp, bits, tot);
  }
  giant_part_scatter_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                              st>>>(
      static_cast<const int*>(pos), static_cast<const int*>(gs), m, b32, rcp,
      bits, S, static_cast<const int*>(totals), b.status, b.counter,
      static_cast<int*>(out_pos), static_cast<int*>(out_gs),
      static_cast<int*>(live));
  return static_cast<int>(cudaGetLastError());
}

long long pss_giant_merge_scratch_bytes(long long m, long long S) {
  Arena a{nullptr, 0};
  carve_merge(a, m, S);
  return static_cast<long long>(a.off);
}

// keys int64 [m] with vals int32 [m] hold S <= 256 runs of the host's
// lengths runs int64 [S] (summing to m), each sorted by (key, value); the
// pairs in (key, run, index) order, the stable sort of the concatenation,
// go to out_keys / out_vals after an odd number of rounds and back into
// keys / vals after an even one: a round merges the non-empty runs
// kMergeWays at a time, until one is left (no round for at most one).  The scratch holds
// pss_giant_merge_scratch_bytes(m, S) bytes.
int pss_giant_merge(void* keys, void* vals, long long m, const void* runs,
                    int S, void* out_keys, void* out_vals, void* scratch,
                    void* stream) {
  if (S < 0 || S > kMergeMaxRuns) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  MergeRound r;
  r.runs = 0;
  long long at = 0;
  const long long* len = static_cast<const long long*>(runs);
  for (int s = 0; s < S; ++s) {
    if (len[s] < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (len[s] > 0) {
      r.off[r.runs++] = at;
      at += len[s];
    }
  }
  if (at != m) return static_cast<int>(cudaErrorInvalidValue);
  r.off[r.runs] = m;
  int* list = static_cast<int*>(scratch);
  long long* src_k = static_cast<long long*>(keys);
  int* src_v = static_cast<int*>(vals);
  long long* dst_k = static_cast<long long*>(out_keys);
  int* dst_v = static_cast<int*>(out_vals);
  while (r.runs > 1) {
    r.ways = r.runs < kMergeWays ? r.runs : kMergeWays;
    r.gap = kMergeTile / r.ways;
    int rows = 0;
    for (int c = 0; c < r.runs; ++c) {
      r.smp[c] = rows;
      rows += static_cast<int>(cdiv(r.off[c + 1] - r.off[c], r.gap));
    }
    r.smp[r.runs] = rows;
    int lanes_log = 0;
    while ((1 << lanes_log) < r.ways) ++lanes_log;
    const long long threads = static_cast<long long>(rows) << lanes_log;
    giant_merge_rank_kernel<<<static_cast<unsigned>(cdiv(threads, kThreads)),
                              kThreads, 0, st>>>(src_k, r, lanes_log, list);
    giant_merge_segments_kernel<<<static_cast<unsigned>(rows), kMergeThreads,
                                  0, st>>>(src_k, src_v, r, list, dst_k,
                                           dst_v);
    // Group g becomes run g of the next round.
    int next = 0;
    for (int c = 0; c < r.runs; c += r.ways) r.off[next++] = r.off[c];
    r.off[next] = m;
    r.runs = next;
    long long* tk = src_k;
    src_k = dst_k;
    dst_k = tk;
    int* tv = src_v;
    src_v = dst_v;
    dst_v = tv;
  }
  return static_cast<int>(cudaGetLastError());
}

// stats int32 [3] of the sorted keys uint64 [m] at list indices off + i
// (see giant_flags_kernel).
int pss_giant_flags(const void* keys, long long m, long long off,
                    long long pred, int has_pred, long long succ,
                    int has_succ, int shift, long long real_lo, void* stats,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  giant_stats_init_kernel<<<1, 1, 0, st>>>(static_cast<int*>(stats));
  if (m > 0) {
    long long g = grid_for(m);
    giant_flags_kernel<<<static_cast<unsigned>(g < 4096 ? g : 4096), kThreads,
                         0, st>>>(static_cast<const uint64_t*>(keys), m, off,
                                  static_cast<uint64_t>(pred), has_pred,
                                  static_cast<uint64_t>(succ), has_succ,
                                  shift, static_cast<uint64_t>(real_lo),
                                  static_cast<int*>(stats));
  }
  return static_cast<int>(cudaGetLastError());
}

long long pss_giant_relabel_scratch_bytes(long long m) {
  Arena a{nullptr, 0};
  carve_tiles(a, cdiv(m, kRelabelTile));
  return static_cast<long long>(a.off);
}

// out int32 [m]: the new group start of every pair of the sorted keys
// uint64 [m], the sign bit set where the pair is unsettled (see
// giant_relabel_kernel).  The scratch holds
// pss_giant_relabel_scratch_bytes(m) bytes and is zeroed here.
int pss_giant_relabel(const void* keys, long long m, long long off,
                      long long pred, int has_pred, long long succ,
                      int has_succ, int shift, int carry_a, int carry_b,
                      void* out, void* scratch, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Arena a{static_cast<char*>(scratch), 0};
  const long long tiles = cdiv(m, kRelabelTile);
  const TileBufs b = carve_tiles(a, tiles);
  cudaMemsetAsync(scratch, 0, a.off, st);
  const int vec = aligned16(keys) && aligned16(out) ? 1 : 0;
  giant_relabel_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, st>>>(
      static_cast<const uint64_t*>(keys), m, off, static_cast<uint64_t>(pred),
      has_pred, static_cast<uint64_t>(succ), has_succ, shift, carry_a,
      carry_b, vec, static_cast<int*>(out), b.status, b.counter);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
