// Hand-written Hopper kernels of the device index: the aux builders that
// turn (text, SA) into limb planes and a seed table (K2, K6 and the digit
// limb planes gather text windows; K1 and K3 make the ranked table, K7 and
// K3 the raw and digit ones; K5, the raw pack, is the counterpart of the
// JAX raw_pack_jit, serves no path of the port and runs on K1's
// template), the probes that
// answer a query batch against them (K4 phased, B11 over digit limbs, B15
// over bare text and SA), and the gathers of hits (B8 flat for a merged
// row, B15 capped per query).
//
// Built by pysubstringsearch_tpu_torch/ops/kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -c ... && nvcc -shared
// and bound through ctypes: every entry point takes raw device pointers and
// a cudaStream_t, launches on that stream, never synchronises, allocates
// nothing, and returns cudaGetLastError().
//
// Layouts follow the JAX package, so the tests compare like with like:
//   text   uint8 [C, n_pad]         sa     int32 [C, n_pad]
//   tables int32 [C, base^depth+1]  limbs  int32 [C, K * n_pad] plane-major
// At the reference size C * K * n_pad passes 2^31, so every row base and
// plane offset is computed in 64 bits.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLimbs = 8;

inline unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(b > 0 ? b : 1);
}

// ---------------------------------------------------------------------------
// K1, ranked pack, K7, seed prefix, and K5, raw pack: one streaming
// template.  K1 replaces _ranked_pack_device / ranked_pack_jit, K7 the
// prefix-value stream of build_seed_table_device (reached through
// derive_table_raw_jit; with identity_rank() and base 258 it is also
// build_bucket_table_device's), whose table K3 then bisects, K5
// raw_pack_jit (pysubstringsearch_tpu/ops/search.py).
//
// out[p] folds the D digits srank[text[p]], ..., srank[text[p + D - 1]],
// first digit first; a digit at or past n is 0, and so is one at or past N
// (text is never read at or past N, and only by a wide load past n):
//   kPackShift (K1): v = (v << bits) + digit, D = 30 / bits (6 at bits 5,
//                    5 at bits 6);
//   kPackBase  (K7): v = v * base + digit, D = depth (2-5), base^depth <=
//                    2^28 (base 258 serves a full-byte alphabet);
//   kPackRaw   (K5): the bytes themselves (no byte map), D = 4, v = (v <<
//                    8) | byte, then the top bit flipped: the top byte
//                    biased by -128, the raw limb encoding, without a
//                    signed shift.  A position at or past n packs
//                    INT32_MIN, as the host builder does.
//
// Bound by memory: the n text bytes read once, 4 bytes written a position
// of the row (a tile from n on reads nothing).  A thread owns a
// tile of kPackTile = 16 positions p0 .. p0 + 15 (p0 a multiple of 16 from
// the row's start): one aligned 16-byte load; the D - 1 <= 5 bytes after
// the tile from the next lane's first 8 bytes (__shfl_down_sync; the lanes
// of a warp hold consecutive tiles), or by an 8-byte load at a warp's last
// lane; each of the 16 + D - 1 bytes through the byte map once (shared
// memory, 256 ints); the 16 values folded in registers, every loop
// unrolled.  A warp of 32 full tiles stages its 512 values in shared
// memory and stores them with four 16-byte store instructions, each
// writing 512 contiguous bytes.  A lane's own four 16-byte stores, 64
// bytes apart across the warp, held the kernels at 0.75-0.83 ms on the
// derive rows against 0.47-0.52 staged, where `text.to(torch.int32)` takes
// 0.49-0.55 (sa_bench.py --packs on an H100).  A row's last warp of tiles
// (at most 512 positions) takes scalar stores, and its partial tile byte
// loads.  A text or out view off the 16-byte alignment launches the
// byte-load form (VEC false): the same tiles and folds, byte loads and
// scalar stores.
//
// nvcc -Xptxas -v (sm_90a): 32-40 registers in the VEC form, 61-63 in the
// byte-load form, 0 bytes of stack and of spills in every instantiation;
// 17,408 bytes of shared memory a block.  The byte map's lookups hit
// random banks (3 bytes of the raw corpus a bank), but K7 on the raw and
// digit rows runs as fast as K1 on the ranked one, whose letters each own
// a bank, so the lookups do not set the pace.
// ---------------------------------------------------------------------------
constexpr int kPackShift = 0;
constexpr int kPackBase = 1;
constexpr int kPackRaw = 2;
constexpr int kPackTile = 16;

// A warp's 512 staged values, as 16-byte units.
constexpr int kPackStage = kPackTile * 32 / 4;

// The slot of 16-byte unit u in a warp's stage: the low 3 bits XOR the
// next 3, so 8 lanes storing units 4l + m (a lane's own tile) or loading
// units 32k + l (a coalesced row) each hit 8 distinct groups of 4 banks.
__device__ __forceinline__ int pack_swizzle(int u) {
  return (u & ~7) | ((u ^ (u >> 3)) & 7);
}

// Byte k of a little-endian word array: k is a constant once unrolled, so
// the array stays in registers.
__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

template <int MODE, int D, bool VEC>
__global__ void __launch_bounds__(kThreads)
pack_tile_kernel(const uint8_t* __restrict__ text, long long N, long long n,
                 const int* __restrict__ rank, int base,
                 int* __restrict__ out) {
  constexpr int kBytes = kPackTile + D - 1;  // 17-21
  __shared__ int srank[256];
  __shared__ uint4 stage[kThreads / 32 * kPackStage];
  if (MODE != kPackRaw) {
    for (int i = threadIdx.x; i < 256; i += blockDim.x) srank[i] = rank[i];
    __syncthreads();
  }
  const long long tiles = (N + kPackTile - 1) / kPackTile;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const int lane = threadIdx.x & 31;
  // The loop runs per warp (w0, its first tile, is the same on every lane),
  // so all 32 lanes reach the shuffles.
  for (long long w0 = static_cast<long long>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       w0 < tiles; w0 += stride) {
    const long long p0 = (w0 + lane) * kPackTile;
    // w[0..3]: the tile's bytes, w[4..5]: the 8 after it; 0 where unread.
    // Bytes at or past n are not needed (their digits are 0), so a tile
    // from n on loads nothing; a 16- or 8-byte load may pass n, never N.
    uint32_t w[6] = {0, 0, 0, 0, 0, 0};
    if (VEC) {
      if (p0 < n && p0 + kPackTile <= N) {
        const uint4 c = *reinterpret_cast<const uint4*>(text + p0);
        w[0] = c.x; w[1] = c.y; w[2] = c.z; w[3] = c.w;
      } else {
#pragma unroll
        for (int k = 0; k < kPackTile; ++k)
          if (p0 + k < n) w[k >> 2] |= static_cast<uint32_t>(text[p0 + k])
                                       << (8 * (k & 3));
      }
      w[4] = __shfl_down_sync(0xffffffffu, w[0], 1);
      w[5] = __shfl_down_sync(0xffffffffu, w[1], 1);
      if (lane == 31) {
        const long long q = p0 + kPackTile;
        if (q < n && q + 8 <= N) {
          const uint2 e = *reinterpret_cast<const uint2*>(text + q);
          w[4] = e.x;
          w[5] = e.y;
        } else {
          w[4] = 0;
          w[5] = 0;
#pragma unroll
          for (int k = 0; k < D - 1; ++k)
            if (q + k < n) w[4 + (k >> 2)] |= static_cast<uint32_t>(text[q + k])
                                             << (8 * (k & 3));
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < kBytes; ++k)
        if (p0 + k < n) w[k >> 2] |= static_cast<uint32_t>(text[p0 + k])
                                     << (8 * (k & 3));
    }
    if (p0 >= N) continue;
    // Digits: byte k is text position p0 + k, 0 at or past n (<= N).
    const long long left = n - p0;
    const int L = left < 0 ? 0 : (left > kBytes ? kBytes : static_cast<int>(left));
    uint32_t dg[kBytes];
#pragma unroll
    for (int k = 0; k < kBytes; ++k)
      dg[k] = k >= L ? 0u
              : MODE == kPackRaw ? byte_of(w, k)
                                 : static_cast<uint32_t>(srank[byte_of(w, k)]);
    uint32_t v[kPackTile];
#pragma unroll
    for (int i = 0; i < kPackTile; ++i) {
      uint32_t x = 0;
#pragma unroll
      for (int d = 0; d < D; ++d)
        x = MODE == kPackShift ? (x << (30 / D)) + dg[i + d]
            : MODE == kPackRaw ? (x << 8) | dg[i + d]
                               : x * static_cast<uint32_t>(base) + dg[i + d];
      v[i] = MODE == kPackRaw ? x ^ 0x80000000u : x;
    }
    if (VEC && (w0 + 32) * kPackTile <= N) {
      // A whole warp of full tiles: its 512 values leave through shared
      // memory, so each 16-byte store instruction writes 512 contiguous
      // bytes (a lane's own four would each touch 32 separate 64-byte
      // spans).  pack_swizzle keeps both sides free of bank conflicts.
      uint4* buf = stage + (threadIdx.x >> 5) * kPackStage;
      __syncwarp();  // the warp's reads of the last tile are done
#pragma unroll
      for (int m = 0; m < kPackTile / 4; ++m)
        buf[pack_swizzle(4 * lane + m)] =
            make_uint4(v[4 * m], v[4 * m + 1], v[4 * m + 2], v[4 * m + 3]);
      __syncwarp();
      uint4* dst = reinterpret_cast<uint4*>(out + w0 * kPackTile);
#pragma unroll
      for (int m = 0; m < kPackTile / 4; ++m)
        dst[32 * m + lane] = buf[pack_swizzle(32 * m + lane)];
    } else {
#pragma unroll
      for (int i = 0; i < kPackTile; ++i)
        if (p0 + i < N) out[p0 + i] = static_cast<int>(v[i]);
    }
  }
}

template <int MODE, int D>
int launch_pack(const void* text, long long N, long long n, const void* rank,
                int base, void* out, void* stream) {
  if (N <= 0) return 0;
  n = n < 0 ? 0 : (n > N ? N : n);
  const long long tiles = (N + kPackTile - 1) / kPackTile;
  unsigned grid = blocks_for(tiles);
  if (grid > 65536u * 16u) grid = 65536u * 16u;
  const bool vec = ((reinterpret_cast<uintptr_t>(text) |
                     reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    pack_tile_kernel<MODE, D, true><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)text, N, n, (const int*)rank, base, (int*)out);
  else
    pack_tile_kernel<MODE, D, false><<<grid, kThreads, 0, st>>>(
        (const uint8_t*)text, N, n, (const int*)rank, base, (int*)out);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2, K6 and B12d's limb planes, from the text.  K2 replaces
// _ranked_limb_col_from_pack / derive_limb_ranked_jit, K6
// derive_limb_raw_jit and build_raw_limbs_device, B12d's limbs
// build_limbs_device (ops/search.py); the JAX programs gather a packed
// stream (K1's, K5's or the base-258 one) once a plane.  One kernel
// template serves the three, each with its own entry point (and so its own
// launch count): plane j of slot i < n packs the D digits of text positions
// start_j .. start_j + D - 1, start_j = clip(sa[i]) + off + D * j:
//   ranked: D = 30 / bits rank digits (srank[byte]), big-endian at `bits`
//           bits each, off = depth;
//   raw:    D = 4 bytes big-endian, the top one biased by -128 (its high bit
//           flipped on unsigned bits), off = depth;
//   digit:  D = 3 base-258 digits (byte + 1), off = 2;
// a digit at or past n is 0, and a slot i >= n is 0 in every plane.  The
// ranked and raw planes keep the pack gather's clamp, start_j = min(start_j,
// N - 1) (a plane past the row's end is the pack's value at N - 1, which
// is not 0 when n = N); the digit planes never had one (their plain version
// and the JAX program read 0 past n).
//
// Bound by memory: per slot one coalesced 4-byte sa read, K coalesced
// 4-byte writes, and the scattered read of the window's D * K <= 18 text
// bytes (neighbouring slots point anywhere in the text), which is where the
// time goes.  Gathering the text instead of a 4-byte pack of it touches
// 1.3-1.5 32-byte sectors a slot instead of 2-2.5 (K reads 4 bytes apart
// by D positions), and no pass builds the pack for it.  A thread takes
// kLimbSlots slots: one 16-byte sa load, then every slot's window as
// aligned 16-byte loads through the read-only path, all in flight before
// the first is used; digits are cut from registers (funnel shifts) and each
// plane's kLimbSlots values leave as one 16-byte store.  A window that
// would leave the row, or reach a clamped plane, takes byte loads.
// ---------------------------------------------------------------------------
constexpr int kLimbRanked = 0;
constexpr int kLimbRaw = 1;
constexpr int kLimbDigit = 2;
constexpr int kLimbSlots = 4;  // slots a thread
constexpr int kDigitBase = 258;
constexpr int kDigitLimbOffset = 2;
constexpr int kDigitLimbStride = 3;

template <int KIND>
__device__ __forceinline__ uint32_t limb_digit(uint32_t byte,
                                               const int* srank) {
  if (KIND == kLimbRanked) return static_cast<uint32_t>(srank[byte]);
  if (KIND == kLimbRaw) return byte;
  return byte + 1;
}

// One plane's value from its D digits, first digit first.
template <int KIND, int D>
__device__ __forceinline__ uint32_t limb_fold(uint32_t v, uint32_t digit) {
  if (KIND == kLimbRanked) return (v << (30 / D)) + digit;
  if (KIND == kLimbRaw) return (v << 8) | digit;
  return v * kDigitBase + digit;
}

template <int KIND>
__device__ __forceinline__ uint32_t limb_finish(uint32_t v) {
  return KIND == kLimbRaw ? v ^ 0x80000000u : v;
}

// A slot's planes by byte loads: windows near the row's end, and the
// clamped planes of the ranked and raw kinds.
template <int KIND, int D, int KMAX>
__device__ __forceinline__ void limb_slot_bytes(const uint8_t* __restrict__ text,
                                const int* srank, long long N, long long n,
                                long long q0, uint32_t* v) {
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    long long start = q0 + static_cast<long long>(D) * j;
    if (KIND != kLimbDigit && start > N - 1) start = N - 1;
    uint32_t x = 0;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const long long q = start + d;
      x = limb_fold<KIND, D>(x, q < n ? limb_digit<KIND>(text[q], srank) : 0u);
    }
    v[j] = limb_finish<KIND>(x);
  }
}

template <int KIND, int D, int KMAX>
__global__ void __launch_bounds__(kThreads)
limb_planes_kernel(const uint8_t* __restrict__ text,
                   const int* __restrict__ rank, const int* __restrict__ sa,
                   long long N, long long n, int off, int K,
                   int* __restrict__ limbs) {
  constexpr int kMaxW = D * KMAX;                // window bytes at most
  constexpr int kChunks = (15 + kMaxW + 15) / 16;  // 16-byte loads at most
  constexpr int kWords = (kMaxW + 3) / 4;
  __shared__ int srank[256];
  if (KIND == kLimbRanked) {
    for (int t = threadIdx.x; t < 256; t += blockDim.x) srank[t] = rank[t];
    __syncthreads();
  }
  const long long i0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kLimbSlots;
  if (i0 >= N) return;
  const int W = D * K;
  const bool vec =
      (N & 3) == 0 && i0 + kLimbSlots <= N &&
      ((reinterpret_cast<uintptr_t>(sa) | reinterpret_cast<uintptr_t>(limbs)) &
       15) == 0;
  int s[kLimbSlots];
  if (vec) {
    const int4 q = *reinterpret_cast<const int4*>(sa + i0);
    s[0] = q.x; s[1] = q.y; s[2] = q.z; s[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < kLimbSlots; ++k) s[k] = i0 + k < N ? sa[i0 + k] : 0;
  }
  // Every window's loads first, so they are in flight together.
  const uintptr_t lo = reinterpret_cast<uintptr_t>(text);
  const uintptr_t hi = lo + static_cast<uintptr_t>(N);
  long long q0[kLimbSlots];
  bool fast[kLimbSlots];
  uint4 c[kLimbSlots][kChunks];
#pragma unroll
  for (int k = 0; k < kLimbSlots; ++k) {
    long long p = s[k];
    p = p < 0 ? 0 : (p > N - 1 ? N - 1 : p);
    q0[k] = p + off;
    const uintptr_t a = lo + static_cast<uintptr_t>(q0[k]);
    const uintptr_t a0 = a & ~static_cast<uintptr_t>(15);
    const int need = static_cast<int>(a - a0) + W;  // bytes from a0
    fast[k] = i0 + k < n && q0[k] + W <= N && a0 >= lo &&
              a0 + static_cast<uintptr_t>((need + 15) & ~15) <= hi;
#pragma unroll
    for (int m = 0; m < kChunks; ++m) c[k][m] = make_uint4(0, 0, 0, 0);
    if (fast[k]) {
      const uint4* src = reinterpret_cast<const uint4*>(a0);
      c[k][0] = __ldg(src);
      if (kChunks > 1 && need > 16) c[k][1] = __ldg(src + 1);
      if (kChunks > 2 && need > 32) c[k][2] = __ldg(src + 2);
    }
  }
  uint32_t v[kLimbSlots][KMAX];
#pragma unroll
  for (int k = 0; k < kLimbSlots; ++k) {
    if (i0 + k >= n) {
#pragma unroll
      for (int j = 0; j < KMAX; ++j) v[k][j] = 0;
    } else if (fast[k]) {
      uint32_t w[4 * kChunks];
#pragma unroll
      for (int m = 0; m < kChunks; ++m) {
        w[4 * m] = c[k][m].x; w[4 * m + 1] = c[k][m].y;
        w[4 * m + 2] = c[k][m].z; w[4 * m + 3] = c[k][m].w;
      }
      // Align the window to w[0] byte 0: whole words by two selects (no
      // dynamically indexed array, which would go to local memory), then
      // the bytes by a funnel shift.
      const int o = static_cast<int>((lo + q0[k]) & 15);
      if (o & 8) {
#pragma unroll
        for (int m = 0; m + 2 < 4 * kChunks; ++m) w[m] = w[m + 2];
      }
      if (o & 4) {
#pragma unroll
        for (int m = 0; m + 1 < 4 * kChunks; ++m) w[m] = w[m + 1];
      }
      const int sh = (o & 3) * 8;
      uint32_t b[kWords];
#pragma unroll
      for (int m = 0; m < kWords; ++m) b[m] = __funnelshift_r(w[m], w[m + 1], sh);
      // Digits at or past n are 0: window byte t is text position q0 + t.
      const long long left = n - q0[k];
      const int L = left < 0 ? 0 : (left > kMaxW ? kMaxW : static_cast<int>(left));
#pragma unroll
      for (int j = 0; j < KMAX; ++j) {
        uint32_t x = 0;
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const int t = D * j + d;
          const uint32_t byte = (b[t >> 2] >> (8 * (t & 3))) & 0xffu;
          x = limb_fold<KIND, D>(x, t < L ? limb_digit<KIND>(byte, srank) : 0u);
        }
        v[k][j] = limb_finish<KIND>(x);
      }
    } else {
      limb_slot_bytes<KIND, D, KMAX>(text, srank, N, n, q0[k], v[k]);
    }
  }
#pragma unroll
  for (int j = 0; j < KMAX; ++j) {
    if (j >= K) break;
    int* plane = limbs + static_cast<long long>(j) * N;
    if (vec) {
      *reinterpret_cast<uint4*>(plane + i0) =
          make_uint4(v[0][j], v[1][j], v[2][j], v[3][j]);
    } else {
#pragma unroll
      for (int k = 0; k < kLimbSlots; ++k)
        if (i0 + k < N) plane[i0 + k] = static_cast<int>(v[k][j]);
    }
  }
}

template <int KIND, int D, int KMAX>
int launch_limb_planes(const void* text, const void* rank, const void* sa,
                       long long N, long long n, int off, int K, void* limbs,
                       void* stream) {
  if (N <= 0) return 0;
  if (K < 1 || K > KMAX || n < 0 || n > N) return (int)cudaErrorInvalidValue;
  const long long threads = (N + kLimbSlots - 1) / kLimbSlots;
  const long long grid = (threads + kThreads - 1) / kThreads;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  limb_planes_kernel<KIND, D, KMAX>
      <<<static_cast<unsigned>(grid), kThreads, 0, (cudaStream_t)stream>>>(
          (const uint8_t*)text, (const int*)rank, (const int*)sa, N, n, off,
          K, (int*)limbs);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K3, seed table.  Replaces derive_table_from_pack_jit (ops/search.py),
// a gather + scatter-min + reverse cummin, and the same tail of
// build_seed_table_device, whose prefix values K7 makes (shift 0).
//
// table[k] = first SA slot i < n whose key packed[sa[i]] >> shift is >= k,
// or n.  Keys never decrease in SA order, so a bisection finds each entry.
// Bound by latency: a bisection of the whole row is about log2(n) steps of
// two dependent scattered loads (sa[mid], then packed[sa[mid]]), so the
// entries share their steps:
//   1. seed_coarse_kernel bisects the row for every kSeedRun-th entry
//      only (one thread each): coarse[c] = table[c * kSeedRun].
//   2. seed_fine_kernel, a block per run of kSeedRun entries, whose
//      answers lie in [lo, hi] = [coarse[b], coarse[b + 1]]: the block
//      gathers the keys of S = min(hi - lo, kSeedSamples) evenly spaced
//      slots of that range into shared memory, the last one hi - 1, all
//      loads in flight together; each thread bisects the samples for its
//      entries and finishes in global memory inside the gap between two
//      samples, log2((hi - lo) / S) steps (none where the range has at
//      most kSeedSamples slots: every key is staged).  Entries in one gap
//      walk the same slots, so their loads meet in L1.
// No pass gathers every slot's key: a row has about 8 slots an entry
// (ranked, 32^5 + 1 entries over 268 M slots), and such a pass would read
// 8 random keys for every entry written.  The samples cost two random
// loads each and the gaps' steps mostly hit L1, so few samples win: 64 a
// block measured faster than 128 to 1024 on that row.
// ---------------------------------------------------------------------------
constexpr int kSeedRun = 1024;     // entries a fine block
constexpr int kSeedSamples = 64;   // keys a fine block stages

__device__ __forceinline__ int seed_key(const int* __restrict__ packed,
                                        const int* __restrict__ sa,
                                        long long i, int shift) {
  return packed[sa[i]] >> shift;
}

// The first slot in [lo, hi) whose key is >= k, or hi.
__device__ __forceinline__ long long seed_bisect(
    const int* __restrict__ packed, const int* __restrict__ sa, long long lo,
    long long hi, long long k, int shift) {
  while (lo < hi) {
    const long long mid = lo + ((hi - lo) >> 1);
    if (seed_key(packed, sa, mid, shift) >= k) {
      hi = mid;
    } else {
      lo = mid + 1;
    }
  }
  return lo;
}

__global__ void seed_coarse_kernel(const int* __restrict__ packed,
                                   const int* __restrict__ sa, int n,
                                   int shift, long long runs,
                                   int* __restrict__ coarse) {
  for (long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       c <= runs; c += (long long)gridDim.x * blockDim.x) {
    coarse[c] = static_cast<int>(
        seed_bisect(packed, sa, 0, n, c * kSeedRun, shift));
  }
}

__global__ void __launch_bounds__(kThreads)
seed_fine_kernel(const int* __restrict__ packed, const int* __restrict__ sa,
                 int shift, long long size, const int* __restrict__ coarse,
                 int* __restrict__ table) {
  __shared__ int skey[kSeedSamples];
  const long long k0 = blockIdx.x * (long long)kSeedRun;
  const long long lo = coarse[blockIdx.x];
  const long long hi = coarse[blockIdx.x + 1];
  const long long R = hi - lo;
  const int S = R < kSeedSamples ? static_cast<int>(R) : kSeedSamples;
  // Sample j is slot lo + (j + 1) R / S - 1; the gap before it starts
  // after sample j - 1, at lo + j R / S.
  for (int j = threadIdx.x; j < S; j += kThreads) {
    skey[j] = seed_key(packed, sa, lo + ((j + 1) * R) / S - 1, shift);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kSeedRun; e += kThreads) {
    const long long k = k0 + e;
    if (k >= size) break;
    int a = 0, b = S;
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (skey[mid] >= k) {
        b = mid;
      } else {
        a = mid + 1;
      }
    }
    const long long ans =
        a == S ? hi
               : seed_bisect(packed, sa, lo + (a * R) / S,
                             lo + ((a + 1) * R) / S - 1, k, shift);
    table[k] = static_cast<int>(ans);
  }
}

// ---------------------------------------------------------------------------
// The wide byte compare of B15's probe and of B11's and K4's deep refines:
// the JAX _cmp3 (pysubstringsearch_tpu/ops/search.py) of one pattern against
// one suffix, 16 bytes at a time.  A byte ranks as its value + 1 and a text position at
// or past the row's n as 0, below every byte, so the first position where
// the suffix and the pattern differ decides, and a suffix that ends first
// ranks below.  The text comes in aligned 16-byte loads cut in registers:
// the chunk that holds the window's first byte, and the next one only when
// the bytes it adds are needed (no difference in the first chunk's part, and
// pattern and text go on past it); a chunk without a byte below n is never
// loaded, and a load never leaves the tensor (byte loads at its two ends).
// The first 32 pattern bytes sit in registers (Pattern), the rest is loaded
// like the text.  The first differing byte is the lowest set byte of the
// XOR (__ffs, word by word), so the compare costs a load instruction a 16
// bytes and no byte loop.  The caller passes m, a multiple of 16 that the
// suffix is known to share with the pattern (the classic bound of a
// bisection: every suffix between two boundaries shares at least the
// lesser of their common prefixes with the pattern), and gets back the
// first differing position.
// ---------------------------------------------------------------------------

// The bytes [lo, hi) of one tensor: the only ones a load may touch.
struct Span {
  const uint8_t* lo;
  const uint8_t* hi;
};

// The aligned 16 bytes at a, as four little-endian words; a byte outside
// the span reads 0.
__device__ __forceinline__ void chunk16(const uint8_t* a, const Span& s,
                                        uint32_t x[4]) {
  if (a >= s.lo && a + 16 <= s.hi) {
    const uint4 c = __ldg(reinterpret_cast<const uint4*>(a));
    x[0] = c.x;
    x[1] = c.y;
    x[2] = c.z;
    x[3] = c.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (a + j >= s.lo && a + j < s.hi)
      x[j >> 2] |= static_cast<uint32_t>(a[j]) << (8 * (j & 3));
}

// w = bytes o .. o + 15 of the 32 bytes x, y (o in [0, 16)): two word
// selects and a funnel shift, no indexing that would leave the registers.
__device__ __forceinline__ void funnel16(const uint32_t x[4],
                                         const uint32_t y[4], int o,
                                         uint32_t w[4]) {
  uint32_t v[6];
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    const uint32_t lo = k < 4 ? x[k] : y[k - 4];
    const uint32_t hi = k + 2 < 4 ? x[k + 2] : y[k - 2];
    v[k] = o & 8 ? hi : lo;
  }
#pragma unroll
  for (int k = 0; k < 5; ++k) v[k] = o & 4 ? v[k + 1] : v[k];
  const uint32_t sh = (o & 3) * 8;
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = __funnelshift_r(v[k], v[k + 1], sh);
}

// Bytes a .. a + 15 where only the first `want` matter (the others are
// unspecified): one aligned load, two where the window crosses a chunk.
__device__ __forceinline__ void window16(const uint8_t* a, int want,
                                         const Span& s, uint32_t w[4]) {
  const int o = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
  uint32_t x[4], y[4] = {0, 0, 0, 0};
  chunk16(a - o, s, x);
  if (o + want > 16) chunk16(a - o + 16, s, y);
  funnel16(x, y, o, w);
}

// The index of the first byte where w and p differ, 16 if none.
__device__ __forceinline__ int first_diff(const uint32_t w[4],
                                          const uint32_t p[4]) {
  int idx = 16;
#pragma unroll
  for (int k = 3; k >= 0; --k) {
    const uint32_t d = w[k] ^ p[k];
    if (d) idx = 4 * k + ((__ffs(static_cast<int>(d)) - 1) >> 3);
  }
  return idx;
}

__device__ __forceinline__ uint32_t byte_of16(const uint32_t w[4], int e) {
  const uint32_t word = e & 8 ? (e & 4 ? w[3] : w[2]) : (e & 4 ? w[1] : w[0]);
  return (word >> (8 * (e & 3))) & 0xffu;
}

// A pattern: its bytes, its length and its first 32 bytes in registers.
struct Pattern {
  const uint8_t* p;
  int len;
  uint32_t w[8];
};

__device__ __forceinline__ Pattern load_pattern(const uint8_t* p, int len,
                                                const Span& s) {
  Pattern pt;
  pt.p = p;
  pt.len = len;
#pragma unroll
  for (int k = 0; k < 8; ++k) pt.w[k] = 0;
  if (len > 0) window16(p, len < 16 ? len : 16, s, pt.w);
  if (len > 16) window16(p + 16, len < 32 ? len - 16 : 16, s, pt.w + 4);
  return pt;
}

// The compare of the pattern with the suffix at text position `start` of
// a row (its first byte `row`, n real bytes), from pattern byte m (a
// multiple of 16 below len, shared with the suffix).  *sign: -1 the suffix
// ranks below the pattern, 0 it starts with it, +1 above.  Returns the
// first position where the two differ (len if none).
__device__ int wide_cmp(const uint8_t* row, int n, int start,
                        const Pattern& pt, int m, const Span& ts,
                        const Span& ps, int* sign) {
  const uint8_t* a = row + start + m;
  const int o = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
  const uint8_t* base = a - o;
  int left = n - (start + m);  // text bytes from the window on
  uint32_t nx[4];              // the next chunk, when loaded
  bool have = false;
  while (true) {
    const int lim = pt.len - m < 16 ? pt.len - m : 16;
    const int tl = left <= 0 ? 0 : (left >= 16 ? 16 : left);
    const int need = lim < tl ? lim : tl;
    uint32_t p[4];
    if (m < 32) {
#pragma unroll
      for (int k = 0; k < 4; ++k) p[k] = m == 0 ? pt.w[k] : pt.w[k + 4];
    } else {
      window16(pt.p + m, lim, ps, p);
    }
    uint32_t x[4] = {0, 0, 0, 0}, y[4] = {0, 0, 0, 0}, w[4];
    if (have) {
#pragma unroll
      for (int k = 0; k < 4; ++k) x[k] = nx[k];
    } else if (need > 0) {
      chunk16(base, ts, x);
    }
    have = false;
    funnel16(x, y, o, w);
    int idx = first_diff(w, p);
    if (idx >= 16 - o && need > 16 - o) {
      chunk16(base + 16, ts, nx);
      have = true;
      funnel16(x, nx, o, w);
      idx = first_diff(w, p);
    }
    const int e = idx < tl ? idx : tl;
    if (e < lim) {
      *sign = e >= tl || byte_of16(w, e) < byte_of16(p, e) ? -1 : 1;
      return m + e;
    }
    if (pt.len - m <= 16) {
      *sign = 0;
      return pt.len;
    }
    m += 16;
    base += 16;
    left -= 16;
  }
}

// ---------------------------------------------------------------------------
// B11, the digit-kind probe.  Replaces probe_bounds_limbs_loop with
// _pattern_limb_targets, _limb_cmp3 and its deep _cmp3 loop, reached through
// limbs_loop_batch_jit (pysubstringsearch_tpu/ops/search.py).
//
// The digit kind keys suffixes on base-258 digits (byte + 1, 0 past the
// end): the bucket table indexes the first `depth` (2 or 3) digits, and
// limb j holds digits 2 + 3j .. 4 + 3j whatever the depth, so at depth 3
// limb 0 overlaps the bucket's third digit.  The two bounds of the JAX
// duplex:
//   - the lower bound pads past the pattern with digit 0, the upper bound
//     with 257 (above every real digit), in the bucket id and the limb
//     targets alike, so a pattern shorter than the depth lands on the empty
//     pad buckets beside its prefix and the empty pattern spans [0, n);
//   - each seeds [table[bucket], table[bucket + 1]) and searches for the
//     first slot whose first k limbs compare >= its target (the upper: >),
//     k = ceil((len - 2) / 3) clamped to [1, num_limbs].  The JAX program
//     compares k_used limbs from the batch width instead; the limbs past a
//     pattern's own k hold pad targets (all 0, or all 257), on which both
//     comparisons agree slot for slot, so (lower, count) is the same;
//   - a pattern longer than cover = 2 + 3 * num_limbs searches [lower,
//     upper) again with the wide byte compare, from byte cover & ~15 on:
//     every suffix of that range shares the first cover digits with it.
// The parent, one thread a (row, pattern), ran each bound's bisection as
// about 15 steps of dependent limb loads (each limb after the last, the
// targets in a 64-byte stack frame), then the deep refine with K4's byte
// loop: 338-342 us on the line batch (2 rows x 10,709) and 86-89 us on the
// count batch (2 x 10,000) with only 21.4k threads on the card
// (sa_bench.py --probes on an H100).  Here a (row, pattern) owns
// 2 * kLimbLanes lanes, kLimbLanes a bound, each group running a
// (kLimbLanes + 1)-ary search: every round each lane reads its probe
// slot's first kEagerLimbs limbs together and the rest only where those
// tie with the target, a ballot counts the probes below the target, and
// the range shrinks to the gap between two probes.  The deep refine runs
// the same search with the wide compare, each round starting at the lesser
// common prefix of its two boundary probes (shuffled from the lanes that
// read them).  Wider groups cut the rounds but not the time: 8 lanes a
// bound with every limb read at once took 108-110 us on the line batch
// and 62 us on the count batch, 4 lanes 85 and 53, 2 lanes 77-81 and
// 41-44, one lane 121-129 and 62-70 (the same variants); the limb planes
// are read at random, so the search pays for the loads it adds.  The
// slots are monotone in the SA order, so any search finds the JAX
// program's first slot.  Plane offsets are 64-bit (2 x 5 x 272 Mi limbs
// pass 2^31).
// ---------------------------------------------------------------------------
constexpr int kProbeThreads = 128;
constexpr int kLimbLanes = 2;  // lanes of one bound
constexpr unsigned kLimbLaneMask = (1u << kLimbLanes) - 1;
constexpr int kLimbPatterns = kProbeThreads / (2 * kLimbLanes);
// Limbs a probe reads before its first comparison; the others one at a
// time, where the limbs before them tie with the target.
constexpr int kEagerLimbs = 2;

__device__ __forceinline__ int digit_of(const uint8_t* p, int len, int q,
                                        int pad) {
  return q < len ? p[q] + 1 : pad;
}

// One round's probes over [lo, hi): lane i of the group reads slot
// lo + (R (i + 1)) / (kLimbLanes + 1) (R = hi - lo > kLimbLanes), or
// lo + i in the last round; a lane past hi answers true.  The first slot
// where `pred` holds is then lo + f, or in the gap after the f-th probe,
// f the probes that answer false (the first f, since pred is monotone).
__device__ __forceinline__ long long probe_slot(long long lo, long long hi,
                                                int i) {
  const long long R = hi - lo;
  return R <= kLimbLanes ? lo + i : lo + (R * (i + 1)) / (kLimbLanes + 1);
}

// Advances [lo, hi) by a round whose ballot (one bit a lane of the
// group) says which probes held; returns true when the answer (lo) is
// final.
__device__ __forceinline__ bool probe_round(long long& lo, long long& hi,
                                            unsigned held, int* f_out) {
  const long long R = hi - lo;
  const int f = __popc(~held & kLimbLaneMask);
  *f_out = f;
  if (R <= kLimbLanes) {
    lo += f;
    return true;
  }
  const long long nlo = f == 0 ? lo : lo + (R * f) / (kLimbLanes + 1) + 1;
  hi = f == kLimbLanes ? hi : lo + (R * (f + 1)) / (kLimbLanes + 1);
  lo = nlo;
  return lo >= hi;
}

__global__ void __launch_bounds__(kProbeThreads)
probe_limbs_kernel(const uint8_t* __restrict__ text,
                   const int* __restrict__ n_rows, const int* __restrict__ sa,
                   const int* __restrict__ tables,
                   const int* __restrict__ limbs,
                   const uint8_t* __restrict__ patterns,
                   const int* __restrict__ lengths, int B, int L,
                   long long n_pad, long long table_len, int depth,
                   int num_limbs, int* __restrict__ lower_out,
                   int* __restrict__ count_out) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLimbPatterns + threadIdx.x / (2 * kLimbLanes);
  if (b >= B) return;  // a pattern's lanes leave together
  const int upper = (lane / kLimbLanes) & 1;  // 0: the lower bound, 1: upper
  const int i = lane % kLimbLanes;
  const int first = lane & ~(kLimbLanes - 1);  // this bound's first lane
  const unsigned mine = kLimbLaneMask << first;
  const unsigned both = static_cast<unsigned>(  // the pattern's lanes
      ((1ull << (2 * kLimbLanes)) - 1) << (lane & ~(2 * kLimbLanes - 1)));
  const long long r = blockIdx.y;
  const int n = n_rows[r];
  const int* table = tables + r * table_len;
  const int* row_limbs = limbs + r * static_cast<long long>(num_limbs) * n_pad;
  const uint8_t* pat = patterns + static_cast<long long>(b) * L;
  const int len = lengths[b];
  const int pad = upper ? kDigitBase - 1 : 0;

  long long bucket = 0;
  for (int q = 0; q < depth; ++q)
    bucket = bucket * kDigitBase + digit_of(pat, len, q, pad);
  int k = len / kDigitLimbStride;  // ceil((len - 2) / 3) for len >= 2
  k = k < 1 ? 1 : (k > num_limbs ? num_limbs : k);
  int t[kMaxLimbs];
#pragma unroll
  for (int j = 0; j < kMaxLimbs; ++j) {
    int v = 0;
#pragma unroll
    for (int d = 0; d < kDigitLimbStride; ++d)
      v = v * kDigitBase +
          digit_of(pat, len, kDigitLimbOffset + kDigitLimbStride * j + d, pad);
    t[j] = j < k ? v : 0;
  }

  long long lo = table[bucket], hi = table[bucket + 1];
  while (true) {
    const long long s = probe_slot(lo, hi, i);
    bool held = true;
    if (s < hi) {
      int v[kEagerLimbs];
#pragma unroll
      for (int j = 0; j < kEagerLimbs; ++j)
        v[j] = j < k ? __ldg(row_limbs + static_cast<long long>(j) * n_pad + s)
                     : 0;
      int c = 0;
#pragma unroll
      for (int j = 0; j < kMaxLimbs; ++j) {
        if (c == 0 && j < k) {
          const int x = j < kEagerLimbs
              ? v[j < kEagerLimbs ? j : 0]
              : __ldg(row_limbs + static_cast<long long>(j) * n_pad + s);
          if (x != t[j]) c = x < t[j] ? -1 : 1;
        }
      }
      held = c >= upper;
    }
    const unsigned bits = __ballot_sync(mine, held) >> first;
    int f;
    if (probe_round(lo, hi, bits, &f)) break;
  }
  long long A = __shfl_sync(both, lo, 0, 2 * kLimbLanes);
  long long Z = __shfl_sync(both, lo, kLimbLanes, 2 * kLimbLanes);

  const int cover = kDigitLimbOffset + kDigitLimbStride * num_limbs;
  if (len > cover && A < Z) {
    const Span ts{text, text + static_cast<long long>(gridDim.y) * n_pad};
    const Span ps{patterns, patterns + static_cast<long long>(B) * L};
    const uint8_t* row_text = text + r * n_pad;
    const int* row_sa = sa + r * n_pad;
    const Pattern pt = load_pattern(pat, len, ps);
    lo = A;
    hi = Z;
    int llcp = cover, rlcp = cover;
    while (true) {
      const long long s = probe_slot(lo, hi, i);
      bool held = true;
      int l = len;
      if (s < hi) {
        int sign;
        const int m = (llcp < rlcp ? llcp : rlcp) & ~15;
        l = wide_cmp(row_text, n, __ldg(row_sa + s), pt, m, ts, ps, &sign);
        held = sign >= upper;
      }
      const unsigned bits = __ballot_sync(mine, held) >> first;
      int f;
      if (probe_round(lo, hi, bits, &f)) break;
      // The new boundaries are probes f - 1 and f: their common prefixes.
      const int lf = __shfl_sync(mine, l, f > 0 ? f - 1 : 0, kLimbLanes);
      const int rf = __shfl_sync(mine, l, f < kLimbLanes ? f : 0, kLimbLanes);
      if (f > 0) llcp = lf;
      if (f < kLimbLanes) rlcp = rf;
    }
    A = __shfl_sync(both, lo, 0, 2 * kLimbLanes);
    Z = __shfl_sync(both, lo, kLimbLanes, 2 * kLimbLanes);
  }
  if (i == 0 && upper == 0) {
    lower_out[r * B + b] = static_cast<int>(A);
    count_out[r * B + b] = static_cast<int>(Z - A);
  }
}

// ---------------------------------------------------------------------------
// K4, phased probe.  Replaces probe_bounds_phased (ops/search.py), reached
// via phased_batch_jit / phased_class_exec, with its seeding (_duplex,
// _pattern_buckets_ranked, _ranked_targets, _raw_targets, _tiny_map) and its
// deep text-window refinement (_cmp3, _gather_suffix_windows) folded in.
//
// The JAX program, for the ranked and raw kinds:
//   1. seeds [lo, hi) from the table: the lower bound's bucket pads past the
//      pattern with digit 0, the upper bound's with base-1; an alphabet-
//      absent byte within the seed depth collapses both ids; a pattern of
//      exactly `depth` bytes takes the next bucket as its upper bound;
//   2. bisects limb plane by limb plane: A = first slot with limb >= the
//      lower target, Z = first slot with limb > the upper target, then
//      descends into [A, Z) for the next limb while it is non-empty, k
//      phases for a pattern with k limbs past the depth;
//   3. for a pattern longer than the cover (depth + D * num_limbs bytes),
//      bisects [A, Z) again with a byte compare of the whole pattern
//      against each suffix (a text position at or past n reads as digit 0).
// bits == 0 selects the raw 4-byte limb encoding (top byte biased by -128),
// otherwise rank digits at `bits` bits.  A ranked pattern with an absent
// byte inside the cover gets count 0.  The empty pattern counts n.
//
// Two kernels, chosen by the batch's (row, pattern) pairs.  Up to
// kPhasedPairsWide pairs (the derive rows' 2 x 10k) a thread a pair leaves
// most of the card idle, and the parent, one thread each with both bounds'
// bisections in turn and a byte loop from byte 0 for the deep refine, spent
// five sixths of its 77-78 us on the 2 x 197 patterns past the cover.
// probe_phased_kernel gives a pair 2 * kLimbLanes lanes, B11's groups:
// kLimbLanes a bound, both bounds at once.  Step 2 is one (kLimbLanes + 1)-
// ary search a bound over the seed bucket [table[b], table[b + 1]) for the
// first slot whose first k limbs compare lexicographically >= the bound's
// targets (the upper: >), kEagerLimbs limbs read at once and the rest
// where those tie.  It lands on the phases' slots: limbs before the last
// lie inside the pattern, so their two targets agree and each phase's
// [A, Z) is the slots equal to the pattern so far, and a phase that ends
// with A = Z ends where the lexicographic search ends, at the first slot
// past the prefix.  Step 3 is B11's deep refine, each round from the
// lesser common prefix of its two boundary probes, on a compare that
// reads the text 64 bytes at a time (wide_cmp64).  The first round starts
// at byte cover & ~15 where every suffix of [A, Z) shares the cover bytes
// with the pattern: a limb tie is a byte tie only for a pattern whose
// cover bytes are all in the row's alphabet (an absent byte borrows the
// next present byte's rank, so its digits tie with that byte's) and, for
// raw limbs, are not NUL (a raw limb packs NUL like a position past n).
// Any other pattern compares from byte 0, as the JAX program does.
//
// Past kPhasedPairsWide pairs (the upload geometry's 63 x 2k or 63 x 10k)
// the card is full, and the limb search is bound by its random reads,
// which lanes add: a 3-ary round reads two slots where a bisection step
// reads one.  probe_phased_wide_kernel keeps a thread a pair and runs both
// bounds in one bisection loop: one read serves both while their ranges
// agree, and the two reads are in flight together once they split; its
// deep refine bisects with wide_cmp from the same start.  The rank and
// present maps sit in shared memory in both.  Row, plane and text offsets
// are 64-bit (the ranked derive's 2 x 3 x 272 Mi limbs pass 2^31).
// ---------------------------------------------------------------------------

// K4's deep compare: wide_cmp's contract, with the text read 64 bytes at a
// time: the up to five aligned chunks that hold the next 64 bytes are loaded
// together, so a match of l bytes waits on about l / 64 dependent loads.
__device__ int wide_cmp64(const uint8_t* row, int n, int start,
                          const Pattern& pt, int m, const Span& ts,
                          const Span& ps, int* sign) {
  const uint8_t* a = row + start + m;
  const int o = static_cast<int>(reinterpret_cast<uintptr_t>(a) & 15);
  const uint8_t* base = a - o;
  int left = n - (start + m);  // text bytes from the window on
  while (true) {
    const int want = pt.len - m < 64 ? pt.len - m : 64;
    const int have = left <= 0 ? 0 : (left >= 64 ? 64 : left);
    const int need = want < have ? want : have;
    uint32_t x[5][4];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      if (16 * c < o + need) {
        chunk16(base + 16 * c, ts, x[c]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) x[c][e] = 0;
      }
    }
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const int mg = m + 16 * g;
      const int lim = pt.len - mg < 16 ? pt.len - mg : 16;
      const int lg = left - 16 * g;
      const int tl = lg <= 0 ? 0 : (lg >= 16 ? 16 : lg);
      uint32_t p[4];
      if (mg < 32) {
#pragma unroll
        for (int e = 0; e < 4; ++e) p[e] = mg == 0 ? pt.w[e] : pt.w[e + 4];
      } else {
        window16(pt.p + mg, lim, ps, p);
      }
      uint32_t w[4];
      funnel16(x[g], x[g + 1], o, w);
      const int idx = first_diff(w, p);
      const int e = idx < tl ? idx : tl;
      if (e < lim) {
        *sign = e >= tl || byte_of16(w, e) < byte_of16(p, e) ? -1 : 1;
        return mg + e;
      }
      if (pt.len - mg <= 16) {
        *sign = 0;
        return pt.len;
      }
    }
    m += 64;
    base += 64;
    left -= 64;
  }
}

// Byte q of a pattern row of L bytes; 0 past L.
__device__ __forceinline__ int pattern_byte(const uint8_t* pat, int L,
                                            int q) {
  return q < L ? pat[q] : 0;
}

// The target of limb j for one bound: the pattern's bytes depth + D j ..
// depth + D j + D - 1 packed as the limb planes pack the text (raw: 4
// bytes, the first biased by -128; ranked: D rank digits of `bits` bits),
// each byte past the pattern as the bound's pad.
__device__ __forceinline__ int phased_target(const uint8_t* pat, int L,
                                             int len, const int* srank,
                                             int depth, int bits, int D,
                                             int j, bool upper) {
  const int q0 = depth + D * j;
  int v = 0;
  if (bits == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q0 + e;
      int c = q < len ? pattern_byte(pat, L, q) : (upper ? 255 : 0);
      if (e == 0) c -= 128;
      v = v * 256 + c;
    }
    return v;
  }
  for (int e = 0; e < D; ++e) {
    const int q = q0 + e;
    const int digit = q < len ? srank[pattern_byte(pat, L, q)]
                              : (upper ? (1 << bits) - 1 : 0);
    v = (v << bits) + digit;
  }
  return v;
}

// The seed buckets of both bounds: the lower bound's id pads past the
// pattern with digit 0, the upper bound's with base - 1; an absent byte
// within the depth collapses both ids (digit 0 after it); a pattern of
// exactly `depth` present bytes takes the next bucket as its upper bound.
struct Seed {
  long long lo, up;
};

__device__ __forceinline__ Seed phased_seed(const uint8_t* pat, int L,
                                            int len, const int* srank,
                                            const int* spres, int depth,
                                            int base) {
  int first_bad = depth;
  for (int q = 0; q < depth && q < len; ++q) {
    if (!spres[pattern_byte(pat, L, q)]) {
      first_bad = q;
      break;
    }
  }
  Seed seed{0, 0};
  for (int q = 0; q < depth; ++q) {
    const int rq = srank[pattern_byte(pat, L, q)];
    int dl = q < len ? rq : 0;
    int du = q < len ? rq : base - 1;
    if (q == first_bad) dl = du = rq;
    if (q > first_bad) dl = du = 0;
    seed.lo = seed.lo * base + dl;
    seed.up = seed.up * base + du;
  }
  if (len == depth && first_bad >= len) seed.up += 1;
  return seed;
}

// Whether a limb tie over the cover is a byte tie: every cover byte of the
// pattern is in the row's alphabet and, for raw limbs, not NUL.
__device__ __forceinline__ bool cover_ties(const uint8_t* pat, int L,
                                           int cover, const int* spres,
                                           int bits) {
  for (int q = 0; q < cover; ++q) {
    const int c = pattern_byte(pat, L, q);
    if (!spres[c] || (bits == 0 && c == 0)) return false;
  }
  return true;
}

// A ranked pattern with a byte inside the cover that the alphabet lacks:
// its count is 0.
__device__ __forceinline__ bool absent_in_cover(const uint8_t* pat, int L,
                                                int len, int cover,
                                                const int* spres, int bits) {
  if (bits == 0) return false;
  for (int q = 0; q < len && q < cover; ++q)
    if (!spres[pattern_byte(pat, L, q)]) return true;
  return false;
}

__global__ void __launch_bounds__(kProbeThreads)
probe_phased_kernel(const uint8_t* __restrict__ text,
                    const int* __restrict__ n_rows,
                    const int* __restrict__ sa,
                    const int* __restrict__ tables,
                    const int* __restrict__ limbs,
                    const int* __restrict__ rank,
                    const int* __restrict__ present,
                    const uint8_t* __restrict__ patterns,
                    const int* __restrict__ lengths, int B, int L,
                    long long n_pad, long long table_len, int num_limbs,
                    int depth, int base, int bits,
                    int* __restrict__ lower_out, int* __restrict__ count_out) {
  __shared__ int srank[256];
  __shared__ int spres[256];
  for (int e = threadIdx.x; e < 256; e += blockDim.x) {
    srank[e] = rank[e];
    spres[e] = present[e];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * kLimbPatterns + threadIdx.x / (2 * kLimbLanes);
  if (b >= B) return;  // a pattern's lanes leave together
  const int upper = (lane / kLimbLanes) & 1;  // 0: the lower bound, 1: upper
  const int i = lane % kLimbLanes;
  const int first = lane & ~(kLimbLanes - 1);  // this bound's first lane
  const unsigned mine = kLimbLaneMask << first;
  const unsigned both = static_cast<unsigned>(  // the pattern's lanes
      ((1ull << (2 * kLimbLanes)) - 1) << (lane & ~(2 * kLimbLanes - 1)));
  const long long r = blockIdx.y;
  const int n = n_rows[r];
  const int* table = tables + r * table_len;
  const int* row_limbs = limbs + r * static_cast<long long>(num_limbs) * n_pad;
  const uint8_t* pat = patterns + static_cast<long long>(b) * L;
  const int len = lengths[b];

  const Seed seed = phased_seed(pat, L, len, srank, spres, depth, base);
  const int D = bits == 0 ? 4 : 30 / bits;
  const int cover = depth + D * num_limbs;
  int k = len <= depth ? 0 : (len - depth + D - 1) / D;
  k = k > num_limbs ? num_limbs : k;

  // 2. The limb phases as one lexicographic search a bound; a pattern
  // within the depth takes its bound from the table.
  long long lo;
  if (k == 0) {
    lo = table[upper ? seed.up : seed.lo];
  } else {
    int t[kMaxLimbs];
#pragma unroll
    for (int j = 0; j < kMaxLimbs; ++j)
      t[j] = j < k ? phased_target(pat, L, len, srank, depth, bits, D, j,
                                   upper)
                   : 0;
    lo = table[seed.lo];
    long long hi = table[seed.lo + 1];
    while (true) {
      const long long s = probe_slot(lo, hi, i);
      bool held = true;
      if (s < hi) {
        int v[kEagerLimbs];
#pragma unroll
        for (int j = 0; j < kEagerLimbs; ++j)
          v[j] = j < k
              ? __ldg(row_limbs + static_cast<long long>(j) * n_pad + s) : 0;
        int c = 0;
#pragma unroll
        for (int j = 0; j < kMaxLimbs; ++j) {
          if (c == 0 && j < k) {
            const int x = j < kEagerLimbs
                ? v[j < kEagerLimbs ? j : 0]
                : __ldg(row_limbs + static_cast<long long>(j) * n_pad + s);
            if (x != t[j]) c = x < t[j] ? -1 : 1;
          }
        }
        held = c >= upper;
      }
      const unsigned ballot = __ballot_sync(mine, held) >> first;
      int f;
      if (probe_round(lo, hi, ballot, &f)) break;
    }
  }
  long long A = __shfl_sync(both, lo, 0, 2 * kLimbLanes);
  long long Z = __shfl_sync(both, lo, kLimbLanes, 2 * kLimbLanes);

  // 3. The deep refine past the cover.
  if (len > cover && A < Z) {
    const Span ts{text, text + static_cast<long long>(gridDim.y) * n_pad};
    const Span ps{patterns, patterns + static_cast<long long>(B) * L};
    const uint8_t* row_text = text + r * n_pad;
    const int* row_sa = sa + r * n_pad;
    const Pattern pt = load_pattern(pat, len, ps);
    lo = A;
    long long hi = Z;
    int llcp = cover_ties(pat, L, cover, spres, bits) ? cover : 0;
    int rlcp = llcp;
    while (true) {
      const long long s = probe_slot(lo, hi, i);
      bool held = true;
      int l = len;
      if (s < hi) {
        int sign;
        const int m = (llcp < rlcp ? llcp : rlcp) & ~15;
        l = wide_cmp64(row_text, n, __ldg(row_sa + s), pt, m, ts, ps, &sign);
        held = sign >= upper;
      }
      const unsigned ballot = __ballot_sync(mine, held) >> first;
      int f;
      if (probe_round(lo, hi, ballot, &f)) break;
      // The new boundaries are probes f - 1 and f: their common prefixes.
      const int lf = __shfl_sync(mine, l, f > 0 ? f - 1 : 0, kLimbLanes);
      const int rf = __shfl_sync(mine, l, f < kLimbLanes ? f : 0, kLimbLanes);
      if (f > 0) llcp = lf;
      if (f < kLimbLanes) rlcp = rf;
    }
    A = __shfl_sync(both, lo, 0, 2 * kLimbLanes);
    Z = __shfl_sync(both, lo, kLimbLanes, 2 * kLimbLanes);
  }

  if (i == 0 && upper == 0) {
    lower_out[r * B + b] = static_cast<int>(A);
    count_out[r * B + b] =
        absent_in_cover(pat, L, len, cover, spres, bits) ? 0 : Z - A;
  }
}

// The lexicographic compare of the first k limbs of slot s with targets t
// (t[j * kThreads], in shared memory): limb 0 given, the others loaded
// while the ones before them tie.  -1 below, 0 equal, +1 above.
__device__ __forceinline__ int limbs_cmp(const int* __restrict__ row_limbs,
                                         long long n_pad, int s, int k,
                                         int x0, const int* t) {
  int c = x0 == t[0] ? 0 : (x0 < t[0] ? -1 : 1);
  for (int j = 1; c == 0 && j < k; ++j) {
    const int x = __ldg(row_limbs + static_cast<long long>(j) * n_pad + s);
    const int tj = t[j * kThreads];
    if (x != tj) c = x < tj ? -1 : 1;
  }
  return c;
}

// The first slot in [lo, hi) whose suffix compares >= the pattern (upper:
// >) by the wide compare from the prefix its two boundaries share.
__device__ __forceinline__ int deep_bisect(const uint8_t* row_text,
                                           const int* __restrict__ row_sa,
                                           int n, int lo, int hi, int m0,
                                           const Pattern& pt, const Span& ts,
                                           const Span& ps, int upper) {
  int llcp = m0, rlcp = m0;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    int sign;
    const int m = (llcp < rlcp ? llcp : rlcp) & ~15;
    const int l = wide_cmp(row_text, n, __ldg(row_sa + mid), pt, m, ts, ps,
                           &sign);
    if (sign >= upper) {
      hi = mid;
      rlcp = l;
    } else {
      lo = mid + 1;
      llcp = l;
    }
  }
  return lo;
}

// K4 where the batch already fills the card: one thread a (row, pattern),
// both bounds in one bisection loop.  While the two searches' ranges agree
// a step reads one slot's limbs for both targets; once they split, each
// reads its own slot, the two loads in flight together.  The targets wait
// in shared memory.
__global__ void __launch_bounds__(kThreads, 4)
probe_phased_wide_kernel(const uint8_t* __restrict__ text,
                         const int* __restrict__ n_rows,
                         const int* __restrict__ sa,
                         const int* __restrict__ tables,
                         const int* __restrict__ limbs,
                         const int* __restrict__ rank,
                         const int* __restrict__ present,
                         const uint8_t* __restrict__ patterns,
                         const int* __restrict__ lengths, int B, int L,
                         long long n_pad, long long table_len, int num_limbs,
                         int depth, int base, int bits,
                         int* __restrict__ lower_out,
                         int* __restrict__ count_out) {
  __shared__ int srank[256];
  __shared__ int spres[256];
  __shared__ int stgt[2 * kMaxLimbs * kThreads];
  for (int e = threadIdx.x; e < 256; e += blockDim.x) {
    srank[e] = rank[e];
    spres[e] = present[e];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long r = blockIdx.y;
  const int n = n_rows[r];
  const int* table = tables + r * table_len;
  const int* row_limbs = limbs + r * static_cast<long long>(num_limbs) * n_pad;
  const uint8_t* pat = patterns + static_cast<long long>(b) * L;
  const int len = lengths[b];

  const Seed seed = phased_seed(pat, L, len, srank, spres, depth, base);
  const int D = bits == 0 ? 4 : 30 / bits;
  const int cover = depth + D * num_limbs;
  int k = len <= depth ? 0 : (len - depth + D - 1) / D;
  k = k > num_limbs ? num_limbs : k;

  // 2. The limb phases as one lexicographic search a bound.
  int A, Z;
  if (k == 0) {
    A = table[seed.lo];
    Z = table[seed.up];
  } else {
    int* tl = stgt + threadIdx.x;
    int* tu = tl + kMaxLimbs * kThreads;
    for (int j = 0; j < k; ++j) {
      tl[j * kThreads] =
          phased_target(pat, L, len, srank, depth, bits, D, j, false);
      tu[j * kThreads] =
          phased_target(pat, L, len, srank, depth, bits, D, j, true);
    }
    int la = table[seed.lo], ha = table[seed.lo + 1];
    int lz = la, hz = ha;
    while (la < ha && la == lz && ha == hz) {  // the shared steps
      const int mid = la + ((ha - la) >> 1);
      const int x0 = __ldg(row_limbs + mid);
      if (limbs_cmp(row_limbs, n_pad, mid, k, x0, tl) >= 0) ha = mid;
      else la = mid + 1;
      if (limbs_cmp(row_limbs, n_pad, mid, k, x0, tu) > 0) hz = mid;
      else lz = mid + 1;
    }
    while (la < ha || lz < hz) {  // apart, both loads in flight
      const int ma = la + ((ha - la) >> 1);
      const int mz = lz + ((hz - lz) >> 1);
      const int xa = la < ha ? __ldg(row_limbs + ma) : 0;
      const int xz = lz < hz ? __ldg(row_limbs + mz) : 0;
      if (la < ha) {
        if (limbs_cmp(row_limbs, n_pad, ma, k, xa, tl) >= 0) ha = ma;
        else la = ma + 1;
      }
      if (lz < hz) {
        if (limbs_cmp(row_limbs, n_pad, mz, k, xz, tu) > 0) hz = mz;
        else lz = mz + 1;
      }
    }
    A = la;
    Z = lz;
  }

  // 3. The deep refine past the cover.
  if (len > cover && A < Z) {
    const Span ts{text, text + static_cast<long long>(gridDim.y) * n_pad};
    const Span ps{patterns, patterns + static_cast<long long>(B) * L};
    const uint8_t* row_text = text + r * n_pad;
    const int* row_sa = sa + r * n_pad;
    const Pattern pt = load_pattern(pat, len, ps);
    const int m0 = cover_ties(pat, L, cover, spres, bits) ? cover : 0;
    const int a = deep_bisect(row_text, row_sa, n, A, Z, m0, pt, ts, ps, 0);
    Z = deep_bisect(row_text, row_sa, n, a, Z, m0, pt, ts, ps, 1);
    A = a;
  }

  lower_out[r * B + b] = A;
  count_out[r * B + b] =
      absent_in_cover(pat, L, len, cover, spres, bits) ? 0 : Z - A;
}

// Batches of more (row, pattern) pairs than this take a thread a pair
// (probe_phased_wide_kernel): about two waves of probe_phased_kernel on an
// H100 (7 blocks of 32 pairs an SM at 72 registers), past which its lanes
// only add limb reads.
constexpr long long kPhasedPairsWide = 1 << 16;

// ---------------------------------------------------------------------------
// B8, flat hit gather.  Replaces _gather_flat_jit / gather_hits_flat
// (pysubstringsearch_tpu/ops/search.py), which pads its output to a
// power-of-two bucket and finds every output slot's query with a
// searchsorted over the count prefix sums.
//
// pos[offsets[q] + t] = sa[lower[q] + t] and qid[offsets[q] + t] = q for
// t < count[q], where offsets int32 [B + 1] is the exclusive scan of count
// (pss_scan_exclusive_sum) and total = offsets[B].  Parallel over output
// slots, as the JAX gather is, so the time follows the hit total and not
// the largest range: a block owns kGatherTile consecutive slots, bisects
// offsets once for the query of its first slot and once for its last, and
// each thread finds its slots' query inside that range (the last q with
// offsets[q] <= o, which skips the zero-count queries that share an offset
// with the next one), starting from its previous slot's query and first
// trying the next one.  Stores are coalesced across threads, and so are the
// sa reads within a query's run.  Bound by memory: 4 bytes read and 8
// written a hit, and the offsets and lower bounds a query.
// ---------------------------------------------------------------------------
constexpr int kGatherItems = 16;
constexpr int kGatherTile = kThreads * kGatherItems;

// The last q in [lo, hi] with offsets[q] <= o, given offsets[lo] <= o.
__device__ __forceinline__ int owner(const int* __restrict__ offsets, int lo,
                                     int hi, long long o) {
  if (lo == hi || offsets[lo + 1] > o) return lo;
  lo += 1;
  while (lo < hi) {
    const int mid = lo + ((hi - lo + 1) >> 1);
    if (offsets[mid] <= o) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__global__ void gather_hits_flat_kernel(const int* __restrict__ sa,
                                        const int* __restrict__ lower,
                                        const int* __restrict__ offsets,
                                        int B, long long total,
                                        int* __restrict__ pos,
                                        int* __restrict__ qid) {
  __shared__ int s_q[2];
  const long long tile = static_cast<long long>(blockIdx.x) * kGatherTile;
  if (threadIdx.x < 2) {
    const long long last = tile + kGatherTile < total ? tile + kGatherTile
                                                      : total;
    s_q[threadIdx.x] =
        owner(offsets, 0, B - 1, threadIdx.x == 0 ? tile : last - 1);
  }
  __syncthreads();
  int q = s_q[0];
  const int q_last = s_q[1];
  for (int r = 0; r < kGatherItems; ++r) {
    const long long o = tile + r * kThreads + threadIdx.x;
    if (o >= total) break;
    q = owner(offsets, q, q_last, o);
    pos[o] = sa[lower[q] + (o - offsets[q])];
    qid[o] = q;
  }
}

// ---------------------------------------------------------------------------
// B15, the byte-window bisection probe.  Replaces probe_bounds (unrolled)
// and probe_bounds_loop (while_loop) with _duplex, _bisect_first_geq and
// _cmp3 (pysubstringsearch_tpu/ops/search.py), vmapped over the rows by
// parallel/sharded.py's _probe_chunks.  The two JAX forms compute the same
// bounds, so this one kernel serves both names.
//
// No seed table and no limbs: the rows are bare (text, SA) pairs, as the
// chunk-parallel build leaves them.  lower = first slot in [0, n) whose
// suffix compares >= 0 with the pattern (a suffix that starts with it
// compares 0), upper = first slot that compares >= 1; count = upper -
// lower.  A byte at or past the row's own n ranks 0, below every real byte
// (b + 1), so no byte past n is compared; the empty pattern counts n, an
// empty row 0.  A length past L compares L bytes, as the JAX mask does.
// Row offsets are 64-bit.
//
// One thread a (row, pattern): 63 x 10.2k of them on the scale-out rows.
// The parent ran the duplex's two bisections one after the other (about
// 2 x 23 steps at n = 8 Mi), each step a dependent SA load and then K4's
// byte loop, a text and a pattern byte load for every byte compared: 233 M
// load instructions over the batch, every one divergent across the warp,
// in 1801-1837 us (sa_bench.py --probe-bounds counts the loads on the
// recorded steps, --probes times the kernel; an H100).  The same steps
// with one aligned 16-byte text load where the byte loop read byte by byte
// issue 64 M.  Here:
//   - the wide compare (above), the pattern's first 32 bytes in registers;
//   - one loop for both bounds: they bisect [0, n) together until a slot
//     starts with the pattern (a pattern that never occurs, all the way),
//     then the lower bound finishes [lo, mid) and the upper [mid + 1, hi)
//     in the same loop, so the lanes of a warp stay on one code path;
//   - each step's compare starts at the lesser common prefix of its
//     range's two boundaries (rounded down to 16), which the deep patterns
//     (23-200 bytes) need once the range holds their matches;
//   - the block's row's top kStageLevels levels of the bisection tree
//     (255 nodes: SA entry and first 16 text bytes) are staged in shared
//     memory by the block's threads together, so a thread's first 8 steps
//     read no global memory unless its pattern and the node's suffix share
//     16 bytes.
// What held the first version with the same loads at 992 us was the
// instruction stream, not the loads: the compare in 64-bit shifts and the
// two bounds' searches in two loops that split a warp's lanes; a 32-bit
// compare in one loop took it to 497 us, the staged levels to 482-484
// (sa_bench.py --probes variants on an H100, at 72 registers, 28 warps an
// SM).  Loading the next step's two candidate SA entries ahead (more loads
// in flight) lost 8%; a 64-register cap spilled and lost 17%; staging 10
// or 11 levels, or blocks of 256, lost 4-13%.  The slots are monotone in
// the SA order, so the first slot found is the JAX bisection's.
// ---------------------------------------------------------------------------
// Levels of a row's bisection tree that a block stages in shared memory:
// nodes 1 .. kStageNodes - 1, node 1 the range [0, n), node 2i + 1 the
// upper half of node i, 2i the lower.
constexpr int kStageLevels = 8;
constexpr int kStageNodes = 1 << kStageLevels;
constexpr int kBytesThreads = 128;

__global__ void __launch_bounds__(kBytesThreads)
probe_bytes_kernel(const uint8_t* __restrict__ text,
                   const int* __restrict__ n_rows, const int* __restrict__ sa,
                   const uint8_t* __restrict__ patterns,
                   const int* __restrict__ lengths, int B, int L,
                   long long n_pad, int* __restrict__ lower_out,
                   int* __restrict__ count_out) {
  // Node i's suffix: its first 16 bytes, its SA entry, its bytes below n.
  __shared__ uint4 s_win[kStageNodes];
  __shared__ int s_sa[kStageNodes];
  __shared__ int s_tl[kStageNodes];
  const long long r = blockIdx.y;
  const int n = n_rows[r];
  const Span ts{text, text + static_cast<long long>(gridDim.y) * n_pad};
  const uint8_t* row_text = text + r * n_pad;
  const int* row_sa = sa + r * n_pad;
  for (int node = threadIdx.x + 1; node < kStageNodes; node += blockDim.x) {
    int lo = 0, hi = n;
    for (int k = 30 - __clz(node); k >= 0; --k) {
      const int mid = lo + ((hi - lo) >> 1);
      if ((node >> k) & 1) lo = mid + 1; else hi = mid;
    }
    uint32_t w[4] = {0, 0, 0, 0};
    int s = 0, tl = 0;
    if (lo < hi) {
      s = __ldg(row_sa + lo + ((hi - lo) >> 1));
      tl = n - s < 16 ? n - s : 16;
      if (tl > 0) window16(row_text + s, tl, ts, w);
    }
    s_win[node] = make_uint4(w[0], w[1], w[2], w[3]);
    s_sa[node] = s;
    s_tl[node] = tl;
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int len = lengths[b];
  len = len < 0 ? 0 : (len > L ? L : len);
  int lower = 0, count = n > 0 ? n : 0;  // the empty pattern
  if (len > 0 && n > 0) {
    const Span ps{patterns, patterns + static_cast<long long>(B) * L};
    const Pattern pt =
        load_pattern(patterns + static_cast<long long>(b) * L, len, ps);
    const int lim0 = len < 16 ? len : 16;
    // [lo, hi), its node of the tree (kStageNodes once past the staged
    // levels) and the common prefixes of the suffixes at lo - 1 and hi.
    int lo = 0, hi = n, node = 1, llcp = 0, rlcp = 0;
    int phase = 0;  // 0: both bounds, 1: the lower, 2: the upper
    int zlo = 0, zhi = 0, zr = 0, znode = 0;  // the upper's, set aside
    while (true) {
      if (lo >= hi) {
        if (phase != 1) break;
        lower = lo;
        lo = zlo;
        hi = zhi;
        node = znode;
        llcp = len;
        rlcp = zr;
        phase = 2;
        continue;
      }
      const int mid = lo + ((hi - lo) >> 1);
      int sign, l;
      if (node < kStageNodes) {
        // The staged first 16 bytes decide, unless the pattern goes on
        // past them and they all match.
        const uint4 c = s_win[node];
        const uint32_t w[4] = {c.x, c.y, c.z, c.w};
        const int tl = s_tl[node];
        const int idx = first_diff(w, pt.w);
        const int e = idx < tl ? idx : tl;
        if (e < lim0) {
          sign = e >= tl || byte_of16(w, e) < byte_of16(pt.w, e) ? -1 : 1;
          l = e;
        } else if (len <= 16) {
          sign = 0;
          l = len;
        } else {
          l = wide_cmp(row_text, n, s_sa[node], pt, 16, ts, ps, &sign);
        }
      } else {
        l = wide_cmp(row_text, n, __ldg(row_sa + mid), pt,
                     (llcp < rlcp ? llcp : rlcp) & ~15, ts, ps, &sign);
      }
      if (phase == 0 && sign == 0) {
        // Slot mid starts with the pattern: the lower bound lies in [lo,
        // mid], the upper in [mid + 1, hi]; the lower goes first.
        zlo = mid + 1;
        zhi = hi;
        zr = rlcp;
        znode = node < kStageNodes ? 2 * node + 1 : kStageNodes;
        hi = mid;
        rlcp = len;
        node = node < kStageNodes ? 2 * node : kStageNodes;
        phase = 1;
        continue;
      }
      const bool left = sign >= (phase == 2 ? 1 : 0);
      if (left) {
        hi = mid;
        rlcp = l;
      } else {
        lo = mid + 1;
        llcp = l;
      }
      node = node < kStageNodes ? 2 * node + !left : kStageNodes;
    }
    if (phase == 0) {
      lower = lo;
      count = 0;
    } else {
      count = lo - lower;
    }
  }
  lower_out[r * B + b] = lower;
  count_out[r * B + b] = count;
}

// ---------------------------------------------------------------------------
// B15, the capped hit gather.  Replaces _gather_hits_jit /
// gather_hit_positions (pysubstringsearch_tpu/ops/search.py).
//
// out[b * c + off] = sa[clip(lower[b] + off, 0, N - 1)] for off < count[b],
// else -1; c = min(cap, N) columns.  A 2-D launch: a warp per query row
// (threadIdx.y picks the row, blockIdx.x a group of kGatherRows rows), its
// lanes along the columns, 4 consecutive columns a lane, so the row's
// bounds are loaded once by lane 0 and broadcast, no index is divided, the
// -1 fill happens in the same pass and a lane stores 16 bytes where the row
// is 16-byte aligned (c a multiple of 4).  Bound by memory: 4 bytes written
// an element and at most 4 read, coalesced along each query's SA range.
// ---------------------------------------------------------------------------
constexpr int kGatherRows = 8;

__global__ void gather_hit_positions_kernel(const int* __restrict__ sa,
                                            const int* __restrict__ lower,
                                            const int* __restrict__ count,
                                            long long B, long long N, int c,
                                            int* __restrict__ out) {
  const long long b =
      static_cast<long long>(blockIdx.x) * kGatherRows + threadIdx.y;
  if (b >= B) return;
  const int lane = threadIdx.x;
  long long lo = 0;
  int cnt = 0;
  if (lane == 0) {
    lo = lower[b];
    cnt = count[b];
  }
  lo = __shfl_sync(0xffffffffu, lo, 0);
  cnt = __shfl_sync(0xffffffffu, cnt, 0);
  int* row = out + b * c;
  const bool vec = (c & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int col = 4 * lane; col < c; col += 4 * 32) {
    int v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = col + i;
      if (off < cnt) {
        long long s = lo + off;
        s = s < 0 ? 0 : (s > N - 1 ? N - 1 : s);
        v[i] = sa[s];
      } else {
        v[i] = -1;
      }
    }
    if (vec) {
      *reinterpret_cast<int4*>(row + col) = make_int4(v[0], v[1], v[2], v[3]);
    } else {
      for (int i = 0; i < 4 && col + i < c; ++i) row[col + i] = v[i];
    }
  }
}

}  // namespace

extern "C" {

int pss_ranked_pack(const void* text, long long N, int n, const void* rank,
                    int bits, void* out, void* stream) {
  if (bits == 5)
    return launch_pack<kPackShift, 6>(text, N, n, rank, 0, out, stream);
  if (bits == 6)
    return launch_pack<kPackShift, 5>(text, N, n, rank, 0, out, stream);
  return (int)cudaErrorInvalidValue;
}

int pss_ranked_limb_planes(const void* text, const void* rank,
                           const void* sa, long long N, long long n,
                           int depth, int bits, int num_limbs, void* limbs,
                           void* stream) {
  if (bits == 5)
    return launch_limb_planes<kLimbRanked, 6, 3>(text, rank, sa, N, n, depth,
                                                 num_limbs, limbs, stream);
  if (bits == 6)
    return launch_limb_planes<kLimbRanked, 5, 3>(text, rank, sa, N, n, depth,
                                                 num_limbs, limbs, stream);
  return (int)cudaErrorInvalidValue;
}

int pss_raw_pack(const void* text, long long N, long long n, void* out,
                 void* stream) {
  return launch_pack<kPackRaw, 4>(text, N, n, nullptr, 0, out, stream);
}

int pss_raw_limb_planes(const void* text, const void* sa, long long N,
                        long long n, int depth, int num_limbs, void* limbs,
                        void* stream) {
  return launch_limb_planes<kLimbRaw, 4, 3>(text, nullptr, sa, N, n, depth,
                                            num_limbs, limbs, stream);
}

// B12d's limb planes: limbs[j * N + i] = the base-258 digits of text bytes
// sa[i] + 2 + 3j .. + 2, the digits build_limbs_device packs.
int pss_digit_limb_planes(const void* text, const void* sa, long long N,
                          long long n, int num_limbs, void* limbs,
                          void* stream) {
  return launch_limb_planes<kLimbDigit, kDigitLimbStride, 5>(
      text, nullptr, sa, N, n, kDigitLimbOffset, num_limbs, limbs, stream);
}

int pss_seed_prefix(const void* text, long long N, long long n,
                    const void* rank, int base, int depth, void* out,
                    void* stream) {
  switch (depth) {
    case 2: return launch_pack<kPackBase, 2>(text, N, n, rank, base, out, stream);
    case 3: return launch_pack<kPackBase, 3>(text, N, n, rank, base, out, stream);
    case 4: return launch_pack<kPackBase, 4>(text, N, n, rank, base, out, stream);
    case 5: return launch_pack<kPackBase, 5>(text, N, n, rank, base, out, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// coarse: scratch of pss_seed_table_scratch_bytes(size).
int pss_seed_table(const void* packed, const void* sa, int n, int shift,
                   long long size, void* coarse, void* table, void* stream) {
  if (size <= 0) return 0;
  const long long runs = (size + kSeedRun - 1) / kSeedRun;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned grid = blocks_for(runs + 1);
  if (grid > 65536u * 16u) grid = 65536u * 16u;
  seed_coarse_kernel<<<grid, kThreads, 0, st>>>(
      (const int*)packed, (const int*)sa, n, shift, runs, (int*)coarse);
  seed_fine_kernel<<<static_cast<unsigned>(runs), kThreads, 0, st>>>(
      (const int*)packed, (const int*)sa, shift, size, (const int*)coarse,
      (int*)table);
  return (int)cudaGetLastError();
}

long long pss_seed_table_scratch_bytes(long long size) {
  return static_cast<long long>(sizeof(int)) *
         ((size + kSeedRun - 1) / kSeedRun + 1);
}

int pss_probe_phased(const void* text, const void* n_rows, const void* sa,
                     const void* tables, const void* limbs, const void* rank,
                     const void* present, const void* patterns,
                     const void* lengths, int C, int B, int L,
                     long long n_pad, long long table_len, int num_limbs,
                     int depth, int base, int bits, void* lower, void* count,
                     void* stream) {
  if (C <= 0 || B <= 0) return 0;
  if (C > 65535 || num_limbs > kMaxLimbs) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (static_cast<long long>(C) * B > kPhasedPairsWide) {
    probe_phased_wide_kernel<<<dim3(blocks_for(B), C), kThreads, 0, st>>>(
        (const uint8_t*)text, (const int*)n_rows, (const int*)sa,
        (const int*)tables, (const int*)limbs, (const int*)rank,
        (const int*)present, (const uint8_t*)patterns, (const int*)lengths,
        B, L, n_pad, table_len, num_limbs, depth, base, bits, (int*)lower,
        (int*)count);
  } else {
    const dim3 grid((B + kLimbPatterns - 1) / kLimbPatterns, C);
    probe_phased_kernel<<<grid, kProbeThreads, 0, st>>>(
        (const uint8_t*)text, (const int*)n_rows, (const int*)sa,
        (const int*)tables, (const int*)limbs, (const int*)rank,
        (const int*)present, (const uint8_t*)patterns, (const int*)lengths,
        B, L, n_pad, table_len, num_limbs, depth, base, bits, (int*)lower,
        (int*)count);
  }
  return (int)cudaGetLastError();
}

int pss_probe_limbs(const void* text, const void* n_rows, const void* sa,
                    const void* tables, const void* limbs,
                    const void* patterns, const void* lengths, int C, int B,
                    int L, long long n_pad, long long table_len, int depth,
                    int num_limbs, void* lower, void* count, void* stream) {
  if (C <= 0 || B <= 0) return 0;
  if (C > 65535 || num_limbs < 1 || num_limbs > kMaxLimbs || depth < 1 ||
      depth > 3)
    return (int)cudaErrorInvalidValue;
  dim3 grid((B + kLimbPatterns - 1) / kLimbPatterns, C);
  probe_limbs_kernel<<<grid, kProbeThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)text, (const int*)n_rows, (const int*)sa,
      (const int*)tables, (const int*)limbs, (const uint8_t*)patterns,
      (const int*)lengths, B, L, n_pad, table_len, depth, num_limbs,
      (int*)lower, (int*)count);
  return (int)cudaGetLastError();
}

// offsets int32 [B + 1], the exclusive scan of the counts; total =
// offsets[B], read by the caller, sizes pos and qid and the grid.
int pss_gather_hits_flat(const void* sa, const void* lower,
                         const void* offsets, int B, long long total,
                         void* pos, void* qid, void* stream) {
  if (B <= 0 || total <= 0) return 0;
  const long long grid = (total + kGatherTile - 1) / kGatherTile;
  gather_hits_flat_kernel<<<(unsigned)grid, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int*)sa, (const int*)lower, (const int*)offsets, B, total,
      (int*)pos, (int*)qid);
  return (int)cudaGetLastError();
}

int pss_probe_bytes(const void* text, const void* n_rows, const void* sa,
                    const void* patterns, const void* lengths, int C, int B,
                    int L, long long n_pad, void* lower, void* count,
                    void* stream) {
  if (C <= 0 || B <= 0) return 0;
  if (C > 65535 || L < 0) return (int)cudaErrorInvalidValue;
  dim3 grid((B + kBytesThreads - 1) / kBytesThreads, C);
  probe_bytes_kernel<<<grid, kBytesThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)text, (const int*)n_rows, (const int*)sa,
      (const uint8_t*)patterns, (const int*)lengths, B, L, n_pad,
      (int*)lower, (int*)count);
  return (int)cudaGetLastError();
}

int pss_gather_hit_positions(const void* sa, const void* lower,
                             const void* count, long long B, long long N,
                             int c, void* out, void* stream) {
  if (B <= 0 || c <= 0) return 0;
  const long long blocks = (B + kGatherRows - 1) / kGatherRows;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gather_hit_positions_kernel<<<(unsigned)blocks, dim3(32, kGatherRows), 0,
                                (cudaStream_t)stream>>>(
      (const int*)sa, (const int*)lower, (const int*)count, B, N, c,
      (int*)out);
  return (int)cudaGetLastError();
}

}  // extern "C"
