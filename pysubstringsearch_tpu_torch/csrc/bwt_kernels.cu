// B13, the Burrows-Wheeler transform from a suffix array on the card.
// Replaces bwt_from_sa_device (pysubstringsearch_tpu/ops/bwt.py), whose
// argmin, two gathers and select become kernels on one stream.
//
// Built and bound like csrc/search_kernels.cu (see ops/kernels.py): the
// entry point takes raw device pointers and a cudaStream_t, launches on that
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError().
//
// text uint8 [n], sa int32 [n] a permutation of [0, n):
//   primary = i0 + 1, i0 the slot with sa[i0] == 0;
//   u[0] = text[n - 1]; u[i] = text[(sa[j] - 1) mod n] with j = i - 1 for
//   1 <= i <= i0 and j = i for i > i0 (libsais' U: the rotation BWT column
//   with the sentinel's entry dropped).
//
// Bound by memory: 4 bytes of SA and 1 byte of text read per slot and 1
// byte written; the text reads are scattered, which is where the time goes:
// each miss costs a 64-byte DRAM access, and the card's rate of those is
// the same however many loads are in flight (sa_bench.py --gathers'
// access rate), so the design keeps the reads in the L2 instead:
//   1. bwt_gather_kernel, in P = ceil(n / kBwtRegion) passes: pass r takes
//      only the slots whose source byte (sa[j] - 1) mod n lies in the r-th
//      of P equal slices of the text (about 48 MiB, which the 50 MB L2
//      mostly holds) and writes g[j] = text[source] into an n-byte
//      scratch; each pass reads the SA again, streaming (evict-first), and
//      stores its bytes alone.  The first pass's thread that sees
//      sa[j] == 0 writes the primary index.  A thread takes kBwtSlots
//      slots: four 16-byte sa loads, then its byte loads in flight
//      together, then one 16-byte store where every slot is in the slice.
//   2. bwt_shift_kernel: u[i] = g[i - 1] for i <= i0 (g[-1] read as
//      text[n - 1]) and g[i] past it, reading i0 from device memory, so the
//      primary index never crosses to the host: a streaming pass of n bytes
//      each way, 16 a thread.
// At 268 M slots one pass took 8.71-8.78 ms and six take 7.63 (sa_bench.py
// --gathers on an NVIDIA H100 80GB HBM3 at 700 W; PERF.md).  Partitioning
// the slots by slice first (one SA read, pairs written in slice order)
// lost: its stores into U land anywhere, and scattered byte stores cost
// more than the reads they save.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBwtSlots = 16;  // slots (bytes) a thread
constexpr long long kBwtRegion = 48LL << 20;  // text bytes a gather pass

inline long long bwt_blocks(long long n) {
  const long long threads = (n + kBwtSlots - 1) / kBwtSlots;
  return (threads + kThreads - 1) / kThreads;
}

// One pass: the slots whose source byte lies in [lo, hi).
__global__ void __launch_bounds__(kThreads)
bwt_gather_kernel(const uint8_t* __restrict__ text,
                  const int* __restrict__ sa, long long n, long long lo,
                  long long hi, int first, int* __restrict__ primary,
                  uint8_t* __restrict__ g) {
  const long long j0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kBwtSlots;
  if (j0 >= n) return;
  const bool vec =
      j0 + kBwtSlots <= n &&
      ((reinterpret_cast<uintptr_t>(sa) | reinterpret_cast<uintptr_t>(g)) &
       15) == 0;
  int s[kBwtSlots];
  if (vec) {
#pragma unroll
    for (int q = 0; q < kBwtSlots / 4; ++q) {
      const int4 v = __ldcs(reinterpret_cast<const int4*>(sa + j0 + 4 * q));
      s[4 * q] = v.x; s[4 * q + 1] = v.y; s[4 * q + 2] = v.z;
      s[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kBwtSlots; ++k) s[k] = j0 + k < n ? sa[j0 + k] : 1;
  }
  uint32_t b[kBwtSlots];
  unsigned mask = 0;
#pragma unroll
  for (int k = 0; k < kBwtSlots; ++k) {
    if (first && s[k] == 0 && j0 + k < n)
      *primary = static_cast<int>(j0 + k + 1);
    const long long p = s[k] == 0 ? n - 1 : static_cast<long long>(s[k]) - 1;
    b[k] = 0;
    if (p >= lo && p < hi && j0 + k < n) {
      b[k] = __ldg(text + p);
      mask |= 1u << k;
    }
  }
  if (vec && mask == 0xffffu) {
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      w[q] = b[4 * q] | (b[4 * q + 1] << 8) | (b[4 * q + 2] << 16) |
             (b[4 * q + 3] << 24);
    *reinterpret_cast<uint4*>(g + j0) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
#pragma unroll
    for (int k = 0; k < kBwtSlots; ++k)
      if (mask & (1u << k)) g[j0 + k] = static_cast<uint8_t>(b[k]);
  }
}

__global__ void __launch_bounds__(kThreads)
bwt_shift_kernel(const uint8_t* __restrict__ g,
                 const uint8_t* __restrict__ text, long long n,
                 const int* __restrict__ primary, uint8_t* __restrict__ u) {
  const long long i0 = static_cast<long long>(*primary) - 1;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) *
      kBwtSlots;
  if (c0 >= n) return;
  const bool vec =
      c0 + kBwtSlots <= n &&
      ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(u)) &
       15) == 0;
  if (vec && (c0 > i0 || c0 + kBwtSlots - 1 <= i0)) {
    const uint4 cur = *reinterpret_cast<const uint4*>(g + c0);
    uint4 out = cur;
    if (c0 <= i0) {  // the whole chunk one byte later: u[i] = g[i - 1]
      const uint32_t prev = c0 > 0 ? g[c0 - 1] : text[n - 1];
      out.x = (cur.x << 8) | prev;
      out.y = __funnelshift_l(cur.x, cur.y, 8);
      out.z = __funnelshift_l(cur.y, cur.z, 8);
      out.w = __funnelshift_l(cur.z, cur.w, 8);
    }
    *reinterpret_cast<uint4*>(u + c0) = out;
    return;
  }
  // The row's tail, and the one chunk that holds i0 and i0 + 1.
  for (long long i = c0; i < c0 + kBwtSlots && i < n; ++i) {
    if (i == 0) {
      u[0] = text[n - 1];
    } else {
      u[i] = i <= i0 ? g[i - 1] : g[i];
    }
  }
}

}  // namespace

extern "C" {

// scratch: n bytes of device memory.
int pss_bwt_from_sa(const void* text, const void* sa, long long n,
                    void* primary, void* u, void* scratch, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const long long grid = bwt_blocks(n);
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long passes = (n + kBwtRegion - 1) / kBwtRegion;
  for (long long r = 0; r < passes; ++r) {
    bwt_gather_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        (const uint8_t*)text, (const int*)sa, n, n * r / passes,
        n * (r + 1) / passes, r == 0, (int*)primary, (uint8_t*)scratch);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return (int)rc;
  }
  bwt_shift_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
      (const uint8_t*)scratch, (const uint8_t*)text, n, (const int*)primary,
      (uint8_t*)u);
  return (int)cudaGetLastError();
}

}  // extern "C"
