// B13, the Burrows-Wheeler transform from a suffix array on the card.
// Replaces bwt_from_sa_device (pysubstringsearch_tpu/ops/bwt.py), whose
// argmin, two gathers and select become two kernels on one stream.
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
// The first kernel finds i0 (the one thread that sees sa[i] == 0 writes
// it), the second gathers, reading i0 from device memory, so the primary
// index never crosses to the host.  Bound by memory: 4 bytes of SA read
// once by each kernel and 1 byte written per slot; the text reads are
// scattered (one 32-byte sector per byte), which is where the time goes.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

inline unsigned blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b < 1) b = 1;
  if (b > 65536LL * 16) b = 65536LL * 16;
  return static_cast<unsigned>(b);
}

__global__ void bwt_primary_kernel(const int* __restrict__ sa, long long n,
                                   int* __restrict__ primary) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (sa[i] == 0) *primary = static_cast<int>(i + 1);
  }
}

__global__ void bwt_gather_kernel(const uint8_t* __restrict__ text,
                                  const int* __restrict__ sa, long long n,
                                  const int* __restrict__ primary,
                                  uint8_t* __restrict__ u) {
  const long long i0 = static_cast<long long>(*primary) - 1;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    if (i == 0) {
      u[0] = text[n - 1];
      continue;
    }
    const long long j = i <= i0 ? i - 1 : i;
    long long s = static_cast<long long>(sa[j]) - 1;
    s = s < 0 ? s + n : s;
    u[i] = text[s];
  }
}

}  // namespace

extern "C" {

int pss_bwt_from_sa(const void* text, const void* sa, long long n,
                    void* primary, void* u, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  bwt_primary_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const int*)sa, n, (int*)primary);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  bwt_gather_kernel<<<blocks_for(n), kThreads, 0, s>>>(
      (const uint8_t*)text, (const int*)sa, n, (const int*)primary,
      (uint8_t*)u);
  return (int)cudaGetLastError();
}

}  // extern "C"
