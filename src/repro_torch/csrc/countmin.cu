// One-hot count update for Hopper: the count-min sketch and the latency
// histograms of the in-tick telemetry.
//
// Replaces the Pallas TPU kernels src/repro/kernels/countmin/kernel.py
// (_cm_kernel / countmin_update) and src/repro/kernels/histogram/kernel.py
// (_hist_kernel / histogram_update).  Both compute the same function, so
// one kernel serves both wrappers (kernels/countmin, kernels/histogram).
//
// Inputs:
//   counts [rows, width] int32, updated in place
//   cols   [rows, B]     int32: the column of event i in row r (hashed key
//                        columns for the sketch, latency buckets for the
//                        histogram; computed outside the kernel, as on the
//                        TPU)
//   add    [B]           int32: event i counts where add[i] > 0
// For every row r and event i with add[i] > 0, counts[r, cols[r, i]] gains
// one.  A column outside [0, width) counts nowhere (the TPU kernel's sink
// column).  Integer adds in any order give the same sum, so the result is
// bitwise equal to the plain version whatever order the atomics land in.
//
// What bounds it: bytes.  cols and add are read once and the counters
// read and written once: about 0.8 MB for a 2 x 2048 sketch at B = 65,536
// (0.24 us at 3.35 TB/s).  At that size launch latency dominates.
//
// Design: each block takes a contiguous slice of the batch and keeps a
// private copy of the counters in shared memory (16 KB for 2 x 2048, 512 B
// for one 128-bucket histogram row).  Lanes of a warp that hit the same
// counter are grouped with __match_any_sync and the lowest of them adds the
// group's size, so a hot column (the Zipf head: a fifth of a batch; or the
// one latency bucket a whole tick's events share) costs one shared atomic
// per warp, not 32.  The block then adds each nonzero private counter to
// the global counters with one atomic.  Counters too large for the shared
// memory budget take the same warp-aggregated atomics on global memory
// directly.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;                 // events per thread per block
constexpr int kChunk = kThreads * kPerThread;  // events per block
constexpr long long kSharedBytes = 48 * 1024;  // no opt-in attribute needed

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
countmin_kernel(int32_t* __restrict__ counts, const int32_t* __restrict__ cols,
                const int32_t* __restrict__ add, int rows, int width,
                long long B) {
  extern __shared__ int32_t priv[];
  const int n = rows * width;
  int32_t* dst = kShared ? priv : counts;
  if (kShared) {
    for (int j = threadIdx.x; j < n; j += kThreads) priv[j] = 0;
    __syncthreads();
  }
  const long long lo = (long long)blockIdx.x * kChunk;
  const long long hi = lo + kChunk < B ? lo + kChunk : B;
  const int lane = threadIdx.x & 31;
  // every thread of the block runs the same trip count, so whole warps
  // reach __match_any_sync together
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    const bool on = i < hi && add[i] > 0;
    for (int r = 0; r < rows; ++r) {
      int f = -1;
      if (on) {
        const int c = cols[(long long)r * B + i];
        if (c >= 0 && c < width) f = r * width + c;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, f);
      if (f >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&dst[f], (int32_t)__popc(peers));
    }
  }
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int32_t v = priv[j];
      if (v != 0) atomicAdd(&counts[j], v);
    }
  }
}

}  // namespace

// rows * width < 2**31.  Returns cudaGetLastError() after the launch.
extern "C" int countmin_launch(void* counts, const void* cols, const void* add,
                               int rows, int width, long long B,
                               void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((unsigned)((B + kChunk - 1) / kChunk));
  const long long bytes = (long long)rows * width * sizeof(int32_t);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int32_t* c = static_cast<int32_t*>(counts);
  const int32_t* k = static_cast<const int32_t*>(cols);
  const int32_t* a = static_cast<const int32_t*>(add);
  if (bytes <= kSharedBytes)
    countmin_kernel<true><<<grid, kThreads, (size_t)bytes, s>>>(c, k, a, rows,
                                                                width, B);
  else
    countmin_kernel<false><<<grid, kThreads, 0, s>>>(c, k, a, rows, width, B);
  return (int)cudaGetLastError();
}

extern "C" const char* countmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
