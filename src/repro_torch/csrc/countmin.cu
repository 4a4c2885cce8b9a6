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
//   add    [B]           int32: event i counts where add[i] > 0
// and the column of event i in row r, from one of three sources:
//   cols   [rows, B] int32, computed outside the kernel as on the TPU
//          (countmin_launch);
//   keys   [B] int32 or int64 and one uint32 salt a row, passed by value
//          (countmin_keys_launch): the column is
//          mix32(fold_u32(key) ^ salt) % width in native uint32
//          (hash32.cuh), bitwise telemetry/sketch.py::columns (64-bit
//          keys xor-fold their halves);
//   ts     [B] int32 and the tick, read through a device pointer or passed
//          by value (countmin_ages_launch, one row): the column is the
//          bucket of lat = max(tick - ts, 0) (int32, wrapping as torch
//          does), min(32 - clz(lat), n_buckets - 1), bitwise
//          telemetry/latency.py::bucketize and the JAX package's clz.
//          The counted events' lat are also added into one int32 in
//          place (warp sums, one atomic a warp): integer adds mod 2**32,
//          so bitwise the plain int32 sum, wrap-around included.
// For every row r and event i with add[i] > 0, counts[r, col(r, i)] gains
// one.  A column outside [0, width) counts nowhere (the TPU kernel's sink
// column).  Integer adds in any order give the same sum, so the result is
// bitwise equal to the plain version whatever order the atomics land in.
// The fused sources save the telemetry path the ~24 elementwise launches
// of the int64-emulated hash, the ~6 of the bucketing and the ~5 of the
// latency sum, an updater a tick, and the [rows, B] column array's round
// trip through memory.
//
// What bounds it: bytes.  cols (or keys, or ts) and add are read once and
// the counters read and written once: about 0.8 MB for a 2 x 2048 sketch
// at B = 65,536 from cols, 0.5 MB from int32 keys (0.24 / 0.15 us at
// 3.35 TB/s).  At that size launch latency dominates.
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

#include "hash32.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;                 // events per thread per block
constexpr int kChunk = kThreads * kPerThread;  // events per block
constexpr long long kSharedBytes = 48 * 1024;  // no opt-in attribute needed
constexpr int kMaxDepth = 8;                   // salts passed by value

// Column sources.  load(i) reads what a counted event i needs once;
// col(e, r) gives its column in row r; init() runs once a thread before
// the loop, tally(e) for each counted event and flush() once a thread
// after the loop, with the whole warp.

struct ColsSrc {                               // cols[r, i], given
  const int32_t* cols;
  long long B;
  __device__ void init() {}
  __device__ long long load(long long i) const { return i; }
  __device__ int col(long long i, int r) const { return cols[r * B + i]; }
  __device__ void tally(long long) {}
  __device__ void flush() {}
};

struct Salts {
  uint32_t s[kMaxDepth];
};

template <typename KeyT>
struct KeysSrc {                 // mix32(fold(key) ^ salt_r) % width
  const KeyT* keys;
  Salts salts;
  uint32_t width;
  __device__ void init() {}
  __device__ uint32_t load(long long i) const { return fold_u32(keys[i]); }
  __device__ int col(uint32_t u, int r) const {
    return (int)(mix32(u ^ salts.s[r]) % width);
  }
  __device__ void tally(uint32_t) {}
  __device__ void flush() {}
};

struct Age {
  int bucket;
  uint32_t lat;
};

struct AgesSrc {                               // one row of latency buckets
  const int32_t* ts;
  const int32_t* tick_ptr;                     // the tick on the device, or
  int32_t tick;                                // null and the tick by value
  int top;                                     // n_buckets - 1
  int32_t* lat_sum;                            // gains the counted ages
  uint32_t acc;
  __device__ void init() {
    if (tick_ptr) tick = *tick_ptr;
    acc = 0;
  }
  __device__ Age load(long long i) const {
    int32_t lat = (int32_t)((uint32_t)tick - (uint32_t)ts[i]);
    lat = lat > 0 ? lat : 0;
    const int b = 32 - __clz(lat);
    return Age{b < top ? b : top, (uint32_t)lat};
  }
  __device__ int col(const Age& e, int) const { return e.bucket; }
  __device__ void tally(const Age& e) { acc += e.lat; }
  __device__ void flush() {
    const uint32_t w = __reduce_add_sync(0xffffffffu, acc);
    if ((threadIdx.x & 31) == 0 && w != 0)
      atomicAdd(reinterpret_cast<unsigned*>(lat_sum), w);
  }
};

template <typename Src, bool kShared>
__global__ void __launch_bounds__(kThreads)
countmin_kernel(int32_t* __restrict__ counts, Src src,
                const int32_t* __restrict__ add, int rows, int width,
                long long B) {
  extern __shared__ int32_t priv[];
  const int n = rows * width;
  int32_t* dst = kShared ? priv : counts;
  if (kShared) {
    for (int j = threadIdx.x; j < n; j += kThreads) priv[j] = 0;
    __syncthreads();
  }
  src.init();
  const long long lo = (long long)blockIdx.x * kChunk;
  const long long hi = lo + kChunk < B ? lo + kChunk : B;
  const int lane = threadIdx.x & 31;
  // every thread of the block runs the same trip count, so whole warps
  // reach __match_any_sync together
  for (long long base = lo; base < hi; base += kThreads) {
    const long long i = base + threadIdx.x;
    const bool on = i < hi && add[i] > 0;
    decltype(src.load(0)) e{};
    if (on) {
      e = src.load(i);
      src.tally(e);
    }
    for (int r = 0; r < rows; ++r) {
      int f = -1;
      if (on) {
        const int c = src.col(e, r);
        if (c >= 0 && c < width) f = r * width + c;
      }
      const unsigned peers = __match_any_sync(0xffffffffu, f);
      if (f >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&dst[f], (int32_t)__popc(peers));
    }
  }
  src.flush();
  if (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int32_t v = priv[j];
      if (v != 0) atomicAdd(&counts[j], v);
    }
  }
}

template <typename Src>
int launch(void* counts, const Src& src, const void* add, int rows,
           int width, long long B, void* stream) {
  if (B <= 0) return 0;
  const dim3 grid((unsigned)((B + kChunk - 1) / kChunk));
  const long long bytes = (long long)rows * width * sizeof(int32_t);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  int32_t* c = static_cast<int32_t*>(counts);
  const int32_t* a = static_cast<const int32_t*>(add);
  if (bytes <= kSharedBytes)
    countmin_kernel<Src, true><<<grid, kThreads, (size_t)bytes, s>>>(
        c, src, a, rows, width, B);
  else
    countmin_kernel<Src, false><<<grid, kThreads, 0, s>>>(c, src, a, rows,
                                                           width, B);
  return (int)cudaGetLastError();
}

}  // namespace

// rows * width < 2**31 in every entry point.  Each returns
// cudaGetLastError() after the launch.

extern "C" int countmin_launch(void* counts, const void* cols, const void* add,
                               int rows, int width, long long B,
                               void* stream) {
  return launch(counts, ColsSrc{static_cast<const int32_t*>(cols), B}, add,
                rows, width, B, stream);
}

// salts: `depth` (<= 8) uint32 values in host memory, copied into the
// kernel's arguments.  key_bytes: 4 (int32) or 8 (int64).
extern "C" int countmin_keys_launch(void* counts, const void* keys,
                                    const void* add, const uint32_t* salts,
                                    int depth, int width, long long B,
                                    int key_bytes, void* stream) {
  if (depth < 1 || depth > kMaxDepth) return (int)cudaErrorInvalidValue;
  Salts sl{};
  for (int r = 0; r < depth; ++r) sl.s[r] = salts[r];
  if (key_bytes == 8)
    return launch(counts,
                  KeysSrc<long long>{static_cast<const long long*>(keys), sl,
                                     (uint32_t)width},
                  add, depth, width, B, stream);
  return launch(counts,
                KeysSrc<int>{static_cast<const int*>(keys), sl,
                             (uint32_t)width},
                add, depth, width, B, stream);
}

// tick_ptr: a device int32 holding the tick, or null to use tick.
// Counts one row of `width` >= n_buckets.  lat_sum: a device int32 that
// gains the counted events' ages.
extern "C" int countmin_ages_launch(void* counts, const void* ts,
                                    const void* add, const void* tick_ptr,
                                    int tick, int n_buckets, void* lat_sum,
                                    int width, long long B, void* stream) {
  return launch(counts,
                AgesSrc{static_cast<const int32_t*>(ts),
                        static_cast<const int32_t*>(tick_ptr), tick,
                        n_buckets - 1, static_cast<int32_t*>(lat_sum), 0},
                add, 1, width, B, stream);
}

extern "C" const char* countmin_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
