// Fused RMSNorm for Hopper: every norm of the model stack.
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm/kernel.py
// (_rms_kernel / rmsnorm): for every row r of x [rows, D],
//   o[r, :] = (x[r, :] * rsqrt(mean(x[r, :]**2) + eps)) * w'   (f32)
// with w' = w, or 1 + w under scale_offset, then cast to x's dtype, in the
// order of src/repro/models/layers/norms.py::apply.  x and o are bf16 or
// f32, w is f32 (the norm scales stay f32 in every compute dtype); any
// D >= 1.
//
// What bounds it on the H100: bytes.  The row is read once for the sum of
// squares and once more for the output (the second read hits L1/L2: a row
// is at most a few KB), and o is written once; the arithmetic is ~4 FLOPs
// an element.  At 2048 rows x 2048 bf16 that is 16.8 MB through HBM,
// ~5 us at 3.35 TB/s.  Design: one block of 256 threads per row, 16-byte
// loads and stores where the row is aligned.  The sum of squares is taken
// in f32 in a fixed order (each thread its strided elements, then a
// shuffle tree in each warp, then warp 0 over the warps' sums): no
// atomics, so two calls give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ w,
               T* __restrict__ o, int D, float eps, int offset, int vec) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = o + row * D;
  constexpr int kVec = 16 / sizeof(T);
  const int tid = threadIdx.x;

  float ss = 0.f;
  if (vec) {
    const int nv = D / kVec;
    for (int i = tid; i < nv; i += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const float f = to_f32(e[k]);
        ss = fmaf(f, f, ss);
      }
    }
  } else {
    for (int i = tid; i < D; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
    }
  }
  ss = warp_sum(ss);
  if ((tid & 31) == 0) red[tid >> 5] = ss;
  __syncthreads();
  if (tid < 32) {
    float v = tid < kWarps ? red[tid] : 0.f;
    v = warp_sum(v);
    if (tid == 0) red[0] = v;
  }
  __syncthreads();
  const float inv = rsqrtf(red[0] / (float)D + eps);

  if (vec) {
    const int nv = D / kVec;
    for (int i = tid; i < nv; i += kThreads) {
      const uint4 raw = reinterpret_cast<const uint4*>(xr)[i];
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 res;
      T* r = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        float wk = w[i * kVec + k];
        if (offset) wk = 1.f + wk;
        from_f32(r + k, (to_f32(e[k]) * inv) * wk);
      }
      reinterpret_cast<uint4*>(orow)[i] = res;
    }
  } else {
    for (int i = tid; i < D; i += kThreads) {
      float wk = w[i];
      if (offset) wk = 1.f + wk;
      from_f32(orow + i, (to_f32(xr[i]) * inv) * wk);
    }
  }
}

template <typename T>
int launch(const void* x, const float* w, void* o, long long rows, int D,
           float eps, int offset, int vec, cudaStream_t s) {
  rmsnorm_kernel<T><<<(unsigned)rows, kThreads, 0, s>>>(
      static_cast<const T*>(x), w, static_cast<T*>(o), D, eps, offset, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = f32, 1 = bf16 (x and o); w is f32.  x and o are [rows, D]
// contiguous; vec = 1 when x, o and D allow 16-byte accesses (checked by
// the Python wrapper).  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const float* w, void* o,
                              long long rows, int D, float eps, int offset,
                              int x_dtype, int vec, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_dtype == 1
             ? launch<__nv_bfloat16>(x, w, o, rows, D, eps, offset, vec, s)
             : launch<float>(x, w, o, rows, D, eps, offset, vec, s);
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
