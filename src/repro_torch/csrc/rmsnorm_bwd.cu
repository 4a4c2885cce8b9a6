// RMSNorm backward for Hopper: the norms' gradients in the training step.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// its norms (src/repro/models/layers/norms.py::apply), so it has no
// backward Pallas kernel.  The port's forward is the CUDA kernel
// csrc/rmsnorm.cu, which autograd cannot differentiate, so its backward is
// this kernel (kernels/rmsnorm/ops.py binds the two in a
// torch.autograd.Function).  For every row r of x [rows, D], with
// w' = w, or 1 + w under scale_offset, and dy the output's gradient:
//   rstd = rsqrt(mean(x[r, :]**2) + eps)        (recomputed, f32)
//   dx[r, :] = rstd (w' dy[r, :]) - x[r, :] rstd**3 mean(w' dy[r, :] x[r, :])
//   dw[:]   += dy[r, :] (x[r, :] rstd)
// dx is written in x's dtype (bf16 or f32), dw in f32.
//
// What bounds it on the H100: bytes.  x and dy read once, dx written once,
// ~10 FLOPs an element: at the training shape (4 x 1,024 rows of D = 896,
// bf16) 22 MB, ~6.6 us at 3.35 TB/s.
//
// Design: two launches, no atomics, so two calls give the same bits.
//   1. rows: a 256-thread block takes `rpb` consecutive rows, one at a
//      time: a first pass over the row sums x**2 and w' dy x (each thread
//      its columns in turn, a shuffle tree in each warp, the 8 warps' sums
//      in order), a second writes dx and adds dy x rstd into the block's
//      dw partial, which stays in shared memory (a thread owns the columns
//      c = tid mod 256, so no two threads touch one word), and is written
//      to part[block, :] at the end.
//   2. dw: a thread a column sums part[:, column] over the blocks in order.
// The wrapper's plan (kernels/rmsnorm/kernel.py::bwd_plan) gives at most
// 1,024 blocks, one wave of resident blocks at the training shape.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 12288;   // the dw partial in 48 KB of shared memory

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
rmsnorm_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ part, long long rows, int D, int rpb,
                 float eps, int offset) {
  extern __shared__ float acc[];            // [D]: this block's dw partial
  __shared__ float red[2][2][kWarps];       // by row parity: ss, dot
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  for (int i = tid; i < D; i += kThreads) acc[i] = 0.f;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = r0 + rpb < rows ? r0 + rpb : rows;
  for (long long r = r0; r < r1; ++r) {
    const T* xr = x + r * D;
    const T* dyr = dy + r * D;
    float ss = 0.f, dot = 0.f;
    for (int i = tid; i < D; i += kThreads) {
      const float xf = to_f32(xr[i]);
      const float g = to_f32(dyr[i]) * (offset ? 1.f + w[i] : w[i]);
      ss = fmaf(xf, xf, ss);
      dot = fmaf(g, xf, dot);
    }
    ss = warp_sum(ss);
    dot = warp_sum(dot);
    const int par = (int)(r & 1);   // two buffers: one barrier a row
    if (lane == 0) {
      red[par][0][warp] = ss;
      red[par][1][warp] = dot;
    }
    __syncthreads();
    ss = 0.f;
    dot = 0.f;
    for (int i = 0; i < kWarps; ++i) {
      ss += red[par][0][i];
      dot += red[par][1][i];
    }
    const float rstd = rsqrtf(ss / (float)D + eps);
    const float c = rstd * rstd * rstd * (dot / (float)D);
    T* dxr = dx + r * D;
    for (int i = tid; i < D; i += kThreads) {
      const float xf = to_f32(xr[i]);
      const float gy = to_f32(dyr[i]);
      const float g = gy * (offset ? 1.f + w[i] : w[i]);
      from_f32(dxr + i, rstd * g - xf * c);
      acc[i] = fmaf(gy, xf * rstd, acc[i]);
    }
  }
  float* pb = part + (long long)blockIdx.x * D;
  for (int i = tid; i < D; i += kThreads) pb[i] = acc[i];
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_dw(const float* __restrict__ part, float* __restrict__ dw,
               int n_blocks, int D) {
  const int d = blockIdx.x * kThreads + threadIdx.x;
  if (d >= D) return;
  float s = 0.f;
  for (int b = 0; b < n_blocks; ++b) s += part[(long long)b * D + d];
  dw[d] = s;
}

template <typename T>
int launch(const void* x, const float* w, const void* dy, void* dx,
           float* part, float* dw, long long rows, int D, int rpb, float eps,
           int offset, cudaStream_t s) {
  const int nb = (int)((rows + rpb - 1) / rpb);
  rmsnorm_bwd_rows<T><<<nb, kThreads, D * sizeof(float), s>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, D, rpb, eps, offset);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  rmsnorm_bwd_dw<<<(D + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      part, dw, nb, D);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = f32, 1 = bf16 (x, dy and dx); w, dw and part are f32.  x,
// dy and dx are [rows, D] contiguous, part [ceil(rows / rpb), D] scratch.
// The plan (rpb rows a block) is the Python wrapper's.  Returns
// cudaGetLastError() after the launches (the first failing one's code).
extern "C" int rmsnorm_bwd_launch(const void* x, const float* w,
                                  const void* dy, void* dx, float* part,
                                  float* dw, long long rows, int D, int rpb,
                                  float eps, int offset, int x_dtype,
                                  void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (D > kMaxD || rpb < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_dtype == 1
             ? launch<__nv_bfloat16>(x, w, dy, dx, part, dw, rows, D, rpb,
                                     eps, offset, s)
             : launch<float>(x, w, dy, dx, part, dw, rows, D, rpb, eps,
                             offset, s);
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
