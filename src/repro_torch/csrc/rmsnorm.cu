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
// What bounds it on the H100.  At prefill (2048 rows of D = 896-4096,
// bf16) bytes: x read once, o written once, ~4 FLOPs an element; 2048 x
// 2048 bf16 is 16.8 MB, ~5 us at 3.35 TB/s.  In decode (8 rows, 31 of
// every 32 calls on the serving paths) the bytes are a few KB and the
// time is the kernel's chain of dependent latencies: load, reduce, store.
//
// Design (two routes; the wrapper's plain-Python plan,
// kernels/rmsnorm/kernel.py::plan, picks one and its sizes):
//
// * regs (D a multiple of 16 bytes, 16-byte aligned x): a row, or a slice
//   of it, stays in registers.  Each of the row's `tpr` threads (a
//   multiple of 32) loads its VPT 16-byte vectors of x and the matching
//   16-byte vectors of w, all issued together before the reduction, so
//   the two latencies overlap; x is read from memory once.  A row of one
//   warp (tpr = 32, several rows a block) reduces by a shuffle tree alone:
//   no shared memory and no barrier.  A wider row (a small block per row)
//   adds one barrier: each warp's sum goes to shared memory and every
//   thread adds its row's warp sums in warp order.  The plan gives decode
//   rows more threads (one vector each, more loads in flight) and prefill
//   rows fewer (four vectors each, more rows a wave).
// * loop (odd D, unaligned x, or D past the register budget): one block
//   of 256 threads per row, x read element by element, twice (the second
//   read hits L1/L2).
//
// The sum of squares is f32 in a fixed order on both routes (each thread
// its elements in turn, a shuffle tree in each warp, then the warps' sums
// in order): no atomics, so two calls give the same bits.
//
// A row split across ranks (kernels/rmsnorm/ops.py's route over a last dim
// sharded on a mesh axis) takes two launches a rank.  `rmsnorm_sums`, a warp
// a row (16-byte loads where the row allows them), writes each row's f32
// partial sum of squares over the rank's columns, and with dy the partial
// sum of dy w' x the backward needs (csrc/rmsnorm_bwd.cu takes both); the
// ranks' partials are gathered and summed in rank order; then either route
// above normalises with the row's total in place of its own sum (`ss`,
// the whole row's `d_norm` elements), skipping the reduction.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // the loop route's block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBlock = 1024;
// threads a block may have with VPT vectors a thread: four or more take
// more than the 64 registers a thread of a 1024-thread block gets
__host__ __device__ constexpr int max_block(int vpt) {
  return vpt >= 4 ? 256 : kMaxBlock;
}

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

// ------------------------------------------------------------ regs route
// rpb rows a block, tpr threads a row (tpr a multiple of 32, rpb * tpr <=
// max_block(VPT); tpr == 32 means one warp a row and no barrier).  Each
// thread holds VPT 16-byte vectors of its row: t, t + tpr, t + 2 tpr, ...
template <typename T, int VPT>
__global__ void __launch_bounds__(max_block(VPT))
rmsnorm_regs(const T* __restrict__ x, const float* __restrict__ w,
             T* __restrict__ o, long long rows, int D, float eps, int offset,
             int tpr, int rpb, const float* __restrict__ ss_in, int d_norm) {
  constexpr int kVec = 16 / sizeof(T);        // elements a vector
  constexpr int kW = kVec / 4;                // float4s of w a vector
  __shared__ float red[kMaxBlock / 32];
  const int t = threadIdx.x % tpr;
  const long long row = (long long)blockIdx.x * rpb + threadIdx.x / tpr;
  const bool live = row < rows;
  const int nv = D / kVec;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * D);
  const float4* wv = reinterpret_cast<const float4*>(w);

  uint4 xv[VPT];
  float4 wr[VPT][kW];
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = t + k * tpr;
    const bool ok = live && i < nv;
    xv[k] = ok ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int c = 0; c < kW; ++c)
      wr[k][c] = i < nv ? __ldg(wv + i * kW + c)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float ss = 0.f;
  if (ss_in) {                 // the row's total, summed over the ranks
    if (live) ss = ss_in[row];
  } else {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const T* e = reinterpret_cast<const T*>(&xv[k]);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
      }
    }
    ss = warp_sum(ss);
    if (tpr > 32) {            // one barrier: the row's warp sums in order
      const int warp = threadIdx.x >> 5;
      if ((threadIdx.x & 31) == 0) red[warp] = ss;
      __syncthreads();
      const int w0 = (threadIdx.x / tpr) * (tpr >> 5);
      ss = 0.f;
      for (int i = 0; i < (tpr >> 5); ++i) ss += red[w0 + i];
    }
  }
  if (!live) return;
  const float inv = rsqrtf(ss / (float)d_norm + eps);
  uint4* orow = reinterpret_cast<uint4*>(o + row * D);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = t + k * tpr;
    if (i >= nv) continue;
    const T* e = reinterpret_cast<const T*>(&xv[k]);
    const float* wk = reinterpret_cast<const float*>(&wr[k][0]);
    uint4 res;
    T* r = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const float s = offset ? 1.f + wk[j] : wk[j];
      from_f32(r + j, (to_f32(e[j]) * inv) * s);
    }
    orow[i] = res;
  }
}

// ------------------------------------------------------------ loop route
template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_loop(const T* __restrict__ x, const float* __restrict__ w,
             T* __restrict__ o, int D, float eps, int offset,
             const float* __restrict__ ss_in, int d_norm) {
  __shared__ float red[kWarps];
  const long long row = blockIdx.x;
  const T* xr = x + row * D;
  T* orow = o + row * D;
  const int tid = threadIdx.x;

  float total;
  if (ss_in) {                 // the row's total, summed over the ranks
    total = ss_in[row];
  } else {
    float ss = 0.f;
    for (int i = tid; i < D; i += kThreads) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
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
    total = red[0];
  }
  const float inv = rsqrtf(total / (float)d_norm + eps);
  for (int i = tid; i < D; i += kThreads) {
    float wk = w[i];
    if (offset) wk = 1.f + wk;
    from_f32(orow + i, (to_f32(xr[i]) * inv) * wk);
  }
}

// ------------------------------------------------------- the row sums
// A warp a row (8 rows a block): out[r] = sum x[r, :]**2, or with dy
// out[r] = (sum x**2, sum (dy w') x) as out[2 r], out[2 r + 1]; each lane
// its 16-byte vectors (or, with vec = 0, its elements) in turn, then a
// shuffle tree: a fixed order.
constexpr int kSumWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kSumWarps * 32)
rmsnorm_row_sums(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, float* __restrict__ out,
                 long long rows, int D, int offset, int vec) {
  constexpr int kVec = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kSumWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + row * D;
  const T* gr = dy ? dy + row * D : nullptr;
  float ss = 0.f, dot = 0.f;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(xr);
    const uint4* gv = reinterpret_cast<const uint4*>(gr);
    for (int i = lane; i < D / kVec; i += 32) {
      const uint4 raw = __ldg(xv + i);
      const T* e = reinterpret_cast<const T*>(&raw);
      uint4 graw = make_uint4(0u, 0u, 0u, 0u);
      if (gr) graw = __ldg(gv + i);
      const T* ge = reinterpret_cast<const T*>(&graw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float f = to_f32(e[j]);
        ss = fmaf(f, f, ss);
        if (gr) {
          const float wk = w[i * kVec + j];
          dot = fmaf(to_f32(ge[j]) * (offset ? 1.f + wk : wk), f, dot);
        }
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) {
      const float f = to_f32(xr[i]);
      ss = fmaf(f, f, ss);
      if (gr) dot = fmaf(to_f32(gr[i]) * (offset ? 1.f + w[i] : w[i]), f, dot);
    }
  }
  ss = warp_sum(ss);
  if (gr) {
    dot = warp_sum(dot);
    if (lane == 0) {
      out[2 * row] = ss;
      out[2 * row + 1] = dot;
    }
  } else if (lane == 0) {
    out[row] = ss;
  }
}

template <typename T>
int launch(const void* x, const float* w, void* o, long long rows, int D,
           float eps, int offset, int tpr, int rpb, int vpt,
           const float* ss_in, int d_norm, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(o);
  if (vpt == 0) {
    rmsnorm_loop<T><<<(unsigned)rows, kThreads, 0, s>>>(xt, w, ot, D, eps,
                                                        offset, ss_in, d_norm);
    return (int)cudaGetLastError();
  }
  const unsigned grid = (unsigned)((rows + rpb - 1) / rpb);
  const int block = tpr * rpb;
  switch (vpt) {
    case 1:
      rmsnorm_regs<T, 1><<<grid, block, 0, s>>>(xt, w, ot, rows, D, eps,
                                                offset, tpr, rpb, ss_in,
                                                d_norm);
      break;
    case 2:
      rmsnorm_regs<T, 2><<<grid, block, 0, s>>>(xt, w, ot, rows, D, eps,
                                                offset, tpr, rpb, ss_in,
                                                d_norm);
      break;
    case 4:
      rmsnorm_regs<T, 4><<<grid, block, 0, s>>>(xt, w, ot, rows, D, eps,
                                                offset, tpr, rpb, ss_in,
                                                d_norm);
      break;
    case 8:
      rmsnorm_regs<T, 8><<<grid, block, 0, s>>>(xt, w, ot, rows, D, eps,
                                                offset, tpr, rpb, ss_in,
                                                d_norm);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = f32, 1 = bf16 (x and o); w is f32.  x and o are [rows, D]
// contiguous.  vpt = 0 takes the loop route; vpt in {1, 2, 4, 8} the regs
// route with tpr threads
// a row and rpb rows a block (x, o and w 16-byte aligned, D a whole number
// of 16-byte vectors).  The plan is the Python wrapper's.  ss: null (each
// row's own sum of squares) or [rows] f32, the rows' totals over a whole
// row of d_norm elements (d_norm is D when ss is null).  Returns
// cudaGetLastError() after the launch.
extern "C" int rmsnorm_launch(const void* x, const float* w, void* o,
                              long long rows, int D, float eps, int offset,
                              int x_dtype, int tpr, int rpb, int vpt,
                              const float* ss, int d_norm, void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (vpt != 0 && (tpr % 32 != 0 || tpr * rpb > max_block(vpt) || rpb < 1))
    return (int)cudaErrorInvalidValue;
  if (d_norm <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return x_dtype == 1 ? launch<__nv_bfloat16>(x, w, o, rows, D, eps, offset,
                                              tpr, rpb, vpt, ss, d_norm, s)
                      : launch<float>(x, w, o, rows, D, eps, offset, tpr,
                                      rpb, vpt, ss, d_norm, s);
}

// The rows' partial sums: x (and dy, or null) [rows, D] contiguous, of
// x_dtype; w [D] f32 (read only with dy); out [rows] f32, or [rows, 2]
// with dy.  vec: 16-byte loads (x, dy 16-byte aligned, D a whole number
// of 16-byte vectors).  Returns cudaGetLastError() after the launch.
extern "C" int rmsnorm_sums_launch(const void* x, const float* w,
                                   const void* dy, float* out, long long rows,
                                   int D, int offset, int x_dtype, int vec,
                                   void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const unsigned grid = (unsigned)((rows + kSumWarps - 1) / kSumWarps);
  if (x_dtype == 1)
    rmsnorm_row_sums<__nv_bfloat16><<<grid, kSumWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), w,
        static_cast<const __nv_bfloat16*>(dy), out, rows, D, offset, vec);
  else
    rmsnorm_row_sums<float><<<grid, kSumWarps * 32, 0, s>>>(
        static_cast<const float*>(x), w, static_cast<const float*>(dy), out,
        rows, D, offset, vec);
  return (int)cudaGetLastError();
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
