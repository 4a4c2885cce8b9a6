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
// Design: two launches, no atomics, so two calls give the same bits.  The
// wrapper's plain-Python plan (kernels/rmsnorm/kernel.py::bwd_plan, a
// function of rows, D, the dtype and alignment alone, never of the device,
// so a shape always sums dw in one order) picks one of two routes:
//
// * regs (D a whole number of 16-byte vectors, at most WARP_VECTORS = 4 a
//   lane: D <= 1,024 bf16 or 512 f32; 16-byte aligned tensors), the
//   forward's `regs` route turned around.  A warp owns a row: each lane
//   holds its VPT 16-byte vectors of x and dy (vectors lane, lane + 32,
//   ...), read from memory once, and the next row's are loaded before this
//   row's sums, so the two latencies overlap.  Sum x**2 and sum w' dy x
//   reduce by a shuffle tree alone, with no barrier; dx is written from
//   the registers.  A warp takes `rpw` consecutive rows and adds each
//   row's dy x rstd into its own row of shared memory (a lane owns its
//   columns, so no two lanes touch one word and no barrier is needed);
//   at the end the block's 8 warps' rows are added in warp order into
//   part[block, :].  The plan keeps the blocks at most 256 (at the
//   training shape 256 blocks of 16 rows: a 917 KB partial, one wave of
//   resident blocks).  The second launch sums a column's partials with 32
//   warps, each a contiguous 32nd of the blocks in order, then the 32
//   sums in warp order (on the loop route too).
// * loop (odd D, unaligned tensors, D past the register budget up to
//   12,288): a 256-thread block takes `rpb` consecutive rows, one at a
//   time: a first pass over the row sums x**2 and w' dy x (each thread its
//   columns in turn, a shuffle tree in each warp, the 8 warps' sums in
//   order), a second writes dx and adds dy x rstd into the block's dw
//   partial, which stays in shared memory (a thread owns the columns
//   c = tid mod 256, so no two threads touch one word), and is written to
//   part[block, :] at the end.  At most 1,024 blocks.

// A row split across ranks (kernels/rmsnorm/ops.py): the rows' sums of x**2
// and of w' dy x over the rank's columns come from csrc/rmsnorm.cu's
// rmsnorm_sums, gathered and summed in rank order; both routes then take
// them (`sums` [rows, 2], over a whole row of `d_norm` elements) in place
// of their own reductions, and dw is the rank's columns.

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
                 float eps, int offset, const float* __restrict__ sums,
                 int d_norm) {
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
    if (sums) {                     // the row's totals over the ranks
      ss = sums[2 * r];
      dot = sums[2 * r + 1];
    } else {
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
    }
    const float rstd = rsqrtf(ss / (float)d_norm + eps);
    const float c = rstd * rstd * rstd * (dot / (float)d_norm);
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

// dw[c] = sum of part[:, c]: a block takes 32 columns; warp q of its 32
// sums the blocks [q nb / 32, (q + 1) nb / 32) in order, then lane c's
// sums are added in warp order
constexpr int kSumWarps = 32;
__global__ void __launch_bounds__(kSumWarps * 32)
rmsnorm_bwd_dw_cols(const float* __restrict__ part, float* __restrict__ dw,
                    int n_blocks, int D) {
  __shared__ float red[kSumWarps][33];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int col = blockIdx.x * 32 + lane;
  const int lo = (int)((long long)warp * n_blocks / kSumWarps);
  const int hi = (int)((long long)(warp + 1) * n_blocks / kSumWarps);
  float s = 0.f;
  if (col < D) {
#pragma unroll 8
    for (int b = lo; b < hi; ++b) s += part[(long long)b * D + col];
  }
  red[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < D) {
    float t = 0.f;
    for (int q = 0; q < kSumWarps; ++q) t += red[q][lane];
    dw[col] = t;
  }
}

// the second launch of both routes: dw from the row blocks' partials
int sum_dw(const float* part, float* dw, int n_blocks, int D,
           cudaStream_t s) {
  rmsnorm_bwd_dw_cols<<<(D + 31) / 32, kSumWarps * 32, 0, s>>>(part, dw,
                                                               n_blocks, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* x, const float* w, const void* dy, void* dx,
           float* part, float* dw, long long rows, int D, int rpb, float eps,
           int offset, const float* sums, int d_norm, cudaStream_t s) {
  const int nb = (int)((rows + rpb - 1) / rpb);
  rmsnorm_bwd_rows<T><<<nb, kThreads, D * sizeof(float), s>>>(
      static_cast<const T*>(x), w, static_cast<const T*>(dy),
      static_cast<T*>(dx), part, rows, D, rpb, eps, offset, sums, d_norm);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return sum_dw(part, dw, nb, D, s);
}

// ------------------------------------------------------------ regs route
constexpr int kRegsWarps = 8;   // a block's warps

template <typename T, int VPT>
struct RowRegs {
  uint4 x[VPT], dy[VPT];
};

// a lane's vectors of row r (zeros past the row)
template <typename T, int VPT>
__device__ __forceinline__ void load_row(RowRegs<T, VPT>& v, const T* x,
                                         const T* dy, long long r, int nv,
                                         int lane, int D) {
  const uint4* xr = reinterpret_cast<const uint4*>(x + r * D);
  const uint4* gr = reinterpret_cast<const uint4*>(dy + r * D);
#pragma unroll
  for (int k = 0; k < VPT; ++k) {
    const int i = lane + 32 * k;
    const bool ok = i < nv;
    v.x[k] = ok ? __ldg(xr + i) : make_uint4(0u, 0u, 0u, 0u);
    v.dy[k] = ok ? __ldg(gr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// w' of vector i's kVec elements (w, 16-byte aligned, read through the
// read-only cache: it stays in L1)
template <int kVec>
__device__ __forceinline__ void w_vec(float (&wk)[kVec], const float* w,
                                      int i, int offset) {
  const float4* wv = reinterpret_cast<const float4*>(w) + i * (kVec / 4);
#pragma unroll
  for (int c = 0; c < kVec / 4; ++c) {
    const float4 f = __ldg(wv + c);
    wk[4 * c] = f.x;
    wk[4 * c + 1] = f.y;
    wk[4 * c + 2] = f.z;
    wk[4 * c + 3] = f.w;
  }
  if (offset)
#pragma unroll
    for (int j = 0; j < kVec; ++j) wk[j] += 1.f;
}

// A warp takes rows [r0, r0 + rpw) of x and dy and writes their dx; its
// dw partial (its lanes' columns) is summed in its row of shared memory,
// row after row; then the block's warps' rows are added in warp order
// into part[blockIdx.x, :].
template <typename T, int VPT>
__global__ void __launch_bounds__(kRegsWarps * 32, 2)
rmsnorm_bwd_regs(const T* __restrict__ x, const float* __restrict__ w,
                 const T* __restrict__ dy, T* __restrict__ dx,
                 float* __restrict__ part, long long rows, int D, int rpw,
                 float eps, int offset, const float* __restrict__ sums,
                 int d_norm) {
  constexpr int kVec = 16 / sizeof(T);        // elements a vector
  extern __shared__ __align__(16) float red[];  // [kRegsWarps][D]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nv = D / kVec;
  const long long r0 = ((long long)blockIdx.x * kRegsWarps + warp) * rpw;
  const long long r1 = r0 + rpw < rows ? r0 + rpw : rows;
  float* mine = red + warp * D;

  if (r0 >= r1) {          // a warp past the last row adds zeros
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lane + 32 * k;
      if (i < nv)
#pragma unroll
        for (int j = 0; j < kVec; ++j) mine[i * kVec + j] = 0.f;
    }
  }
  RowRegs<T, VPT> cur;
  if (r0 < r1) load_row(cur, x, dy, r0, nv, lane, D);
  for (long long r = r0; r < r1; ++r) {
    RowRegs<T, VPT> nxt;
    if (r + 1 < r1) load_row(nxt, x, dy, r + 1, nv, lane, D);
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lane + 32 * k;
      if (i >= nv) continue;
      const T* xe = reinterpret_cast<const T*>(&cur.x[k]);
      const T* ge = reinterpret_cast<const T*>(&cur.dy[k]);
      float wk[kVec];
      w_vec(wk, w, i, offset);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const float xf = to_f32(xe[j]);
        ss = fmaf(xf, xf, ss);
        dot = fmaf(to_f32(ge[j]) * wk[j], xf, dot);
      }
    }
    if (sums) {            // the row's totals over the ranks
      ss = sums[2 * r];
      dot = sums[2 * r + 1];
    } else {
      ss = warp_sum(ss);
      dot = warp_sum(dot);
    }
    const float rstd = rsqrtf(ss / (float)d_norm + eps);
    const float c = rstd * rstd * rstd * (dot / (float)d_norm);
    uint4* dxr = reinterpret_cast<uint4*>(dx + r * D);
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = lane + 32 * k;
      if (i >= nv) continue;
      const T* xe = reinterpret_cast<const T*>(&cur.x[k]);
      const T* ge = reinterpret_cast<const T*>(&cur.dy[k]);
      float wk[kVec];
      w_vec(wk, w, i, offset);
      float4* acc = reinterpret_cast<float4*>(mine + i * kVec);
      uint4 res;
      T* o = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int q = 0; q < kVec / 4; ++q) {
        float4 m = r == r0 ? make_float4(0.f, 0.f, 0.f, 0.f) : acc[q];
        float* mv = reinterpret_cast<float*>(&m);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = 4 * q + e;
          const float xf = to_f32(xe[j]), gy = to_f32(ge[j]);
          from_f32(o + j, rstd * (gy * wk[j]) - xf * c);
          mv[e] = fmaf(gy, xf * rstd, mv[e]);
        }
        acc[q] = m;
      }
      dxr[i] = res;
    }
    if (r + 1 < r1) cur = nxt;
  }
  __syncthreads();
  float* pb = part + (long long)blockIdx.x * D;
  for (int e = threadIdx.x; e < D; e += kRegsWarps * 32) {
    float t = 0.f;
    for (int q = 0; q < kRegsWarps; ++q) t += red[q * D + e];
    pb[e] = t;
  }
}

template <typename T, int VPT>
int launch_regs_vpt(const T* x, const float* w, const T* dy, T* dx,
                    float* part, long long rows, int D, int rpw, float eps,
                    int offset, unsigned nb, const float* sums, int d_norm,
                    cudaStream_t s) {
  rmsnorm_bwd_regs<T, VPT>
      <<<nb, kRegsWarps * 32, kRegsWarps * D * sizeof(float), s>>>(
          x, w, dy, dx, part, rows, D, rpw, eps, offset, sums, d_norm);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_regs(const void* x, const float* w, const void* dy, void* dx,
                float* part, float* dw, long long rows, int D, int rpw,
                float eps, int offset, int vpt, const float* sums, int d_norm,
                cudaStream_t s) {
  const long long per_block = (long long)kRegsWarps * rpw;
  const unsigned nb = (unsigned)((rows + per_block - 1) / per_block);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  T* ot = static_cast<T*>(dx);
  int e;
  switch (vpt) {
    case 1:
      e = launch_regs_vpt<T, 1>(xt, w, gt, ot, part, rows, D, rpw, eps,
                                offset, nb, sums, d_norm, s);
      break;
    case 2:
      e = launch_regs_vpt<T, 2>(xt, w, gt, ot, part, rows, D, rpw, eps,
                                offset, nb, sums, d_norm, s);
      break;
    case 4:
      e = launch_regs_vpt<T, 4>(xt, w, gt, ot, part, rows, D, rpw, eps,
                                offset, nb, sums, d_norm, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) return e;
  return sum_dw(part, dw, (int)nb, D, s);
}

}  // namespace

// x_dtype: 0 = f32, 1 = bf16 (x, dy and dx); w, dw and part are f32.  x,
// dy and dx are [rows, D] contiguous, part [blocks, D] scratch.  vpt = 0
// takes the loop route with rpb rows a block (blocks = ceil(rows / rpb));
// vpt in {1, 2, 4} the regs route with rpb rows a warp, 8 warps a block
// (blocks = ceil(rows / (8 rpb)); x, dy, dx and w 16-byte aligned, D a
// whole number of 16-byte vectors, at most 32 vpt of them).  The plan is
// the Python wrapper's.  sums: null (each row's own sums) or [rows, 2] f32,
// the rows' totals of x**2 and w' dy x over a whole row of d_norm elements
// (d_norm is D when sums is null).  Returns cudaGetLastError() after the
// launches (the first failing one's code).
extern "C" int rmsnorm_bwd_launch(const void* x, const float* w,
                                  const void* dy, void* dx, float* part,
                                  float* dw, long long rows, int D, int rpb,
                                  float eps, int offset, int x_dtype,
                                  int vpt, const float* sums, int d_norm,
                                  void* stream) {
  if (rows <= 0 || D <= 0) return 0;
  if (D > kMaxD || rpb < 1 || d_norm <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (vpt != 0) {
    const int vec = x_dtype == 1 ? 8 : 4;
    if (D % vec || D / vec > 32 * vpt) return (int)cudaErrorInvalidValue;
    return x_dtype == 1
               ? launch_regs<__nv_bfloat16>(x, w, dy, dx, part, dw, rows, D,
                                            rpb, eps, offset, vpt, sums,
                                            d_norm, s)
               : launch_regs<float>(x, w, dy, dx, part, dw, rows, D, rpb,
                                    eps, offset, vpt, sums, d_norm, s);
  }
  return x_dtype == 1
             ? launch<__nv_bfloat16>(x, w, dy, dx, part, dw, rows, D, rpb,
                                     eps, offset, sums, d_norm, s)
             : launch<float>(x, w, dy, dx, part, dw, rows, D, rpb, eps,
                             offset, sums, d_norm, s);
}

extern "C" const char* rmsnorm_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
