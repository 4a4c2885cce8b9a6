// Decode attention for Hopper: one new token per request against its KV
// cache.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention): for every batch b, query row s < Sq
// and query head h,
//   o[b, s, h, :] = softmax_j(scale * q[b, s, h, :] . k[b, j, g, :]) v[b, j, g, :]
// with g = h / (H / Hkv), scale = Dh**-0.5, over the cache rows
//   j < lengths[b]   and, with a window,   j >= lengths[b] - window.
// Scores, probabilities and the accumulator are f32, as on the TPU (an
// online softmax over key tiles; masked scores -1e30, the denominator
// max(l, 1e-30)).  Tiles at or past lengths[b], or wholly before the window,
// are skipped, so a short request in a batch does not pay for the longest.
//
// q is bf16 or f32 (the model's compute dtype), the caches bf16 or f32 (the
// serving caches are bf16); the output has q's dtype.  Tensors are
// [B, S, heads, D], read through their strides (last dimension contiguous).
// Dh and Dv are at most 256.
//
// What bounds it on the H100: bytes.  A decode step reads each request's
// cache rows below its length once (qwen2-0.5b at B = 8, mean length 256:
// ~1 MB a layer, ~0.3 us at 3.35 TB/s) and does 4 FLOPs per cached value
// per query head.  Design: one block per (b, kv head), which serves all
// H / Hkv query heads of the group (7 for qwen2-0.5b), so each K/V tile is
// read from device memory once for the group.  Eight warps take one query
// row each (more rows take more passes); a 64-row K/V tile is staged in
// shared memory as f32 with 16-byte loads where the strides allow, a lane
// scores two keys, a warp reduces with shuffles, and each lane accumulates
// Dv/32 value columns in registers.  Splitting a long cache across blocks
// (flash decoding proper) is later work: at B * Hkv = 16 blocks the card
// is mostly idle.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kKeys = 64;  // cache rows per K/V tile
constexpr int kWarps = 8;  // query rows per pass
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
// Q [8][Dh] + K [64][Dh | 1] + V [64][Dv], f32, at Dh = Dv = 256
constexpr int kMaxSmemBytes =
    4 * (kWarps * kMaxD + kKeys * (kMaxD + 1) + kKeys * kMaxD);

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int32_t* lengths;
  void* o;
  int B, Sq, S, H, Hkv, Dh, Dv;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, s, head
  int window, vec;
  float scale;
};

// Stage cache rows [row0, row0 + kKeys) of one kv head as f32 into
// dst[kKeys][ld]; rows at or past `rows` read as 0.  With `vec` (D, the
// strides and the base 16-byte aligned) each thread moves 16 bytes.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = D / kVec;
    for (int i = threadIdx.x; i < kKeys * per_row; i += kThreads) {
      const int r = i / per_row, d = (i - r * per_row) * kVec;
      float* out = dst + r * ld + d;
      if (row0 + r < rows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * s_row + d);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int x = 0; x < kVec; ++x) out[x] = to_f32(e[x]);
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) out[x] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < kKeys * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      dst[r * ld + d] =
          row0 + r < rows ? to_f32(src[(long long)(row0 + r) * s_row + d])
                          : 0.f;
    }
  }
}

// NC = value columns per lane (Dv <= 32 * NC)
template <typename TQ, typename TC, int NC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int ks_ld = a.Dh | 1;  // odd stride: conflict-free key reads
  float* Qs = smem;
  float* Ks = Qs + kWarps * a.Dh;
  float* Vs = Ks + kKeys * ks_ld;

  const int g = blockIdx.x;
  const int b = blockIdx.y;
  const int rep = a.H / a.Hkv;
  const int rows = rep * a.Sq;  // query rows of the group: (head, s)
  const int len = a.lengths[b] < a.S ? a.lengths[b] : a.S;
  const int lo = a.window ? len - a.window : 0;  // first visible row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = a.vec != 0;

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qs[0];
  const TC* kp = static_cast<const TC*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const TC* vp = static_cast<const TC*>(a.v) + b * a.vs[0] + g * a.vs[2];
  TQ* op = static_cast<TQ*>(a.o) + b * a.os[0];

  for (int r0 = 0; r0 < rows; r0 += kWarps) {
    __syncthreads();  // the previous pass is done with shared memory
    for (int i = threadIdx.x; i < kWarps * a.Dh; i += kThreads) {
      const int w = i / a.Dh, d = i - w * a.Dh, row = r0 + w;
      float x = 0.f;
      if (row < rows) {
        const int hh = row / a.Sq, s = row - hh * a.Sq;
        x = to_f32(qp[s * a.qs[1] + (g * rep + hh) * a.qs[2] + d]) * a.scale;
      }
      Qs[i] = x;
    }
    float m = kNegInf, l = 0.f, acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = 0.f;
    const float* qr = Qs + warp * a.Dh;

    for (int k0 = 0; k0 < len; k0 += kKeys) {
      if (a.window && k0 + kKeys <= lo) continue;  // wholly before the window
      __syncthreads();  // Qs written / the previous tile consumed
      stage(Ks, ks_ld, kp, a.ks[1], k0, len, a.Dh, vec);
      stage(Vs, a.Dv, vp, a.vs[1], k0, len, a.Dv, vec);
      __syncthreads();

      const float* k_lo = Ks + lane * ks_ld;
      const float* k_hi = Ks + (lane + 32) * ks_ld;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < a.Dh; ++d) {
        const float qv = qr[d];
        s0 = fmaf(qv, k_lo[d], s0);
        s1 = fmaf(qv, k_hi[d], s1);
      }
      const int c0 = k0 + lane, c1 = k0 + lane + 32;
      const bool v0 = c0 < len && c0 >= lo, v1 = c1 < len && c1 >= lo;
      const float x0 = v0 ? s0 : kNegInf, x1 = v1 ? s1 : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m, mx);
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m - m_new);
      l = l * corr + ps;
      m = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c] *= corr;
      for (int j = 0; j < 32; ++j) {
        const float pa = __shfl_sync(0xffffffffu, p0, j);
        const float pb = __shfl_sync(0xffffffffu, p1, j);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int col = c * 32 + lane;
          if (col < a.Dv)
            acc[c] = fmaf(pa, Vs[j * a.Dv + col],
                          fmaf(pb, Vs[(j + 32) * a.Dv + col], acc[c]));
        }
      }
    }

    const int row = r0 + warp;
    if (row < rows) {
      const int hh = row / a.Sq, s = row - hh * a.Sq;
      TQ* orow = op + s * a.os[1] + (g * rep + hh) * a.os[2];
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        if (col < a.Dv) store(orow + col, acc[c] * inv);
      }
    }
  }
}

template <typename TQ, typename TC, int NC>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TC, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 4 * ((size_t)kWarps * a.Dh +
                           (size_t)kKeys * (a.Dh | 1) + (size_t)kKeys * a.Dv);
  const dim3 grid((unsigned)a.Hkv, (unsigned)a.B);
  decode_attention_kernel<TQ, TC, NC><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC>
int launch_nc(const Args& a, cudaStream_t s) {
  if (a.Dv <= 32) return launch<TQ, TC, 1>(a, s);
  if (a.Dv <= 64) return launch<TQ, TC, 2>(a, s);
  if (a.Dv <= 128) return launch<TQ, TC, 4>(a, s);
  return launch<TQ, TC, 8>(a, s);
}

}  // namespace

// q_dtype / c_dtype: 0 = f32, 1 = bf16 (o has q's dtype).  strides: 12
// element strides, (batch, seq, head) of q, k, v, o in turn.  lengths: [B]
// int32 on the device.  Sizes are checked by the Python wrapper
// (1 <= Dh, Dv <= 256, H % Hkv == 0).  Returns cudaGetLastError() after the
// launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, int B, int Sq, int S, int H,
                                       int Hkv, int Dh, int Dv,
                                       const long long* strides, int window,
                                       float scale, int q_dtype, int c_dtype,
                                       int vec, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.o = o;
  a.B = B;
  a.Sq = Sq;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.Dv = Dv;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.os[i] = strides[9 + i];
  }
  a.window = window;
  a.vec = vec;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (q_dtype == 1)
    return c_dtype == 1 ? launch_nc<__nv_bfloat16, __nv_bfloat16>(a, s)
                        : launch_nc<__nv_bfloat16, float>(a, s);
  return c_dtype == 1 ? launch_nc<float, __nv_bfloat16>(a, s)
                      : launch_nc<float, float>(a, s);
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
