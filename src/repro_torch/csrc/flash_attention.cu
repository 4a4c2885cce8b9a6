// Flash attention forward for Hopper: prefill of the dense decoder.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fwd_kernel / flash_attention): for every batch b, query head h and query
// row i,
//   o[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, g, :]) v[b, j, g, :]
// with g = h / (H / Hkv) (GQA: the shared kv head is read directly, never
// repeated), scale = Dh**-0.5, over the keys j that the masks keep:
//   j < Skv;  j <= i + q_offset (causal);  j > i + q_offset - window (window).
// Scores, the running max, the denominator and the accumulator are f32 (an
// online softmax over key tiles); masked scores are -1e30 and the
// denominator is max(l, 1e-30), as in the TPU kernel, so a row every key of
// which is masked comes out 0.  Key tiles that no row of the block needs
// (above the causal diagonal, wholly before the window) are skipped, so a
// windowed layer costs O(S * window).
//
// Tensors are [B, S, heads, D] and read through their strides (the last
// dimension contiguous); nothing is transposed or copied.  q, k and v share
// one dtype (bf16 or f32); the output has it too.  Dh and Dv are at most 256.
//
// What bounds it on the H100: at the serving shapes (S = 256, Dh = 64) the
// bytes are ~7 MB (q, k, v read once, o written once: ~2 us at 3.35 TB/s)
// and the products ~1 GFLOP causal (~1 us on the bf16 tensor cores), so a
// kernel near its bound would be memory-bound.  This first design keeps the
// arithmetic on the f32 CUDA cores and shared memory instead of the tensor
// cores: one block per (b, h, 64-row query tile), 8 warps of 8 query rows
// each.  The block stages its query tile (pre-scaled) and one 64-key K/V
// tile at a time in shared memory as f32; a lane computes the scores of two
// keys for its warp's 8 rows, a warp reduces the row max and sum with
// shuffles, and each lane accumulates Dv/32 value columns of its warp's rows
// in registers.  K rows are padded to an odd stride so the lanes' reads of
// 32 different keys fall in 32 banks.  Loads are 16 bytes a thread where the
// strides allow it.  wgmma, TMA and a pipelined tile ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;                  // query rows per block
constexpr int kKeys = 64;                  // keys per K/V tile
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;
// Q [64][Dh] + K [64][Dh | 1] + V [64][Dv], f32, at Dh = Dv = 256
constexpr int kMaxSmemBytes =
    4 * (kRows * kMaxD + kKeys * (kMaxD + 1) + kKeys * kMaxD);

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
  void* o;
  int B, Sq, Skv, H, Hkv, Dh, Dv;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, s, head
  int causal, window, q_offset, vec;
  float scale;
};

// Stage rows [row0, row0 + n) of one head of a [B, S, heads, D] tensor as f32
// into dst[n][ld], times mul; rows at or past `rows` read as 0.  With `vec`
// (D, the strides and the base 16-byte aligned) each thread moves 16 bytes.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D, int n, float mul, bool vec) {
  if (vec) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = D / kVec;
    for (int i = threadIdx.x; i < n * per_row; i += kThreads) {
      const int r = i / per_row, d = (i - r * per_row) * kVec;
      float* out = dst + r * ld + d;
      if (row0 + r < rows) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            src + (long long)(row0 + r) * s_row + d);
        const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
        for (int x = 0; x < kVec; ++x) out[x] = to_f32(e[x]) * mul;
      } else {
#pragma unroll
        for (int x = 0; x < kVec; ++x) out[x] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int r = i / D, d = i - r * D;
      dst[r * ld + d] =
          row0 + r < rows ? to_f32(src[(long long)(row0 + r) * s_row + d]) * mul
                          : 0.f;
    }
  }
}

// NC = value columns per lane (Dv <= 32 * NC)
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(Args a) {
  extern __shared__ float smem[];
  const int ks_ld = a.Dh | 1;  // odd stride: conflict-free key reads
  float* Qs = smem;
  float* Ks = Qs + kRows * a.Dh;
  float* Vs = Ks + kKeys * ks_ld;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool vec = a.vec != 0;

  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + g * a.vs[2];
  stage(Qs, a.Dh, qp, a.qs[1], q0, a.Sq, a.Dh, kRows, a.scale, vec);

  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][NC];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  }
  const int wr0 = warp * kRowsPerWarp;  // the warp's first row in the tile
  // absolute positions of the block's first and last real query rows
  const int last = (q0 + kRows < a.Sq ? q0 + kRows : a.Sq) - 1;
  const int pos_lo = q0 + a.q_offset, pos_hi = last + a.q_offset;

  for (int k0 = 0; k0 < a.Skv; k0 += kKeys) {
    if (a.causal && k0 > pos_hi) break;                            // above
    if (a.window && k0 + kKeys - 1 <= pos_lo - a.window) continue;  // before
    __syncthreads();  // the previous tile is consumed
    stage(Ks, ks_ld, kp, a.ks[1], k0, a.Skv, a.Dh, kKeys, 1.f, vec);
    stage(Vs, a.Dv, vp, a.vs[1], k0, a.Skv, a.Dv, kKeys, 1.f, vec);
    __syncthreads();

    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
    float s0[kRowsPerWarp], s1[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) s0[r] = s1[r] = 0.f;
    const float* k_lo = Ks + lane * ks_ld;
    const float* k_hi = Ks + (lane + 32) * ks_ld;
    for (int d = 0; d < a.Dh; ++d) {
      const float x0 = k_lo[d], x1 = k_hi[d];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float qv = Qs[(wr0 + r) * a.Dh + d];
        s0[r] = fmaf(qv, x0, s0[r]);
        s1[r] = fmaf(qv, x1, s1[r]);
      }
    }

    const int c0 = k0 + lane, c1 = k0 + lane + 32;
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int pos = q0 + wr0 + r + a.q_offset;
      bool v0 = c0 < a.Skv, v1 = c1 < a.Skv;
      if (a.causal) {
        v0 = v0 && c0 <= pos;
        v1 = v1 && c1 <= pos;
      }
      if (a.window) {
        v0 = v0 && c0 > pos - a.window;
        v1 = v1 && c1 > pos - a.window;
      }
      const float x0 = v0 ? s0[r] : kNegInf, x1 = v1 ? s1[r] : kNegInf;
      float mx = fmaxf(x0, x1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = v0 ? expf(x0 - m_new) : 0.f;
      const float p1 = v1 ? expf(x1 - m_new) : 0.f;
      float ps = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + ps;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
      s0[r] = p0;
      s1[r] = p1;
    }

    // acc[r][c] += sum_j p[r][j] * V[j][c * 32 + lane]
    for (int j = 0; j < 32; ++j) {
      float va[NC], vb[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        va[c] = col < a.Dv ? Vs[j * a.Dv + col] : 0.f;
        vb[c] = col < a.Dv ? Vs[(j + 32) * a.Dv + col] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const float pa = __shfl_sync(0xffffffffu, s0[r], j);
        const float pb = __shfl_sync(0xffffffffu, s1[r], j);
#pragma unroll
        for (int c = 0; c < NC; ++c)
          acc[r][c] = fmaf(pa, va[c], fmaf(pb, vb[c], acc[r][c]));
      }
    }
  }

  T* op = static_cast<T*>(a.o) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = q0 + wr0 + r;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = c * 32 + lane;
      if (col < a.Dv) store(op + row * a.os[1] + col, acc[r][c] * inv);
    }
  }
}

template <typename T, int NC>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, NC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem =
      4 * ((size_t)kRows * a.Dh + (size_t)kKeys * (a.Dh | 1) +
           (size_t)kKeys * a.Dv);
  const dim3 grid((unsigned)((a.Sq + kRows - 1) / kRows), (unsigned)a.H,
                  (unsigned)a.B);
  flash_attention_kernel<T, NC><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, cudaStream_t s) {
  if (a.Dv <= 32) return launch<T, 1>(a, s);
  if (a.Dv <= 64) return launch<T, 2>(a, s);
  if (a.Dv <= 128) return launch<T, 4>(a, s);
  return launch<T, 8>(a, s);
}

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike).  strides: 12 element
// strides, (batch, seq, head) of q, k, v, o in turn.  Sizes are checked by
// the Python wrapper (1 <= Dh, Dv <= 256, H % Hkv == 0).  Returns
// cudaGetLastError() after the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int B, int Sq,
                                      int Skv, int H, int Hkv, int Dh, int Dv,
                                      const long long* strides, int causal,
                                      int window, int q_offset, float scale,
                                      int dtype, int vec, void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
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
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.vec = vec;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
