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
// kernel near its bound is memory- and latency-bound.  Two routes, chosen
// by the wrapper before the launch:
//
// * wgmma (bf16; Dh and Dv multiples of 16; 16-byte aligned base and
//   strides).  One warpgroup (128 threads) owns a 64-row query tile.  Q is
//   staged once and 64-key K/V tiles stream through a two-stage ring, all
//   bf16 in shared memory, by 16-byte cp.async copies (commit/wait groups):
//   the next tile's copy overlaps this tile's work.  Tiles are stored as
//   blocks of 64 columns in the 128-byte swizzle of the wgmma descriptors
//   (a row's 128 bytes in one shared-memory row, its 16-byte chunks
//   permuted by the row index), Q and K K-major, V MN-major (Dv contiguous,
//   the transpose bit); eight neighbouring threads copy one row, so the
//   reads are coalesced and the writes conflict-free.  S = Q K^T is Dh/16
//   `wgmma m64n64k16` from shared memory into f32 registers; it is scaled
//   in f32 after the product (in log2 units, so each p is one exp2), and
//   the masks (only on tiles some row does not see whole) and the online
//   softmax run on the accumulator fragment (a row's values sit in a quad
//   of lanes: two-step shuffles).  P is rounded to bf16 in registers, where
//   the accumulator layout of one product is the register-A layout of the
//   next, and O += P V runs as `wgmma` with A from registers.  The row sums
//   use the f32 p, in a fixed order.
// * simt (f32, Dh or Dv not a multiple of 16, unaligned views).  The f32
//   CUDA cores from shared memory: one block per (b, h, 64-row query tile),
//   8 warps of 8 query rows each; the query tile (pre-scaled) and one
//   64-key K/V tile at a time staged as f32; a lane scores two keys for its
//   warp's rows, a warp reduces the row max and sum with shuffles, and each
//   lane accumulates Dv/32 value columns in registers.  K rows are padded to
//   an odd stride so the lanes' reads of 32 keys fall in 32 banks.  f32
//   stays here because the tensor cores would round it to TF32.
//
// Both routes sum in a fixed order with no atomics: two calls give the same
// bits.  Given an lse buffer (the training forward), each route also writes
// every row's log-sum-exp of the scaled scores, which the backward kernel
// (csrc/flash_attention_bwd.cu) reads; O is computed as without it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kRows = 64;   // query rows per block
constexpr int kKeys = 64;   // keys per K/V tile
constexpr int kMaxD = 256;
constexpr float kNegInf = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [B, H, Sq] or null: each row's log-sum-exp, for training
  int B, Sq, Skv, H, Hkv, Dh, Dv;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, s, head
  int causal, window, q_offset, vec;
  float scale;
};

// The key tiles [t_lo, t_hi) that some query row of [q0, q0 + kRows) needs.
__device__ __forceinline__ void tile_range(const Args& a, int q0, int* t_lo,
                                           int* t_hi) {
  const int last = (q0 + kRows < a.Sq ? q0 + kRows : a.Sq) - 1;
  const int pos_lo = q0 + a.q_offset, pos_hi = last + a.q_offset;
  int hi = (a.Skv + kKeys - 1) / kKeys;
  if (a.causal) {
    const int c = pos_hi < 0 ? 0 : pos_hi / kKeys + 1;
    hi = c < hi ? c : hi;
  }
  int lo = 0;
  if (a.window) {
    const int first = pos_lo - a.window + 1;  // the first row's first key
    lo = first > 0 ? first / kKeys : 0;
  }
  *t_lo = lo;
  *t_hi = hi;
}

__device__ __forceinline__ bool key_visible(const Args& a, int key, int pos) {
  return key < a.Skv && (!a.causal || key <= pos) &&
         (!a.window || key > pos - a.window);
}

// ------------------------------------------------------------ wgmma route
namespace wg {

constexpr int kThreads = 128;  // one warpgroup
using namespace hopper;  // csrc/hopper_mma.cuh

// op over v[0..16), as a balanced tree (short dependency chains; a fixed
// order, so the same bits every call)
struct Max {
  __device__ float operator()(float x, float y) const { return fmaxf(x, y); }
};
struct Sum {
  __device__ float operator()(float x, float y) const { return x + y; }
};
template <typename Op>
__device__ __forceinline__ float tree16(const float (&v)[16], Op op) {
  float a[8], b[4];
#pragma unroll
  for (int x = 0; x < 8; ++x) a[x] = op(v[x], v[x + 8]);
#pragma unroll
  for (int x = 0; x < 4; ++x) b[x] = op(a[x], a[x + 4]);
  return op(op(b[0], b[2]), op(b[1], b[3]));
}

// Shared memory of the wgmma route: Q [64][Dh], and two stages of K [64][Dh]
// and V [64][DVP], each as blocks of 64 columns (8 KB, zero-padded), plus
// room to align the first block to 1024 bytes.
__host__ __device__ inline int smem_bytes(int Dh, int DVP) {
  const int kb = (Dh + 63) / 64, vb = (DVP + 63) / 64;
  return 8192 * (3 * kb + 2 * vb) + 1024;
}

// DVP: Dv rounded up to 16, 32, 64, 128 or 256; O is DVP / NW products of
// width NW = min(DVP, 64), one for each 64-column block of V.
template <int DVP>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_wgmma(Args a) {
  constexpr int NW = DVP < 64 ? DVP : 64;
  constexpr int NCH = DVP / NW;
  extern __shared__ __align__(1024) unsigned char smem[];
  const int Dh = a.Dh, kb = (Dh + 63) / 64, vb = NCH;
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t k_stage = 8192 * kb, v_stage = 8192 * vb;
  const uint32_t k_s = q_s + k_stage;            // [2][kb][64][64]
  const uint32_t v_s = k_s + 2 * k_stage;        // [2][vb][64][64]

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const __nv_bfloat16* qp =
      static_cast<const __nv_bfloat16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* kp =
      static_cast<const __nv_bfloat16*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const __nv_bfloat16* vp =
      static_cast<const __nv_bfloat16*>(a.v) + b * a.vs[0] + g * a.vs[2];

  int t_lo, t_hi;
  tile_range(a, q0, &t_lo, &t_hi);

  stage(q_s, qp, a.qs[1], q0, a.Sq, kb, Dh);
  if (t_lo < t_hi) {
    stage(k_s, kp, a.ks[1], t_lo * kKeys, a.Skv, kb, Dh);
    stage(v_s, vp, a.vs[1], t_lo * kKeys, a.Skv, vb, a.Dv);
  }
  cp_async_commit();

  // the thread's two rows in the tile (r and r + 8) and first column
  const int row_a = warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const int pos_a = q0 + row_a + a.q_offset;
  // the tile's first and last rows' positions, and scale * log2 e
  const int pos_lo = q0 + a.q_offset, pos_last = pos_lo + kRows - 1;
  const float c2 = a.scale * 1.4426950408889634f;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NCH][NW / 2];
#pragma unroll
  for (int c = 0; c < NCH; ++c)
#pragma unroll
    for (int x = 0; x < NW / 2; ++x) o[c][x] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile's copies overlap this tile's work
      stage(k_s + (st ^ 1) * k_stage, kp, a.ks[1], (t + 1) * kKeys, a.Skv,
            kb, Dh);
      stage(v_s + (st ^ 1) * v_stage, vp, a.vs[1], (t + 1) * kKeys, a.Skv,
            vb, a.Dv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    // this thread's copies, visible to the tensor cores' (async) proxy,
    // then everyone's
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T: k-step kk reads 32 bytes at (kk % 4) * 32 in the rows of
    // column block kk / 4 (Q and K are K-major)
    float s[32] = {};
    const uint32_t kt = k_s + st * k_stage;
    fence_regs(s);
    wg_fence();
    for (int kk = 0; kk < Dh / 16; ++kk) {
      const uint32_t off = (kk >> 2) * 8192 + (kk & 3) * 32;
      mma_ss_n64(s, desc_b128(q_s + off), desc_b128(kt + off), kk > 0);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);

    // masks and the online softmax on the fragment: s[n * 4 + i * 2 + j]
    // is row row_a + 8 i, key k0 + 8 n + col0 + j.  Scores are kept in
    // log2 units (scale * log2 e folded into one multiply) so that each p
    // is one exp2.  A tile that every row of the block sees whole skips
    // the masks.
    const int k0 = t * kKeys;
    const bool whole =
        k0 + kKeys <= a.Skv && (!a.causal || k0 + kKeys - 1 <= pos_lo) &&
        (!a.window || k0 > pos_last - a.window);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int pos = pos_a + 8 * i;
      // the row's visible keys are [kmin, kmax]
      const int kmax = a.causal && pos < a.Skv - 1 ? pos : a.Skv - 1;
      const int kmin = a.window ? pos - a.window + 1 : 0;
      // the row's 16 values here: v[2 n + j] = s[n * 4 + i * 2 + j]
      float v[16];
      uint32_t vis = 0xffffu;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          v[2 * n + j] = s[n * 4 + i * 2 + j];
          if (!whole) {
            const int key = k0 + 8 * n + col0 + j;
            if (key < kmin || key > kmax) {
              vis &= ~(1u << (n * 2 + j));
              v[2 * n + j] = kNegInf;
            }
          }
        }
      float mx = tree16(v, Max());
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx * c2);
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const float p = exp2f(fmaf(v[x], c2, -m_new));
        v[x] = (vis >> x) & 1u ? p : 0.f;
        s[(x >> 1) * 4 + i * 2 + (x & 1)] = v[x];
      }
      float ps = tree16(v, Sum());
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      const float corr = exp2f(m[i] - m_new);
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NCH; ++c)
#pragma unroll
        for (int n = 0; n < NW / 8; ++n) {
          o[c][n * 4 + i * 2] *= corr;
          o[c][n * 4 + i * 2 + 1] *= corr;
        }
    }

    // P (bf16) as the A operand: keys 16 kk .. 16 kk + 15 are the fragment
    // columns n = 2 kk (a[0], a[1]) and n = 2 kk + 1 (a[2], a[3])
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);

    // O += P V: V is MN-major; k-step kk reads keys 16 kk .. 16 kk + 15
    // (two groups of 8 rows, 2048 bytes on), product c column block c
    const uint32_t vt = v_s + st * v_stage;
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < NCH; ++c)
        mma_rs(o[c], pa[kk], desc_b128(vt + c * 8192 + kk * 2048));
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int c = 0; c < NCH; ++c) fence_regs(o[c]);
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

  __nv_bfloat16* op =
      static_cast<__nv_bfloat16*>(a.o) + b * a.os[0] + h * a.os[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_a + 8 * i;
    if (row >= a.Sq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    __nv_bfloat16* orow = op + (long long)row * a.os[1];
#pragma unroll
    for (int c = 0; c < NCH; ++c)
#pragma unroll
      for (int n = 0; n < NW / 8; ++n) {
        const int col = c * NW + n * 8 + col0;
        if (col < a.Dv)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(o[c][n * 4 + i * 2] * inv,
                                    o[c][n * 4 + i * 2 + 1] * inv);
      }
  }
  // the rows' log-sum-exp of the scaled scores in natural units (m and l
  // are in log2 units), for the backward kernel; O is not touched
  if (a.lse && (lane & 3) == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row_a + 8 * i;
      if (row < a.Sq)
        a.lse[((long long)b * a.H + h) * a.Sq + row] =
            (m[i] + log2f(fmaxf(l[i], 1e-30f))) * 0.6931471805599453f;
    }
  }
}

template <int DVP>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_wgmma<DVP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxD, DVP));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((a.Sq + kRows - 1) / kRows), (unsigned)a.H,
                  (unsigned)a.B);
  flash_attention_wgmma<DVP>
      <<<grid, kThreads, smem_bytes(a.Dh, DVP), s>>>(a);
  return (int)cudaGetLastError();
}

int launch_dv(const Args& a, cudaStream_t s) {
  if (a.Dv <= 16) return launch<16>(a, s);
  if (a.Dv <= 32) return launch<32>(a, s);
  if (a.Dv <= 64) return launch<64>(a, s);
  if (a.Dv <= 128) return launch<128>(a, s);
  return launch<256>(a, s);
}

}  // namespace wg

// ------------------------------------------------------------- simt route
namespace simt {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = kRows / kWarps;
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
flash_attention_simt(Args a) {
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
  int t_lo, t_hi;
  tile_range(a, q0, &t_lo, &t_hi);

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * kKeys;
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
      const bool v0 = key_visible(a, c0, pos), v1 = key_visible(a, c1, pos);
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
  // the rows' log-sum-exp of the scaled scores, for the backward kernel
  if (a.lse && lane == 0) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = q0 + wr0 + r;
      if (row < a.Sq)
        a.lse[((long long)b * a.H + h) * a.Sq + row] =
            m[r] + logf(fmaxf(l[r], 1e-30f));
    }
  }
}

template <typename T, int NC>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_simt<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem =
      4 * ((size_t)kRows * a.Dh + (size_t)kKeys * (a.Dh | 1) +
           (size_t)kKeys * a.Dv);
  const dim3 grid((unsigned)((a.Sq + kRows - 1) / kRows), (unsigned)a.H,
                  (unsigned)a.B);
  flash_attention_simt<T, NC><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, cudaStream_t s) {
  if (a.Dv <= 32) return launch<T, 1>(a, s);
  if (a.Dv <= 64) return launch<T, 2>(a, s);
  if (a.Dv <= 128) return launch<T, 4>(a, s);
  return launch<T, 8>(a, s);
}

}  // namespace simt

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and o alike).  lse: null, or [B, H,
// Sq] f32 to receive each row's log-sum-exp of the scaled scores (natural
// log; the backward kernel's input).  strides: 12 element
// strides, (batch, seq, head) of q, k, v, o in turn.  route: 0 = simt,
// 1 = wgmma (bf16, Dh and Dv multiples of 16, vec).  Sizes are checked by
// the Python wrapper (1 <= Dh, Dv <= 256, H % Hkv == 0), which also picks
// the route; a wgmma route the shape cannot take returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError() after
// the launch.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int B, int Sq,
                                      int Skv, int H, int Hkv, int Dh, int Dv,
                                      const long long* strides, int causal,
                                      int window, int q_offset, float scale,
                                      int dtype, int vec, int route,
                                      void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.lse = lse;
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
  if (route == 1) {
    if (dtype != 1 || !vec || Dh % 16 || Dv % 16 || Dh > kMaxD || Dv > kMaxD)
      return (int)cudaErrorInvalidValue;
    return wg::launch_dv(a, s);
  }
  return dtype == 1 ? simt::launch_t<__nv_bfloat16>(a, s)
                    : simt::launch_t<float>(a, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
