// Flash attention backward for Hopper: the gradients of the training step.
//
// Replaces no TPU kernel: the JAX package trains through XLA's autodiff of
// the plain attention its dispatcher takes off the TPU
// (src/repro/kernels/attention/ops.py), so it has no backward Pallas
// kernel.  The port's forward is the CUDA kernel csrc/flash_attention.cu,
// which autograd cannot differentiate, so its backward is this kernel
// (kernels/attention/ops.py binds the two in a torch.autograd.Function).
//
// For every batch b, query head h (kv head g = h / (H / Hkv)), query row i
// and visible key j (the forward's masks: j < Skv; j <= i + q_offset when
// causal; j > i + q_offset - window with a window), with the forward's
// log-sum-exp lse[b, h, i] of the scaled scores:
//   P[i, j]  = exp(scale * q_i . k_j - lse_i)
//   dP[i, j] = dO_i . v_j
//   delta_i  = dO_i . O_i
//   dS[i, j] = P[i, j] (dP[i, j] - delta_i)
//   dq_i = scale * sum_j dS[i, j] k_j
//   dk_j = scale * sum_{h in g, i} dS[i, j] q_i
//   dv_j = sum_{h in g, i} P[i, j] dO_i
// This is FlashAttention-2's backward in its deterministic form: no
// atomics.  Every sum runs in a fixed order (a thread's products in turn,
// tiles and heads in order), so two calls give the same bits; the
// gradients are rounded once, to the inputs' dtype, at the end.
//
// What bounds it on the H100.  At qwen2-0.5b's training shape (B 4, S
// 1,024, 14 query heads over 2 kv heads, Dh 64, causal) the five products
// (S, dP, P^T dO, dS^T Q, dS K) are 2 (3 Dh + 2 Dv) FLOPs a visible pair,
// 18.8 GFLOP over the causal half, against ~32 MB read and written once:
// operations bound it, ~19 us on the bf16 tensor cores.  Two routes, chosen
// by the wrapper (kernels/flash_attention/kernel.py::bwd_route, the
// forward's rule over q, k, v, o and dO):
//
// * wgmma (bf16; Dh and Dv multiples of 16; 16-byte aligned base and
//   strides).  Every product is a `wgmma` on bf16 tiles in shared memory
//   (the helpers of csrc/hopper_mma.cuh, the forward's: 64-row tiles in the
//   128-byte swizzle, copied by 16-byte cp.async through a two-stage ring,
//   each thread's copy offsets worked out once), one warpgroup a block, in
//   three launches:
//   1. dQ, a block per (64-row query tile, query head, batch), the
//      heaviest (causal: the last) tiles first.  Q and dO stay in shared
//      memory; the block computes delta for its rows (written out for
//      launch 2); K and V tiles stream through the ring, skipping those no
//      row sees.  S = Q K^T and dP = dO V^T from shared memory in one
//      group; P and dS = P (dP - delta) on the accumulator fragment (the
//      masks only on tiles some row does not see whole), dS rounded to
//      bf16 in registers, where the accumulator layout of one product is
//      the register-A layout of the next: dQ += dS K with K read MN-major
//      (the transpose bit, as the forward reads V).
//   2. dK and dV, keys the M dimension: a block per (64-key tile, QUERY
//      head, batch), the heaviest (causal: the first) key tiles first.  K
//      and V stay in shared memory; Q, dO and the rows' lse and delta
//      stream through the ring.  S^T = K Q^T and dP^T = V dO^T give P^T
//      and dS^T in accumulator layout; rounded to bf16 they are the
//      register-A operands of dV += P^T dO and dK += dS^T Q (dO and Q read
//      MN-major).  The grid: one block a kv head would be 128 blocks at
//      qwen2's shape on 132 SMs, key tile 0 walking 7 heads x 16 query
//      tiles and key tile 15 7 x 1; a block a query head is 896 blocks,
//      and with the heaviest first the card stays full.  Its cost: with a
//      GQA group (H > Hkv) each block writes f32 partials of dK and dV for
//      its query head ([B, H, Skv, D], 29 MB at qwen2's shape, written and
//      read once: ~9 us at 3.35 TB/s), and
//   3. a small launch sums the group's partials in head order, scales dK
//      and rounds once.  Without a group (H == Hkv) launch 2 writes dK and
//      dV itself and launch 3 does not run.
//   Left out, being slower or no faster on the H100: walking 2 heads a
//   block (4 partials a key instead of 7, but 512 blocks), the group's
//   heads as one thread block cluster summing through distributed shared
//   memory (no launch 3, but 7-block clusters schedule badly), two query
//   tiles a dQ block sharing the K/V ring.
//   S, dP, lse, delta and every sum over tiles stay f32; P and dS are
//   rounded to bf16 before the products that consume them, as the
//   forward's wgmma route rounds P.  A dQ block owns one 64-column chunk of
//   dQ and a dK/dV block one chunk of dK and one of dV (64 f32 accumulator
//   registers a thread beside S and dP): wider heads (Dh 128 and up,
//   MLA's 192 / 128) take more blocks a tile, each recomputing S and dP;
//   a head dim with fewer chunks than the other repeats its last one,
//   computed and not written.  Shared memory is 24 blocks of 8 KB at
//   Dh = Dv = 256 (197 KB), so every head dim keeps 64 x 64 tiles.  The
//   register budget keeps 4 dQ blocks (126 registers) and 3 dK/dV blocks
//   (164) resident on an SM.
// * simt (f32, head dims not multiples of 16, unaligned views).  The f32
//   CUDA cores from shared memory, in two launches:
//   1. dq: a block per (query tile, h, b).  It computes delta for its rows
//      (written out for launch 2), then loops over the key tiles its rows
//      see (the forward's tile skipping), recomputing P and dP, and sums
//      dq in registers.
//   2. dk / dv: a block per (key tile, g, b).  It loops over the group's
//      query heads in order and, for each, over the query tiles that can
//      see the tile (causal, window and q_offset limits), recomputing P
//      and dP, and sums dk and dv in registers.
//   Every input is staged as f32 (bf16 widened on the way), and each
//   product is a 16 x 16 grid of threads, a thread owning a (TILE/16) x
//   (TILE/16) block of a TILE x TILE score tile (rows ty + 16 a, columns
//   tx + 16 b) or a (TILE/16) x (D/16) block of a TILE x D gradient tile,
//   so a lane's loads in a step are one row broadcast and 16 consecutive
//   words.  Rows of D-wide tiles are padded to 32k + 1 words
//   (conflict-free column walks), score tiles to TILE + 16.  TILE is 64
//   for head dims up to 128 and 32 up to 256, which keeps shared memory
//   under 180 KB.  It recomputes S and dP in both launches (seven products
//   a pair) on 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_mma.cuh"

namespace {

constexpr int kThreads = 256;   // a 16 x 16 grid
constexpr int kMaxD = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;     // [B, H, Sq], natural log of the scaled scores
  float* delta;         // [B, H, Sq], written by launch 1
  void* dq;
  void* dk;
  void* dv;
  int B, Sq, Skv, H, Hkv, Dh, Dv;
  // element strides of (batch, seq, head): q, k, v, o, dout, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int causal, window, q_offset;
  float scale;
  // wgmma route with H > Hkv: each query head's f32 partials of dK and dV,
  // [B, H, Skv, Dh] and [B, H, Skv, Dv], summed by launch 3
  float* dkp;
  float* dvp;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ bool key_visible(const Args& a, int key, int pos) {
  return key < a.Skv && (!a.causal || key <= pos) &&
         (!a.window || key > pos - a.window);
}

// the padded row stride of a D-wide tile: 32k + 1 words
__host__ __device__ constexpr int ld_of(int D) {
  return (D + 31) / 32 * 32 + 1;
}

template <int TILE>
__host__ __device__ constexpr size_t smem_floats(int Dh, int Dv) {
  return (size_t)TILE * (2 * ld_of(Dh) + 2 * ld_of(Dv) + 2 * (TILE + 16)) +
         2 * TILE;
}

// rows [row0, row0 + TILE) of one head of a [B, S, heads, D] tensor into
// dst[TILE][ld] as f32; rows at or past `rows` read as 0
template <typename T, int TILE>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D) {
  for (int i = threadIdx.x; i < TILE * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] = row0 + r < rows
                          ? to_f32(src[(long long)(row0 + r) * s_row + d])
                          : 0.f;
  }
}

// s[x][y] = sum_d A[ty + 16 x][d] B[tx + 16 y][d], d < D
template <int NI>
__device__ __forceinline__ void scores(float (&s)[NI][NI], const float* A,
                                       const float* Bm, int ld, int D,
                                       int ty, int tx) {
#pragma unroll
  for (int x = 0; x < NI; ++x)
#pragma unroll
    for (int y = 0; y < NI; ++y) s[x][y] = 0.f;
  for (int d = 0; d < D; ++d) {
    float av[NI], bv[NI];
#pragma unroll
    for (int x = 0; x < NI; ++x) {
      av[x] = A[(ty + 16 * x) * ld + d];
      bv[x] = Bm[(tx + 16 * x) * ld + d];
    }
#pragma unroll
    for (int x = 0; x < NI; ++x)
#pragma unroll
      for (int y = 0; y < NI; ++y) s[x][y] = fmaf(av[x], bv[y], s[x][y]);
  }
}

// acc[x][c] += sum_r M[r][ty + 16 x] Bm[r][tx + 16 c] over r < TILE, for
// the columns tx + 16 c < D (M a TILE x TILE tile, row stride TILE + 16;
// Bm a TILE x D tile, row stride ld).  With kTrans M is read as
// M[ty + 16 x][r] instead.
template <int TILE, int NC, bool kTrans>
__device__ __forceinline__ void accumulate(float (&acc)[TILE / 16][NC],
                                           const float* M, const float* Bm,
                                           int ld, int D, int ty, int tx) {
  constexpr int NI = TILE / 16;
  constexpr int LM = TILE + 16;
  for (int r = 0; r < TILE; ++r) {
    float mv[NI];
#pragma unroll
    for (int x = 0; x < NI; ++x)
      mv[x] = kTrans ? M[(ty + 16 * x) * LM + r] : M[r * LM + ty + 16 * x];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        const float bv = Bm[r * ld + col];
#pragma unroll
        for (int x = 0; x < NI; ++x) acc[x][c] = fmaf(mv[x], bv, acc[x][c]);
      }
    }
  }
}

// P and dS of one (query tile, key tile) pair into Ps / dSs [TILE][TILE +
// 16] (rows the queries, columns the keys); P is 0 where a key is masked
// or a row is past Sq.
template <int TILE>
__device__ __forceinline__ void probs(const Args& a, const float* Qs,
                                      const float* Ks, const float* dOs,
                                      const float* Vs, const float* lse_s,
                                      const float* dl_s, float* Ps,
                                      float* dSs, int q0, int k0, int ty,
                                      int tx) {
  constexpr int NI = TILE / 16;
  constexpr int LM = TILE + 16;
  const int ldh = ld_of(a.Dh), ldv = ld_of(a.Dv);
  float s[NI][NI], dp[NI][NI];
  scores<NI>(s, Qs, Ks, ldh, a.Dh, ty, tx);
  scores<NI>(dp, dOs, Vs, ldv, a.Dv, ty, tx);
#pragma unroll
  for (int x = 0; x < NI; ++x) {
    const int i = ty + 16 * x;
    const int pos = q0 + i + a.q_offset;
    const bool row_ok = q0 + i < a.Sq;
#pragma unroll
    for (int y = 0; y < NI; ++y) {
      const int j = tx + 16 * y;
      const bool vis = row_ok && key_visible(a, k0 + j, pos);
      const float p = vis ? expf(s[x][y] * a.scale - lse_s[i]) : 0.f;
      if (Ps) Ps[i * LM + j] = p;
      dSs[i * LM + j] = p * (dp[x][y] - dl_s[i]);
    }
  }
}

// ------------------------------------------------------------- launch 1
template <typename T, int TILE, int DP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dq(Args a) {
  constexpr int NI = TILE / 16, NC = DP / 16;
  extern __shared__ float smem[];
  const int ldh = ld_of(a.Dh), ldv = ld_of(a.Dv);
  float* Qs = smem;
  float* Ks = Qs + TILE * ldh;
  float* dOs = Ks + TILE * ldh;
  float* Vs = dOs + TILE * ldv;
  float* dSs = Vs + TILE * ldv;
  float* lse_s = dSs + 2 * TILE * (TILE + 16);
  float* dl_s = lse_s + TILE;

  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (a.H / a.Hkv);
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + g * a.vs[2];
  const T* op = static_cast<const T*>(a.o) + b * a.os[0] + h * a.os[2];
  const T* dop = static_cast<const T*>(a.dout) + b * a.dos[0] + h * a.dos[2];
  const long long stat = ((long long)b * a.H + h) * a.Sq;

  stage<T, TILE>(Qs, ldh, qp, a.qs[1], q0, a.Sq, a.Dh);
  stage<T, TILE>(dOs, ldv, dop, a.dos[1], q0, a.Sq, a.Dv);
  __syncthreads();
  // delta_i = dO_i . O_i: a warp a row, lanes over the columns, then a
  // shuffle tree
  for (int i = warp; i < TILE; i += kThreads / 32) {
    const int row = q0 + i;
    float acc = 0.f;
    if (row < a.Sq)
      for (int e = lane; e < a.Dv; e += 32)
        acc = fmaf(dOs[i * ldv + e], to_f32(op[(long long)row * a.os[1] + e]),
                   acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      dl_s[i] = acc;
      lse_s[i] = row < a.Sq ? a.lse[stat + row] : 0.f;
      if (row < a.Sq) a.delta[stat + row] = acc;
    }
  }

  // the key tiles some row of the tile sees (the forward's skipping)
  const int last = (q0 + TILE < a.Sq ? q0 + TILE : a.Sq) - 1;
  int t_hi = (a.Skv + TILE - 1) / TILE, t_lo = 0;
  if (a.causal) {
    const int p = last + a.q_offset;
    const int c = p < 0 ? 0 : p / TILE + 1;
    t_hi = c < t_hi ? c : t_hi;
  }
  if (a.window) {
    const int first = q0 + a.q_offset - a.window + 1;
    t_lo = first > 0 ? first / TILE : 0;
  }

  float acc[NI][NC];
#pragma unroll
  for (int x = 0; x < NI; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[x][c] = 0.f;
  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the previous tile is consumed
    stage<T, TILE>(Ks, ldh, kp, a.ks[1], k0, a.Skv, a.Dh);
    stage<T, TILE>(Vs, ldv, vp, a.vs[1], k0, a.Skv, a.Dv);
    __syncthreads();
    probs<TILE>(a, Qs, Ks, dOs, Vs, lse_s, dl_s, nullptr, dSs, q0, k0, ty,
                tx);
    __syncthreads();
    // dq[i][d] += sum_j dS[i][j] K[j][d]
    accumulate<TILE, NC, true>(acc, dSs, Ks, ldh, a.Dh, ty, tx);
  }

  T* dqp = static_cast<T*>(a.dq) + b * a.dqs[0] + h * a.dqs[2];
#pragma unroll
  for (int x = 0; x < NI; ++x) {
    const int row = q0 + ty + 16 * x;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.Dh)
        store(dqp + (long long)row * a.dqs[1] + col, acc[x][c] * a.scale);
    }
  }
}

// ------------------------------------------------------------- launch 2
template <typename T, int TILE, int DP>
__global__ void __launch_bounds__(kThreads)
attn_bwd_dkdv(Args a) {
  constexpr int NI = TILE / 16, NC = DP / 16;
  extern __shared__ float smem[];
  const int ldh = ld_of(a.Dh), ldv = ld_of(a.Dv);
  float* Qs = smem;
  float* Ks = Qs + TILE * ldh;
  float* dOs = Ks + TILE * ldh;
  float* Vs = dOs + TILE * ldv;
  float* Ps = Vs + TILE * ldv;
  float* dSs = Ps + TILE * (TILE + 16);
  float* lse_s = dSs + TILE * (TILE + 16);
  float* dl_s = lse_s + TILE;

  const int k0 = blockIdx.x * TILE, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hkv;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + g * a.vs[2];
  stage<T, TILE>(Ks, ldh, kp, a.ks[1], k0, a.Skv, a.Dh);
  stage<T, TILE>(Vs, ldv, vp, a.vs[1], k0, a.Skv, a.Dv);

  // the query rows that can see a key of [k0, k1]
  const int k1 = (k0 + TILE < a.Skv ? k0 + TILE : a.Skv) - 1;
  int i_lo = 0, i_hi = a.Sq - 1;
  if (a.causal && k0 - a.q_offset > i_lo) i_lo = k0 - a.q_offset;
  if (a.window && k1 + a.window - 1 - a.q_offset < i_hi)
    i_hi = k1 + a.window - 1 - a.q_offset;

  float dk[NI][NC], dv[NI][NC];
#pragma unroll
  for (int x = 0; x < NI; ++x)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[x][c] = dv[x][c] = 0.f;
  for (int hh = 0; hh < rep && i_lo <= i_hi; ++hh) {
    const int h = g * rep + hh;
    const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
    const T* dop =
        static_cast<const T*>(a.dout) + b * a.dos[0] + h * a.dos[2];
    const long long stat = ((long long)b * a.H + h) * a.Sq;
    for (int qt = i_lo / TILE; qt <= i_hi / TILE; ++qt) {
      const int q0 = qt * TILE;
      __syncthreads();  // the previous query tile is consumed
      stage<T, TILE>(Qs, ldh, qp, a.qs[1], q0, a.Sq, a.Dh);
      stage<T, TILE>(dOs, ldv, dop, a.dos[1], q0, a.Sq, a.Dv);
      for (int i = threadIdx.x; i < TILE; i += kThreads) {
        const bool ok = q0 + i < a.Sq;
        lse_s[i] = ok ? a.lse[stat + q0 + i] : 0.f;
        dl_s[i] = ok ? a.delta[stat + q0 + i] : 0.f;
      }
      __syncthreads();
      probs<TILE>(a, Qs, Ks, dOs, Vs, lse_s, dl_s, Ps, dSs, q0, k0, ty, tx);
      __syncthreads();
      // dv[j][e] += sum_i P[i][j] dO[i][e]; dk[j][d] += sum_i dS[i][j] Q[i][d]
      accumulate<TILE, NC, false>(dv, Ps, dOs, ldv, a.Dv, ty, tx);
      accumulate<TILE, NC, false>(dk, dSs, Qs, ldh, a.Dh, ty, tx);
    }
  }

  T* dkp = static_cast<T*>(a.dk) + b * a.dks[0] + g * a.dks[2];
  T* dvp = static_cast<T*>(a.dv) + b * a.dvs[0] + g * a.dvs[2];
#pragma unroll
  for (int x = 0; x < NI; ++x) {
    const int row = k0 + ty + 16 * x;
    if (row >= a.Skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.Dh)
        store(dkp + (long long)row * a.dks[1] + col, dk[x][c] * a.scale);
      if (col < a.Dv)
        store(dvp + (long long)row * a.dvs[1] + col, dv[x][c]);
    }
  }
}

template <typename T, int TILE, int DP>
int launch(const Args& a, cudaStream_t s) {
  constexpr size_t kMaxSmem = smem_floats<TILE>(DP, DP) * 4;
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      attn_bwd_dq<T, TILE, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kMaxSmem);
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      attn_bwd_dkdv<T, TILE, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSmem);
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  const size_t smem = smem_floats<TILE>(a.Dh, a.Dv) * 4;
  const dim3 g1((unsigned)((a.Sq + TILE - 1) / TILE), (unsigned)a.H,
                (unsigned)a.B);
  attn_bwd_dq<T, TILE, DP><<<g1, kThreads, smem, s>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((unsigned)((a.Skv + TILE - 1) / TILE), (unsigned)a.Hkv,
                (unsigned)a.B);
  attn_bwd_dkdv<T, TILE, DP><<<g2, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const Args& a, cudaStream_t s) {
  const int d = a.Dh > a.Dv ? a.Dh : a.Dv;
  if (d <= 64) return launch<T, 64, 64>(a, s);
  if (d <= 128) return launch<T, 64, 128>(a, s);
  return launch<T, 32, 256>(a, s);
}

// ------------------------------------------------------------ wgmma route
namespace wg {

using namespace hopper;  // csrc/hopper_mma.cuh
constexpr int kWg = 128;       // one warpgroup a block
constexpr int kTile = 64;      // query rows and keys a tile
constexpr float kLog2e = 1.4426950408889634f;
typedef __nv_bfloat16 bf16;

// 4 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

// 2**x on the special-function unit (flush-to-zero: exp2(-inf) is 0 and a
// denormal result is 0), with no slow path
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Dynamic shared memory of both product launches: a [64][Dh] and a
// [64][Dv] tile that stay, and two stages of the same pair that stream,
// each as blocks of 64 columns (8 KB), plus room to align to 1024 bytes.
__host__ __device__ inline int smem_bytes(int Dh, int Dv) {
  return 8192 * 3 * ((Dh + 63) / 64 + (Dv + 63) / 64) + 1024;
}

// k-step kk of a K-major operand whose 64-column blocks start at `base`
__device__ __forceinline__ uint64_t kmajor(uint32_t base, int kk) {
  return desc_b128(base + (kk >> 2) * 8192 + (kk & 3) * 32);
}
// k-step kk (16 rows) of column block c of an MN-major operand
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, int c, int kk) {
  return desc_b128(base + c * 8192 + kk * 2048);
}

// The accumulator fragment's values, rounded to bf16 pairs, as the
// register-A operand of the next product: k-step kk takes the fragment
// columns n = 2 kk (a[0], a[1]) and n = 2 kk + 1 (a[2], a[3]).
__device__ __forceinline__ void to_a(uint32_t (&a)[4][4],
                                     const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x)
      a[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// A thread's share of copying rows [row0, row0 + 64) x columns [0, 64 nb)
// of one head of a [B, S, heads, D] bf16 tensor into the layout of
// hopper::stage (csrc/hopper_mma.cuh): thread t copies the 16-byte chunk
// t % 8 of rows t / 8 + 16 j (j < 4) of each column block, so its row,
// column and swizzled shared-memory offset are worked out once.
struct Tiler {
  uint32_t soff;
  int r, col;
  __device__ explicit Tiler(int t)
      : soff((t >> 3) * 128 + (((t & 7) ^ ((t >> 3) & 7)) << 4)),
        r(t >> 3),
        col((t & 7) * 8) {}
  __device__ __forceinline__ void copy(uint32_t dst, const bf16* src,
                                       long long s_row, int row0, int rows,
                                       int nb, int D) const {
    const bf16* p = src + (long long)(row0 + r) * s_row + col;
    for (int cb = 0; cb < nb; ++cb) {
      const bool col_ok = cb * 64 + col < D;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = col_ok && row0 + r + 16 * j < rows;
        cp_async16(dst + cb * 8192 + soff + j * 2048,
                   ok ? p + 16 * j * s_row + cb * 64 : src, ok);
      }
    }
  }
};

// acc[64 x NW] += A (registers, 64 x 64) B (shared memory, MN-major,
// column block c), four k-steps in one group
template <int NW>
__device__ __forceinline__ void mma_rs64(float (&acc)[NW / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b, int c) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) mma_rs(acc, a[kk], mnmajor(b, c, kk));
}

// ------------------------------------------------------------- launch 1
// dQ: a block per (query head, batch, query tile x dQ chunk), the chunk
// (NW columns of dQ) fastest, the heaviest (causal: the last) tiles
// first.  The fragment value s[n * 4 + i * 2 + j] is row row_a + 8 i, key
// k0 + 8 n + col0 + j.
template <int NW>
__global__ void __launch_bounds__(kWg, 4) attn_bwd_dq_wgmma(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float lse_s[kTile], dl_s[kTile];
  const int Dh = a.Dh, Dv = a.Dv;
  const int kb = (Dh + 63) / 64, vb = (Dv + 63) / 64;
  const uint32_t q_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t do_s = q_s + 8192 * kb;
  const uint32_t k_stage = 8192 * kb, v_stage = 8192 * vb;
  const uint32_t k_s = do_s + v_stage;          // [2][kb][64][64]
  const uint32_t v_s = k_s + 2 * k_stage;       // [2][vb][64][64]

  const int nc = (Dh + NW - 1) / NW;
  const int n_qt = (a.Sq + kTile - 1) / kTile;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_qt - 1 - (int)blockIdx.z / nc) * kTile;
  const int chunk = (int)(blockIdx.z % nc);
  const int g = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vs[0] + g * a.vs[2];
  const bf16* op = static_cast<const bf16*>(a.o) + b * a.os[0] + h * a.os[2];
  const bf16* dop =
      static_cast<const bf16*>(a.dout) + b * a.dos[0] + h * a.dos[2];
  const long long stat = ((long long)b * a.H + h) * a.Sq;

  // the key tiles [t_lo, t_hi) that some row of the tile sees
  const int last = (q0 + kTile < a.Sq ? q0 + kTile : a.Sq) - 1;
  const int pos_lo = q0 + a.q_offset, pos_last = pos_lo + kTile - 1;
  int t_hi = (a.Skv + kTile - 1) / kTile, t_lo = 0;
  if (a.causal) {
    const int p = last + a.q_offset;
    const int c = p < 0 ? 0 : p / kTile + 1;
    t_hi = c < t_hi ? c : t_hi;
  }
  if (a.window) {
    const int first = pos_lo - a.window + 1;
    t_lo = first > 0 ? first / kTile : 0;
  }

  const Tiler tl(tid);
  tl.copy(q_s, qp, a.qs[1], q0, a.Sq, kb, Dh);
  tl.copy(do_s, dop, a.dos[1], q0, a.Sq, vb, Dv);
  if (t_lo < t_hi) {
    tl.copy(k_s, kp, a.ks[1], t_lo * kTile, a.Skv, kb, Dh);
    tl.copy(v_s, vp, a.vs[1], t_lo * kTile, a.Skv, vb, Dv);
  }
  cp_async_commit();

  // delta = rowsum(dO o O), two threads a row (16-byte loads, each its
  // vectors in turn, then the pair's sum), while the copies fly
  {
    const int r = tid >> 1, half = tid & 1, row = q0 + r;
    float acc = 0.f;
    if (row < a.Sq) {
      const bf16* dr = dop + (long long)row * a.dos[1];
      const bf16* orow = op + (long long)row * a.os[1];
      for (int c = half * 8; c < Dv; c += 16) {
        const uint4 x = *reinterpret_cast<const uint4*>(dr + c);
        const uint4 y = *reinterpret_cast<const uint4*>(orow + c);
        const __nv_bfloat162* xp =
            reinterpret_cast<const __nv_bfloat162*>(&x);
        const __nv_bfloat162* yp =
            reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 fx = __bfloat1622float2(xp[e]);
          const float2 fy = __bfloat1622float2(yp[e]);
          acc = fmaf(fx.x, fy.x, acc);
          acc = fmaf(fx.y, fy.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) {
      dl_s[r] = acc;
      lse_s[r] = row < a.Sq ? a.lse[stat + row] : 0.f;
      if (row < a.Sq && chunk == 0) a.delta[stat + row] = acc;
    }
  }
  __syncthreads();

  // the thread's two rows (r and r + 8) and first column
  const int row_a = warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const float c2 = a.scale * kLog2e;
  float lse2[2], dl[2];
  int kmin[2], kmax[2];  // the row's visible keys
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = lse_s[row_a + 8 * i] * kLog2e;
    dl[i] = dl_s[row_a + 8 * i];
    const int pos = pos_lo + row_a + 8 * i;
    kmax[i] = a.causal && pos < a.Skv - 1 ? pos : a.Skv - 1;
    kmin[i] = a.window ? pos - a.window + 1 : 0;
  }

  float acc[NW / 2];
#pragma unroll
  for (int x = 0; x < NW / 2; ++x) acc[x] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {  // the next tile's copies overlap this tile's work
      tl.copy(k_s + (st ^ 1) * k_stage, kp, a.ks[1], (t + 1) * kTile, a.Skv,
              kb, Dh);
      tl.copy(v_s + (st ^ 1) * v_stage, vp, a.vs[1], (t + 1) * kTile, a.Skv,
              vb, Dv);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S = Q K^T and dP = dO V^T, all K-major, in one group
    const uint32_t kt = k_s + st * k_stage, vt = v_s + st * v_stage;
    float s[32] = {}, dp[32] = {};
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    for (int kk = 0; kk < Dh / 16; ++kk)
      mma_ss_n64(s, kmajor(q_s, kk), kmajor(kt, kk), kk > 0);
    for (int kk = 0; kk < Dv / 16; ++kk)
      mma_ss_n64(dp, kmajor(do_s, kk), kmajor(vt, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P and dS = P (dP - delta) on the fragment (masks only on tiles some
    // row does not see whole), dS rounded to bf16 as the A operand
    const int k0 = t * kTile;
    const bool whole =
        k0 + kTile <= a.Skv && (!a.causal || k0 + kTile - 1 <= pos_lo) &&
        (!a.window || k0 > pos_last - a.window);
    if (whole) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        s[x] = ex2(fmaf(s[x], c2, -lse2[i])) * (dp[x] - dl[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int x = n * 4 + i * 2 + j, key = k0 + 8 * n + col0 + j;
            const bool vis = key >= kmin[i] && key <= kmax[i];
            const float p =
                ex2(vis ? fmaf(s[x], c2, -lse2[i]) : -INFINITY);
            s[x] = p * (dp[x] - dl[i]);
          }
    }
    uint32_t da[4][4];
    to_a(da, s);

    // dQ += dS K: K is MN-major; the chunk is column block `chunk` of K
    fence_regs(acc);
    wg_fence();
    mma_rs64<NW>(acc, da, kt, chunk);
    wg_commit();
    wg_wait0();
    fence_regs(acc);
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

  bf16* dqp = static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_a + 8 * i;
    if (row >= a.Sq) continue;
    bf16* drow = dqp + (long long)row * a.dqs[1];
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
      const int col = chunk * NW + n * 8 + col0;
      if (col < Dh)
        *reinterpret_cast<__nv_bfloat162*>(drow + col) =
            __floats2bfloat162_rn(acc[n * 4 + i * 2] * a.scale,
                                  acc[n * 4 + i * 2 + 1] * a.scale);
    }
  }
}

// write a [64 x NW] gradient chunk: with a GQA group (rep > 1) the query
// head's f32 partial [B, H, Skv, D], summed by launch 3; else the
// gradient itself, times mul, rounded
template <int NW>
__device__ __forceinline__ void write_chunk(const Args& a, const float* acc,
                                            float* part, void* out,
                                            const long long* os, int D,
                                            int c, float mul, int b, int h,
                                            int g, int rep, int k0,
                                            int row_a, int col0) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_a + 8 * i;
    if (key >= a.Skv) continue;
#pragma unroll
    for (int n = 0; n < NW / 8; ++n) {
      const int col = c * NW + n * 8 + col0;
      if (col >= D) continue;
      const float x0 = acc[n * 4 + i * 2], x1 = acc[n * 4 + i * 2 + 1];
      if (rep > 1) {
        *reinterpret_cast<float2*>(
            part + (((long long)b * a.H + h) * a.Skv + key) * D + col) =
            make_float2(x0, x1);
      } else {
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<bf16*>(out) + b * os[0] + key * os[1] + g * os[2] +
            col) = __floats2bfloat162_rn(x0 * mul, x1 * mul);
      }
    }
  }
}

// ------------------------------------------------------------- launch 2
// dK, dV: a block per (query head, batch, key tile x chunk pair), the pair
// fastest.  Pair p owns dK's column chunk p and dV's chunk p (each NW
// wide); a head dim with fewer chunks than pairs repeats its last chunk,
// computed and not written.  The fragment value s[n * 4 + i * 2 + j] is
// key k0 + row_a + 8 i, query row q0 + 8 n + col0 + j.
template <int NW>
__global__ void __launch_bounds__(kWg, 3) attn_bwd_dkdv_wgmma(Args a) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ __align__(16) float stats_s[2][2 * kTile];  // lse, then delta
  const int Dh = a.Dh, Dv = a.Dv;
  const int kb = (Dh + 63) / 64, vb = (Dv + 63) / 64;
  const uint32_t k_s = (smem_u32(smem) + 1023) & ~1023u;
  const uint32_t v_s = k_s + 8192 * kb;
  const uint32_t ring = v_s + 8192 * vb;        // [2][Q kb | dO vb]
  const uint32_t q_stage = 8192 * (kb + vb);

  const int nk = (Dh + NW - 1) / NW, nv = (Dv + NW - 1) / NW;
  const int np = nk > nv ? nk : nv;
  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = (int)(blockIdx.z / np) * kTile;
  const int pair = (int)(blockIdx.z % np);
  const int ck = pair < nk ? pair : nk - 1, cv = pair < nv ? pair : nv - 1;
  const int rep = a.H / a.Hkv, g = h / rep;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.vs[0] + g * a.vs[2];
  const bf16* dop =
      static_cast<const bf16*>(a.dout) + b * a.dos[0] + h * a.dos[2];
  const long long stat = ((long long)b * a.H + h) * a.Sq;

  // the query tiles [t_lo, t_hi) whose rows can see a key of [k0, k1]
  const int k1 = (k0 + kTile < a.Skv ? k0 + kTile : a.Skv) - 1;
  int i_lo = 0, i_hi = a.Sq - 1;
  if (a.causal && k0 - a.q_offset > i_lo) i_lo = k0 - a.q_offset;
  if (a.window && k1 + a.window - 1 - a.q_offset < i_hi)
    i_hi = k1 + a.window - 1 - a.q_offset;
  const int t_lo = i_lo / kTile;
  const int t_hi = i_lo <= i_hi ? i_hi / kTile + 1 : t_lo;

  // a stage: Q and dO tiles, and the rows' lse and delta (a thread each)
  const uint32_t stats_u = smem_u32(&stats_s[0][0]);
  const Tiler tl(tid);
  auto stage_q = [&](int st, int t) {
    const uint32_t qt = ring + st * q_stage;
    tl.copy(qt, qp, a.qs[1], t * kTile, a.Sq, kb, Dh);
    tl.copy(qt + 8192 * kb, dop, a.dos[1], t * kTile, a.Sq, vb, Dv);
    const int row = t * kTile + (tid & (kTile - 1));
    const float* src = (tid < kTile ? a.lse : a.delta) + stat + row;
    const bool ok = row < a.Sq;
    cp_async4(stats_u + (st * 2 * kTile + tid) * 4, ok ? src : a.lse, ok);
  };
  if (t_lo < t_hi) {
    tl.copy(k_s, kp, a.ks[1], k0, a.Skv, kb, Dh);
    tl.copy(v_s, vp, a.vs[1], k0, a.Skv, vb, Dv);
    stage_q(0, t_lo);
  }
  cp_async_commit();

  const int row_a = warp * 16 + (lane >> 2);
  const int col0 = (lane & 3) * 2;
  const float c2 = a.scale * kLog2e;

  float dk[NW / 2], dv[NW / 2];
#pragma unroll
  for (int x = 0; x < NW / 2; ++x) dk[x] = dv[x] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) & 1;
    if (t + 1 < t_hi) {
      stage_q(st ^ 1, t + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T, all K-major, in one group
    const uint32_t qt = ring + st * q_stage, dot = qt + 8192 * kb;
    float s[32] = {}, dp[32] = {};
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    for (int kk = 0; kk < Dh / 16; ++kk)
      mma_ss_n64(s, kmajor(k_s, kk), kmajor(qt, kk), kk > 0);
    for (int kk = 0; kk < Dv / 16; ++kk)
      mma_ss_n64(dp, kmajor(v_s, kk), kmajor(dot, kk), kk > 0);
    wg_commit();
    wg_wait0();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T on the fragment; a column's lse and delta from the
    // stage
    const int q0 = t * kTile;
    const bool whole =
        q0 + kTile <= a.Sq &&
        (!a.causal || k0 + kTile - 1 <= q0 + a.q_offset) &&
        (!a.window || k0 > q0 + kTile - 1 + a.q_offset - a.window);
    const float* ls = stats_s[st];
    if (whole) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + col0 + j;
          const float lse2 = ls[col] * kLog2e, dl = ls[kTile + col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = n * 4 + i * 2 + j;
            const float p = ex2(fmaf(s[x], c2, -lse2));
            s[x] = p;
            dp[x] = p * (dp[x] - dl);
          }
        }
    } else {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = 8 * n + col0 + j, pos = q0 + col + a.q_offset;
          const float lse2 = ls[col] * kLog2e, dl = ls[kTile + col];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int x = n * 4 + i * 2 + j, key = k0 + row_a + 8 * i;
            const bool vis = q0 + col < a.Sq && (!a.causal || key <= pos) &&
                             (!a.window || key > pos - a.window);
            const float p = ex2(vis ? fmaf(s[x], c2, -lse2) : -INFINITY);
            s[x] = p;
            dp[x] = p * (dp[x] - dl);
          }
        }
    }
    uint32_t pa[4][4], da[4][4];
    to_a(pa, s);
    to_a(da, dp);

    // dV += P^T dO and dK += dS^T Q (dO and Q MN-major), in one group
    fence_regs(dv);
    fence_regs(dk);
    wg_fence();
    mma_rs64<NW>(dv, pa, dot, cv);
    mma_rs64<NW>(dk, da, qt, ck);
    wg_commit();
    wg_wait0();
    fence_regs(dv);
    fence_regs(dk);
    __syncthreads();  // this stage is free for the copy two tiles on
  }
  cp_async_wait<0>();

  // rows past Skv are not written; a block with no visible query tile
  // writes zeros
  if (pair < nk)
    write_chunk<NW>(a, dk, a.dkp, a.dk, a.dks, Dh, ck, a.scale, b, h, g,
                    rep, k0, row_a, col0);
  if (pair < nv)
    write_chunk<NW>(a, dv, a.dvp, a.dv, a.dvs, Dv, cv, 1.f, b, h, g, rep,
                    k0, row_a, col0);
}

// ------------------------------------------------------------- launch 3
// dK and dV of a GQA group: each element the sum of its rep query heads'
// partials in head order, dK times scale, rounded once.  blockIdx.y: 0 dK,
// 1 dV; a grid-stride loop over (b, g, key, 4 columns).
__global__ void __launch_bounds__(256) attn_bwd_sum(Args a) {
  const bool is_k = blockIdx.y == 0;
  const int D = is_k ? a.Dh : a.Dv, n4 = D / 4, rep = a.H / a.Hkv;
  const float* part = is_k ? a.dkp : a.dvp;
  bf16* out = static_cast<bf16*>(is_k ? a.dk : a.dv);
  const long long* os = is_k ? a.dks : a.dvs;
  const float m = is_k ? a.scale : 1.f;
  const long long total = (long long)a.B * a.Hkv * a.Skv * n4;
  for (long long e = (long long)blockIdx.x * 256 + threadIdx.x; e < total;
       e += (long long)gridDim.x * 256) {
    const int d = (int)(e % n4) * 4;
    long long r = e / n4;
    const int s = (int)(r % a.Skv);
    r /= a.Skv;
    const int g = (int)(r % a.Hkv), b = (int)(r / a.Hkv);
    const float* p =
        part + (((long long)b * a.H + g * rep) * a.Skv + s) * D + d;
    float4 x = *reinterpret_cast<const float4*>(p);
    for (int hh = 1; hh < rep; ++hh) {
      const float4 y =
          *reinterpret_cast<const float4*>(p + (long long)hh * a.Skv * D);
      x.x += y.x;
      x.y += y.y;
      x.z += y.z;
      x.w += y.w;
    }
    __nv_bfloat162 v[2] = {__floats2bfloat162_rn(x.x * m, x.y * m),
                           __floats2bfloat162_rn(x.z * m, x.w * m)};
    *reinterpret_cast<uint2*>(out + b * os[0] + s * os[1] + g * os[2] + d) =
        *reinterpret_cast<const uint2*>(v);
  }
}

template <int NW>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr1 = cudaFuncSetAttribute(
      attn_bwd_dq_wgmma<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxD, kMaxD));
  static const cudaError_t attr2 = cudaFuncSetAttribute(
      attn_bwd_dkdv_wgmma<NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxD, kMaxD));
  if (attr1 != cudaSuccess) return (int)attr1;
  if (attr2 != cudaSuccess) return (int)attr2;
  const int smem = smem_bytes(a.Dh, a.Dv);
  const int nk = (a.Dh + NW - 1) / NW, nv = (a.Dv + NW - 1) / NW;
  const dim3 g1((unsigned)a.H, (unsigned)a.B,
                (unsigned)((a.Sq + kTile - 1) / kTile * nk));
  attn_bwd_dq_wgmma<NW><<<g1, kWg, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const dim3 g2((unsigned)a.H, (unsigned)a.B,
                (unsigned)((a.Skv + kTile - 1) / kTile * (nk > nv ? nk : nv)));
  attn_bwd_dkdv_wgmma<NW><<<g2, kWg, smem, s>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess || a.H == a.Hkv) return (int)e;
  const int d = a.Dh > a.Dv ? a.Dh : a.Dv;
  const long long items = (long long)a.B * a.Hkv * a.Skv * (d / 4);
  const long long blocks = (items + 255) / 256;
  attn_bwd_sum<<<dim3((unsigned)(blocks < 65535 ? blocks : 65535), 2), 256,
                 0, s>>>(a);
  return (int)cudaGetLastError();
}

// the chunk width: 64 columns, or the wider head dim rounded up to 16 or
// 32 where both are narrower (a narrower product, no zero columns)
int launch_nw(const Args& a, cudaStream_t s) {
  const int d = a.Dh > a.Dv ? a.Dh : a.Dv;
  if (d <= 16) return launch<16>(a, s);
  if (d <= 32) return launch<32>(a, s);
  return launch<64>(a, s);
}

}  // namespace wg

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout and the gradients alike).
// strides: 24 element strides, (batch, seq, head) of q, k, v, o, dout, dq,
// dk, dv in turn.  lse [B, H, Sq] (f32, the forward's) is read; delta
// [B, H, Sq] (f32 scratch) is written by the dQ launch and read by the
// dK/dV launch.  route: 0 = simt, 1 = wgmma (bf16, Dh and Dv multiples of
// 16, every tensor 16-byte aligned with strides of whole 16-byte units),
// which with H > Hkv also needs dkp [B, H, Skv, Dh] and dvp [B, H, Skv,
// Dv] (f32 scratch; null otherwise).  Sizes are checked by the Python
// wrapper (1 <= Dh, Dv <= 256, H % Hkv == 0, Sq, Skv >= 1), which also
// picks the route; a wgmma route the shape cannot take returns
// cudaErrorInvalidValue without a launch.  Returns cudaGetLastError()
// after the launches (the first failing one's code).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, float* dkp, float* dvp, int B, int Sq, int Skv, int H,
    int Hkv, int Dh, int Dv, const long long* strides, int causal,
    int window, int q_offset, float scale, int dtype, int route,
    void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0) return 0;
  if (Dh < 1 || Dv < 1 || Dh > kMaxD || Dv > kMaxD || Hkv <= 0 || H % Hkv)
    return (int)cudaErrorInvalidValue;
  if (route == 1 && (dtype != 1 || Dh % 16 || Dv % 16 ||
                     (H != Hkv && (!dkp || !dvp))))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.dout = dout;
  a.lse = lse;
  a.delta = delta;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.dkp = dkp;
  a.dvp = dvp;
  a.B = B;
  a.Sq = Sq;
  a.Skv = Skv;
  a.H = H;
  a.Hkv = Hkv;
  a.Dh = Dh;
  a.Dv = Dv;
  long long* dst[8] = {a.qs, a.ks, a.vs, a.os, a.dos, a.dqs, a.dks, a.dvs};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  a.scale = scale;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (route == 1) return wg::launch_nw(a, s);
  return dtype == 1 ? launch_d<__nv_bfloat16>(a, s) : launch_d<float>(a, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
