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
// This is FlashAttention-2's backward in its deterministic form: two
// launches and no atomics.
//   1. dq: a block per (query tile, h, b).  It computes delta for its rows
//      (written out for launch 2), then loops over the key tiles its rows
//      see (the forward's tile skipping), recomputing P and dP, and sums
//      dq in registers.
//   2. dk / dv: a block per (key tile, g, b).  It loops over the group's
//      query heads in order and, for each, over the query tiles that can
//      see the tile (causal, window and q_offset limits), recomputing P
//      and dP, and sums dk and dv in registers.
// Every sum runs in a fixed order (a thread's products in turn, tiles and
// heads in order), so two calls give the same bits; the gradients are
// rounded once, to the inputs' dtype, at the end.
//
// What bounds it on the H100.  At qwen2-0.5b's training shape (B 4, S
// 1,024, 14 query heads over 2 kv heads, Dh 64, causal) the five products
// (S, dP, P^T dO, dS^T Q, dS K) are 2 (3 Dh + 2 Dv) FLOPs a visible pair,
// 18.8 GFLOP over the causal half, against ~32 MB read and written once:
// operations bound it, ~19 us on the bf16 tensor cores.  This kernel
// recomputes S and dP in both launches (seven products a pair).  This
// first design runs on
// the f32 CUDA cores (67 TFLOP/s), from shared memory: every input is
// staged as f32 (bf16 widened on the way), and each product is a 16 x 16
// grid of threads, a thread owning a (TILE/16) x (TILE/16) block of a
// TILE x TILE score tile (rows ty + 16 a, columns tx + 16 b) or a
// (TILE/16) x (D/16) block of a TILE x D gradient tile, so a lane's loads
// in a step are one row broadcast and 16 consecutive words.  Rows of
// D-wide tiles are padded to 32k + 1 words (conflict-free column walks),
// score tiles to TILE + 16.  TILE is 64 for head dims up to 128 and 32 up
// to 256, which keeps shared memory under 180 KB.  wgmma and TMA are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v, o, dout and the gradients alike).
// strides: 24 element strides, (batch, seq, head) of q, k, v, o, dout, dq,
// dk, dv in turn.  lse [B, H, Sq] (f32, the forward's) is read; delta
// [B, H, Sq] (f32 scratch) is written by the first launch and read by the
// second.  Sizes are checked by the Python wrapper (1 <= Dh, Dv <= 256,
// H % Hkv == 0, Sq, Skv >= 1).  Returns cudaGetLastError() after the
// launches (the first failing one's code).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, int B, int Sq, int Skv, int H, int Hkv, int Dh, int Dv,
    const long long* strides, int causal, int window, int q_offset,
    float scale, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0) return 0;
  if (Dh < 1 || Dv < 1 || Dh > kMaxD || Dv > kMaxD || Hkv <= 0 || H % Hkv)
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
  return dtype == 1 ? launch_d<__nv_bfloat16>(a, s) : launch_d<float>(a, s);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
