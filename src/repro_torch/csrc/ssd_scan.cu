// Chunked SSD scan for Hopper: the Mamba-2 prefill recurrence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan).  For every batch b and head h, from a zero
// state S [N, P] (f32) or a given initial one (h0 [B, H, N, P] f32: the
// route over a sequence split across ranks scans a rank's slice from the
// state the ranks before it carry, kernels/ssd/ops.py), over chunks of L
// rows with cum = the inclusive cumsum of log_a inside the chunk:
//   y[l]  = sum_{m <= l} (q_l . k_m) exp(cum_l - cum_m) v_m
//           + exp(cum_l) (q_l S)
//   S    <- exp(cum_last) S + sum_m exp(cum_last - cum_m) k_m^T v_m
// and the final S is returned.  q, k are [B, S, H, N], v and y [B, S, H, P]
// (bf16 or f32, one dtype), log_a [B, S, H] f32 (<= 0), final [B, H, N, P]
// f32.  Every tensor is read through its strides with the last dimension
// contiguous, so q and k may be broadcast views with a head stride of 0
// (Mamba-2 shares B and C across heads) and nothing is copied.
//
// The TPU kernel keeps S in VMEM scratch and walks the chunks along a
// sequential grid axis.  Hopper blocks run in no order, so here a block
// walks its chunks in order.  The decay exp(cum_l - cum_m) is selected
// before use where l >= m (for l < m the exponent may overflow);
// exp(cum_l) * exp(-cum_m) is never formed (exp(-cum) overflows over a
// 256-row chunk with strong decay).  A ragged last chunk (S not a multiple
// of L) is masked here: its rows past S read as q = k = v = 0 and log_a =
// 0, which is what the TPU kernel's zero padding gives, so the final state
// equals the unpadded one.  Every sum runs in a fixed order with no
// atomics: two calls give the same bits.
//
// What bounds it on the H100: at the serving shape (B = 8, S = L = 256,
// H = 64, N = P = 64, bf16, q and k head-broadcast) the function moves
// ~43 MB (v and y 16.8 MB each, the f32 final state 8.4 MB; q, k and
// log_a ~1 MB), ~13 us at 3.35 TB/s, and does ~10.7 GFLOP counting the
// masked half of each [L, L] product: ~0.011 ms on the bf16 tensor cores,
// ~0.16 ms on the f32 CUDA cores.  So the products belong on the tensor
// cores, and the bytes set the bound.  Two routes, chosen by the wrapper:
//
// * mma (bf16; N and P each 16, 32, 64 or 128, compiled for each so
//   that every loop over them unrolls; a chunk that is a multiple of 16
//   up to 256 whose tiles fit shared memory; 16-byte aligned views).  One
//   block of 8 warps takes (b, h).  Each chunk's Q, K and V are staged
//   once as bf16 by 16-byte cp.async copies (rows padded by 16 bytes, so
//   ldmatrix reads are free of bank conflicts), while the block scans
//   log_a.  The products are `mma.sync m16n8k16` (bf16 in, f32
//   accumulators) fed by ldmatrix: a warp owns 16 query rows, holds their
//   Q fragments in registers, and walks the 16-key blocks at or below its
//   diagonal; the f32 score fragment of Q K^T takes the decay in
//   registers (ex2 of differences of cum kept in log2 units), is rounded
//   to bf16, and is the A fragment of G V as it stands (as in
//   FlashAttention-2), so the masked score tile never goes through
//   shared memory.  The 16-row query groups go to the warps in a snake
//   order (warp w takes groups w and 15 - w of a 256-row chunk), so each
//   warp walks the same number of key blocks.  The state update S_chunk
//   = (k . wend)^T V (wend_m = exp(cum_last - cum_m)) runs on the tensor
//   cores too, as 16 x 32 tiles of [N, P] over the warps (16 x 16 where
//   P is not a multiple of 32), with k . wend split into a bf16 high part
//   and a bf16 low part (hi = bf16(x), lo = bf16(x - hi)), two products
//   summed in f32 (in two accumulators, so the chains are independent,
//   added at the end): one bf16 rounding of k . wend misses the state's
//   5e-4 tolerance (~1.1-1.4e-3 of max|S| + 1 in a float64 emulation),
//   the split keeps it near 1e-6.  The G V product rounds the
//   decayed scores to bf16, and the carried-state product exp(cum_l)
//   (q_l S) rounds S to bf16 (y's tolerance is 2e-2); S itself stays f32:
//   S <- exp(cum_last) S + S_chunk is done in f32 in the output tensor,
//   each thread rereading its own 16-byte stores, and a bf16 copy of S is
//   staged in shared memory for the next chunk.  y is stored as packed
//   bf16 pairs, the final state as 16-byte f32 stores (lane pairs swap
//   halves of their accumulator fragments first).  A 256-row chunk of
//   N = P = 64 takes 110 KB of shared memory.  Where q and k are
//   head-broadcast (Mamba-2), every head of a request has the same Q K^T
//   and each block recomputes it: sharing it between two heads a block
//   (half the blocks, one an SM) ran within the spread between runs on
//   the H100 at zamba2's serving shape, so a block takes one head.  The
//   next chunk is not prefetched into a second buffer (the serving shape
//   has a single chunk), and the bf16 copy of S is staged only when a
//   chunk follows another.  wgmma was not taken: its 64-row tiles would
//   give each warpgroup four query groups of one causal chunk, and the
//   products are only 64 deep.
// * simt (f32, other N or P, larger chunks, unaligned views): the f32
//   CUDA cores from shared memory, one block per (b, h); a chunk is cut
//   into 64-row sub-tiles; for query tile i the block stages Q_i, and for
//   each key tile j <= i stages K_j and V_j as f32, forms Q_i K_j^T in a
//   [64, 64] shared tile scaled by the decay, then adds the tile times V_j
//   into the y tile kept in registers.  The last query tile
//   of a chunk sees every key tile, so it also accumulates the chunk's
//   state update in registers; S (f32, shared memory) is updated once the
//   chunk's last tile is done.  f32 stays here because the tensor cores
//   would round it.  N and P are at most 128, the chunk at most 2048 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  const float* la;
  void* y;
  float* fin;
  const float* h0;    // [B, H, N, P] f32, or null: a zero state
  int B, S, H, N, P, L;
  long long qs[3], ks[3], vs[3], las[3], ys[3];  // (batch, seq, head)
};

// ------------------------------------------------------------- simt route
namespace simt {

constexpr int kT = 64;            // rows of a sub-tile
constexpr int kThreads = 256;     // a 16 x 16 grid: (ty, tx)
constexpr int kMaxNP = 128;
constexpr int kMaxChunk = 2048;
constexpr int kGld = kT + 1;      // G rows, odd: conflict-free row reads

// S [N][P] + Q, K [64][N + 1] + V [64][P] + G [64][65] + cum, wend [L]
__host__ __device__ constexpr int smem_floats(int N, int P, int L) {
  return N * P + 2 * kT * (N + 1) + kT * P + kT * kGld + 2 * L;
}
constexpr int kMaxSmemBytes = 4 * smem_floats(kMaxNP, kMaxNP, kMaxChunk);

// Stage rows [row0, row0 + 64) of one head into dst[64][ld] as f32; rows
// at or past `rows` read as 0.
template <typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      long long s_row, int row0, int rows,
                                      int D) {
  for (int i = threadIdx.x; i < kT * D; i += kThreads) {
    const int r = i / D, d = i - r * D;
    dst[r * ld + d] =
        row0 + r < rows ? to_f32(src[(long long)(row0 + r) * s_row + d]) : 0.f;
  }
}

// R = columns (of P) and state rows (of N) per thread, over 16: N, P <= 16 R
template <typename T, int R>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(Args a) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[kThreads / 32];
  const int N = a.N, P = a.P, L = a.L;
  const int ldn = N + 1;
  float* St = smem;                   // [N][P]
  float* Qs = St + N * P;             // [64][N + 1]
  float* Ks = Qs + kT * ldn;          // [64][N + 1]
  float* Vs = Ks + kT * ldn;          // [64][P]
  float* G = Vs + kT * P;             // [64][65]
  float* cum = G + kT * kGld;         // [L]
  float* wend = cum + L;              // [L]: exp(cum_last - cum_m)

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const T* qp = static_cast<const T*>(a.q) + b * a.qs[0] + h * a.qs[2];
  const T* kp = static_cast<const T*>(a.k) + b * a.ks[0] + h * a.ks[2];
  const T* vp = static_cast<const T*>(a.v) + b * a.vs[0] + h * a.vs[2];
  const float* lap = a.la + b * a.las[0] + h * a.las[2];
  T* yp = static_cast<T*>(a.y) + b * a.ys[0] + h * a.ys[2];

  const float* h0p = a.h0 ? a.h0 + ((long long)b * a.H + h) * N * P : nullptr;
  for (int i = tid; i < N * P; i += kThreads) St[i] = h0p ? h0p[i] : 0.f;

  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int Lr = min(L, a.S - t0);   // real rows of this chunk
    __syncthreads();                   // the last chunk is done with cum
    // cum: inclusive scan of log_a over the chunk, 256 rows a pass, in a
    // fixed order (shuffles in a warp, then the warps' totals in turn)
    float carry = 0.f;
    for (int base = 0; base < Lr; base += kThreads) {
      const int i = base + tid;
      float x = i < Lr ? lap[(long long)(t0 + i) * a.las[1]] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += n;
      }
      if (lane == 31) warp_tot[warp] = x;
      __syncthreads();
      float pre = carry, next = carry;
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) pre += warp_tot[w];
        next += warp_tot[w];
      }
      if (i < Lr) cum[i] = pre + x;
      __syncthreads();                 // warp_tot is read before reuse
      carry = next;
    }
    const float c_last = cum[Lr - 1];
    for (int i = tid; i < Lr; i += kThreads) wend[i] = expf(c_last - cum[i]);

    const int nt = (Lr + kT - 1) / kT;
    float sacc[R][R];                  // state rows ty + 16a, cols tx + 16c
#pragma unroll
    for (int x = 0; x < R; ++x)
#pragma unroll
      for (int c = 0; c < R; ++c) sacc[x][c] = 0.f;

    for (int ti = 0; ti < nt; ++ti) {
      const int r0 = ti * kT;
      __syncthreads();                 // Qs is free; cum, wend are written
      stage(Qs, ldn, qp + (long long)t0 * a.qs[1], a.qs[1], r0, Lr, N);
      float acc[4][R];                 // y rows ty + 16r, cols tx + 16c
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < R; ++c) acc[r][c] = 0.f;
      __syncthreads();
      if (t0 > 0 || h0p) {             // carried state: exp(cum_l) (q_l S)
        for (int n = 0; n < N; ++n) {
          float qv[4], sv[R];
#pragma unroll
          for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * ldn + n];
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const int p = tx + 16 * c;
            sv[c] = p < P ? St[n * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < R; ++c) acc[r][c] = fmaf(qv[r], sv[c], acc[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int l = r0 + ty + 16 * r;
          const float e = l < Lr ? expf(cum[l]) : 0.f;
#pragma unroll
          for (int c = 0; c < R; ++c) acc[r][c] *= e;
        }
      }

      for (int tj = 0; tj <= ti; ++tj) {
        const int m0 = tj * kT;
        const int mr = min(kT, Lr - m0);   // real key rows of the tile
        __syncthreads();               // Ks, Vs and G are free
        stage(Ks, ldn, kp + (long long)t0 * a.ks[1], a.ks[1], m0, Lr, N);
        stage(Vs, P, vp + (long long)t0 * a.vs[1], a.vs[1], m0, Lr, P);
        __syncthreads();
        // G[l][m] = (q_l . k_m) exp(cum_l - cum_m) where m <= l, else 0
        float g[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] = 0.f;
        for (int n = 0; n < N; ++n) {
          float qv[4], kv[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) qv[r] = Qs[(ty + 16 * r) * ldn + n];
#pragma unroll
          for (int c = 0; c < 4; ++c) kv[c] = Ks[(tx + 16 * c) * ldn + n];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c) g[r][c] = fmaf(qv[r], kv[c], g[r][c]);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int l = r0 + ty + 16 * r;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int m = m0 + tx + 16 * c;
            G[(ty + 16 * r) * kGld + tx + 16 * c] =
                (m <= l && l < Lr) ? g[r][c] * expf(cum[l] - cum[m]) : 0.f;
          }
        }
        __syncthreads();
        // y tile += G V
        for (int m = 0; m < mr; ++m) {
          float gv[4], vv[R];
#pragma unroll
          for (int r = 0; r < 4; ++r) gv[r] = G[(ty + 16 * r) * kGld + m];
#pragma unroll
          for (int c = 0; c < R; ++c) {
            const int p = tx + 16 * c;
            vv[c] = p < P ? Vs[m * P + p] : 0.f;
          }
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int c = 0; c < R; ++c) acc[r][c] = fmaf(gv[r], vv[c], acc[r][c]);
        }
        if (ti == nt - 1) {            // the chunk's state update
          for (int m = 0; m < mr; ++m) {
            const float wm = wend[m0 + m];
            float kv[R], vv[R];
#pragma unroll
            for (int x = 0; x < R; ++x) {
              const int n = ty + 16 * x;
              kv[x] = n < N ? Ks[m * ldn + n] * wm : 0.f;
            }
#pragma unroll
            for (int c = 0; c < R; ++c) {
              const int p = tx + 16 * c;
              vv[c] = p < P ? Vs[m * P + p] : 0.f;
            }
#pragma unroll
            for (int x = 0; x < R; ++x)
#pragma unroll
              for (int c = 0; c < R; ++c)
                sacc[x][c] = fmaf(kv[x], vv[c], sacc[x][c]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int l = r0 + ty + 16 * r;
        if (l >= Lr) continue;
        T* yr = yp + (long long)(t0 + l) * a.ys[1];
#pragma unroll
        for (int c = 0; c < R; ++c) {
          const int p = tx + 16 * c;
          if (p < P) store(yr + p, acc[r][c]);
        }
      }
    }
    __syncthreads();                   // every tile has read the old S
    const float e_last = expf(c_last);
#pragma unroll
    for (int x = 0; x < R; ++x) {
      const int n = ty + 16 * x;
#pragma unroll
      for (int c = 0; c < R; ++c) {
        const int p = tx + 16 * c;
        if (n < N && p < P) St[n * P + p] = e_last * St[n * P + p] + sacc[x][c];
      }
    }
  }
  __syncthreads();
  float* fp = a.fin + ((long long)b * a.H + h) * N * P;
  for (int i = tid; i < N * P; i += kThreads) fp[i] = St[i];
}

template <typename T, int R>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_scan_kernel<T, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmemBytes);
  if (attr != cudaSuccess) return (int)attr;
  const size_t smem = 4 * (size_t)smem_floats(a.N, a.P, a.L);
  const dim3 grid((unsigned)a.H, (unsigned)a.B);
  ssd_scan_kernel<T, R><<<grid, kThreads, smem, s>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_t(const Args& a, cudaStream_t s) {
  const int d = a.N > a.P ? a.N : a.P;
  if (d <= 16) return launch<T, 1>(a, s);
  if (d <= 32) return launch<T, 2>(a, s);
  if (d <= 64) return launch<T, 4>(a, s);
  return launch<T, 8>(a, s);
}


}  // namespace simt

// -------------------------------------------------------------- mma route
namespace mma {

constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;         // bf16 of padding a shared row: 16 bytes
constexpr int kMaxSmem = 232448 - 1024;   // dynamic bytes a block may ask
constexpr float kLog2e = 1.4426950408889634f;

// Q, K [L][N + 8] + V [L][P + 8] (bf16) + cum, wend [L] (f32) + Sb
// [N][P + 8] (bf16; only when a chunk follows another).  Mirrored by
// kernels/ssd_scan/kernel.py::smem_bytes.
__host__ __device__ constexpr int smem_bytes(int L, int N, int P, bool carry) {
  return 2 * L * (2 * (N + kPad) + P + kPad) + 4 * 2 * L +
         (carry ? 2 * N * (P + kPad) : 0);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, zero-filled when !ok (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// d += a b: a 16 x 16 bf16 (row), b 16 x 8 bf16 (col), d 16 x 8 f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// two floats as bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// a bf16 pair times (w0, w1) in f32, split into bf16 high and low parts
__device__ __forceinline__ void split(uint32_t kv, float w0, float w1,
                                      uint32_t* hi, uint32_t* lo) {
  const float x0 = __uint_as_float(kv << 16) * w0;
  const float x1 = __uint_as_float(kv & 0xffff0000u) * w1;
  const __nv_bfloat16 h0 = __float2bfloat16(x0), h1 = __float2bfloat16(x1);
  __nv_bfloat162 hv;
  hv.x = h0;
  hv.y = h1;
  *hi = *reinterpret_cast<uint32_t*>(&hv);
  *lo = pack_bf16(x0 - __bfloat162float(h0), x1 - __bfloat162float(h1));
}

// 2^x, flushing results below 2^-126 to 0 (a decay that small adds
// nothing to a bf16 score)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// s = Q K^T for 16 query rows and 16 keys (f32, the C fragments of two
// 8-key tiles): qf holds the rows' Q as A fragments of the NQ 16-deep
// steps of N, ka is this lane's ldmatrix address of the block's K at
// column 0.  Even and odd steps go to two accumulators, summed at the
// end (a fixed order, half the chain).
template <int NQ>
__device__ __forceinline__ void qk(float (&s)[2][4], const uint32_t (&qf)[NQ][4],
                                   uint32_t ka) {
  float u[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] = u[t][e] = 0.f;
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    uint32_t bf[4];
    ldsm_x4(bf, ka + i * 32);
    float (&d)[2][4] = (i & 1) ? u : s;
    mma16816(d[0], qf[i], bf[0], bf[1]);
    mma16816(d[1], qf[i], bf[2], bf[3]);
  }
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[t][e] += u[t][e];
}

// Rows [t0, t0 + L) of one head's [S, D] bf16 view (row stride s_row
// elements) into dst [L][D + 8] by 16-byte cp.async; rows at or past S
// read as 0.
template <int D>
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      long long s_row, int t0, int L, int S) {
  constexpr int cpr = D >> 3;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < L * cpr; i += kThreads) {
    const int r = i / cpr, c = i - r * cpr;
    const bool ok = t0 + r < S;
    const __nv_bfloat16* p = ok ? src + (long long)(t0 + r) * s_row + c * 8
                                : src;
    cp_async16(dst + (uint32_t)((r * (D + kPad) + c * 8) * 2), p, ok);
  }
}

// One head a block; N = 16 NQ and P = 16 PT (a.N and a.P); a.L is the
// chunk: a multiple of 16, at most 256.
template <int PT, int NQ>
__global__ void __launch_bounds__(kThreads, 1) ssd_mma_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float warp_tot[kWarps];
  __shared__ float c_last;           // cum at the chunk's last row
  constexpr int N = 16 * NQ, P = 16 * PT;
  constexpr int ldn = N + kPad, ldp = P + kPad;
  const int L = a.L;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + L * ldn;
  __nv_bfloat16* Vs = Ks + L * ldn;           // [L][P + 8]
  float* cum = reinterpret_cast<float*>(Vs + L * ldp);   // [L], in log2 units
  float* wend = cum + L;                      // [L]: exp(cum_last - cum_m)
  __nv_bfloat16* Sb = reinterpret_cast<__nv_bfloat16*>(wend + L);
                                              // [N][P + 8], if S > L
  const uint32_t q_u = smem_u32(Qs), k_u = smem_u32(Ks), v_u = smem_u32(Vs),
                 s_u = smem_u32(Sb);

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) +
                            b * a.qs[0] + h * a.qs[2];
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) +
                            b * a.ks[0] + h * a.ks[2];
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) +
                            b * a.vs[0] + h * a.vs[2];
  const float* lap = a.la + b * a.las[0] + h * a.las[2];
  __nv_bfloat16* yp = static_cast<__nv_bfloat16*>(a.y) + b * a.ys[0] +
                      h * a.ys[2];
  float* fp = a.fin + ((long long)b * a.H + h) * N * P;
  // this lane's ldmatrix row offsets (elements): A from row-major tiles,
  // B from K rows, and B (or A) through the transpose
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3),
            kb_col = ((lane >> 3) & 1) * 8;
  const int t_row = (lane & 7) + ((lane >> 3) & 1) * 8, t_col = (lane >> 4) * 8;

  if (a.h0) {   // the initial state: f32 into fin, bf16 into Sb
    const float* hp = a.h0 + ((long long)b * a.H + h) * N * P;
    for (int i = tid * 4; i < N * P; i += kThreads * 4) {
      const int n = i / P, p = i - n * P;
      const float4 v = *reinterpret_cast<const float4*>(hp + i);
      *reinterpret_cast<float4*>(fp + i) = v;
      uint2 packed;
      packed.x = pack_bf16(v.x, v.y);
      packed.y = pack_bf16(v.z, v.w);
      *reinterpret_cast<uint2*>(Sb + n * ldp + p) = packed;
    }
  }
  for (int t0 = 0; t0 < a.S; t0 += L) {
    const int Lr = min(L, a.S - t0);   // real rows of this chunk
    const bool carry = t0 > 0 || a.h0;
    __syncthreads();                   // the last chunk is done with smem
    stage<N>(q_u, qp, a.qs[1], t0, L, a.S);
    stage<N>(k_u, kp, a.ks[1], t0, L, a.S);
    stage<P>(v_u, vp, a.vs[1], t0, L, a.S);
    cp_async_commit();
    // meanwhile cum: an inclusive scan of log_a over the chunk (L <= 256
    // rows, one a thread), shuffles in a warp, then the warps' totals in
    // order
    {
      float x = tid < Lr ? lap[(long long)(t0 + tid) * a.las[1]] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float n = __shfl_up_sync(0xffffffffu, x, off);
        if (lane >= off) x += n;
      }
      if (lane == 31) warp_tot[warp] = x;
      __syncthreads();
      float pre = 0.f;
      for (int w = 0; w < warp; ++w) pre += warp_tot[w];
      const float c = pre + x;
      if (tid < L) cum[tid] = c * kLog2e;
      if (tid == Lr - 1) c_last = c;
      __syncthreads();                 // cum is whole; c_last is set
      if (tid < L) wend[tid] = expf(c_last - c);
    }
    cp_async_wait_all();
    __syncthreads();

    // ---- y: 16-row query groups, snake order over the warps
    const int groups = (Lr + 15) >> 4;
    for (int rg = 0; rg < groups; ++rg) {
      const int pass = rg / kWarps, slot = rg % kWarps;
      if (((pass & 1) ? kWarps - 1 - slot : slot) != warp) continue;
      const int r0 = rg * 16, l0 = r0 + gid, l1 = l0 + 8;
      // the rows' Q, held in registers for every key block
      const uint32_t qa = q_u + (uint32_t)(((r0 + a_row) * ldn + a_col) * 2);
      uint32_t qf[NQ][4];
#pragma unroll
      for (int i = 0; i < NQ; ++i) ldsm_x4(qf[i], qa + i * 32);
      float acc[2 * PT][4];
#pragma unroll
      for (int j = 0; j < 2 * PT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      if (carry) {                     // exp(cum_l) (q_l S), S in bf16
#pragma unroll
        for (int i = 0; i < NQ; ++i) {
#pragma unroll
          for (int jp = 0; jp < PT; ++jp) {
            uint32_t bf[4];
            ldsm_x4_t(bf, s_u + (uint32_t)(((16 * i + t_row) * ldp +
                                            jp * 16 + t_col) * 2));
            mma16816(acc[2 * jp], qf[i], bf[0], bf[1]);
            mma16816(acc[2 * jp + 1], qf[i], bf[2], bf[3]);
          }
        }
        const float e0 = exp2f(cum[l0]), e1 = exp2f(cum[l1]);
#pragma unroll
        for (int j = 0; j < 2 * PT; ++j) {
          acc[j][0] *= e0;
          acc[j][1] *= e0;
          acc[j][2] *= e1;
          acc[j][3] *= e1;
        }
      }
      const float c0 = cum[l0], c1 = cum[l1];
      for (int kb = 0; kb <= rg; ++kb) {
        const int m0 = kb * 16;
        float s[2][4];                 // rows l0 / l1, keys m0 + 8 t + 2 tig
        qk(s, qf, k_u + (uint32_t)(((m0 + kb_row) * ldn + kb_col) * 2));
        uint32_t pa[4];                // the A fragment of G V
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int m = m0 + 8 * t + 2 * tig;
          const float cm0 = cum[m], cm1 = cum[m + 1];
          const float p00 = m <= l0 ? s[t][0] * ex2(c0 - cm0) : 0.f;
          const float p01 = m + 1 <= l0 ? s[t][1] * ex2(c0 - cm1) : 0.f;
          const float p10 = m <= l1 ? s[t][2] * ex2(c1 - cm0) : 0.f;
          const float p11 = m + 1 <= l1 ? s[t][3] * ex2(c1 - cm1) : 0.f;
          pa[2 * t] = pack_bf16(p00, p01);
          pa[2 * t + 1] = pack_bf16(p10, p11);
        }
        const uint32_t va = v_u + (uint32_t)(((m0 + t_row) * ldp + t_col) * 2);
#pragma unroll
        for (int jp = 0; jp < PT; ++jp) {
          uint32_t bf[4];
          ldsm_x4_t(bf, va + jp * 32);
          mma16816(acc[2 * jp], pa, bf[0], bf[1]);
          mma16816(acc[2 * jp + 1], pa, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 2 * PT; ++j) {
        const int col = j * 8 + 2 * tig;
        if (l0 < Lr)
          *reinterpret_cast<uint32_t*>(yp + (long long)(t0 + l0) * a.ys[1] + col) =
              pack_bf16(acc[j][0], acc[j][1]);
        if (l1 < Lr)
          *reinterpret_cast<uint32_t*>(yp + (long long)(t0 + l1) * a.ys[1] + col) =
              pack_bf16(acc[j][2], acc[j][3]);
      }
    }

    // ---- the state: tiles of 16 rows of N by 16 W columns of P over the
    // warps (W = 2 where P allows), hi and lo products into separate
    // accumulators (independent chains), summed in f32 at the end
    const int kbs = (Lr + 15) >> 4;
    constexpr int W = (P & 31) ? 1 : 2, ptiles = P / (16 * W);
    for (int task = warp; task < (N >> 4) * ptiles; task += kWarps) {
      const int n0 = (task / ptiles) * 16, p0 = (task % ptiles) * 16 * W;
      float sh[2 * W][4], sl[2 * W][4];
#pragma unroll
      for (int t = 0; t < 2 * W; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) sh[t][e] = sl[t][e] = 0.f;
      for (int kb = 0; kb < kbs; ++kb) {
        const int m0 = kb * 16;
        // (k^T) fragment: rows n0 + gid (+ 8), keys mA, mA + 1 (regs 0, 1)
        // and mA + 8, mA + 9 (regs 2, 3)
        uint32_t kf[4];
        ldsm_x4_t(kf, k_u + (uint32_t)(((m0 + kb_row) * ldn + n0 + kb_col) * 2));
        const int mA = m0 + 2 * tig;
        const float w0 = wend[mA], w1 = wend[mA + 1], w2 = wend[mA + 8],
                    w3 = wend[mA + 9];
        uint32_t hi[4], lo[4];
        split(kf[0], w0, w1, &hi[0], &lo[0]);
        split(kf[1], w0, w1, &hi[1], &lo[1]);
        split(kf[2], w2, w3, &hi[2], &lo[2]);
        split(kf[3], w2, w3, &hi[3], &lo[3]);
        const uint32_t va = v_u + (uint32_t)(((m0 + t_row) * ldp + p0 + t_col) * 2);
#pragma unroll
        for (int w = 0; w < W; ++w) {
          uint32_t bf[4];
          ldsm_x4_t(bf, va + w * 32);
          mma16816(sh[2 * w], hi, bf[0], bf[1]);
          mma16816(sh[2 * w + 1], hi, bf[2], bf[3]);
          mma16816(sl[2 * w], lo, bf[0], bf[1]);
          mma16816(sl[2 * w + 1], lo, bf[2], bf[3]);
        }
      }
      // S <- exp(cum_last) S + S_chunk in f32, 16-byte stores: lane pairs
      // swap halves so the even lane holds 4 columns of row gid and the
      // odd lane 4 columns of row gid + 8
      const bool odd = tig & 1;
      const int row = n0 + gid + (odd ? 8 : 0);
      const float el = expf(c_last);
#pragma unroll
      for (int t = 0; t < 2 * W; ++t) {
        float c[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) c[e] = sh[t][e] + sl[t][e];
        const float x0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
        float4 v = odd ? make_float4(x0, x1, c[2], c[3])
                       : make_float4(c[0], c[1], x0, x1);
        float4* dst = reinterpret_cast<float4*>(
            fp + (long long)row * P + p0 + 8 * t + 2 * (tig & 2));
        if (carry) {
          const float4 o = *dst;
          v.x = fmaf(el, o.x, v.x);
          v.y = fmaf(el, o.y, v.y);
          v.z = fmaf(el, o.z, v.z);
          v.w = fmaf(el, o.w, v.w);
        }
        *dst = v;
      }
    }
    if (t0 + L < a.S) {                // the next chunk reads S in bf16
      __syncthreads();                 // fin is written; Sb is free
      for (int i = tid * 4; i < N * P; i += kThreads * 4) {
        const int n = i / P, p = i - n * P;
        const float4 v = *reinterpret_cast<const float4*>(fp + i);
        uint2 packed;
        packed.x = pack_bf16(v.x, v.y);
        packed.y = pack_bf16(v.z, v.w);
        *reinterpret_cast<uint2*>(Sb + n * ldp + p) = packed;
      }
    }
  }
}

template <int PT, int NQ>
int launch(const Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      ssd_mma_kernel<PT, NQ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  const int bytes = smem_bytes(a.L, a.N, a.P, a.S > a.L || a.h0);
  if (bytes > kMaxSmem || a.L % 16 || a.L > 256 || a.N != 16 * NQ ||
      a.P != 16 * PT)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)a.H, (unsigned)a.B);
  ssd_mma_kernel<PT, NQ><<<grid, kThreads, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

template <int NQ>
int launch_p(const Args& a, cudaStream_t s) {
  switch (a.P) {
    case 16: return launch<1, NQ>(a, s);
    case 32: return launch<2, NQ>(a, s);
    case 64: return launch<4, NQ>(a, s);
    case 128: return launch<8, NQ>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

int launch_n(const Args& a, cudaStream_t s) {
  switch (a.N) {
    case 16: return launch_p<1>(a, s);
    case 32: return launch_p<2>(a, s);
    case 64: return launch_p<4>(a, s);
    case 128: return launch_p<8>(a, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace mma

}  // namespace


// dtype: 0 = f32, 1 = bf16 (q, k, v and y alike; log_a and final are f32).
// strides: 15 element strides, (batch, seq, head) of q, k, v, log_a, y in
// turn.  route: 0 = simt, 1 = mma (bf16 only).  h0: null (a zero
// state) or the initial state [B, H, N, P] f32, contiguous and 16-byte
// aligned.
// L is the chunk (the simt route: min(chunk, S); the mma route: the
// chunk, or S rounded up to 16 when S is shorter).  Sizes are checked by
// the Python wrapper (1 <= N, P <= 128, 1 <= L <= 2048, S >= 1; the mma
// route's limits also here).  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v,
                               const float* log_a, void* y, float* fin,
                               int B, int S, int H, int N, int P, int L,
                               const long long* strides, int dtype,
                               int route, const float* h0, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = log_a;
  a.y = y;
  a.fin = fin;
  a.h0 = h0;
  a.B = B;
  a.S = S;
  a.H = H;
  a.N = N;
  a.P = P;
  a.L = L;
  for (int i = 0; i < 3; ++i) {
    a.qs[i] = strides[i];
    a.ks[i] = strides[3 + i];
    a.vs[i] = strides[6 + i];
    a.las[i] = strides[9 + i];
    a.ys[i] = strides[12 + i];
  }
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return mma::launch_n(a, s);
  }
  return dtype == 1 ? simt::launch_t<__nv_bfloat16>(a, s)
                    : simt::launch_t<float>(a, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
