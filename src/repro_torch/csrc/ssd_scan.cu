// Chunked SSD scan for Hopper: the Mamba-2 prefill recurrence.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel / ssd_scan).  For every batch b and head h, from a zero
// state S [N, P] (f32), over chunks of L rows with cum = the inclusive
// cumsum of log_a inside the chunk:
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
// sequential grid axis.  Hopper blocks run in no order, so here one block
// per (b, h) walks its chunks in order, with S in shared memory.  A chunk
// is cut into 64-row sub-tiles: for query tile i the block stages Q_i, and
// for each key tile j <= i stages K_j and V_j as f32, forms Q_i K_j^T in a
// [64, 64] shared tile scaled by exp(cum_l - cum_m) where l >= m (selected
// before exp: for l < m the exponent may overflow, and inf * 0 is NaN),
// then adds the tile times V_j into the y tile kept in registers.  The
// last query tile of a chunk sees every key tile, so it also accumulates
// the chunk's state update in registers; S is updated once the chunk's
// last tile is done.  exp(cum_l) * exp(-cum_m) is never formed (exp(-cum)
// overflows over a 256-row chunk with strong decay).  A ragged last chunk
// (S not a multiple of L) is masked here: its rows past S read as q = k =
// v = 0 and log_a = 0, which is what the TPU kernel's zero padding gives,
// so the final state equals the unpadded one.  Every sum runs in a fixed
// order with no atomics: two calls give the same bits.
//
// What bounds it on the H100: at the serving shape (B = 8, S = L = 256,
// H = 64, N = P = 64, bf16) the function moves ~43 MB (v and y 16.8 MB
// each, the f32 final state 8.4 MB; q, k and log_a ~1 MB), ~13 us at
// 3.35 TB/s, and does ~10.7 GFLOP counting the masked half of each
// [L, L] product (~0.011 ms on the bf16 tensor cores, ~0.16 ms on the f32
// CUDA cores).  This first design runs the products on the f32 CUDA cores
// from shared memory (a 16 x 16 thread grid, each thread 4 rows by up to
// 8 columns), so it is bound by shared-memory loads and the FMA rate, well
// above the byte bound; wgmma and TMA are later work.  N and P are at most
// 128, the chunk at most 2048 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
  int B, S, H, N, P, L;
  long long qs[3], ks[3], vs[3], las[3], ys[3];  // (batch, seq, head)
};

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

  for (int i = tid; i < N * P; i += kThreads) St[i] = 0.f;

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
      if (t0 > 0) {                    // carried state: exp(cum_l) (q_l S)
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

}  // namespace

// dtype: 0 = f32, 1 = bf16 (q, k, v and y alike; log_a and final are f32).
// strides: 15 element strides, (batch, seq, head) of q, k, v, log_a, y in
// turn.  Sizes are checked by the Python wrapper (1 <= N, P <= 128,
// 1 <= L <= 2048, S >= 1).  Returns cudaGetLastError() after the launch.
extern "C" int ssd_scan_launch(const void* q, const void* k, const void* v,
                               const float* log_a, void* y, float* fin,
                               int B, int S, int H, int N, int P, int L,
                               const long long* strides, int dtype,
                               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return 0;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.la = log_a;
  a.y = y;
  a.fin = fin;
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
  return dtype == 1 ? launch_t<__nv_bfloat16>(a, s) : launch_t<float>(a, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
