// Decode attention for Hopper: a few new tokens per request against its KV
// cache, as split-cache flash decoding.
//
// Replaces the Pallas TPU kernel src/repro/kernels/decode_attention/kernel.py
// (_decode_kernel / decode_attention): for every batch b, query row s < Sq
// and query head h,
//   o[b, s, h, :] = softmax_j(scale * q[b, s, h, :] . k[b, j, g, :]) v[b, j, g, :]
// with g = h / (H / Hkv), scale = Dh**-0.5, over the cache rows
//   j < lengths[b]   and, with a window,   j >= lengths[b] - window.
// Scores, probabilities and the accumulator are f32, as on the TPU (an
// online softmax; masked scores -1e30, the denominator max(l, 1e-30)); q is
// scaled in f32 before the product, as there.  Rows at or past lengths[b],
// or before the window, are never read, so a short request in a batch does
// not pay for the longest.
//
// A cache whose sequence is split across ranks (the serving rules shard
// it over "model") gives each rank a slice: `seq_offset` is the global
// position of the slice's row 0 and `seq_total` the whole cache's length,
// so the mask is tested in global positions (lengths[b] clamped to
// seq_total, the window's start derived from that).  On that route the
// kernel writes o in f32 and, beside it, each row's log-sum-exp in f32
// (natural log; -inf and o = 0 for a row with no visible key on the
// slice), which kernels/decode_attention/ops.py merges across ranks.
//
// q is bf16 or f32 (the model's compute dtype), the caches bf16 or f32 (the
// serving caches are bf16); the output has q's dtype.  Tensors are
// [B, S, heads, D], read through their strides (last dimension contiguous).
// Dh and Dv are at most 256.
//
// What bounds it on the H100: bytes, and the parallelism to move them.  A
// decode step reads each request's visible cache rows once (qwen2-0.5b at
// B = 8, mean length 256: ~1 MB a layer, ~0.3 us at 3.35 TB/s) and does
// ~4 FLOPs a cached byte, far below the ~295 ops a byte at which the tensor
// cores would matter, so the products stay on the CUDA cores.  The TPU
// kernel walks the cache along a sequential grid axis; here the cache is
// split across blocks instead:
//
// * The grid is (splits, Hkv, B); `splits` is chosen on the host from
//   B * Hkv and S alone (no host sync), at most 8.  A block serves all
//   H / Hkv query heads of its kv head (and all Sq rows), so a cache row is
//   read once for the group.  It reads lengths[b] on the device and takes
//   its share of the visible rows [lo, len): ragged requests spread evenly
//   over their splits, and a split with nothing to read yields the empty
//   partial (m = -1e30, l = 0).
// * Cache tiles of 64 rows stay in the cache dtype in shared memory, double
//   buffered by 16-byte cp.async copies where the strides allow it (one
//   buffer where two do not fit, plain loads for unaligned views).  The
//   query rows are loaded before lengths[b] is read, so the two loads'
//   latencies overlap.  Four warps split a tile's keys, 16 each, so a block
//   with one query row (Hkv = H, Sq = 1) keeps every warp busy: two lanes
//   score a key (each half of Dh, in interleaved 16-byte chunks; K rows
//   padded to an odd number of 16-byte units, so eight lanes' chunks fall
//   in distinct banks), a warp's p go through shared memory, and each lane
//   accumulates Dv/32 value columns.  A pass takes 1 query row or 8 (a
//   compile-time count, so the rows' chains interleave; rows past the last
//   one are computed on a zero query and dropped); more rows take more
//   passes.  Scores are kept in log2 units (q times scale * log2 e), so
//   each p is one exp2.
// * Each warp keeps its own (m, l, acc); the block merges its four warps in
//   warp order.  The splits of one (b, g) are launched as one thread-block
//   cluster: each block stores its partial into the cluster's first block
//   (distributed shared memory: a remote store does not wait for a reply,
//   a remote load would), and after a cluster barrier that block merges
//   them in split order.  No atomics and no scratch in device memory: two
//   calls give the same bits, and each call is one launch.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kKeys = 64;                   // cache rows per tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kWarpKeys = kKeys / kWarps;   // a warp's keys of a tile
constexpr int kRows = 8;                    // query rows per pass
constexpr int kMaxSplits = 8;               // the portable cluster size
constexpr int kMaxSmem = 232448 - 4096;     // dynamic, beside the static
constexpr float kNegInf = -1e30f;

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
  float* lse;         // [B, Sq, H] f32, or null
  int o_f32;          // o is f32 (the partial route), else q's dtype
  int seq_offset, seq_total;
  int B, Sq, S, H, Hkv, Dh, Dv;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, s, head
  int window, vec, splits, stages;
  int dhp, kld, dvp;  // Q row, K row and V row strides in shared memory
  int ksh, vsh;       // log2 of the 16-byte chunks of a K / V row, or -1
  int dsh;            // log2 Dv, or -1
  float scale;
};

// Shared memory, in bytes: Q rows (f32 [8][dhp]), the splits' partials
// (f32 [splits][8][Dv + 2]: acc, m, l; filled in the cluster's first
// block), then the cache tiles (per stage K [64][kld] and V [64][dvp] in
// the cache dtype), which the warps' partials (f32 [4][8][Dv + 2]) reuse
// once the tiles are consumed.
struct Layout {
  int part, tiles, stage, total;
};
__host__ __device__ inline Layout layout(const Args& a, int esize) {
  Layout L;
  L.part = kRows * a.dhp * 4;
  L.tiles = L.part + (a.splits > 1 ? a.splits : 0) * kRows * (a.Dv + 2) * 4;
  L.stage = kKeys * (a.kld + a.dvp) * esize;
  const int tiles = a.stages * L.stage;
  const int warps = kWarps * kRows * (a.Dv + 2) * 4;
  L.total = L.tiles + (tiles > warps ? tiles : warps);
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Stage cache rows [row0, row0 + 64) of one kv head into K [64][kld] and
// V [64][dvp]; rows at or past `end` (and K columns past Dh) read as 0.
// With `vec`, thread i copies the 16-byte chunks i, i + 128, ... (a row's
// chunks on neighbouring threads); the row of a chunk is a shift where
// the chunks of a row are a power of two.
template <typename TC>
__device__ __forceinline__ void load_tile(const Args& a, TC* Kt, const TC* kp,
                                          const TC* vp, int row0, int end) {
  TC* Vt = Kt + kKeys * a.kld;
  if (a.vec) {
    constexpr int kVec = 16 / sizeof(TC);
    const int kc = a.dhp / kVec, vc = a.dvp / kVec;
    for (int i = threadIdx.x; i < kKeys * kc; i += kThreads) {
      const int r = a.ksh >= 0 ? i >> a.ksh : i / kc, c = i - r * kc;
      const bool ok = row0 + r < end;
      cp_async16(Kt + r * a.kld + c * kVec,
                 ok ? kp + (long long)(row0 + r) * a.ks[1] + c * kVec : kp,
                 ok);
    }
    for (int i = threadIdx.x; i < kKeys * vc; i += kThreads) {
      const int r = a.vsh >= 0 ? i >> a.vsh : i / vc, c = i - r * vc;
      const bool ok = row0 + r < end;
      cp_async16(Vt + r * a.dvp + c * kVec,
                 ok ? vp + (long long)(row0 + r) * a.vs[1] + c * kVec : vp,
                 ok);
    }
  } else {
    for (int r = 0; r < kKeys; ++r) {
      const bool ok = row0 + r < end;
      const TC* kr = kp + (long long)(row0 + r) * a.ks[1];
      const TC* vr = vp + (long long)(row0 + r) * a.vs[1];
      for (int d = threadIdx.x; d < a.dhp; d += kThreads)
        store(Kt + r * a.kld + d, ok && d < a.Dh ? to_f32(kr[d]) : 0.f);
      for (int d = threadIdx.x; d < a.Dv; d += kThreads)
        store(Vt + r * a.dvp + d, ok ? to_f32(vr[d]) : 0.f);
    }
  }
}

// 16 bytes of the cache dtype as f32
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const float*) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       const __nv_bfloat16*) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 f = __bfloat1622float2(p[x]);
    out[2 * x] = f.x;
    out[2 * x + 1] = f.y;
  }
}

// The element offset of query row `row` of a kv group whose first head is
// h0 (row = head offset * Sq + token) in a [B, S, heads, D] tensor's batch.
__device__ __forceinline__ long long row_off(const Args& a, int row, int h0,
                                             const long long* st) {
  const int hh = a.Sq == 1 ? row : row / a.Sq, t = row - hh * a.Sq;
  return t * st[1] + (h0 + hh) * st[2];
}

// Output element `col` of query row `row` (of the group whose first head is
// h0) of batch b: in q's dtype, or in f32 on the partial route.
template <typename TQ>
__device__ __forceinline__ void store_out(const Args& a, int b, int row,
                                          int h0, int col, float v) {
  const long long off = b * a.os[0] + row_off(a, row, h0, a.os) + col;
  if (a.o_f32)
    static_cast<float*>(a.o)[off] = v;
  else
    store(static_cast<TQ*>(a.o) + off, v);
}

// Row `row`'s log-sum-exp (natural log) from its max M (log2 units) and
// denominator l: -inf where no key was visible.
__device__ __forceinline__ void store_lse(const Args& a, int b, int row,
                                          int h0, float M, float l) {
  const int hh = a.Sq == 1 ? row : row / a.Sq, t = row - hh * a.Sq;
  a.lse[((long long)b * a.Sq + t) * a.H + h0 + hh] =
      l > 0.f ? (M + log2f(l)) * 0.6931471805599453f : __int_as_float(0xff800000u);
}

// Rows [r0, r0 + RP) of the group's queries, times mul, into registers:
// thread tid holds elements tid and tid + 128 of each (0 past Dh or R).
template <int RP, typename TQ>
__device__ __forceinline__ void load_q(const Args& a, float (&qv)[RP][2],
                                       const TQ* qp, int r0, int R, int h0,
                                       float mul) {
#pragma unroll
  for (int r = 0; r < RP; ++r) {
    const bool row_ok = r0 + r < R;
    const TQ* qr = qp + (row_ok ? row_off(a, r0 + r, h0, a.qs) : 0);
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int d = threadIdx.x + x * kThreads;
      qv[r][x] = row_ok && d < a.Dh ? to_f32(qr[d]) * mul : 0.f;
    }
  }
}

// NC = value columns per lane (Dv <= 32 * NC); RP = query rows a pass (1,
// or 8 with rows past the last one computed on a zero query and dropped)
template <typename TQ, typename TC, int NC, int RP>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  constexpr int kVec = 16 / sizeof(TC);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) float pbuf[kWarps][RP][kWarpKeys];  // a warp's p
  __shared__ float wts[RP][kWarps + 1];     // the warps' weights, then l
  __shared__ float sw[RP][kMaxSplits];      // the splits' weights
  const Layout L = layout(a, sizeof(TC));
  float* Qs = reinterpret_cast<float*>(smem);
  float* part = reinterpret_cast<float*>(smem + L.part);
  unsigned char* tiles = smem + L.tiles;
  float* wpart = reinterpret_cast<float*>(tiles);

  const int split = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int rep = a.H / a.Hkv, R = rep * a.Sq, dv1 = a.Dv + 2;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int half = lane >> 4, key = lane & 15;  // two lanes a key
  const int nchunk = a.dhp / kVec;
  // this split's slot among the partials in the cluster's first block
  // (blockIdx.x is the block's rank in its cluster)
  float* gather = part;
  if (a.splits > 1) {
    gather = cg::this_cluster().map_shared_rank(part, 0) + split * kRows * dv1;
    // this block has started (waited for before the first remote store)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  }

  const TQ* qp = static_cast<const TQ*>(a.q) + b * a.qs[0];
  const TC* kp = static_cast<const TC*>(a.k) + b * a.ks[0] + g * a.ks[2];
  const TC* vp = static_cast<const TC*>(a.v) + b * a.vs[0] + g * a.vs[2];
  // scores in log2 units: q times scale * log2 e, so each p is one exp2
  const float c2 = a.scale * 1.4426950408889634f;
  // a pass's query rows: thread tid loads elements tid and tid + 128 of
  // each row into registers, before anything waits on lengths[b]
  float qv[RP][2];
  load_q<RP>(a, qv, qp, 0, R, g * rep, c2);

  // this split's share of the visible rows [lo, len): global positions
  // (lengths[b] clamped to the whole cache), then this slice's rows
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len < a.seq_total ? len : a.seq_total);
  int lo = a.window && len > a.window ? len - a.window : 0;
  len -= a.seq_offset;
  lo -= a.seq_offset;
  len = len < a.S ? len : a.S;
  lo = lo > 0 ? lo : 0;
  len = len > lo ? len : lo;
  const int per = (len - lo + a.splits - 1) / a.splits;
  const int start = lo + split * per;
  const int end = start + per < len ? start + per : len;
  const int ntile = end > start ? (end - start + kKeys - 1) / kKeys : 0;

  for (int r0 = 0; r0 < R; r0 += RP) {
    const int nr = R - r0 < RP ? R - r0 : RP;
    if (r0 > 0) load_q<RP>(a, qv, qp, r0, R, g * rep, c2);
    __syncthreads();  // the previous pass is done with shared memory
    if (ntile > 0) {  // the first tile's copies overlap the query's loads
      load_tile(a, reinterpret_cast<TC*>(tiles), kp, vp, start, end);
      cp_async_commit();
    }
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int d = tid + x * kThreads;
        if (d < a.dhp) Qs[r * a.dhp + d] = qv[r][x];
      }
    // m: the running max (warp-uniform); l: this lane's key's share of the
    // denominator, summed over the warp's keys at the end
    float m[RP], l[RP], acc[RP][NC];
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      m[r] = kNegInf;
      l[r] = 0.f;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
    }

    for (int t = 0; t < ntile; ++t) {
      const int st = a.stages == 2 ? (t & 1) : 0;
      if (a.stages == 2 && t + 1 < ntile) {
        load_tile(a, reinterpret_cast<TC*>(tiles + (st ^ 1) * L.stage), kp,
                  vp, start + (t + 1) * kKeys, end);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();

      const int k0 = start + t * kKeys + warp * kWarpKeys;
      const int kw = end - k0 < kWarpKeys ? end - k0 : kWarpKeys;
      if (kw > 0) {  // warp-uniform: the warp has keys in this tile
        const TC* Kt = reinterpret_cast<const TC*>(tiles + st * L.stage);
        const TC* Vt = Kt + kKeys * a.kld + warp * kWarpKeys * a.dvp;
        const bool valid = key < kw;
        const uint4* krow = reinterpret_cast<const uint4*>(
            Kt + (warp * kWarpKeys + key) * a.kld);
        float s[RP];
#pragma unroll
        for (int r = 0; r < RP; ++r) s[r] = 0.f;
#pragma unroll 4
        for (int c = half; c < nchunk; c += 2) {
          float kf[kVec];
          unpack(krow[c], kf, static_cast<const TC*>(nullptr));
#pragma unroll
          for (int r = 0; r < RP; ++r) {
            const float4* qv =
                reinterpret_cast<const float4*>(Qs + r * a.dhp + c * kVec);
#pragma unroll
            for (int x = 0; x < kVec / 4; ++x) {
              const float4 q4 = qv[x];
              s[r] = fmaf(q4.x, kf[4 * x], s[r]);
              s[r] = fmaf(q4.y, kf[4 * x + 1], s[r]);
              s[r] = fmaf(q4.z, kf[4 * x + 2], s[r]);
              s[r] = fmaf(q4.w, kf[4 * x + 3], s[r]);
            }
          }
        }
#pragma unroll
        for (int r = 0; r < RP; ++r) {
          s[r] += __shfl_xor_sync(0xffffffffu, s[r], 16);
          const float x = valid ? s[r] : kNegInf;
          float mx = x;
#pragma unroll
          for (int off = 8; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
          const float m_new = fmaxf(m[r], mx);
          const float p = valid ? exp2f(x - m_new) : 0.f;
          const float corr = exp2f(m[r] - m_new);
          l[r] = l[r] * corr + p;
          m[r] = m_new;
#pragma unroll
          for (int c = 0; c < NC; ++c) acc[r][c] *= corr;
          if (half == 0) pbuf[warp][r][key] = p;
        }
        __syncwarp();
        // acc[r][c] += sum_j p[r][j] * V[j][c * 32 + lane], four keys at a
        // time (p past kw is 0, and those V rows are zero-filled)
#pragma unroll 4
        for (int j = 0; j < kw; j += 4) {
          float4 p4[RP];
#pragma unroll
          for (int r = 0; r < RP; ++r)
            p4[r] = *reinterpret_cast<const float4*>(&pbuf[warp][r][j]);
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            float vv[NC];
#pragma unroll
            for (int c = 0; c < NC; ++c) {
              const int col = c * 32 + lane;
              vv[c] = col < a.Dv ? to_f32(Vt[(j + x) * a.dvp + col]) : 0.f;
            }
#pragma unroll
            for (int r = 0; r < RP; ++r) {
              const float pj = x == 0   ? p4[r].x
                               : x == 1 ? p4[r].y
                               : x == 2 ? p4[r].z
                                        : p4[r].w;
#pragma unroll
              for (int c = 0; c < NC; ++c)
                acc[r][c] = fmaf(pj, vv[c], acc[r][c]);
            }
          }
        }
        __syncwarp();  // pbuf is read before the next tile writes it
      }
      __syncthreads();  // this stage is free for the next copy into it
      if (a.stages == 1 && t + 1 < ntile) {
        load_tile(a, reinterpret_cast<TC*>(tiles), kp, vp,
                  start + (t + 1) * kKeys, end);
        cp_async_commit();
      }
    }

    // the warp's denominators: its key lanes' shares, in a fixed order
#pragma unroll
    for (int r = 0; r < RP; ++r)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
    // merge the four warps in warp order (the tiles' memory is free); rows
    // past nr hold finite values of a zero query and are never stored
#pragma unroll
    for (int r = 0; r < RP; ++r) {
      float* w = wpart + (warp * RP + r) * dv1;
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = c * 32 + lane;
        if (col < a.Dv) w[col] = acc[r][c];
      }
      if (lane == 0) {
        w[a.Dv] = m[r];
        w[a.Dv + 1] = l[r];
      }
    }
    __syncthreads();
    float M = kNegInf, Lw = 0.f;  // row tid's max and denominator
    if (tid < RP) {               // and its warps' weights exp2(m_w - M)
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        M = fmaxf(M, wpart[(w * RP + tid) * dv1 + a.Dv]);
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float* pw = wpart + (w * RP + tid) * dv1;
        const float e = exp2f(pw[a.Dv] - M);
        wts[tid][w] = e;
        Lw += pw[a.Dv + 1] * e;
      }
      wts[tid][kWarps] = Lw;
      if (a.lse && a.splits == 1 && tid < nr)
        store_lse(a, b, r0 + tid, g * rep, M, Lw);
    }
    __syncthreads();
    if (a.splits > 1 && r0 == 0)  // the first block has started
      asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int i = tid; i < RP * a.Dv; i += kThreads) {
      const int r = a.dsh >= 0 ? i >> a.dsh : i / a.Dv, col = i - r * a.Dv;
      float A = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        A += wpart[(w * RP + r) * dv1 + col] * wts[r][w];
      if (a.splits > 1)
        gather[r * dv1 + col] = A;
      else if (r < nr)
        store_out<TQ>(a, b, r0 + r, g * rep, col,
                      A / fmaxf(wts[r][kWarps], 1e-30f));
    }
    if (a.splits > 1 && tid < RP) {
      gather[tid * dv1 + a.Dv] = M;
      gather[tid * dv1 + a.Dv + 1] = Lw;
    }

    // merge the splits in split order, in the cluster's first block
    if (a.splits > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      cluster.sync();  // every split's partial has landed
      if (split == 0) {
        if (tid < RP * kMaxSplits) {  // weight exp2(m_sp - M) of (r, sp)
          const int r = tid / kMaxSplits, sp = tid % kMaxSplits;
          float Ms = kNegInf;
#pragma unroll
          for (int x = 0; x < kMaxSplits; ++x)
            if (x < a.splits)
              Ms = fmaxf(Ms, part[(x * kRows + r) * dv1 + a.Dv]);
          sw[r][sp] = sp < a.splits
                          ? exp2f(part[(sp * kRows + r) * dv1 + a.Dv] - Ms)
                          : 0.f;
        }
        __syncthreads();
        if (a.lse && tid < nr) {      // the row's max and denominator
          float Ms = kNegInf, Ls = 0.f;
          for (int sp = 0; sp < a.splits; ++sp)
            Ms = fmaxf(Ms, part[(sp * kRows + tid) * dv1 + a.Dv]);
          for (int sp = 0; sp < a.splits; ++sp)
            Ls += part[(sp * kRows + tid) * dv1 + a.Dv + 1] * sw[tid][sp];
          store_lse(a, b, r0 + tid, g * rep, Ms, Ls);
        }
        for (int i = tid; i < RP * a.Dv; i += kThreads) {
          const int r = a.dsh >= 0 ? i >> a.dsh : i / a.Dv, col = i - r * a.Dv;
          float A = 0.f, Ls = 0.f;
#pragma unroll
          for (int sp = 0; sp < kMaxSplits; ++sp) {
            if (sp < a.splits) {
              const float* ps = part + (sp * kRows + r) * dv1;
              A += ps[col] * sw[r][sp];
              Ls += ps[a.Dv + 1] * sw[r][sp];
            }
          }
          if (r < nr)
            store_out<TQ>(a, b, r0 + r, g * rep, col, A / fmaxf(Ls, 1e-30f));
        }
      }
      // the next pass writes the slots again only once they are read
      if (r0 + RP < R) cluster.sync();
    }
  }
}

template <typename TQ, typename TC, int NC, int RP>
int launch(Args& a, cudaStream_t s) {
  // raise the dynamic shared-memory ceiling once per instance
  static const cudaError_t attr = cudaFuncSetAttribute(
      decode_attention_kernel<TQ, TC, NC, RP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (attr != cudaSuccess) return (int)attr;
  constexpr int kVec = 16 / sizeof(TC);
  const int nchunk = (a.Dh + kVec - 1) / kVec;
  a.dhp = nchunk * kVec;
  a.kld = (nchunk | 1) * kVec;  // an odd number of 16-byte units
  a.dvp = (a.Dv + kVec - 1) / kVec * kVec;
  const int kc = a.dhp / kVec, vc = a.dvp / kVec;
  a.ksh = (kc & (kc - 1)) == 0 ? __builtin_ctz(kc) : -1;
  a.vsh = (vc & (vc - 1)) == 0 ? __builtin_ctz(vc) : -1;
  a.dsh = (a.Dv & (a.Dv - 1)) == 0 ? __builtin_ctz(a.Dv) : -1;
  a.stages = 2;
  if (layout(a, sizeof(TC)).total > kMaxSmem) a.stages = 1;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)a.splits, (unsigned)a.Hkv, (unsigned)a.B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = (size_t)layout(a, sizeof(TC)).total;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)a.splits;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = a.splits > 1 ? 1 : 0;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, decode_attention_kernel<TQ, TC, NC, RP>, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename TQ, typename TC, int NC>
int launch_rp(Args& a, cudaStream_t s) {
  if (a.H / a.Hkv * a.Sq == 1) return launch<TQ, TC, NC, 1>(a, s);
  return launch<TQ, TC, NC, kRows>(a, s);
}

template <typename TQ, typename TC>
int launch_nc(Args& a, cudaStream_t s) {
  if (a.Dv <= 32) return launch_rp<TQ, TC, 1>(a, s);
  if (a.Dv <= 64) return launch_rp<TQ, TC, 2>(a, s);
  if (a.Dv <= 128) return launch_rp<TQ, TC, 4>(a, s);
  return launch_rp<TQ, TC, 8>(a, s);
}

}  // namespace

// q_dtype / c_dtype: 0 = f32, 1 = bf16 (o has q's dtype, or f32 with
// lse).  strides: 12 element strides, (batch, seq, head) of q, k, v, o in
// turn.  lengths: [B] int32 on the device.  seq_offset / seq_total: the
// global position of cache row 0 and the whole cache's length (0 and S
// for a whole cache).  lse: null, or [B, Sq, H] f32 (then o is f32).
// splits: blocks a (b, kv head), 1-8 (the wrapper's plan).  Sizes are
// checked by the Python wrapper (1 <= Dh, Dv <= 256, H % Hkv == 0).
// Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_launch(const void* q, const void* k,
                                       const void* v, const void* lengths,
                                       void* o, int B, int Sq, int S, int H,
                                       int Hkv, int Dh, int Dv,
                                       const long long* strides, int window,
                                       float scale, int q_dtype, int c_dtype,
                                       int vec, int splits, int seq_offset,
                                       int seq_total, float* lse,
                                       void* stream) {
  if (B <= 0 || Sq <= 0 || H <= 0) return 0;
  if (splits < 1 || splits > kMaxSplits) return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.lengths = static_cast<const int32_t*>(lengths);
  a.o = o;
  a.lse = lse;
  a.o_f32 = lse != nullptr;
  a.seq_offset = seq_offset;
  a.seq_total = seq_total;
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
  a.splits = splits;
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
