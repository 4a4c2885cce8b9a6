// Fused segmented combine + in-place slate read-modify-write for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/slate_update/kernel.py
// (_slate_kernel / slate_update): the updater hot loop of a counter-style
// AssociativeUpdater (DESIGN.md section 2.3).
//
// Inputs (one microbatch, sorted by key):
//   keys   [B]    int32 or int64, sorted; compared only for equality
//   deltas [B, D] f32, D % 8 == 0; rows of invalid events arrive zeroed
//   slots  [B]    int32 slate row for each run-last row, -1 elsewhere;
//                 distinct runs have distinct slots (no write conflicts)
//   table  [N, D] f32, updated in place
// For every row i with slots[i] >= 0 the kernel combines the inclusive
// prefix of i's key run (sum, or max over the non-negative domain with 0
// as identity) and folds it into table[slots[i]].
//
// What bounds it: bytes (keys, slots and deltas read once, one random
// 32-byte sector read and written per updated slate row and column group),
// about 3.3 MB at B = 65,536, D = 8: ~1 us at 3.35 TB/s.  At that size the
// time is launch and memory latency, so the design keeps the chain of
// dependent steps short and independent of how long a run is.
//
// Design: a tile-parallel segmented scan.  Each block takes one tile of
// kTile = 512 rows and one 8-column group, by a tile id drawn from an
// atomic counter (so every tile it may wait on is already running or
// done).  Its 256 threads load 2 rows each as 16-byte vectors and scan
// them in a fixed order: serially in the thread, then across lanes with
// shuffles and head flags, then across the 8 warps in shared memory.  The
// block then publishes its tile's status: the aggregate of its last
// segment and whether the tile holds a run head.  Rows whose run began in
// an earlier tile (only the tile's leading run) add the aggregates of the
// predecessor tiles back to the one holding the run's head: warp 0 reads
// 32 statuses at a time, one a lane, and sums them by a fixed butterfly,
// windows nearest first.  A predecessor's own look-back result is never
// used, so no sum depends on which tile finished first: every call gives
// the same bits.  Each slotted row then does one plain read-modify-write of
// its table row: slots of distinct runs are distinct, so there are no
// atomics on the table.  A one-key batch of 65,536 rows is 128 tiles and
// four look-back windows.
//
// The status words live in a scratch buffer owned by the wrapper (one per
// device, zeroed once when it is allocated).  The last block to finish
// (an atomic count) clears the statuses of the launch and the two
// counters, so every launch finds the scratch all zero, as the first one
// did: no memset and no per-call state from the host, and a captured
// launch replays as it is.  Launches that share a scratch must not
// overlap (one stream).
//
// Sums follow another order than the JAX oracle's segment_sum and the
// plain version's doubling scan; results are bitwise equal under the
// counter contract (integer-valued f32 below 2**24).  Max is
// order-independent and always bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 2;                     // rows per thread
constexpr int kTile = kThreads * kRows;      // rows per tile
constexpr int kGroup = 8;                    // columns per block
constexpr int kHeader = 32;                  // counter words before statuses
// status of a (tile, group), kStatus words: the flag (0 unpublished,
// 1 no head, 2 head) and, from word 4 (16-byte aligned), the aggregate
constexpr int kStatus = 12;
constexpr int kNoHead = 1;
constexpr int kHead = 2;

struct Vec {
  float v[kGroup];
};

template <bool kMax>
__device__ __forceinline__ float op(float a, float b) {
  return kMax ? fmaxf(a, b) : a + b;
}

template <bool kMax>
__device__ __forceinline__ void combine(Vec& acc, const Vec& x) {
#pragma unroll
  for (int d = 0; d < kGroup; ++d) acc.v[d] = op<kMax>(acc.v[d], x.v[d]);
}

__device__ __forceinline__ Vec shfl_up(const Vec& x, int off) {
  Vec r;
#pragma unroll
  for (int d = 0; d < kGroup; ++d)
    r.v[d] = __shfl_up_sync(0xffffffffu, x.v[d], off);
  return r;
}

__device__ __forceinline__ Vec shfl_xor(const Vec& x, int off) {
  Vec r;
#pragma unroll
  for (int d = 0; d < kGroup; ++d)
    r.v[d] = __shfl_xor_sync(0xffffffffu, x.v[d], off);
  return r;
}

__device__ __forceinline__ Vec load8(const float* p) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  return Vec{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

__device__ __forceinline__ void store8(float* p, const Vec& x) {
  reinterpret_cast<float4*>(p)[0] =
      make_float4(x.v[0], x.v[1], x.v[2], x.v[3]);
  reinterpret_cast<float4*>(p)[1] =
      make_float4(x.v[4], x.v[5], x.v[6], x.v[7]);
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

template <typename KeyT, bool kMax>
__global__ void __launch_bounds__(kThreads)
slate_update_kernel(const KeyT* __restrict__ keys,
                    const float* __restrict__ deltas,
                    const int32_t* __restrict__ slots,
                    float* __restrict__ table, int* __restrict__ scratch,
                    long long B, int D, int groups, int n_blocks) {
  __shared__ int s_id;
  __shared__ int s_last;
  __shared__ Vec s_warp_agg[kWarps];
  __shared__ int s_warp_head[kWarps];
  __shared__ Vec s_warp_pre[kWarps];
  __shared__ int s_warp_pre_head[kWarps];
  __shared__ Vec s_carry;

  int* ctr = scratch;                        // [0] next id, [1] finished
  int* status = scratch + kHeader;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (tid == 0) s_id = atomicAdd(&ctr[0], 1);
  __syncthreads();
  const int id = s_id;                       // tile-major: (t, g)
  const long long t = id / groups;
  const int c0 = (id - (int)t * groups) * kGroup;
  const long long row0 = t * kTile + (long long)tid * kRows;

  // ---- load this thread's rows; heads where the key changes ----------
  Vec v[kRows];
  bool head[kRows];
  int32_t slot[kRows];
  KeyT prev = (row0 > 0 && row0 <= B) ? keys[row0 - 1] : KeyT(0);
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    const long long r = row0 + j;
    if (r < B) {
      const KeyT k = keys[r];
      head[j] = (r == 0) || (k != prev);
      prev = k;
      slot[j] = slots[r];
      v[j] = load8(deltas + r * D + c0);
      if (kMax) {
#pragma unroll
        for (int d = 0; d < kGroup; ++d) v[j].v[d] = fmaxf(v[j].v[d], 0.0f);
      }
    } else {                                  // past the batch: own run
      head[j] = true;
      slot[j] = -1;
#pragma unroll
      for (int d = 0; d < kGroup; ++d) v[j].v[d] = 0.0f;
    }
  }

  // ---- serial scan inside the thread ---------------------------------
  // seen[j]: a head lies at or before row j among this thread's rows
  bool seen[kRows];
  seen[0] = head[0];
#pragma unroll
  for (int j = 1; j < kRows; ++j) {
    if (!head[j]) combine<kMax>(v[j], v[j - 1]);
    seen[j] = seen[j - 1] || head[j];
  }

  // ---- segmented inclusive scan of thread aggregates across lanes ----
  Vec s = v[kRows - 1];
  bool f = seen[kRows - 1];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Vec up = shfl_up(s, off);
    const bool fup = __shfl_up_sync(0xffffffffu, f, off);
    if (lane >= off) {
      if (!f) combine<kMax>(s, up);
      f = f || fup;
    }
  }
  // exclusive prefix of this thread inside its warp
  Vec ex = shfl_up(s, 1);
  bool exf = __shfl_up_sync(0xffffffffu, f, 1);
  if (lane == 31) {
    s_warp_agg[warp] = s;
    s_warp_head[warp] = f;
  }
  __syncthreads();

  // ---- across warps, then publish the tile's status ------------------
  if (warp == 0) {
    Vec w = s_warp_agg[lane < kWarps ? lane : 0];
    bool wf = lane < kWarps ? s_warp_head[lane] : true;
#pragma unroll
    for (int off = 1; off < kWarps; off <<= 1) {
      const Vec up = shfl_up(w, off);
      const bool fup = __shfl_up_sync(0xffffffffu, wf, off);
      if (lane >= off) {
        if (!wf) combine<kMax>(w, up);
        wf = wf || fup;
      }
    }
    const Vec wex = shfl_up(w, 1);
    const bool wexf = __shfl_up_sync(0xffffffffu, wf, 1);
    if (lane < kWarps) {
      s_warp_pre[lane] = wex;                 // lane 0's is never read
      s_warp_pre_head[lane] = lane == 0 ? 0 : wexf;
    }
    if (lane == kWarps - 1) {                 // the tile's last segment
      int* own = status + (long long)id * kStatus;
      store8(reinterpret_cast<float*>(own + 4), w);
      st_release(own, wf ? kHead : kNoHead);
    }
  }
  __syncthreads();

  // ---- each row's prefix inside the tile -----------------------------
  // pre: prefix of the rows before this thread's first row, back to the
  // run's head or the tile's start; pref: whether that reaches a head
  Vec pre = ex;                               // lane 0's is never read
  bool pref = lane > 0 && exf;
  if (!pref && warp > 0) {                    // reach into earlier warps
    if (lane > 0) combine<kMax>(pre, s_warp_pre[warp]);
    else pre = s_warp_pre[warp];
    pref = s_warp_pre_head[warp];
  }
  const bool has_pre = lane > 0 || warp > 0;  // rows precede this thread
  // in_tile[j]: row j's run began inside this tile
  bool in_tile[kRows];
  bool need = false;
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (!seen[j] && has_pre) combine<kMax>(v[j], pre);
    in_tile[j] = seen[j] || pref;
    need = need || (!in_tile[j] && slot[j] >= 0);
  }

  // ---- look back over earlier tiles for the leading run --------------
  if (__syncthreads_or(need)) {
    if (warp == 0) {
      Vec carry;
      bool have = false;
      for (long long base = t - 1;; base -= 32) {
        const long long tp = base - lane;
        Vec a;
        bool ahead = true;                    // before tile 0: a head
        if (tp >= 0) {
          const int* st =
              status + (tp * groups + (id - (int)t * groups)) * kStatus;
          int fl;
          while ((fl = ld_acquire(st)) == 0) {
          }
          ahead = fl == kHead;
          const float4* p = reinterpret_cast<const float4*>(st + 4);
          const float4 x = __ldcg(p);
          const float4 y = __ldcg(p + 1);
          a = Vec{{x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w}};
        } else {
#pragma unroll
          for (int d = 0; d < kGroup; ++d) a.v[d] = 0.0f;
        }
        const unsigned heads = __ballot_sync(0xffffffffu, ahead);
        const int first = heads ? __ffs(heads) - 1 : 31;
        // lanes up to the head tile contribute; a fixed butterfly
        bool on = lane <= first && tp >= 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const Vec o = shfl_xor(a, off);
          const bool oon = __shfl_xor_sync(0xffffffffu, on, off);
          if (oon) {
            if (on) combine<kMax>(a, o);
            else a = o;
          }
          on = on || oon;
        }
        if (on) {                             // the same on every lane
          if (have) combine<kMax>(carry, a);
          else carry = a;
          have = true;
        }
        if (heads) break;
      }
      if (lane == 0) s_carry = carry;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kRows; ++j)
      if (!in_tile[j] && slot[j] >= 0) combine<kMax>(v[j], s_carry);
  }

  // ---- one read-modify-write per slotted row -------------------------
#pragma unroll
  for (int j = 0; j < kRows; ++j) {
    if (slot[j] >= 0) {
      float* dst = table + (long long)slot[j] * D + c0;
      Vec cur = load8(dst);
      combine<kMax>(cur, v[j]);
      store8(dst, cur);
    }
  }

  // ---- the last block to finish clears the scratch -------------------
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(&ctr[1], 1) == n_blocks - 1;
  }
  __syncthreads();
  if (s_last) {
    __threadfence();
    int4* words = reinterpret_cast<int4*>(status);
    const int n4 = n_blocks * kStatus / 4;
    for (int i = tid; i < n4; i += kThreads) words[i] = make_int4(0, 0, 0, 0);
    if (tid == 0) {
      ctr[0] = 0;
      ctr[1] = 0;
    }
  }
}

long long n_blocks_of(long long B, int D) {
  return (B + kTile - 1) / kTile * (D / kGroup);
}

template <typename KeyT>
int launch(const void* keys, const void* deltas, const void* slots,
           void* table, void* scratch, long long B, int D, int op,
           void* stream) {
  const long long n = n_blocks_of(B, D);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int groups = D / kGroup;
  auto* k = static_cast<const KeyT*>(keys);
  auto* dl = static_cast<const float*>(deltas);
  auto* sl = static_cast<const int32_t*>(slots);
  auto* tb = static_cast<float*>(table);
  auto* sc = static_cast<int*>(scratch);
  if (op == 1)
    slate_update_kernel<KeyT, true><<<(unsigned)n, kThreads, 0, s>>>(
        k, dl, sl, tb, sc, B, D, groups, (int)n);
  else
    slate_update_kernel<KeyT, false><<<(unsigned)n, kThreads, 0, s>>>(
        k, dl, sl, tb, sc, B, D, groups, (int)n);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of zeroed scratch a launch at (B, D) needs.
extern "C" long long slate_update_scratch_bytes(long long B, int D) {
  const long long n = n_blocks_of(B, D);
  return (kHeader + n * kStatus) * 4;
}

// op: 0 = sum, 1 = max.  key_bytes: 4 (int32) or 8 (int64).  scratch:
// at least slate_update_scratch_bytes(B, D), zero before the first launch
// (each launch leaves it zero).  Returns cudaGetLastError() after the
// launch.
extern "C" int slate_update_launch(const void* keys, const void* deltas,
                                   const void* slots, void* table,
                                   void* scratch, long long B, int D, int op,
                                   int key_bytes, void* stream) {
  if (B <= 0) return 0;
  if (key_bytes == 8)
    return launch<long long>(keys, deltas, slots, table, scratch, B, D, op,
                             stream);
  return launch<int>(keys, deltas, slots, table, scratch, B, D, op, stream);
}

extern "C" const char* slate_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
