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
// Design: one warp per row with a slot.  The warp walks its run backward
// 32 rows at a time; a ballot on key equality finds where the run starts.
// Each lane accumulates its own rows' 8-column tile in registers across
// the walk, and one shuffle reduction at the end gives the run total;
// lane d then read-modify-writes table[slot, c0 + d].  No atomics: slots
// of distinct runs are unique.  The work is memory-bound (gather of the
// deltas, one random 32-byte sector read and written per slate row); the
// backward walk costs one warp O(run length / 32) steps, so a single hot
// run (a fifth of the batch under Zipf skew) serializes on one warp.
//
// Sum order differs from the JAX oracle's segment_sum; results are
// bitwise equal under the counter contract (integer-valued f32 below
// 2**24).  Max is order-independent and always bitwise equal.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kTile = 8;           // columns per register tile

template <typename KeyT, bool kMax>
__global__ void slate_update_kernel(const KeyT* __restrict__ keys,
                                    const float* __restrict__ deltas,
                                    const int32_t* __restrict__ slots,
                                    float* __restrict__ table,
                                    int64_t B, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;
  const int64_t slot = slots[row];           // widened for the address
  if (slot < 0) return;                       // warp-uniform exit
  const KeyT key = keys[row];

  for (int c0 = 0; c0 < D; c0 += kTile) {
    float acc[kTile];
#pragma unroll
    for (int d = 0; d < kTile; ++d) acc[d] = 0.0f;

    for (int64_t base = row;; base -= 32) {
      const int64_t j = base - lane;          // lane 0 = nearest row
      const bool in_run = (j >= 0) && (keys[j] == key);
      const unsigned m = __ballot_sync(0xffffffffu, in_run);
      // rows of one run are contiguous: lanes [0, n) belong to it
      const int n = (~m == 0u) ? 32 : (__ffs(~m) - 1);
      if (lane < n) {
        const float4* src =
            reinterpret_cast<const float4*>(deltas + j * D + c0);
        const float4 a = src[0];
        const float4 b = src[1];
        const float v[kTile] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int d = 0; d < kTile; ++d)
          acc[d] = kMax ? fmaxf(acc[d], v[d]) : acc[d] + v[d];
      }
      if (n < 32) break;
    }

#pragma unroll
    for (int d = 0; d < kTile; ++d) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float o = __shfl_xor_sync(0xffffffffu, acc[d], off);
        acc[d] = kMax ? fmaxf(acc[d], o) : acc[d] + o;
      }
    }
    if (lane < kTile) {
      float total = acc[0];
#pragma unroll
      for (int d = 1; d < kTile; ++d)
        if (lane == d) total = acc[d];
      float* dst = table + slot * D + c0 + lane;
      *dst = kMax ? fmaxf(*dst, total) : *dst + total;
    }
  }
}

template <typename KeyT>
int launch(const void* keys, const void* deltas, const void* slots,
           void* table, long long B, int D, int op, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((B + kWarpsPerBlock - 1) / kWarpsPerBlock));
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (op == 1) {
    slate_update_kernel<KeyT, true><<<grid, block, 0, s>>>(
        static_cast<const KeyT*>(keys), static_cast<const float*>(deltas),
        static_cast<const int32_t*>(slots), static_cast<float*>(table), B, D);
  } else {
    slate_update_kernel<KeyT, false><<<grid, block, 0, s>>>(
        static_cast<const KeyT*>(keys), static_cast<const float*>(deltas),
        static_cast<const int32_t*>(slots), static_cast<float*>(table), B, D);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 = sum, 1 = max.  key_bytes: 4 (int32) or 8 (int64).
// Returns cudaGetLastError() after the launch.
extern "C" int slate_update_launch(const void* keys, const void* deltas,
                                   const void* slots, void* table,
                                   long long B, int D, int op,
                                   int key_bytes, void* stream) {
  if (key_bytes == 8)
    return launch<long long>(keys, deltas, slots, table, B, D, op, stream);
  return launch<int>(keys, deltas, slots, table, B, D, op, stream);
}

extern "C" const char* slate_update_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
