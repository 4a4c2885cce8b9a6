// Batched slate point-lookup for Hopper: probe walk + row gather.
//
// Replaces the Pallas TPU kernels src/repro/kernels/slate_lookup/kernel.py
// (_lookup_kernel / slate_lookup for int32 keys, and _lookup_kernel_wide /
// slate_lookup_wide, which split int64 keys into 32-bit planes because TPU
// SMEM scalars are 32-bit).  One kernel templated on the key type serves
// both widths here.
//
// Inputs:
//   table_keys [N]    int32 or int64 (EMPTY = -1)
//   query      [Q]    same key type
//   cand       [P, Q] int32 probe candidates from slates/table._probe_seq
//                     (the hash math stays in one place, outside the kernel)
//   vals       [N, D] 32-bit words (f32 or int32), row-major
// Outputs:
//   slot  [Q] int32: the first candidate whose key equals the query, or -1
//   found [Q] bool
//   rows  [Q, D]: vals[slot], zeros on a miss
//
// Design: one warp per query.  Lanes 0..P-1 load their candidate slot and
// that slot's key; a ballot on equality and __ffs give the first hit in
// probe order (table.lookup's first_true).  The warp then copies the D-wide
// row (lanes stride the columns) or writes zeros.  The work is bound by
// random 32-byte sector reads (P key probes and one row per query), so the
// design keeps every probe of a query in flight at once instead of walking
// them in turn as the TPU kernel's scalar loop does.  There is no limit on
// Q (the TPU kernel's MAX_Q came from SMEM).  Bitwise equal to the plain
// version always.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename KeyT>
__global__ void slate_lookup_kernel(const KeyT* __restrict__ table_keys,
                                    const KeyT* __restrict__ query,
                                    const int32_t* __restrict__ cand,
                                    const uint32_t* __restrict__ vals,
                                    int32_t* __restrict__ slot_out,
                                    bool* __restrict__ found_out,
                                    uint32_t* __restrict__ rows,
                                    int64_t Q, int P, int D) {
  const int lane = threadIdx.x & 31;
  const int64_t q = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (q >= Q) return;                          // warp-uniform exit
  const KeyT k = query[q];
  int32_t c = -1;
  bool hit = false;
  if (lane < P) {
    c = cand[(int64_t)lane * Q + q];
    hit = table_keys[c] == k;
  }
  const unsigned m = __ballot_sync(0xffffffffu, hit);
  const int first = __ffs(m) - 1;              // -1: no hit
  const int32_t slot = __shfl_sync(0xffffffffu, c, first < 0 ? 0 : first);
  const bool found = first >= 0;
  if (lane == 0) {
    slot_out[q] = found ? slot : -1;
    found_out[q] = found;
  }
  uint32_t* dst = rows + q * D;
  if (found) {
    const uint32_t* src = vals + (int64_t)slot * D;
    for (int d = lane; d < D; d += 32) dst[d] = src[d];
  } else {
    for (int d = lane; d < D; d += 32) dst[d] = 0u;
  }
}

template <typename KeyT>
int launch(const void* table_keys, const void* query, const void* cand,
           const void* vals, void* slot_out, void* found_out, void* rows,
           long long Q, int P, int D, void* stream) {
  const dim3 block(32 * kWarpsPerBlock);
  const dim3 grid((unsigned)((Q + kWarpsPerBlock - 1) / kWarpsPerBlock));
  slate_lookup_kernel<KeyT><<<grid, block, 0,
                              reinterpret_cast<cudaStream_t>(stream)>>>(
      static_cast<const KeyT*>(table_keys), static_cast<const KeyT*>(query),
      static_cast<const int32_t*>(cand), static_cast<const uint32_t*>(vals),
      static_cast<int32_t*>(slot_out), static_cast<bool*>(found_out),
      static_cast<uint32_t*>(rows), Q, P, D);
  return (int)cudaGetLastError();
}

}  // namespace

// key_bytes: 4 (int32) or 8 (int64).  P <= 32.
// Returns cudaGetLastError() after the launch.
extern "C" int slate_lookup_launch(const void* table_keys, const void* query,
                                   const void* cand, const void* vals,
                                   void* slot_out, void* found_out,
                                   void* rows, long long Q, int P, int D,
                                   int key_bytes, void* stream) {
  if (key_bytes == 8)
    return launch<long long>(table_keys, query, cand, vals, slot_out,
                             found_out, rows, Q, P, D, stream);
  return launch<int>(table_keys, query, cand, vals, slot_out, found_out,
                     rows, Q, P, D, stream);
}

extern "C" const char* slate_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
