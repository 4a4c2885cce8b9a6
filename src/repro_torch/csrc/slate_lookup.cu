// Batched slate point-lookup for Hopper: a probe walk, then a row gather.
//
// Replaces the Pallas TPU kernels src/repro/kernels/slate_lookup/kernel.py
// (_lookup_kernel / slate_lookup for int32 keys, and _lookup_kernel_wide /
// slate_lookup_wide, which split int64 keys into 32-bit planes because TPU
// SMEM scalars are 32-bit).  One kernel templated on the key type serves
// both widths here.
//
// Three routes, each a template instance, differ in where a query's
// candidate slots come from and in where its walk stops:
//   cand  candidates given, cand [P, Q] int32 (the TPU kernel's interface);
//         stops at the first hit.
//   keys  candidates hashed in registers; stops at the first hit.  The
//         read path: ops.slate_lookup, lookup_tree, lookup_slots.
//   find  candidates hashed; stops at the first probe that hits or finds
//         EMPTY, on the rows where pending[q] (slates/table.py::
//         _lookup_keys, the walk of each insert_or_find round).
// The hash is slates/table.py::_probe_seq in native uint32 (hash32.cuh):
//   h1 = mix32(fold(key) ^ 0xA11CE) % C,
//   h2 = mix32(fold(key) ^ 0xB0B) % (C - 1) + 1,
//   cand_p = (uint32)(h1 + p * h2) % C, wrapping before the modulus,
// with C the hashed capacity (the engine's tables carry a sink row past
// it).  The `hit` rule walks all P probes on a miss: after expire_ttl a
// live key can sit past an EMPTY slot, so a read must not stop there.
//
// Inputs:
//   table_keys [N]    int32 or int64 (EMPTY = -1)
//   query      [Q]    same key type
//   cand       [P, Q] int32 probe candidates (cand only)
//   pending    [Q]    bool (find only)
//   vals       [N, D] 32-bit words (f32 or int32), row-major (cand, keys)
// Outputs:
//   slot  [Q] int32 (cand, keys) or int64 (find): the slot where the walk
//         stopped, or -1
//   found [Q] bool: the walk stopped on the query's key
//   rows  [Q, D]: vals[slot], zeros on a miss (cand, keys; optional)
// Rows of find that are not pending write slot -1 and found false.
//
// What bounds it: random 32-byte sectors (one a probe, one or more a row)
// and the latency of the dependent steps between them, not arithmetic.
// At load 0.25 most chains stop at their first probe.  Design: a thread a
// query.  Probe 0's key is read first, and only where it does not stop the
// chain are probes 1..P-1 read, all together (kBatch at a time in
// registers), the first stop in probe order winning.  So a chain costs at
// most two dependent memory steps (for P <= kBatch + 1), and a query that
// its first probe decides costs one sector.  The thread then copies its
// row, as 16-byte vectors where D % 4 == 0 and both matrices are 16-byte
// aligned.  The candidates of probes 1..kBatch are computed (or, on cand,
// loaded: coalesced rows of cand) before probe 0's key arrives.  One
// launch per call, no host state; bitwise equal to the plain version
// always.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash32.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kBatch = 8;                      // probes in flight together
enum Route { kCand = 0, kKeys = 1, kFind = 2 };

// The candidate slot of probe p for query q: given (cand) or hashed.
template <typename KeyT, int kRoute>
struct Chain {
  const int32_t* cand;
  long long Q, q;
  uint32_t C, h1, h2;
  __device__ Chain(const int32_t* cand_, long long Q_, long long q_, KeyT key,
                   uint32_t C_)
      : cand(cand_), Q(Q_), q(q_), C(C_), h1(0), h2(0) {
    if (kRoute != kCand) {
      const uint32_t u = fold_u32(key);
      h1 = mix32(u ^ 0xA11CEu) % C;
      h2 = mix32(u ^ 0xB0Bu) % (C - 1u) + 1u;
    }
  }
  __device__ uint32_t at(int p) const {
    if (kRoute == kCand) return (uint32_t)cand[(long long)p * Q + q];
    return (h1 + (uint32_t)p * h2) % C;
  }
};

template <typename KeyT, int kRoute>
__global__ void __launch_bounds__(kThreads)
slate_lookup_kernel(const KeyT* __restrict__ table_keys,
                    const KeyT* __restrict__ query,
                    const int32_t* __restrict__ cand,
                    const bool* __restrict__ pending,
                    const uint32_t* __restrict__ vals,
                    void* __restrict__ slot_out,
                    bool* __restrict__ found_out,
                    uint32_t* __restrict__ rows,
                    long long Q, int P, int D, uint32_t C, bool vec) {
  const long long q = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (q >= Q) return;
  long long slot = -1;
  bool found = false;
  if (kRoute != kFind || pending[q]) {
    const KeyT key = query[q];
    const Chain<KeyT, kRoute> chain(cand, Q, q, key, C);
    const auto stops = [&](KeyT k) {
      return k == key || (kRoute == kFind && k == (KeyT)-1);
    };
    uint32_t c[kBatch + 1];
#pragma unroll
    for (int j = 0; j <= kBatch; ++j) c[j] = j < P ? chain.at(j) : 0u;
    const KeyT k0 = table_keys[c[0]];
    if (stops(k0)) {
      slot = c[0];
      found = k0 == key;
    } else {
      for (int base = 1; base < P; base += kBatch) {
        uint32_t cb[kBatch];
        KeyT k[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int p = base + j;
          cb[j] = base == 1 ? c[1 + j] : (p < P ? chain.at(p) : 0u);
          if (p < P) k[j] = table_keys[cb[j]];
        }
        bool stopped = false;
#pragma unroll
        for (int j = kBatch - 1; j >= 0; --j) {   // the lowest probe wins
          if (base + j < P && stops(k[j])) {
            slot = cb[j];
            found = k[j] == key;
            stopped = true;
          }
        }
        if (stopped) break;
      }
    }
  }
  if (kRoute == kFind)
    static_cast<long long*>(slot_out)[q] = slot;
  else
    static_cast<int32_t*>(slot_out)[q] = (int32_t)slot;
  found_out[q] = found;
  if (kRoute == kFind || rows == nullptr) return;
  uint32_t* dst = rows + q * D;
  const uint32_t* src = vals + (found ? slot : 0) * D;
  if (vec) {
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    if (found) {
#pragma unroll 4
      for (int i = 0; i < D / 4; ++i) d4[i] = __ldg(s4 + i);
    } else {
#pragma unroll 4
      for (int i = 0; i < D / 4; ++i) d4[i] = make_uint4(0u, 0u, 0u, 0u);
    }
  } else if (found) {
#pragma unroll 4
    for (int i = 0; i < D; ++i) dst[i] = __ldg(src + i);
  } else {
    for (int i = 0; i < D; ++i) dst[i] = 0u;
  }
}

template <typename KeyT, int kRoute>
int launch(const void* table_keys, const void* query, const void* cand,
           const void* pending, const void* vals, void* slot_out,
           void* found_out, void* rows, long long Q, int P, int D,
           uint32_t C, bool vec, cudaStream_t stream) {
  const unsigned grid = (unsigned)((Q + kThreads - 1) / kThreads);
  slate_lookup_kernel<KeyT, kRoute><<<grid, kThreads, 0, stream>>>(
      static_cast<const KeyT*>(table_keys), static_cast<const KeyT*>(query),
      static_cast<const int32_t*>(cand), static_cast<const bool*>(pending),
      static_cast<const uint32_t*>(vals), slot_out,
      static_cast<bool*>(found_out), static_cast<uint32_t*>(rows), Q, P, D, C,
      vec);
  return (int)cudaGetLastError();
}

template <typename KeyT>
int by_route(int route, const void* table_keys, const void* query,
             const void* cand, const void* pending, const void* vals,
             void* slot_out, void* found_out, void* rows, long long Q, int P,
             int D, uint32_t C, bool vec, cudaStream_t s) {
  switch (route) {
    case kCand:
      return launch<KeyT, kCand>(table_keys, query, cand, pending, vals,
                                 slot_out, found_out, rows, Q, P, D, C, vec,
                                 s);
    case kKeys:
      return launch<KeyT, kKeys>(table_keys, query, cand, pending, vals,
                                 slot_out, found_out, rows, Q, P, D, C, vec,
                                 s);
    case kFind:
      return launch<KeyT, kFind>(table_keys, query, cand, pending, vals,
                                 slot_out, found_out, rows, Q, P, D, C, vec,
                                 s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// route: 0 cand, 1 keys, 2 find.  key_bytes: 4 (int32) or 8 (int64).
// cand: [P, Q] int32 (cand), else null; pending: [Q] bool (find), else
// null; vals and rows: [N, D] and [Q, D] (cand and keys; rows null for
// slots alone), else null.  C: the hashed capacity, 2 <= C <= N < 2**31
// (keys and find).  vec: D % 4 == 0 and vals and rows 16-byte aligned.
// Q > 0.  Returns cudaGetLastError() after the launch.
extern "C" int slate_lookup_launch(int route, const void* table_keys,
                                   const void* query, const void* cand,
                                   const void* pending, const void* vals,
                                   void* slot_out, void* found_out,
                                   void* rows, long long Q, int P, int D,
                                   long long C, int key_bytes, int vec,
                                   void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (key_bytes == 8)
    return by_route<long long>(route, table_keys, query, cand, pending, vals,
                               slot_out, found_out, rows, Q, P, D,
                               (uint32_t)C, vec != 0, s);
  return by_route<int>(route, table_keys, query, cand, pending, vals,
                       slot_out, found_out, rows, Q, P, D, (uint32_t)C,
                       vec != 0, s);
}

extern "C" const char* slate_lookup_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
