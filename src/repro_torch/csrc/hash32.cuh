// The port's integer hash in native uint32, shared by the kernels that
// hash keys on the card (countmin.cu's `keys` route, slate_lookup.cu's
// `keys` and `find` routes).  Bitwise core/hashing.py::hash_key, which
// emulates the same uint32 arithmetic in int64 tensors:
//   hash_key(key, salt) == mix32(fold_u32(key) ^ salt).

#pragma once

#include <stdint.h>

// splitmix-style avalanche (core/hashing.py::mix32).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  return x ^ (x >> 16);
}

// A key's 32-bit fold (core/hashing.py::fold_u32): the bit pattern of a
// 32-bit key, the xor of the two halves of a 64-bit one.
template <typename KeyT>
__device__ __forceinline__ uint32_t fold_u32(KeyT key) {
  const uint64_t k = (uint64_t)(int64_t)key;
  return sizeof(KeyT) > 4 ? (uint32_t)(k ^ (k >> 32)) : (uint32_t)k;
}
