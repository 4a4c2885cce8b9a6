// Hopper tensor-core helpers shared by the attention kernels
// (csrc/flash_attention.cu's and csrc/flash_attention_bwd.cu's wgmma
// routes): cp.async copies and their commit/wait groups, the wgmma
// shared-memory descriptor for the 128-byte swizzle, the fence / commit /
// wait wrappers, the m64nNk16 products (A from shared memory or from
// registers) and the staging of a [64 rows][D] bf16 tile into the
// swizzled layout.  One warpgroup (128 threads) issues every product.
//
// Layout: a tile is stored as blocks of 64 columns (8 KB each); the
// 16-byte chunk c of row r of block cb sits at byte
// cb * 8192 + r * 128 + (c ^ (r % 8)) * 16.  The same bytes serve as a
// K-major operand (k-step kk at (kk / 4) * 8192 + (kk % 4) * 32) and as an
// MN-major one (the transpose bit; k-step kk, 16 rows, at kk * 2048 and
// column block c at c * 8192).

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {
namespace hopper {

constexpr int kThreads = 128;  // one warpgroup

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
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle: start address
// (16-byte units), leading byte offset 16 (unused: no product here spans
// two 64-element atoms along its contiguous dimension), stride byte offset
// 1024 (the next group of 8 rows of 128 bytes), layout type 1 (B128).  An
// atom (8 rows of 128 bytes, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8)) starts on a 1024-byte boundary.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across the products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

#define F4(a, i) "+f"(a[i]), "+f"(a[i + 1]), "+f"(a[i + 2]), "+f"(a[i + 3])
#define F8(a, i) F4(a, i), F4(a, i + 4)
#define F16(a, i) F8(a, i), F8(a, i + 8)

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, K-major
__device__ __forceinline__ void mma_ss_n64(float (&d)[32], uint64_t da,
                                           uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "l"(da), "l"(db), "r"(scale_d));
}

// d[64 x N] += A[64 x 16] (registers, bf16 pairs) B[16 x N] (shared
// memory, MN-major: the transpose bit)
__device__ __forceinline__ void mma_rs(float (&d)[32], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F16(d, 0), F16(d, 16)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[16], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void mma_rs(float (&d)[8], const uint32_t (&a)[4],
                                       uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "1;\n}\n"
      : F8(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef F16
#undef F8
#undef F4

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Copy rows [row0, row0 + 64) x columns [0, 64 nb) of one head of a
// [B, S, heads, D] bf16 tensor into nb blocks of [64 rows][64 columns] in
// the 128-byte swizzle: the 16-byte chunk c of row r in block cb goes to
// byte cb * 8192 + r * 128 + (c ^ (r % 8)) * 16.  Eight neighbouring
// threads read one row's 128 bytes and fill one 128-byte row of shared
// memory.  Rows at or past `rows` and columns at or past D are zero-filled.
__device__ __forceinline__ void stage(uint32_t dst, const __nv_bfloat16* src,
                                      long long s_row, int row0, int rows,
                                      int nb, int D) {
  for (int i = threadIdx.x; i < nb * 512; i += kThreads) {
    const int c = i & 7, r = (i >> 3) & 63, cb = i >> 9;
    const int col = cb * 64 + c * 8;
    const bool ok = row0 + r < rows && col < D;
    cp_async16(dst + cb * 8192 + r * 128 + ((c ^ (r & 7)) << 4),
               ok ? src + (long long)(row0 + r) * s_row + col : src, ok);
  }
}

}  // namespace hopper
}  // namespace
