// Building blocks of the wgmma kernels on Hopper (sm_90a): zero-filling
// cp.async copies into 128-byte-swizzled shared-memory tiles, the wgmma
// shared-memory descriptors of those tiles, and the warpgroup MMA itself.
//
// Tile layouts (bf16, every tile 1024-byte aligned):
//
// * K-major (the stencil's gathered rows, K = input channels): a tile of
//   R rows x 64 channels, one 128-byte row each.  16-byte chunk j of row r
//   sits at r * 128 + ((j ^ (r % 8)) * 16): the 128-byte swizzle, so a
//   warp's ldmatrix-like reads of one chunk column hit 8 different banks.
//   Descriptor: SBO = 1024 bytes (8 rows), LBO unused; the k16 step s of
//   the 64-channel row starts 32 * s bytes in.
// * MN-major (the weight slice, the cotangent rows, the weight gradient's
//   gathered rows: K = the row index, MN contiguous): 64-column atoms, each
//   K rows x 128 bytes with the same swizzle, atom a at a * K * 128.
//   Descriptor (transpose bit set): LBO = the atom stride, SBO = 1024
//   bytes (8 K-rows); the k16 step s starts 16 * 128 * s bytes in.
// * K-major B (the dense layers' transposed weight): N rows x 64 input
//   channels, laid out as A; the TMA's 128-byte swizzle writes the same
//   layout.  wgmma_k16 takes N = 8, 32, 64 or 128.
//
// Included by stencil_gather_matmul.cu, stencil_dkernel.cu and
// dense_gemm.cu.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of byte b of row r in a 128-byte-swizzled tile.
__device__ __forceinline__ uint32_t swz(int r, int b) {
  return (uint32_t)(r * 128 + ((((b >> 4) ^ r) & 7) << 4) + (b & 15));
}

// Copy VEC bytes from global src to shared dst, or zeros when !valid.
// VEC 16, 8 and 4 go through cp.async (asynchronous; src-size 0 fills
// zeros without reading src); VEC 2 is a plain load and store.
template <int VEC>
__device__ __forceinline__ void copy_chunk(uint32_t dst, void* dst_generic,
                                           const void* src, bool valid) {
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
  } else if constexpr (VEC == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 8 : 0) : "memory");
  } else if constexpr (VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                 :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
  } else {
    static_assert(VEC == 2, "VEC is 16, 8, 4 or 2 bytes");
    *static_cast<bf16*>(dst_generic) =
        valid ? *static_cast<const bf16*>(src) : __float2bfloat16_rn(0.f);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Make this thread's shared-memory writes (cp.async and plain stores, the
// generic proxy) visible to wgmma's reads (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The widest chunk (16, 8, 4 or 2 bytes) that every row of a bf16 matrix
// with row pitch ``ld`` elements can be copied in, given its base address.
__host__ __forceinline__ int chunk_bytes(const void* base, int ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(base);
  const int pitch = 2 * ld;
  for (int v = 16; v > 2; v /= 2)
    if (pitch % v == 0 && a % v == 0) return v;
  return 2;
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16)
       | ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32)
       | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from moving accumulator accesses across wgmma ops.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// D (64 x 64, f32, registers) += A (smem desc) * B (smem desc), k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 128, f32, registers) += A (smem desc) * B (smem desc), k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 8, f32, registers) += A (smem desc) * B (smem desc), k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n8(float (&d)[4], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3"
      "}, "
      "%4, %5, p, 1, 1, %7, %8;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// D (64 x 32, f32, registers) += A (smem desc) * B (smem desc), k16.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// One k16 step: D (64 x N) += A * B, N = 2 R.  TA / TB: 0 for a
// K-major operand, 1 for an MN-major one (the transpose bits).
template <int TA, int TB, int R>
__device__ __forceinline__ void wgmma_k16(float (&d)[R], uint64_t da,
                                          uint64_t db) {
  if constexpr (R == 4) {
    wgmma_n8<TA, TB>(d, da, db);
  } else if constexpr (R == 16) {
    wgmma_n32<TA, TB>(d, da, db);
  } else if constexpr (R == 32) {
    wgmma_n64<TA, TB>(d, da, db);
  } else {
    static_assert(R == 64, "N is 8, 32, 64 or 128");
    wgmma_n128<TA, TB>(d, da, db);
  }
}

}  // namespace sm90
