// Row chunks of the warp-per-row kernels (rank_reduce.cu and
// stencil_tap_tables_sum.cu) and of slice_points.cu: a lane loads VB bytes
// of a row (16, 8, 4 or 2) as 32-bit words, takes its V = VB / sizeof(T)
// elements out as their exact float32 images, and stores V float sums with
// the widest stores the address allows.
//
// Included by rank_reduce.cu, stencil_tap_tables_sum.cu and slice_points.cu.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace lane_chunks {

// one VB-byte chunk of a row as 32-bit words (a 2-byte chunk in the low
// half of one word)
template <int VB> struct Words { static constexpr int N = VB >= 4 ? VB / 4 : 1; };

template <int VB>
__device__ __forceinline__ void load_words(uint32_t (&w)[Words<VB>::N],
                                           const unsigned char* p) {
  if constexpr (VB == 16) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (VB == 8) {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (VB == 4) {
    w[0] = __ldg(reinterpret_cast<const unsigned int*>(p));
  } else {
    w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
}

// load_words issued where it stands: the compiler keeps every load of a
// batch ahead of the sums rather than sinking each into the branch that
// uses it (volatile)
template <int VB>
__device__ __forceinline__ void load_words_in_order(uint32_t (&w)[Words<VB>::N],
                                                    const unsigned char* p) {
  if constexpr (VB == 16) {
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3]) : "l"(p));
  } else if constexpr (VB == 8) {
    asm volatile("ld.global.nc.v2.u32 {%0, %1}, [%2];"
                 : "=r"(w[0]), "=r"(w[1]) : "l"(p));
  } else if constexpr (VB == 4) {
    asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(w[0]) : "l"(p));
  } else {
    unsigned short h;
    asm volatile("ld.global.nc.u16 %0, [%1];" : "=h"(h) : "l"(p));
    w[0] = h;
  }
}

// element e of a chunk of T (float or a 2-byte bf16) as its exact float32
// image
template <typename T, int VB>
__device__ __forceinline__ float element(const uint32_t (&w)[Words<VB>::N],
                                         int e) {
  if constexpr (sizeof(T) == 4) {
    return __uint_as_float(w[e]);
  } else if constexpr (VB == 2) {
    return __uint_as_float(w[0] << 16);
  } else {
    const uint32_t x = w[e >> 1];
    return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
  }
}

// o[col0 .. col0 + V) (the part below n) from a; 16- or 8-byte stores
// where the address allows
template <int V>
__device__ __forceinline__ void store_chunk(float* o, int col0, int n,
                                            const float (&a)[V]) {
  if (col0 >= n) return;
  float* p = o + col0;
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  if (V % 4 == 0 && col0 + V <= n && addr % 16 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
  } else if (V % 2 == 0 && col0 + V <= n && addr % 8 == 0) {
#pragma unroll
    for (int i = 0; i < V; i += 2)
      *reinterpret_cast<float2*>(p + i) = make_float2(a[i], a[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (col0 + i < n) p[i] = a[i];
  }
}

inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p *= 2;
  return p;
}

}  // namespace lane_chunks
