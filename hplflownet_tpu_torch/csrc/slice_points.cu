// Slice: each point's d + 1 lattice vertex rows, barycentric-weighted,
// with the slice bias and the cast to the compute dtype fused.
//
//   out[n, c] = cast( ((w0 v0 + w1 v1) + w2 v2) + w3 v3  [+ bias[c]] )
//   v_r = table[ids[n, r], c] as float32,  w_r = bary[n, r]
//
// An absent vertex (id -1: an invalid point, or a vertex dropped past
// capacity) reads no row and adds nothing; an id past the table's last row
// reads the last row (the plain version's clamp).  Products and sums are
// float32, __fmul_rn then __fadd_rn in vertex order (no contraction), then
// the bias, then round-to-nearest-even into the output dtype: the
// arithmetic of the plain composition (kernels/slice.py), so the two agree
// value for value.
//
// Replaces no Pallas kernel: the JAX package leaves the slice to XLA
// (hplflownet_tpu/ops/bcl.py:290-337: d + 1 gathers, float32 products and
// sums).  In plain PyTorch that is some 26 launches a slice, each (N, C)
// intermediate a float32 tensor written to device memory and read back.
//
// Bound on an H100: bytes.  2 (d + 1) C operations a point against the
// point's result written (2 C bytes in bf16), its ids and weights read (8
// bytes a vertex) and its vertex rows read: far below the ridge point.
// The floor is each of those moved once.  A vertex's row is read by every
// point around it (about four), and the table stays in the 50 MB L2 where
// it fits (every SPLATNet3D slice, every slice of an 8192-point pair), so
// what has to reach device memory is the result, the ids and weights, and
// the table once.  The design moves just that:
//
// * A point's ids and weights are loaded once into registers, by the lanes
//   that own its channels (the same addresses: one transaction).
// * Lanes own VB-byte chunks of a row: 16 bytes (8 bf16 or 4 float32
//   channels) where the row pitch and the addresses allow, else 8, 4 or 2
//   bytes for every chunk of the row (a row whose pitch is not a multiple
//   of 16 bytes has no 16-byte-aligned rows past the first).  A point gets
//   the power of two of lanes at least its chunks, up to 32: a 128-byte
//   bf16 row is 8 lanes and a warp slices 4 points; a 2048-byte row is 32
//   lanes of 4 chunks each.
// * Every row load of a chunk (d + 1 of them, up to four at a time) is
//   issued before its sums, and a block holds 8 warps of points, so some
//   thousands of row loads are in flight on each SM to cover L2 latency.
// * The sums stay in registers: the result is stored once, in the output
//   dtype, with one VB-wide (or, float32 from bf16, two 16-byte) store a
//   chunk, consecutive lanes on consecutive addresses.
// * Blocks shrink from 256 threads to 64 while the grid would give fewer
//   than two blocks an SM, so that the coarse scales' few points (a
//   hundred rows) still spread over the card.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "lane_chunks.cuh"

namespace {

using namespace lane_chunks;

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int MAX_D1 = 8;     // vertices a point (a lattice of up to 7 dims)
constexpr int GROUP = 4;      // row loads issued together

// the V float sums of a chunk as V elements of T at p (V * sizeof(T)
// bytes, aligned to that or to 16)
template <typename T, int V>
__device__ __forceinline__ void store_chunk_as(unsigned char* p,
                                               const float (&a)[V]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        reinterpret_cast<float4*>(p)[i / 4] =
            make_float4(a[i], a[i + 1], a[i + 2], a[i + 3]);
    } else if constexpr (V == 2) {
      *reinterpret_cast<float2*>(p) = make_float2(a[0], a[1]);
    } else {
      *reinterpret_cast<float*>(p) = a[0];
    }
  } else {
    if constexpr (V == 1) {
      *reinterpret_cast<unsigned short*>(p) =
          __bfloat16_as_ushort(__float2bfloat16_rn(a[0]));
    } else {
      uint32_t u[V / 2];
#pragma unroll
      for (int i = 0; i < V / 2; ++i)
        u[i] = (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i])) |
               (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(a[2 * i + 1])) << 16;
      if constexpr (V == 8) {
        *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
      } else if constexpr (V == 4) {
        *reinterpret_cast<uint2*>(p) = make_uint2(u[0], u[1]);
      } else {
        *reinterpret_cast<uint32_t*>(p) = u[0];
      }
    }
  }
}

// 2^lp_log2 lanes a point, VB-byte chunks of V = VB / sizeof(TI) channels
template <typename TI, typename TO, int VB>
__global__ void __launch_bounds__(THREADS)
slice_points_kernel(const unsigned char* __restrict__ table, int h, int c,
                    const float* __restrict__ bary,
                    const int* __restrict__ ids, int n, int d1,
                    const float* __restrict__ bias,
                    unsigned char* __restrict__ out, int lp_log2) {
  constexpr int V = VB / (int)sizeof(TI);
  constexpr int NW = Words<VB>::N;
  const int p = (int)((blockIdx.x * (unsigned)blockDim.x + threadIdx.x) >> lp_log2);
  if (p >= n) return;
  const int lp = 1 << lp_log2;
  const int sub = threadIdx.x & (lp - 1);

  int row[MAX_D1];
  float w[MAX_D1];
#pragma unroll
  for (int r = 0; r < MAX_D1; ++r) {
    row[r] = -1;
    w[r] = 0.f;
    if (r < d1) {
      const int id = __ldg(ids + (size_t)p * d1 + r);
      if (id >= 0) {
        row[r] = id < h ? id : h - 1;
        w[r] = __ldg(bary + (size_t)p * d1 + r);
      }
    }
  }

  const size_t pitch_in = (size_t)c * sizeof(TI);
  unsigned char* o = out + (size_t)p * c * sizeof(TO);
  const int chunks = c / V;
  for (int j = sub; j < chunks; j += lp) {
    float acc[V] = {};
#pragma unroll
    for (int r0 = 0; r0 < MAX_D1; r0 += GROUP) {
      if (r0 >= d1) break;
      uint32_t wd[GROUP][NW];
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int r = r0 + k;
        if (r < d1 && row[r] >= 0) {
          load_words<VB>(wd[k], table + row[r] * pitch_in + (size_t)j * VB);
        } else {
#pragma unroll
          for (int q = 0; q < NW; ++q) wd[k][q] = 0u;
        }
      }
#pragma unroll
      for (int k = 0; k < GROUP; ++k) {
        const int r = r0 + k;
        if (r < d1) {
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const float t = __fmul_rn(w[r], element<TI, VB>(wd[k], e));
            acc[e] = r == 0 ? t : __fadd_rn(acc[e], t);
          }
        }
      }
    }
    if (bias != nullptr) {
#pragma unroll
      for (int e = 0; e < V; ++e) acc[e] = __fadd_rn(acc[e], __ldg(bias + j * V + e));
    }
    store_chunk_as<TO, V>(o + (size_t)j * V * sizeof(TO), acc);
  }
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

template <typename TI, typename TO, int VB>
cudaError_t launch(const void* table, int h, int c, const void* bary,
                   const void* ids, int n, int d1, const void* bias, void* out,
                   cudaStream_t s) {
  const int chunks = c * (int)sizeof(TI) / VB;
  const int lp = pow2_at_least(chunks < 32 ? chunks : 32);
  int lp_log2 = 0;
  while ((1 << lp_log2) < lp) ++lp_log2;
  const long long lanes = (long long)n * lp;
  int threads = THREADS;
  while (threads > 64 && (lanes + threads - 1) / threads < 2LL * sm_count())
    threads /= 2;
  if (lanes > 0x7fffffffLL) return cudaErrorInvalidValue;
  const long long blocks = (lanes + threads - 1) / threads;
  slice_points_kernel<TI, TO, VB><<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const unsigned char*>(table), h, c,
      static_cast<const float*>(bary), static_cast<const int*>(ids), n, d1,
      static_cast<const float*>(bias), static_cast<unsigned char*>(out),
      lp_log2);
  return cudaGetLastError();
}

template <typename TI, typename TO>
cudaError_t by_width(int vb, const void* table, int h, int c, const void* bary,
                     const void* ids, int n, int d1, const void* bias,
                     void* out, cudaStream_t s) {
  switch (vb) {
    case 16: return launch<TI, TO, 16>(table, h, c, bary, ids, n, d1, bias, out, s);
    case 8: return launch<TI, TO, 8>(table, h, c, bary, ids, n, d1, bias, out, s);
    case 4: return launch<TI, TO, 4>(table, h, c, bary, ids, n, d1, bias, out, s);
    default:
      if constexpr (sizeof(TI) == 2)
        return launch<TI, TO, 2>(table, h, c, bary, ids, n, d1, bias, out, s);
      return cudaErrorInvalidValue;
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// table: (h, c) row-major, in_dtype; bary: (n, d1) float32; ids: (n, d1)
// int32, -1 absent; bias: (c,) float32 or null; out: (n, c) out_dtype.
// Dtypes: 0 = float32, 1 = bfloat16.  1 <= d1 <= 8.  Returns the CUDA
// error code of the launch (0 on success).
int hpl_slice_points(const void* table, int h, int c, int in_dtype,
                     const void* bary, const void* ids, int n, int d1,
                     const void* bias, void* out, int out_dtype, void* stream) {
  if (n <= 0 || c <= 0) return 0;
  if (h <= 0 || d1 < 1 || d1 > MAX_D1 || (in_dtype != 0 && in_dtype != 1) ||
      (out_dtype != 0 && out_dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int ti = in_dtype ? 2 : 4, to = out_dtype ? 2 : 4;
  // the widest chunk the row pitch and both addresses allow
  int vb = 16;
  while (vb > ti) {
    const int ob = vb / ti * to;
    if ((c * ti) % vb == 0 && aligned(table, vb) && aligned(out, ob < 16 ? ob : 16))
      break;
    vb /= 2;
  }
  if (!aligned(table, ti) || !aligned(out, to)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (in_dtype) {
    e = out_dtype ? by_width<bf16, bf16>(vb, table, h, c, bary, ids, n, d1, bias, out, s)
                  : by_width<bf16, float>(vb, table, h, c, bary, ids, n, d1, bias, out, s);
  } else {
    e = out_dtype ? by_width<float, bf16>(vb, table, h, c, bary, ids, n, d1, bias, out, s)
                  : by_width<float, float>(vb, table, h, c, bary, ids, n, d1, bias, out, s);
  }
  return (int)e;
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
