// Per-128-entry-block partial sums of a sorted stream by local run rank.
//
//   out[b*128 + k, c] = sum_{j in block b, lrank_j == k} round(g[j, c] * w_j)
//   out[b*128 + k, C] = sum_{j in block b, lrank_j == k} w_j      (density)
//   with lrank_j = meta[j] & 0xFFFF, w_j = g[j, C + (meta[j] >> 16)]
//
// or, with R = 0, the rows summed unweighted.  Block b holds entries
// [128 b, 128 b + 128); the output has ceil(M / 128) * 128 rows, and rows of
// unused ranks are exact zeros.  Each product is rounded to the stream's
// dtype before the float32 sum; the sums are written in float32 or rounded
// once to bfloat16.
//
// Replaces: tools/rank_partial_lab.py variant (:110; body _v2_kernel :74,
// pallas_call :121), the TPU lab's variants of blocked_rank_partial (one
// one-hot MXU dot per 128-entry block, bo blocks per program, optional
// bf16 output).  On Hopper a block of 256 threads takes bo consecutive
// 128-entry blocks (bo is the launch's blocks-per-CTA knob, the lab's
// sweep); for each, the first and last entry of every local rank are found
// with integer min/max in shared memory, then one warp per rank walks its
// entries in stream order, each lane summing up to four channels per pass.
// No float atomics, so a rerun matches bit for bit.  The TPU variant's
// vec_prepass (weighted rows of a whole program block computed before the
// rank dots) has no counterpart: each warp forms its own entries' products
// as it sums them.
//
// Bound on an H100: bytes.  The floor is the stream (M * (C + R) elements
// and M metas) in and M_pad * (C + 1) sums out at 3.35 TB/s; the output,
// mostly zero rows, is the larger part.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;          // 8 warps
constexpr int BLOCK = 128;            // stream entries (and ranks) per block
constexpr int NACC = 4;               // channels per lane per pass
constexpr int PASS = 32 * NACC;       // channels per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float product(float a, float w) { return __fmul_rn(a, w); }
__device__ __forceinline__ float product(bf16 a, bf16 w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(a), to_f32(w))));
}

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T, typename O, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
rank_partial_kernel(const T* __restrict__ g, int m, int cr, int c,
                    const int* __restrict__ meta, int nblocks, int bo,
                    int with_weights, O* __restrict__ out) {
  __shared__ int s_first[BLOCK];
  __shared__ int s_last[BLOCK];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  for (int bb = 0; bb < bo; ++bb) {
    const int blk = blockIdx.x * bo + bb;
    if (blk >= nblocks) break;                   // uniform over the block
    const int e0 = blk * BLOCK;
    if (tid < BLOCK) {
      s_first[tid] = INT_MAX;
      s_last[tid] = -1;
    }
    __syncthreads();
    if (tid < BLOCK && e0 + tid < m) {
      const int k = meta[e0 + tid] & 0xFFFF;
      if (k < BLOCK) {
        atomicMin(&s_first[k], e0 + tid);
        atomicMax(&s_last[k], e0 + tid);
      }
    }
    __syncthreads();
    for (int k = warp; k < BLOCK; k += THREADS / 32) {
      const int s = s_first[k], e = s_last[k] + 1;   // empty: s > e
      O* o = out + (size_t)(e0 + k) * c_out;
      for (int c0 = 0; c0 < c_out; c0 += PASS) {
        float acc[NACC];
#pragma unroll
        for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
        for (int j = s; j < e; ++j) {
          const int mj = meta[j];
          if ((mj & 0xFFFF) != k) continue;
          const T* row = g + (size_t)j * cr;
          if (WEIGHTED) {
            const int lane_w = mj >> 16;
            if (lane_w < 0 || lane_w >= r) continue;   // selects weight 0
            const T w = row[c + lane_w];
#pragma unroll
            for (int q = 0; q < NACC; ++q) {
              const int ch = c0 + lane + 32 * q;
              if (ch < c)
                acc[q] = __fadd_rn(acc[q], product(row[ch], w));
              else if (ch == c && with_weights)
                acc[q] = __fadd_rn(acc[q], to_f32(w));
            }
          } else {
#pragma unroll
            for (int q = 0; q < NACC; ++q) {
              const int ch = c0 + lane + 32 * q;
              if (ch < c) acc[q] = __fadd_rn(acc[q], to_f32(row[ch]));
            }
          }
        }
#pragma unroll
        for (int q = 0; q < NACC; ++q) {
          const int ch = c0 + lane + 32 * q;
          if (ch < c_out) store(o + ch, acc[q]);
        }
      }
    }
    __syncthreads();                             // s_first is reused
  }
}

template <typename T, typename O>
void launch(const void* g, int m, int cr, int c, const int* meta, int nblocks,
            int bo, int with_weights, void* out, cudaStream_t s) {
  const int grid = (nblocks + bo - 1) / bo;
  if (cr > c)
    rank_partial_kernel<T, O, true><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(g), m, cr, c, meta, nblocks, bo, with_weights,
        static_cast<O*>(out));
  else
    rank_partial_kernel<T, O, false><<<grid, THREADS, 0, s>>>(
        static_cast<const T*>(g), m, cr, c, meta, nblocks, bo, 0,
        static_cast<O*>(out));
}

}  // namespace

extern "C" {

// dtype, out_dtype: 0 = float32, 1 = bfloat16.  g: (m, cr) row-major, cr =
// c + r (r = 0: plain rows, no density); meta: (m,) int32, lrank | lane <<
// 16; out: (ceil(m / 128) * 128, c + with_weights).  bo: 128-entry blocks
// per CTA (>= 1).  Returns the CUDA error code of the launch (0 on success).
int hpl_rank_partial(const void* g, int m, int cr, int c, const void* meta,
                     int bo, int with_weights, void* out, int dtype,
                     int out_dtype, void* stream) {
  const int nblocks = (m + BLOCK - 1) / BLOCK;
  if (nblocks <= 0) return 0;
  if (c <= 0 || cr < c || bo < 1 || (cr == c && with_weights))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mp = static_cast<const int*>(meta);
  if (dtype == 1 && out_dtype == 0)
    launch<bf16, float>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 1 && out_dtype == 1)
    launch<bf16, bf16>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 0 && out_dtype == 0)
    launch<float, float>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 0 && out_dtype == 1)
    launch<float, bf16>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
