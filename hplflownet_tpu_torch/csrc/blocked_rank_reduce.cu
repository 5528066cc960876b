// Fused rank-mode reduction: per-rank weighted sums of a sorted stream whose
// entries carry their global rank.
//
//   out[t, c] = sum_{j in range(t / 128), rank_j == t} round(g[j, c] * w_j)
//   out[t, C] = sum_{j in range(t / 128), rank_j == t} w_j      (density)
//   with rank_j = meta[j] >> 2, w_j = g[j, C + (meta[j] & 3)]     (R >= 1)
//
// or, with R = 0, rank_j = meta[j] and the rows summed unweighted.  Block b
// of 128 ranks reads the stream range [start_rows[b], start_rows[b + 1])
// (the last block up to M), which in a rank-mode plan holds every entry of
// its ranks.  Ranks with no entry get exact zeros.  In bf16 mode each
// product is rounded to bf16 before the float32 sum, as
// hplflownet_tpu/ops/segment.py _wr_forward does.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py blocked_rank_reduce (:648;
// body _rank_reduce_kernel :580, pallas_call :724).  The TPU kernel streams
// two fixed windows of the sorted stream per 1024-rank super-block and folds
// each 128-entry chunk with a one-hot MXU dot at a dynamic offset; entries
// past the windows are dropped and counted.  Hopper needs no windows: one
// block per 128 ranks reads exactly its own stream range, finds each rank's
// first and last entry with integer min/max in shared memory (order-free, so
// the result is fixed), and then one warp per rank walks that rank's entries
// in stream order, each lane summing up to four channels per pass.  That is
// the order csrc/rank_reduce.cu sums a run in, so on a rank-mode plan the
// two routes agree bit for bit.  No float atomics; nothing is dropped, so
// there is no overflow counter.  Entries whose rank lies outside the block
// (the padding's sentinel rank, say) are skipped.
//
// Bound on an H100: bytes.  One multiply and one add per stream element
// against 2-4 bytes read: the floor is the stream (M * (C + R) elements plus
// M metas) in and T_pad * (C + 1) floats out at 3.35 TB/s.
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
constexpr int RANKS = 128;            // ranks per block
constexpr int NACC = 4;               // channels per lane per pass
constexpr int PASS = 32 * NACC;       // channels per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float product(float a, float w) { return __fmul_rn(a, w); }
__device__ __forceinline__ float product(bf16 a, bf16 w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(a), to_f32(w))));
}

template <bool WEIGHTED>
__device__ __forceinline__ int rank_of(int meta) { return WEIGHTED ? (meta >> 2) : meta; }

template <typename T, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
blocked_rank_reduce_kernel(const T* __restrict__ g, int m, int cr, int c,
                           const int* __restrict__ meta,
                           const int* __restrict__ start_rows, int nblk,
                           int with_weights, float* __restrict__ out) {
  __shared__ int s_first[RANKS];
  __shared__ int s_last[RANKS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int base = b * RANKS;
  if (tid < RANKS) {
    s_first[tid] = INT_MAX;
    s_last[tid] = -1;
  }
  int lo = start_rows[b];
  lo = lo < 0 ? 0 : (lo > m ? m : lo);
  int hi = b + 1 < nblk ? start_rows[b + 1] : m;
  hi = hi < lo ? lo : (hi > m ? m : hi);
  __syncthreads();
  for (int j = lo + tid; j < hi; j += THREADS) {
    const int k = rank_of<WEIGHTED>(meta[j]) - base;
    if (k >= 0 && k < RANKS) {
      atomicMin(&s_first[k], j);
      atomicMax(&s_last[k], j);
    }
  }
  __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  for (int k = warp; k < RANKS; k += THREADS / 32) {
    const int rank = base + k;
    const int s = s_first[k], e = s_last[k] + 1;    // empty: s > e
    float* o = out + (size_t)rank * c_out;
    for (int c0 = 0; c0 < c_out; c0 += PASS) {
      float acc[NACC];
#pragma unroll
      for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
      for (int j = s; j < e; ++j) {
        const int mj = meta[j];
        if (rank_of<WEIGHTED>(mj) != rank) continue;
        const T* row = g + (size_t)j * cr;
        if (WEIGHTED) {
          const int lane_w = mj & 3;
          if (lane_w >= r) continue;     // the wrapper guarantees lane < R
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
        if (ch < c_out) o[ch] = acc[q];
      }
    }
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  g: (m, cr) row-major with cr = c + r,
// 0 <= r <= 4 (r = 0: plain rows, no density); meta: (m,) int32, rank << 2 |
// lane (r >= 1) or the rank (r = 0); start_rows: (nblk,) int32; out:
// (nblk * 128, c + with_weights) float32.  Returns the CUDA error code of
// the launch (0 on success).
int hpl_blocked_rank_reduce(const void* g, int m, int cr, int c,
                            const void* meta, const void* start_rows,
                            int nblk, int with_weights, void* out, int dtype,
                            void* stream) {
  if (nblk <= 0) return 0;
  const int r = cr - c;
  if (c <= 0 || r < 0 || r > 4 || (r == 0 && with_weights) || m < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mp = static_cast<const int*>(meta);
  const int* sr = static_cast<const int*>(start_rows);
  float* op = static_cast<float*>(out);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* gf = static_cast<const float*>(g);
  if (dtype == 1 && r > 0)
    blocked_rank_reduce_kernel<bf16, true><<<nblk, THREADS, 0, s>>>(
        gb, m, cr, c, mp, sr, nblk, with_weights, op);
  else if (dtype == 1)
    blocked_rank_reduce_kernel<bf16, false><<<nblk, THREADS, 0, s>>>(
        gb, m, cr, c, mp, sr, nblk, 0, op);
  else if (dtype == 0 && r > 0)
    blocked_rank_reduce_kernel<float, true><<<nblk, THREADS, 0, s>>>(
        gf, m, cr, c, mp, sr, nblk, with_weights, op);
  else if (dtype == 0)
    blocked_rank_reduce_kernel<float, false><<<nblk, THREADS, 0, s>>>(
        gf, m, cr, c, mp, sr, nblk, 0, op);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
