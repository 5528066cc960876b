// Splat reduction: per-vertex weighted run sums of the sorted splat stream.
//
//   out[t, c] = sum_{j in [start[t], end[t])} round(g[j, c] * w_j)   c < C
//   out[t, C] = sum_{j in [start[t], end[t])} w_j                    (density)
//   with w_j = g[j, C + rid[j]]
//
// or, with R = 0 (plain rows: g is (M, C), no weight lanes, no density),
//
//   out[t, c] = sum_{j in [start[t], end[t])} g[j, c]
//
// g is the (M, C + R) stream of point rows with their R barycentric weights,
// already gathered in the splat plan's sorted order, so every vertex's
// entries form one contiguous run [start[t], end[t]).  In bf16 mode each
// product is rounded to bf16 before the float32 sum, as
// hplflownet_tpu/ops/segment.py _wr_forward does (:418-421).
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py blocked_rank_partial
// (_rank_partial_kernel :547, pallas_call :763) plus the segment._combine
// assembly (:247-314).  The TPU kernel sums each 128-entry block by local
// run rank with a one-hot MXU matmul and a second XLA pass stitches runs
// that cross blocks.  Only the per-vertex sum is observable, so on Hopper
// the two stages fuse into one segmented sum over the sorted runs: one
// warp owns one vertex and walks its run in order, each lane summing up to
// four channels.  No float atomics: the order of every sum is fixed, so a
// rerun matches bit for bit.  (The TPU kernel's local ranks are not needed.)
//
// Bound on an H100: bytes.  The work is one multiply and one add per
// stream element, against 2-4 bytes read per element: far below the
// ridge point, so the floor is the stream read (M * (C + R) elements)
// plus the output write (T * (C + 1) floats) at 3.35 TB/s.  Lanes read
// consecutive channels of a row, so a warp's loads are coalesced; runs are
// short (a vertex gathers a handful of entries), so the walk is a few
// dependent steps.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;          // 8 warps = 8 vertices per block
constexpr int NACC = 4;               // channels per lane per pass
constexpr int PASS = 32 * NACC;       // channels per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// the stream-dtype product: float32 rounds once; bf16 rounds the (exact)
// float32 product of two bf16 values to bf16
__device__ __forceinline__ float product(float a, float w) { return __fmul_rn(a, w); }
__device__ __forceinline__ float product(bf16 a, bf16 w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(to_f32(a), to_f32(w))));
}

template <typename T, bool WEIGHTED>
__global__ void __launch_bounds__(THREADS)
rank_reduce_kernel(const T* __restrict__ g, int cr, int c,
                   const int* __restrict__ rid, const int* __restrict__ start,
                   const int* __restrict__ end, int t, int m, int with_weights,
                   float* __restrict__ out) {
  const int vtx = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (vtx >= t) return;
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  int s = start[vtx], e = end[vtx];
  s = s < 0 ? 0 : s;
  e = e > m ? m : e;
  float* o = out + (size_t)vtx * c_out;
  for (int c0 = 0; c0 < c_out; c0 += PASS) {
    float acc[NACC];
#pragma unroll
    for (int q = 0; q < NACC; ++q) acc[q] = 0.f;
    for (int j = s; j < e; ++j) {
      const T* row = g + (size_t)j * cr;
      if (WEIGHTED) {
        const int k = rid[j];
        if (k < 0 || k >= r) continue;   // the wrapper guarantees 0 <= rid < R
        const T w = row[c + k];
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

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  g: (m, cr) row-major; rid: (m,) int32
// (unread, and may be null, when cr == c: the plain-row mode, which takes no
// density); start, end: (t,) int32; out: (t, c + with_weights) float32.
// Returns the CUDA error code of the launch (0 on success).
int hpl_rank_reduce(const void* g, int m, int cr, int c, const void* rid,
                    const void* start, const void* end, int t,
                    int with_weights, void* out, int dtype, void* stream) {
  if (t <= 0) return 0;
  const bool weighted = cr > c;
  if (c <= 0 || cr < c || (!weighted && with_weights))
    return (int)cudaErrorInvalidValue;
  const int blocks = (t + THREADS / 32 - 1) / (THREADS / 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ridp = static_cast<const int*>(rid);
  const int* sp = static_cast<const int*>(start);
  const int* ep = static_cast<const int*>(end);
  float* op = static_cast<float*>(out);
  const bf16* gb = static_cast<const bf16*>(g);
  const float* gf = static_cast<const float*>(g);
  if (dtype == 1 && weighted)
    rank_reduce_kernel<bf16, true><<<blocks, THREADS, 0, s>>>(
        gb, cr, c, ridp, sp, ep, t, m, with_weights, op);
  else if (dtype == 1)
    rank_reduce_kernel<bf16, false><<<blocks, THREADS, 0, s>>>(
        gb, cr, c, ridp, sp, ep, t, m, 0, op);
  else if (dtype == 0 && weighted)
    rank_reduce_kernel<float, true><<<blocks, THREADS, 0, s>>>(
        gf, cr, c, ridp, sp, ep, t, m, with_weights, op);
  else if (dtype == 0)
    rank_reduce_kernel<float, false><<<blocks, THREADS, 0, s>>>(
        gf, cr, c, ridp, sp, ep, t, m, 0, op);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
