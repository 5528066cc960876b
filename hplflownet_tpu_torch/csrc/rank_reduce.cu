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
// the two stages fuse into one segmented sum over the sorted runs.
//
// Bound on an H100: bytes.  The work is one multiply and one add per
// stream element, against 2-4 bytes read per element: far below the
// ridge point, so the floor is the stream read (M * (C + R) elements)
// plus the output write (T * (C + 1) floats) at 3.35 TB/s.  A walk of one
// entry at a time is far from it: each entry is a chain of loads (the lane
// id, then the weight, then the row), and the coarse scales' few vertices
// have the longest runs (up to 43 entries), so such a walk takes the same
// time at every scale.  The design, per launch:
//
// * Wide loads.  A lane moves VB bytes of a row at a time: the widest of
//   16, 8, 4 (and 2 for bf16) that the pitch and the stream's address
//   allow, halved while the row's chunks would fill no more than half a
//   warp, so that 32 lanes share each entry's work (a 144-byte bf16 splat
//   row is 18 8-byte chunks, a 2056-byte slice-adjoint row 257).
// * A warp per vertex and column slice.  Lane l holds NQ (1, 2 or 4)
//   chunks of each slice; a row wider than 128 chunks takes more warps
//   (passes), each walking the run for its slice: bcn1_'s 1024 bf16
//   channels are two warps of 512.
// * Batches of U entries: 16 where runs average 6 or more entries, 4
//   from 2, else 1, capped where the batch's chunks would exceed 32 words
//   a lane.  Every load of a batch (lane ids, weights, rows) is issued
//   before its first sum and none is conditional (past the run's end it
//   reloads the last row).  Lane i loads entry i's lane id and, for R <=
//   4, all R weights beside it and selects one, and the warp takes them
//   by shuffle; with U = 1 every lane loads its entry's own.
// * Branch-free sums.  B entries' products are formed ahead of their
//   in-order adds, and a select keeps the columns past C and the entries
//   past the run out of them: a branch around each column's work would
//   keep the compiler from overlapping their dependency chains, which is
//   what bounds a long run.  Every lane also sums the density.
// * A narrow row's sums (NQ = 1) leave through shared memory, so the
//   output row is written in consecutive 4-byte stores.
// * Launch bounds give the short-run regimes 4 or 8 blocks per SM: their
//   time per vertex is latency, and warps in flight are their throughput.
// * No float atomics: every output is a float32 fold from +0 in stream
//   order with __fadd_rn over the stream-dtype products, so a rerun, any
//   regime and blocked_rank_reduce (kernel 5) on the same runs all give
//   the same bits.
//
// hpl_rank_reduce_regime reports the choice (VB, NQ, passes, U).  114
// instantiations: {float32: VB 16, 8, 4; bf16: VB 16, 8, 4, 2} x
// {weighted, plain rows} x NQ {1, 2, 4} x the batch sizes that fit.
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
constexpr int MAX_NQ = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// the stream-dtype product of a value and a weight (both the exact float32
// images of stream elements): float32 rounds once; bf16 rounds the exact
// float32 product of two bf16 values to bf16
template <typename T> __device__ __forceinline__ float product(float a, float w);
template <> __device__ __forceinline__ float product<float>(float a, float w) {
  return __fmul_rn(a, w);
}
template <> __device__ __forceinline__ float product<bf16>(float a, float w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(a, w)));
}

// Blocks per SM the registers must allow: short runs (one entry a batch,
// one chunk a lane) are latency-bound per vertex, so warps in flight are
// what their throughput is made of.
template <int NQ, int U>
constexpr int min_blocks() { return NQ == 1 && U == 1 ? 8 : (NQ * U <= 16 ? 4 : 1); }

// One warp per vertex and column slice (``passes`` slices of 32 NQ chunks
// of V = VB / sizeof(T) columns): lane l owns chunks k0 + l + 32 q.
template <typename T, bool WEIGHTED, int VB, int NQ, int U>
__global__ void __launch_bounds__(THREADS, min_blocks<NQ, U>())
rank_reduce_kernel(const T* __restrict__ g, int cr, int c,
                   const int* __restrict__ rid, const int* __restrict__ start,
                   const int* __restrict__ end, int t, int m, int with_weights,
                   int passes, float* __restrict__ out) {
  constexpr unsigned FULL = 0xffffffffu;
  constexpr int ES = sizeof(T);
  constexpr int V = VB / ES;
  constexpr int NW = Words<VB>::N;
  // U entries per batch (their rows' chunks take at most 32 words a lane)
  static_assert(U * NQ * NW <= 32 && U <= 32, "a batch fits the registers");
  // entries whose products are formed together, ahead of their adds
  constexpr int B0 = 16 / (NQ * V);
  constexpr int B1 = B0 < 1 ? 1 : (B0 > 4 ? 4 : B0);
  constexpr int B = B1 > U ? U : B1;
  static_assert(U % B == 0, "a batch is whole blocks of entries");
  // NQ == 1: the warp's sums leave through shared memory, so that its
  // output row is written in consecutive 4-byte stores (a narrow row's
  // pitch, 276 bytes at C 68, allows no wider ones)
  __shared__ __align__(16) float s_out[NQ == 1 ? THREADS * V : 1];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int vtx = passes == 1 ? warp : warp / passes;
  if (vtx >= t) return;                              // whole warps leave
  const int k0 = (warp - vtx * passes) * 32 * NQ;    // the slice's chunk 0
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  int s = start[vtx], e = end[vtx];
  s = s < 0 ? 0 : s;
  e = e > m ? m : e;
  const size_t pitch = (size_t)cr * ES;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(g);
  float* o = out + (size_t)vtx * c_out;
  float acc[NQ][V];
#pragma unroll
  for (int q = 0; q < NQ; ++q)
#pragma unroll
    for (int el = 0; el < V; ++el) acc[q][el] = 0.f;
  float dacc = 0.f;                    // the density (every lane sums it)
  // per chunk: its byte offset (a lane past the row's values loads chunk
  // 0 and adds nothing from it) and how many of its columns are values
  int off[NQ], nv[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const int col0 = (k0 + lane + 32 * q) * V;
    off[q] = (col0 < c ? col0 : 0) * ES;
    nv[q] = min(max(c - col0, 0), V);
  }
  // one batch of U entries at a time.  Every load of the batch (ids,
  // weights, row chunks) is issued before the first sum and none is
  // conditional (a batch past the run's end reloads its last row).  The
  // sums take B entries at a time: their products first, then the
  // in-order adds, with no branch between two columns' work.
  for (int j0 = s; j0 < e; j0 += U) {
    const int nb = min(U, e - j0);
    const int last = e - 1;
    // lane i: entry j0 + i's weight, and whether it adds (its lane id in
    // [0, R) and the entry in the run); with U == 1 every lane loads the
    // entry's own and no shuffle is needed
    float wm = 0.f;
    int okm = 0;
    if (WEIGHTED) {
      const int mi = U == 1 ? 0 : lane;
      const int jm = min(j0 + mi, last);
      const T* wrow = g + (size_t)jm * cr + c;
      const int kk = __ldg(rid + jm);
      okm = kk >= 0 && kk < r && mi < nb;
      if (r <= 4) {                     // the R weights beside the id
        float w4[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w4[i] = i < r ? to_f32(wrow[i]) : 0.f;
        wm = kk == 0 ? w4[0] : kk == 1 ? w4[1] : kk == 2 ? w4[2] : w4[3];
      } else {
        wm = to_f32(wrow[okm ? kk : 0]);
      }
      wm = okm ? wm : 0.f;
    }
    uint32_t raw[U][NQ][NW];
#pragma unroll
    for (int uu = 0; uu < U; ++uu) {
      const unsigned char* row = base + (size_t)min(j0 + uu, last) * pitch;
#pragma unroll
      for (int q = 0; q < NQ; ++q) load_words_in_order<VB>(raw[uu][q], row + off[q]);
    }
#pragma unroll
    for (int u0 = 0; u0 < U; u0 += B) {
      if (u0 >= nb) break;                         // the same in a warp
      float w[B];
      bool ok[B];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (U == 1) {
          w[b] = WEIGHTED ? wm : 1.f;
          ok[b] = !WEIGHTED || okm != 0;
        } else {
          w[b] = WEIGHTED ? __shfl_sync(FULL, wm, u0 + b) : 1.f;
          ok[b] = u0 + b < nb &&
                  (!WEIGHTED || __shfl_sync(FULL, okm, u0 + b) != 0);
        }
      }
      float p[B][NQ][V];
#pragma unroll
      for (int b = 0; b < B; ++b)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int el = 0; el < V; ++el) {
            const float x = element<T, VB>(raw[u0 + b][q], el);
            p[b][q][el] = WEIGHTED ? product<T>(x, w[b]) : x;
          }
#pragma unroll
      for (int b = 0; b < B; ++b) {
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int el = 0; el < V; ++el) {
            const float y = __fadd_rn(acc[q][el], p[b][q][el]);
            acc[q][el] = ok[b] && el < nv[q] ? y : acc[q][el];
          }
        if (WEIGHTED) {
          const float y = __fadd_rn(dacc, w[b]);
          dacc = ok[b] ? y : dacc;
        }
      }
    }
  }
  if (WEIGHTED && with_weights) {      // column C holds the density
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int el = 0; el < V; ++el)
        if (el == nv[q] && (k0 + lane + 32 * q) * V + el == c) acc[q][el] = dacc;
  }
  if constexpr (NQ == 1) {
    float* so = s_out + (threadIdx.x & ~31) * V;         // the warp's row
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int i = 0; i < V; i += 4)
        *reinterpret_cast<float4*>(so + lane * V + i) =
            make_float4(acc[0][i], acc[0][i + 1], acc[0][i + 2], acc[0][i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) so[lane * V + i] = acc[0][i];
    }
    __syncwarp();
    const int n = min(c_out - k0 * V, 32 * V);
    for (int i = lane; i < n; i += 32) o[k0 * V + i] = so[i];
  } else {
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      store_chunk<V>(o, (k0 + lane + 32 * q) * V, c_out, acc[q]);
  }
}

struct Regime {
  int vb;       // bytes per chunk load
  int nq;       // chunks per lane
  int passes;   // warps per vertex, one per slice of its columns
  int u;        // entries per batch
};

// The chunk width (the widest the pitch and the stream's address allow,
// halved while the row would fill at most half a warp), the chunks per
// lane (1, 2 or 4: the fewest that cover the row, then more slices) and
// the batch size (from the runs' mean length M / T).
Regime choose(const void* g, int m, int cr, int c, int t, int with_weights,
              int es) {
  Regime R;
  const unsigned long long a = reinterpret_cast<unsigned long long>(g);
  const long long pitch = (long long)cr * es;
  R.vb = es;
  for (int v = 16; v > es; v /= 2) {
    if (a % v == 0 && pitch % v == 0) {
      R.vb = v;
      break;
    }
  }
  // a row that would fill at most half a warp takes narrower chunks, so
  // that 32 lanes share each entry's sums (what bounds the long runs)
  auto chunks = [&](int vb) { return (c + with_weights + vb / es - 1) / (vb / es); };
  while (R.vb > es && chunks(R.vb) <= 16) R.vb /= 2;
  const int nco = chunks(R.vb);
  if (nco <= 32) {
    R.nq = 1;
  } else {
    const int per_lane = (nco + 31) / 32;
    R.nq = pow2_at_least(per_lane > MAX_NQ ? MAX_NQ : per_lane);
  }
  R.passes = (nco + 32 * R.nq - 1) / (32 * R.nq);
  // entries per batch, from the runs' mean length: one entry (no shuffles)
  // under 2, 4 under 6, else 16; at most what 32 words of chunks per lane
  // hold
  const long long mean2 = t > 0 ? 2LL * m / t : 0;          // 2 x mean
  int u = mean2 < 4 ? 1 : (mean2 < 12 ? 4 : 16);
  const int cap = 32 / (R.nq * (R.vb >= 4 ? R.vb / 4 : 1));
  R.u = u < cap ? u : cap;
  return R;
}

struct Args {
  int cr, c;
  const int* rid;
  const int* start;
  const int* end;
  int t, m, with_weights;
  float* out;
};

template <typename T, bool W, int VB, int NQ, int U>
int launch(const T* g, const Regime& R, const Args& A, cudaStream_t s) {
  const long long warps = (long long)A.t * R.passes;
  const int blocks = (int)((warps + THREADS / 32 - 1) / (THREADS / 32));
  rank_reduce_kernel<T, W, VB, NQ, U><<<blocks, THREADS, 0, s>>>(
      g, A.cr, A.c, A.rid, A.start, A.end, A.t, A.m, A.with_weights,
      R.passes, A.out);
  return 0;
}

// the batch sizes choose() can ask for: 1, and 4 and 16 capped at what
// 32 words of chunks per lane hold
template <typename T, bool W, int VB, int NQ>
int launch_batches(const T* g, const Regime& R, const Args& A, cudaStream_t s) {
  constexpr int CAP = 32 / (NQ * Words<VB>::N);
  constexpr int U4 = CAP < 4 ? CAP : 4;
  constexpr int U16 = CAP < 16 ? CAP : 16;
  if (R.u == 1) return launch<T, W, VB, NQ, 1>(g, R, A, s);
  if (R.u == U4) return launch<T, W, VB, NQ, U4>(g, R, A, s);
  if (R.u == U16) return launch<T, W, VB, NQ, U16>(g, R, A, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool W, int VB>
int launch_chunks_per_lane(const T* g, const Regime& R, const Args& A, cudaStream_t s) {
  switch (R.nq) {
    case 1: return launch_batches<T, W, VB, 1>(g, R, A, s);
    case 2: return launch_batches<T, W, VB, 2>(g, R, A, s);
    case 4: return launch_batches<T, W, VB, 4>(g, R, A, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T, bool W>
int launch_chunks(const T* g, const Regime& R, const Args& A, cudaStream_t s) {
  switch (R.vb) {
    case 16: return launch_chunks_per_lane<T, W, 16>(g, R, A, s);
    case 8: return launch_chunks_per_lane<T, W, 8>(g, R, A, s);
    case 4: return launch_chunks_per_lane<T, W, 4>(g, R, A, s);
    default: break;
  }
  if constexpr (sizeof(T) == 2) {
    if (R.vb == 2) return launch_chunks_per_lane<T, W, 2>(g, R, A, s);
  }
  return (int)cudaErrorInvalidValue;
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
  if (c <= 0 || cr < c || (!weighted && with_weights) || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  with_weights = with_weights ? 1 : 0;
  const Regime R = choose(g, m, cr, c, t, with_weights, dtype == 1 ? 2 : 4);
  const Args A{cr, c, static_cast<const int*>(rid), static_cast<const int*>(start),
               static_cast<const int*>(end), t, m, with_weights,
               static_cast<float*>(out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == 1) {
    const bf16* gb = static_cast<const bf16*>(g);
    rc = weighted ? launch_chunks<bf16, true>(gb, R, A, s)
                  : launch_chunks<bf16, false>(gb, R, A, s);
  } else {
    const float* gf = static_cast<const float*>(g);
    rc = weighted ? launch_chunks<float, true>(gf, R, A, s)
                  : launch_chunks<float, false>(gf, R, A, s);
  }
  return rc ? rc : (int)cudaGetLastError();
}

// The regime hpl_rank_reduce takes for these arguments (32 lanes per
// vertex), packed as vb | nq << 8 | passes << 16 | u << 24 (-1 for
// arguments it refuses).
int hpl_rank_reduce_regime(const void* g, int m, int cr, int c, int t,
                           int with_weights, int dtype) {
  if (c <= 0 || cr < c || (dtype != 0 && dtype != 1)) return -1;
  const Regime R = choose(g, m, cr, c, t, with_weights ? 1 : 0,
                          dtype == 1 ? 2 : 4);
  return R.vb | R.nq << 8 | R.passes << 16 | R.u << 24;
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
