// Gather-only stencil over per-tap tables.
//
//   out[v, c] = sum_f tables[nb[f, v], f * C + c]           (H_out, C) f32
//
// Each tap f reads its own table, column group f of one (H, F * C) array:
// the correlation adjoint contracts the cotangent with every tap's kernel
// first (z = g @ k2^T, one matmul outside the kernel) and then only gathers
// and adds.  Taps with nb[f, v] outside [0, H) (-1: absent) add nothing.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py stencil_tap_tables_sum
// (_tts_kernel :421, pallas_call :531).  The TPU kernel streams groups of
// tap tables through VMEM, gathers each tap's rows with a one-hot window
// matmul, and writes one partial plane per tap group (in the tables' dtype)
// that a second XLA pass sums.  Here there are no windows and no partial
// planes: one pass gathers the present taps' rows and sums them.
//
// Bound on an H100: bytes.  One add per element read; the floor is the
// present taps' rows (nnz * C elements) plus the ids and the float32 output
// at 3.35 TB/s (0.021 ms at corr1: 65 taps over 12928 vertices, 58%
// present, C 64, bf16).  The reads are scattered rows of C * 2-4 bytes
// (128 at corr1 in bf16), so a thread-per-element walk (a dependent
// id-then-row chain per tap, one row load in flight per thread, 64 bytes
// per warp load) is latency-bound far above it.  The design:
//
// * A block takes 256 / G output vertices and stages their F x vertices
//   ids once, read coalesced along H_out, in shared memory.
// * A lane group per vertex: G lanes (8, 16 or 32: the fewest that cover
//   the row) each load VB bytes of a tap's row (16 where C's bytes and the
//   tables' address allow it, else 8, 4 or 2 for bf16; 16 or 4 for
//   float32), NQ chunks a lane: a 64-channel bf16 row is 8 lanes x 16 bytes,
//   four vertices to a warp.
// * The group lists its vertex's present taps in tap order (one ballot per
//   G taps) in shared memory, then walks the list U taps at a time: the
//   U row loads are issued before their sums, and absent taps cost no load.
// * Each output is a float32 fold from +0 over the present taps in tap
//   order with __fadd_rn, the plain version's order (kernels/tap_tables.py):
//   a rerun gives the same bits.  No atomics.
//
// 36 instantiations: {float32: VB 16, 4; bf16: VB 16, 8, 4, 2} x (G, NQ)
// in {(8, 1), (16, 1), (32, 1), (32, 2), (32, 4), (32, 8)}; wider rows
// take more than one pass.
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
constexpr int MAX_NQ = 8;

// G lanes per output vertex, NQ chunks of V = VB / sizeof(T) columns per
// lane; dynamic shared memory: the block's ids (F x NV ints) and each
// vertex's present-tap list (NV x F shorts).
template <typename T, int VB, int G, int NQ>
__global__ void __launch_bounds__(THREADS)
tap_tables_kernel(const T* __restrict__ tables, int h, int c,
                  const int* __restrict__ nb, int num_taps, int h_out,
                  float* __restrict__ out) {
  constexpr int ES = sizeof(T);
  constexpr int V = VB / ES;
  constexpr int NW = Words<VB>::N;
  constexpr int NV = THREADS / G;                    // vertices per block
  constexpr int RAW = NQ * NW;
  constexpr int U0 = RAW >= 32 ? 1 : 32 / RAW;
  constexpr int U = U0 > 8 ? 8 : U0;                 // taps per batch
  extern __shared__ int smem[];
  int* s_nb = smem;                                         // [F][NV]
  short* s_list = reinterpret_cast<short*>(smem + num_taps * NV);  // [NV][F]
  const int v0 = blockIdx.x * NV;
  for (int i = threadIdx.x; i < num_taps * NV; i += THREADS) {
    const int f = i / NV, v = v0 + (i - f * NV);
    s_nb[i] = v < h_out ? __ldg(nb + (size_t)f * h_out + v) : -1;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int vl = threadIdx.x / G;
  const int shift = lane & ~(G - 1);
  const unsigned gbits = G == 32 ? 0xffffffffu : (1u << G) - 1u;
  short* list = s_list + vl * num_taps;
  // the present taps, in tap order (every lane of the warp takes part)
  int n = 0;
  for (int f0 = 0; f0 < num_taps; f0 += G) {
    const int f = f0 + gl;
    const int id = f < num_taps ? s_nb[f * NV + vl] : -1;
    const bool present = id >= 0 && id < h;
    const unsigned mine = (__ballot_sync(0xffffffffu, present) >> shift) & gbits;
    if (present) list[n + __popc(mine & ((1u << gl) - 1u))] = (short)f;
    n += __popc(mine);
  }
  __syncwarp();
  const int v = v0 + vl;
  if (v >= h_out) return;
  const size_t pitch = (size_t)num_taps * c * ES;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(tables);
  float* o = out + (size_t)v * c;
  const int nco = (c + V - 1) / V;
  for (int k0 = 0; k0 < nco; k0 += G * NQ) {
    float acc[NQ][V];
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int el = 0; el < V; ++el) acc[q][el] = 0.f;
    // U present taps at a time: the batch's row loads are issued before
    // its first sum; absent taps were never listed, so they cost no load
    for (int i0 = 0; i0 < n; i0 += U) {
      uint32_t raw[U][NQ][NW];
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        const int i = i0 + uu;
        const int f = i < n ? list[i] : 0;
        const unsigned char* row =
            base + (size_t)(i < n ? s_nb[f * NV + vl] : 0) * pitch
            + (size_t)f * c * ES;
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int col = (k0 + gl + G * q) * V;
          if (i < n && col < c) {
            load_words<VB>(raw[uu][q], row + (size_t)col * ES);
          } else {
#pragma unroll
            for (int w = 0; w < NW; ++w) raw[uu][q][w] = 0u;
          }
        }
      }
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        if (i0 + uu >= n) break;
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int el = 0; el < V; ++el)
            acc[q][el] = __fadd_rn(acc[q][el], element<T, VB>(raw[uu][q], el));
      }
    }
#pragma unroll
    for (int q = 0; q < NQ; ++q)
      store_chunk<V>(o, (k0 + gl + G * q) * V, c, acc[q]);
  }
}

struct Regime {
  int vb, g, nq;
};

// The widest chunk that divides a tap row's bytes (C * es) and the
// tables' address (float32: 16 or 4 bytes; bf16: 16, 8, 4 or 2), and the
// fewest lanes that cover a row: up to 32 lanes of one chunk each, then up
// to 8 chunks a lane, then passes.
Regime choose(const void* tables, int c, int es) {
  Regime R;
  const unsigned long long a = reinterpret_cast<unsigned long long>(tables);
  const long long row = (long long)c * es;
  R.vb = es;
  for (int v = 16; v > es; v /= 2) {
    if (es == 4 && v == 8) continue;
    if (a % v == 0 && row % v == 0) {
      R.vb = v;
      break;
    }
  }
  const int nco = (c + R.vb / es - 1) / (R.vb / es);
  if (nco <= 32) {
    R.g = pow2_at_least(nco < 8 ? 8 : nco);
    R.nq = 1;
  } else {
    R.g = 32;
    const int per_lane = (nco + 31) / 32;
    R.nq = pow2_at_least(per_lane > MAX_NQ ? MAX_NQ : per_lane);
  }
  return R;
}

struct Args {
  int h, c;
  const int* nb;
  int num_taps, h_out;
  float* out;
};

template <typename T, int VB, int G, int NQ>
int launch(const T* tables, const Args& A, cudaStream_t s) {
  constexpr int NV = THREADS / G;
  const size_t smem = (size_t)A.num_taps * NV * (sizeof(int) + sizeof(short));
  auto kernel = tap_tables_kernel<T, VB, G, NQ>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (A.h_out + NV - 1) / NV;
  kernel<<<blocks, THREADS, smem, s>>>(tables, A.h, A.c, A.nb, A.num_taps,
                                       A.h_out, A.out);
  return 0;
}

template <typename T, int VB>
int launch_groups(const T* tables, const Regime& R, const Args& A,
                  cudaStream_t s) {
  switch (R.g * 16 + R.nq) {
    case 8 * 16 + 1: return launch<T, VB, 8, 1>(tables, A, s);
    case 16 * 16 + 1: return launch<T, VB, 16, 1>(tables, A, s);
    case 32 * 16 + 1: return launch<T, VB, 32, 1>(tables, A, s);
    case 32 * 16 + 2: return launch<T, VB, 32, 2>(tables, A, s);
    case 32 * 16 + 4: return launch<T, VB, 32, 4>(tables, A, s);
    case 32 * 16 + 8: return launch<T, VB, 32, 8>(tables, A, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int launch_chunks(const T* tables, const Regime& R, const Args& A,
                  cudaStream_t s) {
  switch (R.vb) {
    case 16: return launch_groups<T, 16>(tables, R, A, s);
    case 4: return launch_groups<T, 4>(tables, R, A, s);
    default: break;
  }
  if constexpr (sizeof(T) == 2) {
    if (R.vb == 8) return launch_groups<T, 8>(tables, R, A, s);
    if (R.vb == 2) return launch_groups<T, 2>(tables, R, A, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  tables: (h, num_taps * c) row-major;
// nb: (num_taps, h_out) int32; out: (h_out, c) float32.  Returns the CUDA
// error code of the launch (0 on success).
int hpl_stencil_tap_tables_sum(const void* tables, int h, int c, const void* nb,
                               int num_taps, int h_out, void* out, int dtype,
                               void* stream) {
  if (h_out <= 0 || c <= 0) return 0;
  if ((dtype != 0 && dtype != 1) || num_taps < 0 || num_taps > 32767)
    return (int)cudaErrorInvalidValue;
  const Regime R = choose(tables, c, dtype == 1 ? 2 : 4);
  const Args A{h, c, static_cast<const int*>(nb), num_taps, h_out,
               static_cast<float*>(out)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = dtype == 1
      ? launch_chunks<bf16>(static_cast<const bf16*>(tables), R, A, st)
      : launch_chunks<float>(static_cast<const float*>(tables), R, A, st);
  return rc ? rc : (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
