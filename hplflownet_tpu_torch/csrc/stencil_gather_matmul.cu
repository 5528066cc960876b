// Fused multi-tap stencil gather + matmul on the permutohedral lattice.
//
//   out[v, :] = act( sum_f table[nb[f, v], :] @ W[f] + bias )      (H_out, C_out)
//
// Taps with nb[f, v] == -1, or an id >= h_in, add nothing.  The epilogue
// (bias add, activation, output cast) runs in float32 before the single
// global write, as in the TPU kernel's _apply_epilogue.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py stencil_gather_matmul
// (_kernel :93, _pallas_impl :136).  The TPU kernel keeps the whole table in
// VMEM and gathers each tap through a one-hot matmul over a per-block index
// window, degrading out-of-window taps to absent.  This kernel is
// window-free: each block loads its own neighbour ids and gathers the rows
// straight from global memory, so no tap is ever dropped and there is no
// overflow count.
//
// Bound on an H100: operations.  At the widest shape of the flagship
// (the bcn1_ decoder blur: H = 25600, F = 15, C_in = 580, C_out = 1024)
// the present taps need 1.8e11 FLOP against ~50 MB of compulsory traffic,
// far above the ~295 FLOP/byte ridge of bf16.  What stands between a
// gather-GEMM and the tensor cores is (1) absent taps: 60% of the (vertex,
// tap) pairs there read nothing, but in the table's natural order nearly
// every 64-row block holds every tap; (2) the gathered rows' latency, which
// a one-stage loop exposes; (3) re-gathering the same rows for every
// column tile.  The design, bf16 path:
//
// * The block walks its 128 output rows in the stencil plan's order
//   (kernels/stencil_plan.py: rows stably sorted by tap-presence mask, so a
//   block shares its absent taps), reads nb[f, order[i]] and writes row
//   order[i]: every row is written once, no atomics.  The block first loads
//   its rows' ids for every tap into shared memory and lists the taps
//   present in some row; it computes only those (block, tap) pairs.  A
//   block with no present tap (rows that no vertex occupies sort to the
//   front) still writes act(bias).
// * A 6-stage shared-memory ring, four stages in flight (4 and 2 where
//   many taps' ids crowd shared memory), that runs across tap boundaries:
//   each stage is one (tap, 64-channel slice) step of a 128 x 128 output
//   tile.  The gathered rows arrive by cp.async (Hopper's
//   TMA has no row gather) in the widest chunk the row pitch allows
//   (C_in = 580 bf16 is a 1160-byte pitch: 8-byte chunks; 16 where C_in is
//   a multiple of 8), zero-filled for absent rows and past the C_in edge;
//   the W[f] slice arrives the same way.  Both land in 128-byte-swizzled
//   tiles (csrc/sm90_pipe.cuh).
// * Two warpgroups each multiply 64 rows x 128 columns with wgmma
//   (m64n128k16, or m64n64k16 where C_out <= 64), float32 accumulators in
//   registers; A is K-major, the weight slice MN-major through the
//   transpose bit.  One wgmma batch stays in flight while the next stage
//   is issued.
//
// float32 inputs take an exact SIMT path (no TF32), 64 x 64 tiles in plan
// order, one stage; it has no speed target.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <type_traits>

#include "sm90_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float epilogue(float x, const float* bias, int n,
                                          int act, float slope) {
  if (bias != nullptr) x = __fadd_rn(x, bias[n]);
  if (act == ACT_RELU) {
    x = x > 0.f ? x : 0.f;
  } else if (act == ACT_LEAKY) {
    x = x >= 0.f ? x : __fmul_rn(slope, x);
  }
  return x;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Args {
  const void* table;
  int h_in, c_in;
  const int* nb;
  const int* order;
  int num_taps, h_out;
  const void* w;
  int c_out;
  const float* bias;
  int act;
  float slope;
  void* out;
  int vec_a, vec_b;   // cp.async chunk bytes of the table rows and W rows
};

// ---------------------------------------------------------------------------
// bf16: cp.async ring + wgmma
// ---------------------------------------------------------------------------

constexpr int BM = 128;               // output rows per block: 2 warpgroups x 64
constexpr int BK = 64;                // input channels per stage
constexpr int THREADS = 256;
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int ID_BATCH = 8;           // neighbour ids in flight per thread
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may use

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int R = BN / 2;    // accumulators per thread
};

// The ring (STAGES stages, STAGES - 2 in flight ahead of the MMA), then
// ids [F][BM], the tap flags and list [F] each, the rows [BM], the count.
template <int BN, int STAGES>
size_t smem_bytes(int num_taps) {
  return 1024 + (size_t)STAGES * Tile<BN>::STAGE
         + (size_t)num_taps * (BM + 2) * 4 + BM * 4 + 16;
}

// A stage's 128 gathered rows x 64 channels (K-major, swizzled): two
// threads per row, chunk j = half + 2 c.
template <int VEC>
__device__ __forceinline__ void load_rows(uint32_t dst, uint8_t* gdst,
                                          const int* ids, const bf16* table,
                                          int c_in, int k0) {
  constexpr int PER = 128 / VEC / 2;
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  const int id = ids[r];
  const bf16* src = table + (size_t)(id >= 0 ? id : 0) * c_in + k0;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int b = (h + 2 * c) * VEC;
    const bool ok = id >= 0 && k0 + b / 2 < c_in;
    const uint32_t off = sm90::swz(r, b);
    sm90::copy_chunk<VEC>(dst + off, gdst + off, ok ? src + b / 2 : table, ok);
  }
}

// A stage's weight slice W[f][k0 : k0 + 64, n0 : n0 + BN] (MN-major atoms
// of 64 columns, swizzled).
template <int VEC, int BN>
__device__ __forceinline__ void load_weights(uint32_t dst, uint8_t* gdst,
                                             const bf16* wf, int c_in,
                                             int c_out, int k0, int n0) {
  constexpr int CPR = BN * 2 / VEC;                // chunks per K-row
  constexpr int PER = BK * CPR / THREADS;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int idx = threadIdx.x + THREADS * c;
    const int k = idx / CPR, b = (idx % CPR) * VEC;
    const bool ok = k0 + k < c_in && n0 + b / 2 < c_out;
    const uint32_t off = (b >> 7) * (BK * 128) + sm90::swz(k, b & 127);
    sm90::copy_chunk<VEC>(dst + off, gdst + off,
                          ok ? wf + (size_t)(k0 + k) * c_out + n0 + b / 2 : wf,
                          ok);
  }
}

template <int BN>
__device__ __forceinline__ void load_stage(const Args& p, uint32_t dst,
                                           uint8_t* gdst, const int* ids,
                                           int f, int k0, int n0) {
  const bf16* table = static_cast<const bf16*>(p.table);
  switch (p.vec_a) {
    case 16: load_rows<16>(dst, gdst, ids, table, p.c_in, k0); break;
    case 8: load_rows<8>(dst, gdst, ids, table, p.c_in, k0); break;
    case 4: load_rows<4>(dst, gdst, ids, table, p.c_in, k0); break;
    default: load_rows<2>(dst, gdst, ids, table, p.c_in, k0); break;
  }
  const bf16* wf = static_cast<const bf16*>(p.w) + (size_t)f * p.c_in * p.c_out;
  dst += A_BYTES;
  gdst += A_BYTES;
  switch (p.vec_b) {
    case 16: load_weights<16, BN>(dst, gdst, wf, p.c_in, p.c_out, k0, n0); break;
    case 8: load_weights<8, BN>(dst, gdst, wf, p.c_in, p.c_out, k0, n0); break;
    case 4: load_weights<4, BN>(dst, gdst, wf, p.c_in, p.c_out, k0, n0); break;
    default: load_weights<2, BN>(dst, gdst, wf, p.c_in, p.c_out, k0, n0); break;
  }
}

template <int BN, typename TOut, int STAGES>
__global__ void __launch_bounds__(THREADS, 1)
stencil_wgmma_kernel(const Args p) {
  using T = Tile<BN>;
  constexpr int AHEAD = STAGES - 2;   // stages in flight ahead of the MMA
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* gbase = smem_raw + pad;
  const uint32_t sbase = raw + pad;
  const int F = p.num_taps;
  int* ids = reinterpret_cast<int*>(gbase + STAGES * T::STAGE);   // [F][BM]
  int* flags = ids + F * BM;                                     // [F]
  int* taps = flags + F;                                         // [F]
  int* vrow = taps + F;                                          // [BM]
  int* ntaps_s = vrow + BM;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;

  // the block's rows in plan order, their ids per tap, the present taps
  for (int i = tid; i < BM; i += THREADS)
    vrow[i] = row0 + i < p.h_out ? p.order[row0 + i] : -1;
  for (int f = tid; f < F; f += THREADS) flags[f] = 0;
  __syncthreads();
  {
    // two threads per row, each every other tap, ID_BATCH loads in flight
    const int i = tid % BM, v = vrow[i];
    for (int f0 = tid / BM; f0 < F; f0 += 2 * ID_BATCH) {
      int r[ID_BATCH];
#pragma unroll
      for (int j = 0; j < ID_BATCH; ++j) {
        const int f = f0 + 2 * j;
        r[j] = (v >= 0 && f < F) ? __ldg(p.nb + (size_t)f * p.h_out + v) : -1;
      }
#pragma unroll
      for (int j = 0; j < ID_BATCH; ++j) {
        const int f = f0 + 2 * j;
        if (f < F) {
          const int id = (r[j] >= 0 && r[j] < p.h_in) ? r[j] : -1;
          ids[f * BM + i] = id;
          if (id >= 0) flags[f] = 1;
        }
      }
    }
  }
  __syncthreads();
  if (tid < 32) {   // warp 0 lists the present taps in order
    int n = 0;
    for (int f0 = 0; f0 < F; f0 += 32) {
      const bool on = f0 + tid < F && flags[f0 + tid];
      const unsigned mask = __ballot_sync(0xffffffffu, on);
      if (on) taps[n + __popc(mask & ((1u << tid) - 1u))] = f0 + tid;
      n += __popc(mask);
    }
    if (tid == 0) *ntaps_s = n;
  }
  __syncthreads();
  const int kc = (p.c_in + BK - 1) / BK;
  const int n_iters = *ntaps_s * kc;

  auto issue = [&](int it) {
    if (it < n_iters) {
      const int slot = it % STAGES, f = taps[it / kc];
      load_stage<BN>(p, sbase + slot * T::STAGE, gbase + slot * T::STAGE,
                     ids + f * BM, f, (it % kc) * BK, n0);
    }
    sm90::cp_async_commit();
  };

  const int wg = tid / 128;
  float acc[T::R];
#pragma unroll
  for (int i = 0; i < T::R; ++i) acc[i] = 0.f;

#pragma unroll 1
  for (int s = 0; s < AHEAD; ++s) issue(s);
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    sm90::cp_async_wait<AHEAD - 1>();
    sm90::fence_proxy_async();
    __syncthreads();   // stage it landed; every wgmma of stage it - 2 is done
    issue(it + AHEAD);
    const uint32_t a = sbase + (it % STAGES) * T::STAGE + wg * 64 * 128;
    const uint32_t b = sbase + (it % STAGES) * T::STAGE + A_BYTES;
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      sm90::wgmma_k16<0, 1>(acc, sm90::desc(a + ks * 32, 16, 1024),
                            sm90::desc(b + ks * 16 * 128, BK * 128, 1024));
    sm90::wgmma_commit();
    sm90::fence_regs(acc);
    sm90::wgmma_wait<1>();
    sm90::fence_regs(acc);
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();

  // epilogue: rows wg*64 + warp*16 + lane/4 (+8), columns 8q + 2(lane%4) (+1)
  const int warp = (tid % 128) / 32, lane = tid % 32;
  TOut* out = static_cast<TOut*>(p.out);
  const bool pairs = (p.c_out & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int v = vrow[wg * 64 + warp * 16 + lane / 4 + 8 * h];
    if (v >= 0) {
      TOut* orow = out + (size_t)v * p.c_out;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = n0 + 8 * q + 2 * (lane % 4);
        const float x0 = acc[4 * q + 2 * h], x1 = acc[4 * q + 2 * h + 1];
        if (pairs && col + 1 < p.c_out) {
          store2(orow + col, epilogue(x0, p.bias, col, p.act, p.slope),
                 epilogue(x1, p.bias, col + 1, p.act, p.slope));
        } else {
          if (col < p.c_out)
            orow[col] = from_f32<TOut>(epilogue(x0, p.bias, col, p.act, p.slope));
          if (col + 1 < p.c_out)
            orow[col + 1] =
                from_f32<TOut>(epilogue(x1, p.bias, col + 1, p.act, p.slope));
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: exact SIMT products, 64 x 64 tiles, rows in plan order
// ---------------------------------------------------------------------------

constexpr int FM = 64;          // output rows per block
constexpr int FN = 64;          // output channels per block
constexpr int FK = 32;          // input channels per step
constexpr int F_THREADS = 128;

// This tap's table rows for the block's rows (-1: absent or past H_out).
// Returns, to every thread of the block, whether any row is present.
__device__ __forceinline__ int load_tap_rows(int* rows, const int* vrow,
                                             const int* __restrict__ nb, int f,
                                             int h_out, int h_in) {
  int any = 0;
  for (int i = threadIdx.x; i < FM; i += F_THREADS) {
    const int v = vrow[i];
    int r = v >= 0 ? nb[(size_t)f * h_out + v] : -1;
    r = (r >= 0 && r < h_in) ? r : -1;
    rows[i] = r;
    any |= r >= 0;
  }
  return __syncthreads_or(any);
}

template <typename TOut>
__global__ void __launch_bounds__(F_THREADS)
stencil_f32_kernel(const Args p) {
  __shared__ float As[FM][FK + 1];
  __shared__ float Bs[FK][FN];
  __shared__ int rows[FM];
  __shared__ int vrow[FM];
  const float* table = static_cast<const float*>(p.table);
  const float* w = static_cast<const float*>(p.w);

  const int row0 = blockIdx.x * FM;
  const int n0 = blockIdx.y * FN;
  const int tx = threadIdx.x % 16;   // columns tx + 16 j
  const int ty = threadIdx.x / 16;   // rows ty + 8 i
  for (int i = threadIdx.x; i < FM; i += F_THREADS)
    vrow[i] = row0 + i < p.h_out ? p.order[row0 + i] : -1;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int f = 0; f < p.num_taps; ++f) {
    __syncthreads();
    if (!load_tap_rows(rows, vrow, p.nb, f, p.h_out, p.h_in)) continue;
    const float* wf = w + (size_t)f * p.c_in * p.c_out;
    for (int k0 = 0; k0 < p.c_in; k0 += FK) {
      __syncthreads();
      for (int idx = threadIdx.x; idx < FM * FK; idx += F_THREADS) {
        const int i = idx / FK, kk = idx % FK;
        const int r = rows[i], k = k0 + kk;
        As[i][kk] = (r >= 0 && k < p.c_in) ? table[(size_t)r * p.c_in + k] : 0.f;
      }
      for (int idx = threadIdx.x; idx < FK * FN; idx += F_THREADS) {
        const int kk = idx / FN, n = idx % FN;
        const int k = k0 + kk, col = n0 + n;
        Bs[kk][n] = (k < p.c_in && col < p.c_out) ? wf[(size_t)k * p.c_out + col] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < FK; ++kk) {
        float a[8], b[4];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = As[ty + 8 * i][kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
  }

  TOut* out = static_cast<TOut*>(p.out);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = vrow[ty + 8 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (v >= 0 && col < p.c_out)
        out[(size_t)v * p.c_out + col] =
            from_f32<TOut>(epilogue(acc[i][j], p.bias, col, p.act, p.slope));
    }
  }
}

template <int BN, typename TOut, int STAGES>
int launch_wgmma(const Args& a, cudaStream_t s) {
  const size_t bytes = smem_bytes<BN, STAGES>(a.num_taps);
  if (bytes > SMEM_MAX) return (int)cudaErrorInvalidValue;   // too many taps
  static size_t allowed = 0;
  if (bytes > allowed) {
    cudaError_t e = cudaFuncSetAttribute(
        stencil_wgmma_kernel<BN, TOut, STAGES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    allowed = bytes;
  }
  dim3 grid((a.c_out + BN - 1) / BN, (a.h_out + BM - 1) / BM);
  stencil_wgmma_kernel<BN, TOut, STAGES><<<grid, THREADS, bytes, s>>>(a);
  return (int)cudaGetLastError();
}

// S1 stages where the ids of all taps leave room for them, else S2.
template <int BN, typename TOut, int S1, int S2>
int launch_fit(const Args& a, cudaStream_t s) {
  return smem_bytes<BN, S1>(a.num_taps) <= SMEM_MAX
             ? launch_wgmma<BN, TOut, S1>(a, s)
             : launch_wgmma<BN, TOut, S2>(a, s);
}

// 64 output columns per block where C_out <= 64, else 128 (a 256-column
// tile needs 128 accumulators a thread and spills: slower at every shape,
// H100, 700 W).  Six stages (up to ~66 taps' ids beside them), else four.
template <typename TOut>
int launch_bf16(const Args& a, cudaStream_t s) {
  return a.c_out <= 64 ? launch_fit<64, TOut, 6, 4>(a, s)
                       : launch_fit<128, TOut, 6, 4>(a, s);
}

template <typename TOut>
int launch_f32(const Args& a, cudaStream_t s) {
  dim3 grid((a.h_out + FM - 1) / FM, (a.c_out + FN - 1) / FN);
  stencil_f32_kernel<TOut><<<grid, F_THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  act: 0 none, 1 ReLU, 2 leaky
// (negative slope ``slope``).  ``bias`` may be null.  ``order`` (H_out,)
// is a permutation of the output rows (the stencil plan's row order).
// Returns the CUDA error code of the launch (0 on success).
int hpl_stencil_gather_matmul(const void* table, int h_in, int c_in,
                              const void* nb, const void* order, int num_taps,
                              int h_out, const void* w, int c_out,
                              const void* bias, int act, float slope,
                              void* out, int in_dtype, int out_dtype,
                              void* stream) {
  if (h_out <= 0 || c_out <= 0) return 0;
  Args a{table, h_in, c_in, static_cast<const int*>(nb),
         static_cast<const int*>(order), num_taps, h_out, w, c_out,
         static_cast<const float*>(bias), act, slope, out,
         sm90::chunk_bytes(table, c_in), sm90::chunk_bytes(w, c_out)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1) return launch_bf16<bf16>(a, s);
  if (in_dtype == 1 && out_dtype == 0) return launch_bf16<float>(a, s);
  if (in_dtype == 0 && out_dtype == 1) return launch_f32<bf16>(a, s);
  if (in_dtype == 0 && out_dtype == 0) return launch_f32<float>(a, s);
  return (int)cudaErrorInvalidValue;
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
