// Fused multi-tap stencil gather + matmul on the permutohedral lattice.
//
//   out[v, :] = act( sum_f table[nb[f, v], :] @ W[f] + bias )      (H_out, C_out)
//
// Taps with nb[f, v] == -1 (absent neighbour) add nothing.  The epilogue
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
// forward (the bcn1_ decoder blur: H = 25600, F = 15, C_in = 580,
// C_out = 1024) it is 456 GFLOP against ~30 MB of compulsory traffic
// (the table once, the weights once, the output once) — thousands of
// FLOP per byte, far above the ~295 FLOP/byte ridge of bf16.  So the design
// puts the products on the tensor cores: bf16 inputs go through WMMA
// 16x16x16 fragments with float32 accumulators; float32 inputs take a
// SIMT path (exact float32, no TF32).  Each block owns a 64-vertex x
// 64-channel output tile, loops over taps and 32-channel slices of C_in,
// gathers the tap's rows into shared memory (zero rows for absent taps and
// past the channel edge), and multiplies them by the W[f] slice; a tap that
// is absent for all 64 rows is skipped.  It is a
// simple kernel: one stage, no cp.async/TMA pipelining and no wgmma, so it
// runs well below the tensor-core peak — that is later work.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;        // output vertices per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 32;        // input channels per stage
constexpr int THREADS = 128;  // 4 warps
constexpr int A_LD = BK + 8;  // bf16 row pitch of the A tile (80 bytes)
constexpr int B_LD = BN + 8;  // bf16 row pitch of the B tile (144 bytes)
constexpr int C_LD = BN + 4;  // f32 row pitch of the accumulator tile

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16_rn(0.f);
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

// Gather the tap's rows into the A tile: As[i][kk] = table[rows[i], k0 + kk]
// (zero for absent rows and past C_in), and the W[f] slice into the B tile.
template <typename T, int ALD, int BLD>
__device__ __forceinline__ void load_tiles(
    T (*As)[ALD], T (*Bs)[BLD], const int* rows, const T* __restrict__ table,
    int c_in, const T* __restrict__ wf, int c_out, int n0, int k0) {
  const T z = zero_of<T>();
  for (int idx = threadIdx.x; idx < BM * BK; idx += THREADS) {
    const int i = idx / BK, kk = idx % BK;
    const int r = rows[i], k = k0 + kk;
    As[i][kk] = (r >= 0 && k < c_in) ? table[(size_t)r * c_in + k] : z;
  }
  for (int idx = threadIdx.x; idx < BK * BN; idx += THREADS) {
    const int kk = idx / BN, n = idx % BN;
    const int k = k0 + kk, col = n0 + n;
    Bs[kk][n] = (k < c_in && col < c_out) ? wf[(size_t)k * c_out + col] : z;
  }
}

// Load this tap's neighbour ids for the block's rows; -1 past H_out and for
// ids outside the table (those rows read as zero).  Returns, to every thread
// of the block, whether any row is present: a tap absent for the whole block
// (all of it past the occupied vertices, say) is skipped.
__device__ __forceinline__ int load_rows(int* rows, const int* __restrict__ nb,
                                         int f, int h_out, int h_in, int row0) {
  int any = 0;
  for (int i = threadIdx.x; i < BM; i += THREADS) {
    const int v = row0 + i;
    int r = v < h_out ? nb[(size_t)f * h_out + v] : -1;
    r = (r >= 0 && r < h_in) ? r : -1;
    rows[i] = r;
    any |= r >= 0;
  }
  return __syncthreads_or(any);
}

// bf16 inputs: WMMA tensor-core tiles, float32 accumulation.
template <typename TOut>
__global__ void __launch_bounds__(THREADS)
stencil_bf16_kernel(const bf16* __restrict__ table, int h_in, int c_in,
                    const int* __restrict__ nb, int num_taps, int h_out,
                    const bf16* __restrict__ w, int c_out,
                    const float* __restrict__ bias, int act, float slope,
                    TOut* __restrict__ out) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BM][A_LD];
  __shared__ __align__(32) bf16 Bs[BK][B_LD];
  __shared__ __align__(32) float Cs[BM][C_LD];
  __shared__ int rows[BM];

  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int warp = threadIdx.x / 32;
  const int wm = (warp / 2) * 32;   // warp's 32 x 32 sub-tile
  const int wn = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int f = 0; f < num_taps; ++f) {
    __syncthreads();
    if (!load_rows(rows, nb, f, h_out, h_in, row0)) continue;
    const bf16* wf = w + (size_t)f * c_in * c_out;
    for (int k0 = 0; k0 < c_in; k0 += BK) {
      __syncthreads();
      load_tiles<bf16, A_LD, B_LD>(As, Bs, rows, table, c_in, wf, c_out, n0, k0);
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < BK; ks += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], &As[wm + 16 * i][ks], A_LD);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], &Bs[ks][wn + 16 * j], B_LD);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[wm + 16 * i][wn + 16 * j], acc[i][j], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    const int i = idx / BN, n = idx % BN;
    const int v = row0 + i, col = n0 + n;
    if (v < h_out && col < c_out)
      out[(size_t)v * c_out + col] =
          from_f32<TOut>(epilogue(Cs[i][n], bias, col, act, slope));
  }
}

// float32 inputs: exact float32 SIMT products, each thread an 8 x 4 tile.
template <typename TOut>
__global__ void __launch_bounds__(THREADS)
stencil_f32_kernel(const float* __restrict__ table, int h_in, int c_in,
                   const int* __restrict__ nb, int num_taps, int h_out,
                   const float* __restrict__ w, int c_out,
                   const float* __restrict__ bias, int act, float slope,
                   TOut* __restrict__ out) {
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN];
  __shared__ int rows[BM];

  const int row0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tx = threadIdx.x % 16;   // columns tx + 16 j
  const int ty = threadIdx.x / 16;   // rows ty + 8 i
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int f = 0; f < num_taps; ++f) {
    __syncthreads();
    if (!load_rows(rows, nb, f, h_out, h_in, row0)) continue;
    const float* wf = w + (size_t)f * c_in * c_out;
    for (int k0 = 0; k0 < c_in; k0 += BK) {
      __syncthreads();
      load_tiles<float, BK + 1, BN>(As, Bs, rows, table, c_in, wf, c_out, n0, k0);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
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

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int v = row0 + ty + 8 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (v < h_out && col < c_out)
        out[(size_t)v * c_out + col] =
            from_f32<TOut>(epilogue(acc[i][j], bias, col, act, slope));
    }
  }
}

template <typename TIn, typename TOut>
void launch(const void* table, int h_in, int c_in, const int* nb, int num_taps,
            int h_out, const void* w, int c_out, const float* bias, int act,
            float slope, void* out, cudaStream_t stream) {
  dim3 grid((h_out + BM - 1) / BM, (c_out + BN - 1) / BN);
  if constexpr (std::is_same<TIn, bf16>::value) {
    stencil_bf16_kernel<TOut><<<grid, THREADS, 0, stream>>>(
        static_cast<const bf16*>(table), h_in, c_in, nb, num_taps, h_out,
        static_cast<const bf16*>(w), c_out, bias, act, slope,
        static_cast<TOut*>(out));
  } else {
    stencil_f32_kernel<TOut><<<grid, THREADS, 0, stream>>>(
        static_cast<const float*>(table), h_in, c_in, nb, num_taps, h_out,
        static_cast<const float*>(w), c_out, bias, act, slope,
        static_cast<TOut*>(out));
  }
}

}  // namespace

extern "C" {

// dtype codes: 0 = float32, 1 = bfloat16.  act: 0 none, 1 ReLU, 2 leaky
// (negative slope ``slope``).  ``bias`` may be null.  Returns the CUDA
// error code of the launch (0 on success).
int hpl_stencil_gather_matmul(const void* table, int h_in, int c_in,
                              const void* nb, int num_taps, int h_out,
                              const void* w, int c_out, const void* bias,
                              int act, float slope, void* out, int in_dtype,
                              int out_dtype, void* stream) {
  if (h_out <= 0 || c_out <= 0) return 0;
  const int* nbp = static_cast<const int*>(nb);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 1 && out_dtype == 1)
    launch<bf16, bf16>(table, h_in, c_in, nbp, num_taps, h_out, w, c_out, bp, act, slope, out, s);
  else if (in_dtype == 1 && out_dtype == 0)
    launch<bf16, float>(table, h_in, c_in, nbp, num_taps, h_out, w, c_out, bp, act, slope, out, s);
  else if (in_dtype == 0 && out_dtype == 1)
    launch<float, bf16>(table, h_in, c_in, nbp, num_taps, h_out, w, c_out, bp, act, slope, out, s);
  else if (in_dtype == 0 && out_dtype == 0)
    launch<float, float>(table, h_in, c_in, nbp, num_taps, h_out, w, c_out, bp, act, slope, out, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
