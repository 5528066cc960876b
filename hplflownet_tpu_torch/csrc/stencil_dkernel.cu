// Weight gradient of the lattice stencil contraction.
//
//   dW[f, i, o] = sum_v table[nb[f, v], i] * g[v, o]        (F, C_in, C_out) f32
//
// Taps with nb[f, v] == -1 (absent neighbour) add nothing.  table and g are
// both float32 or both bfloat16; products are exact in float32 either way
// (bf16 x bf16 fits a float32 mantissa) and every sum is float32.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py stencil_dkernel (_dk_kernel
// :304, pallas_call :406).  The TPU kernel walks the grid in order and
// accumulates one (C_in, C_out) slab per tap group in VMEM across the vertex
// blocks, re-gathering the rows through a one-hot window matmul.  On Hopper
// blocks run in parallel and nothing carries over between them, so this
// kernel is window-free and gives each block its own output tile: one block
// per (C_in tile, C_out tile, tap, vertex chunk).  The block loops over its
// chunk 32 vertices at a time, gathers the tap's 32 table rows and the 32
// cotangent rows straight from global memory into shared memory (zero rows
// for absent taps and past the channel edges), and accumulates the 64 x 64
// tile of table_rows^T @ g_rows.  A 32-vertex block in which the tap is
// absent for every row is skipped.
//
// Deterministic: no float atomics.  Where the output tiles are too few to
// fill the card (the corr_self gradient has 2 x 1 x 15 of them), the vertex
// axis is cut into a fixed number of chunks (the wrapper picks it from the
// shapes alone); each chunk writes its own partial slab, and a second pass
// sums the slabs in chunk order.  The same shapes therefore give the same
// bits on every run.
//
// Bound on an H100: operations at the wide decoder shapes (bcn1_: 15 taps,
// 25600 vertices, 580 x 1024, about 2 * nnz * C_in * C_out = 1.8e11 FLOP over
// the present taps against ~35 MB of compulsory traffic), bytes at the
// narrow ones.  bf16 inputs go through WMMA 16x16x16 fragments with float32
// accumulators (the table tile is read as a column-major A operand, so no
// transpose is materialised); float32 inputs take exact SIMT FMAs (no TF32).
// It is a simple kernel: one stage, no cp.async/TMA pipelining and no
// wgmma, so it runs well below the tensor-core peak.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TI = 64;        // C_in rows of the output tile
constexpr int TO = 64;        // C_out columns of the output tile
constexpr int BV = 32;        // vertices per stage
constexpr int THREADS = 128;  // 4 warps
constexpr int A_LD = TI + 8;  // bf16 pitch of the table tile (144 bytes)
constexpr int G_LD = TO + 8;  // bf16 pitch of the cotangent tile
constexpr int C_LD = TO + 4;  // f32 pitch of the accumulator tile

template <typename T> __device__ __forceinline__ T zero_of();
template <> __device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <> __device__ __forceinline__ bf16 zero_of<bf16>() {
  return __float2bfloat16_rn(0.f);
}

// This tap's neighbour ids for vertices [v0, v0 + BV) of the chunk ending at
// v_end; -1 past the chunk and for ids outside the table.  Returns, to every
// thread, whether any row is present.
__device__ __forceinline__ int load_rows(int* rows, const int* __restrict__ nb,
                                         int f, int h_out, int h_in, int v0,
                                         int v_end) {
  int any = 0;
  for (int i = threadIdx.x; i < BV; i += THREADS) {
    const int v = v0 + i;
    int r = v < v_end ? nb[(size_t)f * h_out + v] : -1;
    r = (r >= 0 && r < h_in) ? r : -1;
    rows[i] = r;
    any |= r >= 0;
  }
  return __syncthreads_or(any);
}

// As[v][i] = table[rows[v], i0 + i] and Gs[v][o] = g[v0 + v, o0 + o]; zero
// for absent rows and past the channel edges.
template <typename T, int ALD, int GLD>
__device__ __forceinline__ void load_tiles(
    T (*As)[ALD], T (*Gs)[GLD], const int* rows, const T* __restrict__ table,
    int c_in, const T* __restrict__ g, int c_out, int v0, int i0, int o0) {
  const T z = zero_of<T>();
  for (int idx = threadIdx.x; idx < BV * TI; idx += THREADS) {
    const int v = idx / TI, i = idx % TI;
    const int r = rows[v], col = i0 + i;
    As[v][i] = (r >= 0 && col < c_in) ? table[(size_t)r * c_in + col] : z;
  }
  for (int idx = threadIdx.x; idx < BV * TO; idx += THREADS) {
    const int v = idx / TO, o = idx % TO;
    const int col = o0 + o;
    Gs[v][o] = (rows[v] >= 0 && col < c_out)
                   ? g[(size_t)(v0 + v) * c_out + col] : z;
  }
}

// Block (blockIdx.x, blockIdx.y) owns the tile [i0, i0 + 64) x [o0, o0 + 64)
// of tap f over vertex chunk s; it writes slab s of out (S, F, C_in, C_out).
__device__ __forceinline__ void block_coords(int num_taps, int chunk, int h_out,
                                             int& f, int& s, int& v_begin,
                                             int& v_end) {
  f = blockIdx.z % num_taps;
  s = blockIdx.z / num_taps;
  v_begin = s * chunk;
  v_end = min(h_out, v_begin + chunk);
}

__global__ void __launch_bounds__(THREADS)
dkernel_bf16(const bf16* __restrict__ table, int h_in, int c_in,
             const int* __restrict__ nb, int num_taps, int h_out,
             const bf16* __restrict__ g, int c_out, int chunk,
             float* __restrict__ out) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 As[BV][A_LD];
  __shared__ __align__(32) bf16 Gs[BV][G_LD];
  __shared__ __align__(32) float Cs[TI][C_LD];
  __shared__ int rows[BV];

  int f, s, v_begin, v_end;
  block_coords(num_taps, chunk, h_out, f, s, v_begin, v_end);
  const int i0 = blockIdx.x * TI, o0 = blockIdx.y * TO;
  const int warp = threadIdx.x / 32;
  const int wi = (warp / 2) * 32;   // warp's 32 x 32 sub-tile
  const int wo = (warp % 2) * 32;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    __syncthreads();
    if (!load_rows(rows, nb, f, h_out, h_in, v0, v_end)) continue;
    load_tiles<bf16, A_LD, G_LD>(As, Gs, rows, table, c_in, g, c_out, v0, i0, o0);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BV; ks += 16) {
      // A = table_rows^T: element (i, v) sits at As[v][i], a column-major
      // 16 x 16 operand with leading dimension A_LD
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wmma::load_matrix_sync(fa[a], &As[ks][wi + 16 * a], A_LD);
#pragma unroll
      for (int b = 0; b < 2; ++b)
        wmma::load_matrix_sync(fb[b], &Gs[ks][wo + 16 * b], G_LD);
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int b = 0; b < 2; ++b) wmma::mma_sync(acc[a][b], fa[a], fb[b], acc[a][b]);
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
      wmma::store_matrix_sync(&Cs[wi + 16 * a][wo + 16 * b], acc[a][b], C_LD,
                              wmma::mem_row_major);
  __syncthreads();
  float* slab = out + ((size_t)s * num_taps + f) * c_in * c_out;
  for (int idx = threadIdx.x; idx < TI * TO; idx += THREADS) {
    const int i = idx / TO, o = idx % TO;
    const int row = i0 + i, col = o0 + o;
    if (row < c_in && col < c_out) slab[(size_t)row * c_out + col] = Cs[i][o];
  }
}

// float32 inputs: exact float32 SIMT products, each thread an 8 x 4 tile
// (rows ty + 8 a, columns tx + 16 b), summed over the vertices in order.
__global__ void __launch_bounds__(THREADS)
dkernel_f32(const float* __restrict__ table, int h_in, int c_in,
            const int* __restrict__ nb, int num_taps, int h_out,
            const float* __restrict__ g, int c_out, int chunk,
            float* __restrict__ out) {
  __shared__ float As[BV][TI];
  __shared__ float Gs[BV][TO];
  __shared__ int rows[BV];

  int f, s, v_begin, v_end;
  block_coords(num_taps, chunk, h_out, f, s, v_begin, v_end);
  const int i0 = blockIdx.x * TI, o0 = blockIdx.y * TO;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int v0 = v_begin; v0 < v_end; v0 += BV) {
    __syncthreads();
    if (!load_rows(rows, nb, f, h_out, h_in, v0, v_end)) continue;
    load_tiles<float, TI, TO>(As, Gs, rows, table, c_in, g, c_out, v0, i0, o0);
    __syncthreads();
#pragma unroll 8
    for (int v = 0; v < BV; ++v) {
      float x[8], y[4];
#pragma unroll
      for (int a = 0; a < 8; ++a) x[a] = As[v][ty + 8 * a];
#pragma unroll
      for (int b = 0; b < 4; ++b) y[b] = Gs[v][tx + 16 * b];
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(x[a], y[b], acc[a][b]);
    }
  }

  float* slab = out + ((size_t)s * num_taps + f) * c_in * c_out;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = i0 + ty + 8 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = o0 + tx + 16 * b;
      if (row < c_in && col < c_out) slab[(size_t)row * c_out + col] = acc[a][b];
    }
  }
}

// out[j] = sum_s partial[s, j], in chunk order.
__global__ void sum_slabs(const float* __restrict__ partial, int splits,
                          size_t n, float* __restrict__ out) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (size_t)gridDim.x * blockDim.x) {
    float acc = partial[j];
    for (int s = 1; s < splits; ++s) acc = __fadd_rn(acc, partial[(size_t)s * n + j]);
    out[j] = acc;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (table and g alike).  The vertex axis is
// cut into ``splits`` chunks of ``chunk`` vertices; with splits > 1 the
// chunks write ``partial`` (splits, F, C_in, C_out) and a second pass sums
// them into ``out`` (F, C_in, C_out), else the blocks write ``out``
// directly.  Returns the CUDA error code of the launches (0 on success).
int hpl_stencil_dkernel(const void* table, int h_in, int c_in, const void* nb,
                        int num_taps, int h_out, const void* g, int c_out,
                        int chunk, int splits, void* partial, void* out,
                        int dtype, void* stream) {
  if (num_taps <= 0 || c_in <= 0 || c_out <= 0) return 0;
  if (splits < 1 || chunk < 1 || (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* nbp = static_cast<const int*>(nb);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  dim3 grid((c_in + TI - 1) / TI, (c_out + TO - 1) / TO, num_taps * splits);
  if (dtype == 1)
    dkernel_bf16<<<grid, THREADS, 0, st>>>(
        static_cast<const bf16*>(table), h_in, c_in, nbp, num_taps, h_out,
        static_cast<const bf16*>(g), c_out, chunk, dst);
  else if (dtype == 0)
    dkernel_f32<<<grid, THREADS, 0, st>>>(
        static_cast<const float*>(table), h_in, c_in, nbp, num_taps, h_out,
        static_cast<const float*>(g), c_out, chunk, dst);
  else
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const size_t n = (size_t)num_taps * c_in * c_out;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slabs<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial), splits,
                                    n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
