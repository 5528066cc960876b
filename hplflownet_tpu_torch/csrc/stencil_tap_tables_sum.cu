// Gather-only stencil over per-tap tables.
//
//   out[v, c] = sum_f tables[nb[f, v], f * C + c]           (H_out, C) f32
//
// Each tap f reads its own table, column group f of one (H, F * C) array:
// the correlation adjoint contracts the cotangent with every tap's kernel
// first (z = g @ k2^T, one matmul outside the kernel) and then only gathers
// and adds.  Taps with nb[f, v] == -1 (absent) add nothing.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py stencil_tap_tables_sum
// (_tts_kernel :421, pallas_call :531).  The TPU kernel streams groups of
// tap tables through VMEM, gathers each tap's rows with a one-hot window
// matmul, and writes one partial plane per tap group (in the tables' dtype)
// that a second XLA pass sums.  Here there are no windows and no partial
// planes: a block covers 8 output vertices x 32 channels, every thread owns
// one (vertex, channel), walks the taps in order and reads its element of
// the tap's row straight from global memory (a warp reads 32 consecutive
// channels of one row), sums in float32 and writes once.  No atomics: the
// order of every sum is fixed, so a rerun matches bit for bit.
//
// Bound on an H100: bytes.  One add per element read; the floor is the
// present taps' rows (nnz * C elements) plus the ids and the float32 output
// at 3.35 TB/s (about 0.03 ms at corr1: 65 taps over 12928 vertices, C 64,
// bf16).  The reads are scattered rows of C * 2-4 bytes, so the kernel is
// latency-bound well above that floor; many warps in flight hide part of it.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TX = 32;   // channels per block
constexpr int TY = 8;    // output vertices per block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(TX * TY)
tap_tables_kernel(const T* __restrict__ tables, int h, int c,
                  const int* __restrict__ nb, int num_taps, int h_out,
                  float* __restrict__ out) {
  const int ch = blockIdx.y * TX + threadIdx.x;
  const int v = blockIdx.x * TY + threadIdx.y;
  if (v >= h_out || ch >= c) return;
  const size_t pitch = (size_t)num_taps * c;
  float acc = 0.f;
  for (int f = 0; f < num_taps; ++f) {
    const int r = nb[(size_t)f * h_out + v];
    if (r >= 0 && r < h)
      acc = __fadd_rn(acc, to_f32(tables[(size_t)r * pitch + (size_t)f * c + ch]));
  }
  out[(size_t)v * c + ch] = acc;
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
  dim3 block(TX, TY);
  dim3 grid((h_out + TY - 1) / TY, (c + TX - 1) / TX);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* nbp = static_cast<const int*>(nb);
  float* op = static_cast<float*>(out);
  if (dtype == 1)
    tap_tables_kernel<bf16><<<grid, block, 0, st>>>(
        static_cast<const bf16*>(tables), h, c, nbp, num_taps, h_out, op);
  else if (dtype == 0)
    tap_tables_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(tables), h, c, nbp, num_taps, h_out, op);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
