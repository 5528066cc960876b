// Row take: out[i, :] = table[idx[i], :].
//
// Replaces: tools/gather_experiments.py pallas_take (:76; body take_kernel
// :73, pallas_call :77), the gather lab's in-VMEM jnp.take of a whole
// (H + 1, 128) bf16 table.  On Hopper the table stays in device memory (and
// L2): one warp copies one row with 16-byte vector loads and stores, lane l
// moving bytes [16 l, 16 l + 16) of the row (8 bf16 values), so a
// 256-byte bf16 row is one 256-byte load and store for half a warp.  Rows
// whose size or address is not a multiple of 16 bytes fall back to 4- or
// 2-byte words.  An index outside [0, rows) is clamped to the nearest row.
//
// Bound on an H100: bytes.  No arithmetic: the floor is H rows read, H rows
// written and H indices read at 3.35 TB/s.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;          // 8 warps = 8 rows per block

template <typename V>
__global__ void __launch_bounds__(THREADS)
row_take_kernel(const V* __restrict__ table, int rows, int words,
                const int* __restrict__ idx, int n, V* __restrict__ out) {
  const int i = blockIdx.x * (THREADS / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (i >= n) return;
  int src = idx[i];
  src = src < 0 ? 0 : (src >= rows ? rows - 1 : src);
  const V* s = table + (size_t)src * words;
  V* d = out + (size_t)i * words;
  for (int w = lane; w < words; w += 32) d[w] = s[w];
}

template <typename V>
cudaError_t launch(const void* table, int rows, int row_bytes,
                   const int* idx, int n, void* out, cudaStream_t s) {
  const int blocks = (n + THREADS / 32 - 1) / (THREADS / 32);
  row_take_kernel<V><<<blocks, THREADS, 0, s>>>(
      static_cast<const V*>(table), rows, row_bytes / (int)sizeof(V), idx, n,
      static_cast<V*>(out));
  return cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// table: (rows, row_bytes) bytes row-major; idx: (n,) int32; out: (n,
// row_bytes).  row_bytes must be even.  Returns the CUDA error code of the
// launch (0 on success).
int hpl_row_take(const void* table, int rows, int row_bytes, const void* idx,
                 int n, void* out, void* stream) {
  if (n <= 0) return 0;
  if (rows <= 0 || row_bytes <= 0 || row_bytes % 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  if (row_bytes % 16 == 0 && aligned(table, 16) && aligned(out, 16))
    return (int)launch<uint4>(table, rows, row_bytes, ip, n, out, s);
  if (row_bytes % 4 == 0 && aligned(table, 4) && aligned(out, 4))
    return (int)launch<uint32_t>(table, rows, row_bytes, ip, n, out, s);
  return (int)launch<uint16_t>(table, rows, row_bytes, ip, n, out, s);
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
