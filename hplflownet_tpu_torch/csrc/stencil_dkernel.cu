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
// per (C_in tile, C_out tile, tap, vertex chunk).
//
// Bound on an H100: operations at the wide decoder shapes (bcn1_: 15 taps,
// 25600 vertices, 580 x 1024, 2 * nnz * C_in * C_out = 1.8e11 FLOP over the
// present taps against ~35 MB of compulsory traffic), bytes at the narrow
// ones.  Walking every vertex for every tap would multiply 60% zero rows at
// bcn1_, and the gathered rows' latency would stall a one-stage loop.  The
// design:
//
// * Each block sums over its tap's compacted list of present vertices from
//   the stencil plan (kernels/stencil_plan.py: verts[f] in vertex order,
//   rows[f] = nb[f, verts[f]], counts[f]): exactly the present work, in a
//   fixed order.
// * bf16: a cp.async ring of up to 7 stages, five in flight; each stage
//   gathers 64 list entries: the table rows' 128-channel slice and the
//   cotangent rows' C_out slice, both rows of K = vertices with the output
//   dimension contiguous, so both land MN-major in 128-byte-swizzled tiles
//   (csrc/sm90_pipe.cuh) and feed wgmma through its transpose bits; no
//   transpose is materialised.  Two warpgroups each own 64 C_in rows of a
//   128 x 128 (or 128 x 64 where C_out <= 64) output tile, float32
//   accumulators in registers; where C_in <= 64 (corr_cross) they split
//   the columns of a 64 x 256 tile instead, so no warpgroup idles and each
//   stage's gathered table rows serve 256 columns.  Each thread fetches the list
//   entries of the stage after next into registers while the current stage
//   computes.
// * float32 inputs take exact SIMT FMAs (no TF32), 64 x 64 tiles, 32 list
//   entries a step; no speed target.
//
// Deterministic: no float atomics.  Where the output tiles are too few to
// fill the card, the list of each tap is cut into chunks of ``chunk``
// entries (the wrapper picks it from the shapes alone, for H_out entries):
// block (tile, f, s) sums entries [s chunk, min((s + 1) chunk, counts[f]))
// into its own partial slab and exits at once if s > 0 and that range is
// empty; the largest tap (the centre, 2.2x the others at bcn1_) thus gets
// the most chunks, and no chunk is longer than ``chunk``.  A second pass
// sums the ceil(counts[f] / chunk) slabs of tap f in chunk order; split 0
// always writes, so a tap with no present vertex gets zeros.  The same
// inputs therefore give the same bits on every run.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;

struct Args {
  const void* table;
  int h_in, c_in;
  const int* verts;     // (F, list_ld) present vertices per tap
  const int* rows;      // (F, list_ld) their table rows
  const int* counts;    // (F,)
  int num_taps, list_ld;
  const void* g;
  int c_out;
  int chunk, splits;
  float* dst;           // (splits, F, C_in, C_out) partial slabs, or out
  int vec_a, vec_b;     // cp.async chunk bytes of table rows and g rows
};

// Block (tile, f, s): the list range it sums; false if it has nothing to
// write (s > 0 past the count).
__device__ __forceinline__ bool list_range(const Args& p, int f, int s,
                                           int& begin, int& end) {
  const int count = p.counts[f];
  begin = s * p.chunk;
  end = min(count, begin + p.chunk);
  return s == 0 || begin < count;
}

__device__ __forceinline__ float* slab(const Args& p, int f, int s) {
  const size_t n = (size_t)p.c_in * p.c_out;
  return p.dst + ((p.splits > 1 ? (size_t)s * p.num_taps : 0) + f) * n;
}

// ---------------------------------------------------------------------------
// bf16: cp.async ring + wgmma
// ---------------------------------------------------------------------------

constexpr int BK = 64;                // list entries (vertices) per stage
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;      // dynamic shared memory a block may use

// A block's output tile is TM C_in rows x BN C_out columns.  TM = 128: the
// two warpgroups split the rows (64 each, all BN columns); TM = 64 (where
// C_in <= 64, as in corr_cross): they split the columns (BN / 2 each).
template <int TM, int BN>
struct Tile {
  static constexpr int A_BYTES = TM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int WG_N = TM == 128 ? BN : BN / 2;   // a warpgroup's columns
  static constexpr int R = WG_N / 2;                      // its accumulators
  // as many stages as fit, at most 7 (five in flight)
  static constexpr int STAGES = (SMEM_MAX - 1024) / STAGE < 7
                                    ? (SMEM_MAX - 1024) / STAGE : 7;
  static constexpr int AHEAD = STAGES - 2;
};

// One vertex row of a stage: ``width`` channels from ``col0`` of row ``src_row``
// (bf16, pitch ``ld``) into K-row q of an MN-major tile, four threads per
// row, chunk j = part + 4 c.
template <int VEC, int WIDTH>
__device__ __forceinline__ void load_krow(uint32_t dst, uint8_t* gdst, int q,
                                          int part, const bf16* base,
                                          int src_row, int ld, int col0,
                                          bool row_ok) {
  constexpr int PER = WIDTH * 2 / VEC / 4;
  const bf16* src = base + (size_t)(row_ok ? src_row : 0) * ld + col0;
#pragma unroll
  for (int c = 0; c < PER; ++c) {
    const int b = (part + 4 * c) * VEC;
    const bool ok = row_ok && col0 + b / 2 < ld;
    const uint32_t off = (b >> 7) * (BK * 128) + sm90::swz(q, b & 127);
    sm90::copy_chunk<VEC>(dst + off, gdst + off, ok ? src + b / 2 : base, ok);
  }
}

template <int WIDTH>
__device__ __forceinline__ void load_krow_any(int vec, uint32_t dst,
                                              uint8_t* gdst, int q, int part,
                                              const bf16* base, int src_row,
                                              int ld, int col0, bool row_ok) {
  switch (vec) {
    case 16: load_krow<16, WIDTH>(dst, gdst, q, part, base, src_row, ld, col0, row_ok); break;
    case 8: load_krow<8, WIDTH>(dst, gdst, q, part, base, src_row, ld, col0, row_ok); break;
    case 4: load_krow<4, WIDTH>(dst, gdst, q, part, base, src_row, ld, col0, row_ok); break;
    default: load_krow<2, WIDTH>(dst, gdst, q, part, base, src_row, ld, col0, row_ok); break;
  }
}

template <int TM, int BN>
__global__ void __launch_bounds__(THREADS, 1)
dkernel_wgmma(const Args p) {
  using T = Tile<TM, BN>;
  constexpr int STAGES = T::STAGES, AHEAD = T::AHEAD;
  const int mt = (p.c_in + TM - 1) / TM;
  const int m0 = (blockIdx.x % mt) * TM, n0 = (blockIdx.x / mt) * BN;
  const int f = blockIdx.y, s = blockIdx.z;
  int begin, end;
  if (!list_range(p, f, s, begin, end)) return;
  const int n_iters = begin < end ? (end - begin + BK - 1) / BK : 0;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  uint8_t* gbase = smem_raw + pad;
  const uint32_t sbase = raw + pad;

  const int tid = threadIdx.x;
  const int q = tid >> 2, part = tid & 3;   // the stage's K-row, its quarter
  const int* vl = p.verts + (size_t)f * p.list_ld;
  const int* rl = p.rows + (size_t)f * p.list_ld;
  const bf16* table = static_cast<const bf16*>(p.table);
  const bf16* g = static_cast<const bf16*>(p.g);

  // list entry of K-row q in stage it: (table row, vertex), -1 past the range
  auto fetch = [&](int it, int& row, int& vert) {
    const int i = begin + it * BK + q;
    row = -1;
    vert = -1;
    if (it < n_iters && i < end) {
      row = rl[i];
      vert = vl[i];
    }
  };
  auto issue = [&](int it, int row, int vert) {
    if (it < n_iters) {
      const uint32_t dst = sbase + (it % STAGES) * T::STAGE;
      uint8_t* gdst = gbase + (it % STAGES) * T::STAGE;
      const bool ok = row >= 0 && row < p.h_in && vert >= 0;
      load_krow_any<TM>(p.vec_a, dst, gdst, q, part, table, row, p.c_in, m0, ok);
      load_krow_any<BN>(p.vec_b, dst + T::A_BYTES, gdst + T::A_BYTES, q, part,
                        g, vert, p.c_out, n0, ok);
    }
    sm90::cp_async_commit();
  };

  const int wg = tid / 128;
  const int wg_m = TM == 128 ? 64 * wg : 0;          // the warpgroup's rows
  const int wg_n = TM == 128 ? 0 : T::WG_N * wg;     // and columns
  const bool live = m0 + wg_m < p.c_in;   // the warpgroup has C_in rows
  float acc[T::R];
#pragma unroll
  for (int i = 0; i < T::R; ++i) acc[i] = 0.f;

  int nrow, nvert;
#pragma unroll 1
  for (int st = 0; st < AHEAD; ++st) {
    fetch(st, nrow, nvert);
    issue(st, nrow, nvert);
  }
  fetch(AHEAD, nrow, nvert);
#pragma unroll 1
  for (int it = 0; it < n_iters; ++it) {
    sm90::cp_async_wait<AHEAD - 1>();
    sm90::fence_proxy_async();
    __syncthreads();   // stage it landed; every wgmma of stage it - 2 is done
    issue(it + AHEAD, nrow, nvert);
    fetch(it + AHEAD + 1, nrow, nvert);
    if (live) {
      // 64-wide atoms of BK * 128 bytes: the warpgroup's rows and columns
      const uint32_t a = sbase + (it % STAGES) * T::STAGE + wg_m * 2 * BK;
      const uint32_t b = sbase + (it % STAGES) * T::STAGE + T::A_BYTES
                         + wg_n * 2 * BK;
      sm90::fence_regs(acc);
      sm90::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        sm90::wgmma_k16<1, 1>(acc, sm90::desc(a + ks * 16 * 128, BK * 128, 1024),
                              sm90::desc(b + ks * 16 * 128, BK * 128, 1024));
      sm90::wgmma_commit();
      sm90::fence_regs(acc);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc);
    }
  }
  sm90::wgmma_wait<0>();
  sm90::fence_regs(acc);
  sm90::cp_async_wait<0>();

  // rows m0 + wg_m + warp*16 + lane/4 (+8), columns n0 + wg_n + 8 j +
  // 2(lane%4) (+1)
  float* out = slab(p, f, s);
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const bool pairs = (p.c_out & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + wg_m + warp * 16 + lane / 4 + 8 * h;
    if (m < p.c_in) {
      float* orow = out + (size_t)m * p.c_out;
#pragma unroll
      for (int j = 0; j < T::WG_N / 8; ++j) {
        const int col = n0 + wg_n + 8 * j + 2 * (lane % 4);
        const float x0 = acc[4 * j + 2 * h], x1 = acc[4 * j + 2 * h + 1];
        if (pairs && col + 1 < p.c_out) {
          *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
        } else {
          if (col < p.c_out) orow[col] = x0;
          if (col + 1 < p.c_out) orow[col + 1] = x1;
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32: exact SIMT products over the same lists
// ---------------------------------------------------------------------------

constexpr int FI = 64;         // C_in rows of the output tile
constexpr int FO = 64;         // C_out columns of the output tile
constexpr int FV = 32;         // list entries per step
constexpr int F_THREADS = 128;

// Each thread an 8 x 4 tile (rows ty + 8 a, columns tx + 16 b), summed over
// the list entries in order.
__global__ void __launch_bounds__(F_THREADS)
dkernel_f32(const Args p) {
  __shared__ float As[FV][FI];
  __shared__ float Gs[FV][FO];
  __shared__ int rows[FV];
  __shared__ int verts[FV];

  const int f = blockIdx.z % p.num_taps, s = blockIdx.z / p.num_taps;
  int begin, end;
  if (!list_range(p, f, s, begin, end)) return;
  const float* table = static_cast<const float*>(p.table);
  const float* g = static_cast<const float*>(p.g);
  const int* vl = p.verts + (size_t)f * p.list_ld;
  const int* rl = p.rows + (size_t)f * p.list_ld;
  const int i0 = blockIdx.x * FI, o0 = blockIdx.y * FO;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[8][4];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int e0 = begin; e0 < end; e0 += FV) {
    __syncthreads();
    for (int i = threadIdx.x; i < FV; i += F_THREADS) {
      const int e = e0 + i;
      int r = e < end ? rl[e] : -1;
      rows[i] = (r >= 0 && r < p.h_in) ? r : -1;
      verts[i] = e < end ? vl[e] : -1;
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < FV * FI; idx += F_THREADS) {
      const int v = idx / FI, i = idx % FI;
      const int r = rows[v], col = i0 + i;
      As[v][i] = (r >= 0 && col < p.c_in) ? table[(size_t)r * p.c_in + col] : 0.f;
    }
    for (int idx = threadIdx.x; idx < FV * FO; idx += F_THREADS) {
      const int v = idx / FO, o = idx % FO;
      const int col = o0 + o;
      Gs[v][o] = (rows[v] >= 0 && verts[v] >= 0 && col < p.c_out)
                     ? g[(size_t)verts[v] * p.c_out + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int v = 0; v < FV; ++v) {
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

  float* out = slab(p, f, s);
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int row = i0 + ty + 8 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = o0 + tx + 16 * b;
      if (row < p.c_in && col < p.c_out) out[(size_t)row * p.c_out + col] = acc[a][b];
    }
  }
}

// out[j] = sum of the slabs tap f wrote (s < ceil(counts[f] / chunk), at
// least one), in chunk order.
__global__ void sum_slabs(const float* __restrict__ partial,
                          const int* __restrict__ counts, int chunk, int splits,
                          size_t per_tap, size_t n, float* __restrict__ out) {
  for (size_t j = (size_t)blockIdx.x * blockDim.x + threadIdx.x; j < n;
       j += (size_t)gridDim.x * blockDim.x) {
    const int f = (int)(j / per_tap);
    const int used = min(splits, max(1, (counts[f] + chunk - 1) / chunk));
    float acc = partial[j];
    for (int s = 1; s < used; ++s) acc = __fadd_rn(acc, partial[(size_t)s * n + j]);
    out[j] = acc;
  }
}

template <int TM, int BN>
int launch_wgmma(const Args& a, cudaStream_t st) {
  using T = Tile<TM, BN>;
  const size_t bytes = 1024 + (size_t)T::STAGES * T::STAGE;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        dkernel_wgmma<TM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  dim3 grid(((a.c_in + TM - 1) / TM) * ((a.c_out + BN - 1) / BN), a.num_taps,
            a.splits);
  dkernel_wgmma<TM, BN><<<grid, THREADS, bytes, st>>>(a);
  return (int)cudaGetLastError();
}

// The output tile (kernels/dkernel.py's vertex_splits mirrors it): 64 x 256
// where C_in <= 64 < 128 < C_out, else 128 x 64 or 128 x 128.
int launch_bf16(const Args& a, cudaStream_t st) {
  if (a.c_in <= 64 && a.c_out > 128) return launch_wgmma<64, 256>(a, st);
  return a.c_out <= 64 ? launch_wgmma<128, 64>(a, st)
                       : launch_wgmma<128, 128>(a, st);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (table and g alike).  The plan's lists
// ``verts`` / ``rows`` are (F, list_ld) int32 and ``counts`` (F,).  Each
// tap's list is cut into ``splits`` chunks of ``chunk`` entries (a multiple
// of 64); with splits > 1 the chunks write ``partial`` (splits, F, C_in,
// C_out) and a second pass sums them into ``out`` (F, C_in, C_out), else
// the blocks write ``out`` directly.  Returns the CUDA error code of the
// launches (0 on success).
int hpl_stencil_dkernel(const void* table, int h_in, int c_in,
                        const void* verts, const void* rows,
                        const void* counts, int num_taps, int list_ld,
                        const void* g, int c_out, int chunk, int splits,
                        void* partial, void* out, int dtype, void* stream) {
  if (num_taps <= 0 || c_in <= 0 || c_out <= 0) return 0;
  if (splits < 1 || chunk < 1 || chunk % 64 != 0 ||
      (splits > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Args a{table, h_in, c_in, static_cast<const int*>(verts),
         static_cast<const int*>(rows), static_cast<const int*>(counts),
         num_taps, list_ld, g, c_out, chunk, splits,
         static_cast<float*>(splits > 1 ? partial : out), 0, 0};
  int rc;
  if (dtype == 1) {
    a.vec_a = sm90::chunk_bytes(table, c_in);
    a.vec_b = sm90::chunk_bytes(g, c_out);
    rc = launch_bf16(a, st);
  } else if (dtype == 0) {
    dim3 grid((c_in + FI - 1) / FI, (c_out + FO - 1) / FO, num_taps * splits);
    dkernel_f32<<<grid, F_THREADS, 0, st>>>(a);
    rc = (int)cudaGetLastError();
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (rc != 0 || splits == 1) return rc;
  const size_t per_tap = (size_t)c_in * c_out, n = per_tap * num_taps;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  sum_slabs<<<blocks, 256, 0, st>>>(static_cast<const float*>(partial),
                                    static_cast<const int*>(counts), chunk,
                                    splits, per_tap, n, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
