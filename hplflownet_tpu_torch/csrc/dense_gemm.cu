// The dense layers: a GEMM with the bias, activation and output cast fused
// into its epilogue.
//
//   out[m, :] = act( x[m, :] @ W + bias )                        (M, N)
//
// x is (M, K) and the weight comes transposed, W^T (N, K), both row-major
// and both bf16 (or both float32); accumulation is float32.  The epilogue
// (bias add, activation: none, ReLU or leaky with jax.nn's rule at 0, and
// the cast to the output dtype) runs in float32 before the only global
// write, as in csrc/stencil_gather_matmul.cu.
//
// Replaces no Pallas kernel: the JAX package leaves this product to XLA's
// dot (hplflownet_tpu/ops/bcl.py:416, models/layers.py:40,
// ops/corr.py:322-354), and XLA fuses the bias, activation and cast into
// it on the TPU.  On the card the port ran it as a float32 GEMM of
// bf16-rounded operands (cuBLAS picks CUDA-core kernels for it with TF32
// off) followed by separate float32 passes for the bias, the activation
// and the cast.  This kernel runs the same "bf16 x bf16 products, float32
// sums" on the tensor cores (a bf16 x bf16 product is exact in float32 and
// wgmma sums in float32) and keeps the float32 intermediates out of device
// memory.
//
// Bound on an H100: operations where N >= 256 (the head's conv2, 98304 x
// 1024 -> 1024, is 2.1e11 FLOP against 0.4 GB: 500 FLOP a byte, above the
// ~295 of bf16's ridge); bytes where N <= 64 (the correlation's corr1,
// h1 x 15 rows of 32 -> 32 channels, 32 FLOP a byte).  The design:
//
// * Tiles.  128 output rows x BN columns.  BN follows N: 128 for N > 64
//   (the operation-bound layers); N rounded up to 8, 32 or 64 for N <= 64
//   (the byte-bound layers, so that no column is computed twice; N = 3
//   pads to 8, the extra columns masked on write).
// * Operands.  Both are K-major: a stage holds 128 rows of x and BN rows of
//   W^T, 64 input channels each, in 128-byte-swizzled tiles
//   (csrc/sm90_pipe.cuh).  The wrapper hands both over with K padded with
//   zero channels to a multiple of 8 (K = 3, the first layer of conv1, to
//   8; K = 36, the shallow model's refine MLPs, to 40), so that a row
//   pitch is a multiple of 16 bytes, as TMA asks, and one loader serves
//   every layer.
// * Loads.  A producer warpgroup (its registers given to the consumers by
//   setmaxnreg) keeps a ring of stages full: one thread moves a stage with
//   two TMA tile loads, which fill what lies past M, N or K with zeros, and
//   a full mbarrier per stage reports them.
// * Products.  Two consumer warpgroups take the block's tiles in turns
//   (ping-pong): each multiplies a whole tile, 128 rows as two m64nBNk16
//   halves (128 float32 accumulators a thread at BN = 128), frees each
//   stage on its empty mbarrier once its wgmma batch is done, and runs its
//   epilogue while the other's wgmma run.  A turn mbarrier per consumer
//   keeps their products in order.
// * Epilogue.  The tile's bias columns are staged in shared memory, the
//   activation is applied by selects (no branch per value), and bf16 rows
//   leave in 16-byte stores: a quad of lanes trades its pairs by shuffles
//   so that a warp writes 8 rows x 64 contiguous bytes.
// * A persistent grid: one block per SM walks the tiles (block b takes
//   tiles b, b + G, ...), so the loads of a tile's first stages are in
//   flight while the previous tile's epilogue runs.
//
// float32 operands (a float32 compute dtype: the float32 reference, data
// parallel's float32 step) take a SIMT path of exact float32 fmas (no
// TF32), the classic register-blocked one: 128 rows x BN columns a block
// (BN 128, 64 or 32 by N), 8 x BN/16 outputs a thread, 16 input channels
// a step through a double-buffered shared-memory tile, the same epilogue.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda.h>            // CUtensorMap and its enums (types only)
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "rank_tile.cuh"     // mbarriers
#include "sm90_pipe.cuh"

namespace {

using bf16 = __nv_bfloat16;

enum Act { ACT_NONE = 0, ACT_RELU = 1, ACT_LEAKY = 2 };

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// The float32 kernel's epilogue (the same rules, by branches).
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

// The epilogue of the wgmma kernels, fixed for a launch: the bias add and
// the activation (jax.nn's rules at 0: ReLU passes x > 0, leaky x >= 0)
// by selects, so that the unrolled epilogue has no branch per value (with
// one, the head's conv2 took an H100 at 700 W 0.48 ms; by selects 0.35).
struct Epi {
  const float* bs;   // the tile's bias columns (shared memory; 0 without)
  bool bias, pass_all, ge, zero_neg;
  float slope;
};

__device__ __forceinline__ float apply(const Epi& e, float x, int c) {
  const float b = __fadd_rn(x, e.bs[c]);
  x = e.bias ? b : x;
  const bool pass = e.pass_all || x > 0.f || (e.ge && x == 0.f);
  const float neg = e.zero_neg ? 0.f : __fmul_rn(e.slope, x);
  return pass ? x : neg;
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

struct Params {
  CUtensorMap tmap_x, tmap_w;   // TMA descriptors (bf16)
  const void* x;                // (M, K)
  const void* wt;               // (N, K)
  int m, n, k;
  int tiles_n, num_tiles;
  const float* bias;            // (N,) or null
  int act;
  float slope;
  void* out;                    // (M, N)
  int out_f32;                  // out is float32, else bf16
};

// ---------------------------------------------------------------------------
// bf16: a ring of stages + wgmma, persistent
// ---------------------------------------------------------------------------

constexpr int BM = 128;               // output rows per tile
constexpr int BK = 64;                // input channels per stage
constexpr int A_BYTES = BM * BK * 2;  // 16 KB
constexpr int WS_THREADS = 384;       // a producer + 2 consumer warpgroups
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may use

template <int BN>
struct Tile {
  static constexpr int B_BYTES = BN * BK * 2;
  static constexpr int STAGE = A_BYTES + B_BYTES;   // a multiple of 1024
  static constexpr int STAGES = BN == 128 ? 6 : 8;
  static constexpr int R = BN / 2;                  // accumulators per thread
  // the ring, a full and an empty mbarrier per stage and a turn mbarrier
  // per consumer, each consumer warpgroup's copy of the tile's bias
  static constexpr size_t BARS = (size_t)STAGES * STAGE;
  static constexpr size_t BIAS = BARS + 16 * STAGES + 16;
  static constexpr size_t SMEM = 1024 + BIAS + 2 * BN * 4;
  static_assert(SMEM <= SMEM_MAX, "the ring must fit shared memory");
};

// The block's g-th stage lies in tile blockIdx.x + (g / kc) * gridDim.x,
// whose first row and column are row0 and col0.
template <int BN>
__device__ __forceinline__ void tile_of(const Params& p, int kc, int g,
                                        int& row0, int& col0) {
  const int t = (int)blockIdx.x + (g / kc) * (int)gridDim.x;
  row0 = (t / p.tiles_n) * BM;
  col0 = (t % p.tiles_n) * BN;
}

// A warpgroup's four k16 steps over a stage's 128 rows, two halves of 64
// with one B, committed as one batch.  (All four run, zeros past K
// included: a wgmma under a branch makes ptxas wait on every batch before
// the accumulators are touched.)
template <int BN>
__device__ __forceinline__ void mma_stage2(float (&acc0)[BN / 2],
                                           float (&acc1)[BN / 2], uint32_t a,
                                           uint32_t b) {
  sm90::fence_regs(acc0);
  sm90::fence_regs(acc1);
  sm90::wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < BK / 16; ++ks) {
    const uint64_t db = sm90::desc(b + ks * 32, 16, 1024);
    sm90::wgmma_k16<0, 0>(acc0, sm90::desc(a + ks * 32, 16, 1024), db);
    sm90::wgmma_k16<0, 0>(acc1, sm90::desc(a + 64 * 128 + ks * 32, 16, 1024), db);
  }
  sm90::wgmma_commit();
  sm90::fence_regs(acc0);
  sm90::fence_regs(acc1);
}

// One warpgroup's 64 x BN accumulators through the epilogue to rows
// row_base + warp*16 + lane/4 (+8), columns col0 + 8q + 2(lane%4) (+1).
template <int BN, typename TOut>
__device__ __forceinline__ void store_rows(const float (&acc)[BN / 2],
                                           const Params& p, const Epi& e,
                                           int row_base, int col0) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  TOut* out = static_cast<TOut*>(p.out);
  const bool pairs = (p.n & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + warp * 16 + lane / 4 + 8 * h;
    if (row < p.m) {
      TOut* orow = out + (size_t)row * p.n;
#pragma unroll
      for (int q = 0; q < BN / 8; ++q) {
        const int col = col0 + 8 * q + 2 * (lane % 4);
        const float x0 = acc[4 * q + 2 * h], x1 = acc[4 * q + 2 * h + 1];
        if (pairs && col + 1 < p.n) {
          store2(orow + col, apply(e, x0, col - col0),
                 apply(e, x1, col + 1 - col0));
        } else {
          if (col < p.n)
            orow[col] = from_f32<TOut>(apply(e, x0, col - col0));
          if (col + 1 < p.n)
            orow[col + 1] = from_f32<TOut>(apply(e, x1, col + 1 - col0));
        }
      }
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// w[i] of the four lanes of a quad -> lane j's r[k] = lane k's w[j]: a 4 x 4
// transpose of 32-bit words by shuffles (indices by selects, not memory).
__device__ __forceinline__ void quad_transpose(const uint32_t (&w)[4],
                                               uint32_t (&r)[4], int j) {
#pragma unroll
  for (int k = 0; k < 4; ++k) r[k] = w[k];   // r[j] = w[j] holds; the rest
#pragma unroll                               // are overwritten below
  for (int s = 1; s < 4; ++s) {
    const int t = j ^ s;
    const uint32_t send = t == 0 ? w[0] : t == 1 ? w[1] : t == 2 ? w[2] : w[3];
    const uint32_t got = __shfl_xor_sync(0xffffffffu, send, s);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (k == t) r[k] = got;
  }
}

// bf16 rows in 16-byte stores (N a multiple of 8, BN of 32 or more): per
// 4 column groups a quad trades its pairs so that each lane holds one
// group's 8 columns; a warp then writes 8 rows x 64 contiguous bytes, whole
// 32-byte sectors (the pairs alone write half sectors, 4 bytes a lane).
template <int BN>
__device__ __forceinline__ void store_rows_v16(const float (&acc)[BN / 2],
                                               const Params& p, const Epi& e,
                                               int row_base, int col0) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int j = lane % 4;
  bf16* out = static_cast<bf16*>(p.out);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row_base + warp * 16 + lane / 4 + 8 * h;
    bf16* orow = out + (size_t)row * p.n;
#pragma unroll
    for (int q0 = 0; q0 < BN / 8; q0 += 4) {
      uint32_t w[4], r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + i, c = 8 * q + 2 * j;
        w[i] = pack_bf16x2(apply(e, acc[4 * q + 2 * h], c),
                           apply(e, acc[4 * q + 2 * h + 1], c + 1));
      }
      quad_transpose(w, r, j);
      const int col = col0 + 8 * (q0 + j);
      if (row < p.m && col < p.n)
        *reinterpret_cast<uint4*>(orow + col) = make_uint4(r[0], r[1], r[2], r[3]);
    }
  }
}

// Barrier of the 128 threads of consumer warpgroup ``wg`` (0 or 1).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

// The epilogue of a tile: its bias columns (zeros without a bias) into
// warpgroup ``wg``'s slice ``bs`` of shared memory.  (Read from global
// memory in the unrolled epilogue, one load before each use, the head's
// conv2 took an H100 at 700 W 0.80 ms; from shared memory 0.51.)
template <int BN>
__device__ __forceinline__ Epi stage_bias(const Params& p, float* bs, int wg,
                                          int col0) {
  wg_sync(wg);                        // the last tile's epilogue has read bs
  for (int c = threadIdx.x % 128; c < BN; c += 128)
    bs[c] = p.bias != nullptr && col0 + c < p.n ? p.bias[col0 + c] : 0.f;
  wg_sync(wg);
  return Epi{bs, p.bias != nullptr, p.act == ACT_NONE, p.act == ACT_LEAKY,
             p.act == ACT_RELU, p.slope};
}

// The epilogue of 64 rows of a tile, in the output's dtype.
template <int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[BN / 2],
                                           const Params& p, const Epi& e,
                                           int row_base, int col0) {
  if (p.out_f32) {
    store_rows<BN, float>(acc, p, e, row_base, col0);
    return;
  }
  if constexpr (BN >= 32) {
    if (p.n % 8 == 0) {
      store_rows_v16<BN>(acc, p, e, row_base, col0);
      return;
    }
  }
  store_rows<BN, bf16>(acc, p, e, row_base, col0);
}

__device__ __forceinline__ void expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(sm90::smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(sm90::smem_u32(bar)) : "memory");
}

// One TMA tile load: the box at (c0 channels, c1 rows) of ``tmap`` into
// shared ``dst``, completing on ``bar``.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* tmap,
                                         int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(tmap)),
         "r"(sm90::smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int BN>
__global__ void __launch_bounds__(WS_THREADS, 1)
dense_gemm_wgmma_kernel(const __grid_constant__ Params p) {
  using T = Tile<BN>;
  constexpr int STAGES = T::STAGES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
  const uint32_t sbase = raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_raw + pad + T::BARS);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;
  float* bias_s = reinterpret_cast<float*>(smem_raw + pad + T::BIAS);

  const int kc = (p.k + BK - 1) / BK;
  const int mine = (int)blockIdx.x < p.num_tiles
                       ? (p.num_tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                       : 0;
  const int total = mine * kc;        // stages this block walks
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      rank_tile::mbar_init(&full[s], 1);
      rank_tile::mbar_init(&empty[s], 128);   // the consumer's threads
    }
    rank_tile::mbar_init(&turn[0], 128);
    rank_tile::mbar_init(&turn[1], 128);
    rank_tile::mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {                      // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int g = 0; g < total; ++g) {
        const int slot = g % STAGES, use = g / STAGES;
        if (use > 0) rank_tile::mbar_wait(&empty[slot], (use - 1) & 1);
        int row0, col0;
        tile_of<BN>(p, kc, g, row0, col0);
        const uint32_t dst = sbase + slot * T::STAGE;
        expect_tx(&full[slot], T::STAGE);
        tma_load(dst, &p.tmap_x, (g % kc) * BK, row0, &full[slot]);
        tma_load(dst + A_BYTES, &p.tmap_w, (g % kc) * BK, col0, &full[slot]);
      }
    }
    return;
  }

  // The consumers take turns: consumer c multiplies the block's tiles c,
  // c + 2, ..., so that one's epilogue runs while the other's wgmma do.
  // Tile j's products start once the other consumer has waited on every
  // stage of tile j - 1 (turn[c]): a consumer then waits on a stage at
  // most one use of its slot ahead, which the mbarrier's parity tells
  // apart.
  setmaxnreg_inc<232>();
  const int c = wg - 1;
  float acc0[T::R], acc1[T::R];       // rows 0-63 and 64-127 of the tile
#pragma unroll 1
  for (int tile = c; tile < mine; tile += 2) {
#pragma unroll
    for (int i = 0; i < T::R; ++i) acc0[i] = acc1[i] = 0.f;
    if (tile > 0) rank_tile::mbar_wait(&turn[c], ((tile - 1) / 2) & 1);
    int g = tile * kc;
    // one loop per tile, the epilogue after it: a wgmma batch in flight
    // across a branch that touches the accumulators makes ptxas wait on it
#pragma unroll 1
    for (int kstep = 0; kstep < kc; ++kstep, ++g) {
      const int slot = g % STAGES;
      rank_tile::mbar_wait(&full[slot], (g / STAGES) & 1);
      const uint32_t s = sbase + slot * T::STAGE;
      mma_stage2<BN>(acc0, acc1, s, s + A_BYTES);
      sm90::wgmma_wait<1>();
      sm90::fence_regs(acc0);
      sm90::fence_regs(acc1);
      if (kstep > 0) arrive(&empty[(g - 1) % STAGES]);   // its batch is done
    }
    arrive(&turn[1 - c]);
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc0);
    sm90::fence_regs(acc1);
    arrive(&empty[(g - 1) % STAGES]);
    int row0, col0;
    tile_of<BN>(p, kc, g - 1, row0, col0);
    const Epi e = stage_bias<BN>(p, bias_s + c * BN, c, col0);
    store_tile<BN>(acc0, p, e, row0, col0);
    store_tile<BN>(acc1, p, e, row0 + 64, col0);
  }
}

// ---------------------------------------------------------------------------
// float32: exact SIMT products, register-blocked
// ---------------------------------------------------------------------------

constexpr int FM = 128;         // output rows per block
constexpr int FK = 16;          // input channels per step
constexpr int F_THREADS = 256;  // 16 x 16 threads

// ``NV`` consecutive floats (16-, 8- or 4-byte aligned) in one access.
template <int NV>
__device__ __forceinline__ void ld(float* dst, const float* src) {
  if constexpr (NV % 4 == 0) {
#pragma unroll
    for (int i = 0; i < NV; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x; dst[i + 1] = v.y; dst[i + 2] = v.z; dst[i + 3] = v.w;
    }
  } else if constexpr (NV == 2) {
    const float2 v = *reinterpret_cast<const float2*>(src);
    dst[0] = v.x; dst[1] = v.y;
  } else {
    dst[0] = *src;
  }
}

// A block's 128 x BN outputs: thread (tx, ty) owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, and BN/16 columns in runs of GN at tx*GN + 16*GN*j,
// so that its operands leave shared memory in float4 (float2) loads with
// no bank conflict.  A step's 128 x 16 and BN x 16 operands come in whole
// 16- or 8-byte loads (K a multiple of 8 and 16-byte-aligned bases, so a
// thread's run of channels lies wholly inside or past K) and are stored
// transposed, channel-major, a warp's 32 consecutive rows per store (no
// conflict); the next step's are read into registers while this step's
// products run.  Two blocks an SM.  Each output sums its K products in
// order by fmaf.
template <int BN>
__global__ void __launch_bounds__(F_THREADS, 2)
dense_gemm_f32_kernel(const __grid_constant__ Params p) {
  constexpr int CN = BN / 16;                 // columns per thread
  constexpr int GN = CN < 4 ? CN : 4;         // ... in runs of GN
  constexpr int VA = FM * FK / F_THREADS;     // x channels a thread loads a step
  constexpr int VB = BN * FK / F_THREADS;     // W^T channels
  __shared__ __align__(16) float As[2][FK][FM + 4];
  __shared__ __align__(16) float Bs[2][FK][BN + 4];
  const float* x = static_cast<const float*>(p.x);
  const float* wt = static_cast<const float*>(p.wt);
  const int row0 = blockIdx.x * FM, col0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int ar = tid % FM, ak = (tid / FM) * VA;
  const int br = tid % BN, bk = (tid / BN) * VB;
  const bool a_in = row0 + ar < p.m, b_in = col0 + br < p.n;
  const float* xa = x + (size_t)(a_in ? row0 + ar : 0) * p.k + ak;
  const float* wb = wt + (size_t)(b_in ? col0 + br : 0) * p.k + bk;
  float ra[VA], rb[VB];
  auto load = [&](int k0) {
    if (a_in && k0 + ak < p.k) {
      ld<VA>(ra, xa + k0);
    } else {
#pragma unroll
      for (int v = 0; v < VA; ++v) ra[v] = 0.f;
    }
    if (b_in && k0 + bk < p.k) {
      ld<VB>(rb, wb + k0);
    } else {
#pragma unroll
      for (int v = 0; v < VB; ++v) rb[v] = 0.f;
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int v = 0; v < VA; ++v) As[buf][ak + v][ar] = ra[v];
#pragma unroll
    for (int v = 0; v < VB; ++v) Bs[buf][bk + v][br] = rb[v];
  };

  float acc[8][CN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < CN; ++j) acc[i][j] = 0.f;

  load(0);
  stash(0);
  __syncthreads();
  int buf = 0;
#pragma unroll 1
  for (int k0 = 0; k0 < p.k; k0 += FK, buf ^= 1) {
    const bool more = k0 + FK < p.k;
    if (more) load(k0 + FK);
#pragma unroll
    for (int kk = 0; kk < FK; ++kk) {
      float a[8], b[CN];
      ld<4>(a, &As[buf][kk][ty * 4]);
      ld<4>(a + 4, &As[buf][kk][64 + ty * 4]);
#pragma unroll
      for (int j = 0; j < CN; j += GN) ld<GN>(b + j, &Bs[buf][kk][j * 16 + tx * GN]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) stash(buf ^ 1);   // the buffer every thread finished reading
    __syncthreads();            // in the last step
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i / 4) * 64 + ty * 4 + i % 4;
    if (row >= p.m) continue;
#pragma unroll
    for (int j = 0; j < CN; ++j) {
      const int col = col0 + (j / GN) * 16 * GN + tx * GN + j % GN;
      if (col < p.n) {
        const float v = epilogue(acc[i][j], p.bias, col, p.act, p.slope);
        const size_t o = (size_t)row * p.n + col;
        if (p.out_f32)
          static_cast<float*>(p.out)[o] = v;
        else
          static_cast<bf16*>(p.out)[o] = from_f32<bf16>(v);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no libcuda link).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &f, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess
        || q != cudaDriverEntryPointSuccess)
      f = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault) != cudaSuccess)
      f = nullptr;
#endif
    fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// A (rows, k) row-major bf16 matrix as boxes of 64 channels x box_rows
// rows, 128-byte swizzle, zeros past the edges.
bool make_tmap(CUtensorMap* map, const void* base, int rows, int k,
               int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)k, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)k * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int num_sms() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

// Let ``kernel`` use ``bytes`` of dynamic shared memory (once per kernel).
template <typename K>
int allow_smem(K kernel, size_t bytes, bool& allowed) {
  if (allowed) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) allowed = true;
  return (int)e;
}

// Tiles of BN columns; the grid: one block per SM, or one per tile.
template <int BN>
int tiles(Params& p) {
  p.tiles_n = (p.n + BN - 1) / BN;
  p.num_tiles = ((p.m + BM - 1) / BM) * p.tiles_n;
  return p.num_tiles < num_sms() ? p.num_tiles : num_sms();
}

template <int BN>
int launch_tma(Params& p, cudaStream_t s) {
  static bool allowed = false;
  const int grid = tiles<BN>(p);
  if (!make_tmap(&p.tmap_x, p.x, p.m, p.k, BM) ||
      !make_tmap(&p.tmap_w, p.wt, p.n, p.k, BN))
    return (int)cudaErrorInvalidValue;
  if (int e = allow_smem(dense_gemm_wgmma_kernel<BN>, Tile<BN>::SMEM, allowed))
    return e;
  dense_gemm_wgmma_kernel<BN><<<grid, WS_THREADS, Tile<BN>::SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

// The tile width (see the note at the top).  K must be a multiple of 8
// and both bases 16-byte aligned (the wrapper pads and copies so).
int launch_bf16(Params& p, cudaStream_t s) {
  const uintptr_t ax = reinterpret_cast<uintptr_t>(p.x);
  const uintptr_t aw = reinterpret_cast<uintptr_t>(p.wt);
  if (p.k % 8 != 0 || ax % 16 != 0 || aw % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.n <= 8) return launch_tma<8>(p, s);
  if (p.n <= 32) return launch_tma<32>(p, s);
  if (p.n <= 64) return launch_tma<64>(p, s);
  return launch_tma<128>(p, s);
}

template <int BN>
int launch_f32_bn(const Params& p, cudaStream_t s) {
  dim3 grid((p.m + FM - 1) / FM, (p.n + BN - 1) / BN);
  dense_gemm_f32_kernel<BN><<<grid, F_THREADS, 0, s>>>(p);
  return (int)cudaGetLastError();
}

// K a multiple of 8 and 16-byte-aligned bases, as for bf16.
int launch_f32(const Params& p, cudaStream_t s) {
  if (p.k % 8 != 0 || reinterpret_cast<uintptr_t>(p.x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.wt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (p.n <= 32) return launch_f32_bn<32>(p, s);
  if (p.n <= 64) return launch_f32_bn<64>(p, s);
  return launch_f32_bn<128>(p, s);
}

}  // namespace

extern "C" {

// out (M, N) = act(x (M, K) @ wt (N, K)^T + bias).  dtype codes: 0 =
// float32, 1 = bfloat16 (x and wt share in_dtype; K must be a multiple of
// 8 and both bases 16-byte aligned).  act: 0 none, 1 ReLU,
// 2 leaky (negative slope ``slope``).  ``bias`` (N,) float32 may be null.
// Returns the CUDA error code of the launch (0 on success).
int hpl_dense_gemm(const void* x, int m, int k, const void* wt, int n,
                   const void* bias, int act, float slope, void* out,
                   int in_dtype, int out_dtype, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  if (k <= 0 || in_dtype < 0 || in_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  Params p{};
  p.x = x;
  p.wt = wt;
  p.m = m;
  p.n = n;
  p.k = k;
  p.bias = static_cast<const float*>(bias);
  p.act = act;
  p.slope = slope;
  p.out = out;
  p.out_f32 = out_dtype == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return in_dtype == 1 ? launch_bf16(p, s) : launch_f32(p, s);
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
