// Per-128-entry-block partial sums of a sorted stream by local run rank.
//
//   out[b*128 + k, c] = sum_{j in block b, lrank_j == k} round(g[j, c] * w_j)
//   out[b*128 + k, C] = sum_{j in block b, lrank_j == k} w_j      (density)
//   with lrank_j = meta[j] & 0xFFFF, w_j = g[j, C + (meta[j] >> 16)]
//
// or, with R = 0, the rows summed unweighted.  Block b holds entries
// [128 b, 128 b + 128); the output has ceil(M / 128) * 128 rows, and rows of
// unused ranks are exact zeros.  A local rank >= 128 is dropped; a lane
// outside [0, R) selects weight 0, so its entry adds nothing.  Each product
// is rounded to the stream's dtype before the float32 sum; the sums are
// written in float32 or rounded once to bfloat16.
//
// Replaces: tools/rank_partial_lab.py variant (:110; body _v2_kernel :74,
// pallas_call :121), the TPU lab's variants of blocked_rank_partial (one
// one-hot MXU dot per 128-entry block, bo blocks per program, optional
// bf16 output).  The TPU variant's vec_prepass (weighted rows of a whole
// program block computed before the rank dots) has no counterpart: the
// products are formed as they are summed.
//
// Design (csrc/rank_tile.cuh holds the shared pieces).  A CTA of 256
// threads takes bo consecutive 128-entry blocks (bo is the launch's
// blocks-per-CTA knob, the lab's sweep) and, of each, one part of the 128
// local ranks (1, 2, ... 16 parts) in one slab of output columns (whole
// rows up to 96 columns, else 96- or 32-column slabs).  The split is
// chosen per launch: the fewest parts that give the grid two CTAs per SM.
// Four CTAs stay resident on an SM (launch bounds, 56 KB of shared memory
// each), so one wave holds the grid at bo 8 to 32 and the CTAs of an SM
// hide each other's waits; a deeper ring that left room for three lost
// more than it gained.  A part's CTA does not redo its siblings' work: it
// stages only the rows from the first to the last entry of its ranks (a
// sorted block keeps them together) and sums only its ranks.  Block k + 1's
// rows load while block k is summed: a ring of NS = 2 shared-memory stages
// (one bulk copy tracked by an mbarrier where whole rows have a pitch that
// is a multiple of 16 bytes, else cp.async row by row); the metas come
// into registers NS blocks ahead, so the part's row range is known when
// the copy is issued.
// Per block:
//   1. one thread per entry turns its meta into a local rank (or -1: not
//      the part's) and its selected weight, once, and keeps each of the
//      part's ranks' first and last entry and count with integer
//      min/max/add in shared memory (two sets, alternating, so the next
//      block's are reset while this one's are read); the entries NS - 1
//      blocks on give their part's row range;
//   2. warp w owns the part's local ranks w, w + 8, ... and lane l columns
//      l + 32 q: it adds each rank's entries in stream order
//      (rank_tile::add_entries, as kernel 5) into a tile of float sums in
//      shared memory, zeros for unused ranks;
//   3. the part's rows of the block go out in 16-byte stores, rounded to
//      the output dtype.
// No float atomics, so a rerun matches bit for bit.
//
// Bound on an H100: bytes.  The floor is the stream (M * (C + R) elements
// and M metas) in and M_pad * (C + 1) sums out at 3.35 TB/s; the output,
// zero rows included, is the larger part.
//
// Build: nvcc -gencode=arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (see hplflownet_tpu_torch/kernels/_build.py).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <stdint.h>

#include "rank_tile.cuh"

namespace {

using namespace rank_tile;

constexpr int THREADS = 256;          // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int BLOCK = 128;            // stream entries (and ranks) per block
constexpr int EWARPS = BLOCK / 32;    // warps holding a block's entries
constexpr int NS = 2;                 // ring depth: NS - 1 blocks in flight
constexpr int MAX_PARTS = 16;         // rank parts: 128 down to 8 ranks a CTA
constexpr int CTAS_PER_SM = 4;        // resident, by registers and shared memory
constexpr int SMEM_BUDGET = 56 * 1024;
static_assert(BLOCK <= THREADS, "a thread per entry of a block");
static_assert(BLOCK / MAX_PARTS % WARPS == 0, "whole ranks per warp");

struct Layout {
  RowLayout row;  // how staged rows sit (row.sw = 32 NQ: the slab width)
  int nslab;      // slabs of the output row (grid.y)
  int parts;      // CTAs that share a block's ranks, BLOCK / parts each
  int bars;       // NS stage barriers (bulk copies)
  int keys;       // BLOCK local ranks (-1: none) of the block summed
  int ws;         // BLOCK weights of the block summed
  int bounds;     // first[2][BLOCK], last[2][BLOCK], count[2][BLOCK]
  int range;      // [NS][EWARPS][2]: each entry warp's part rows, by slot
  int tile;       // BLOCK / parts x slab float sums
  int total;
};

template <typename T, typename O, bool WEIGHTED, int NQ>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
rank_partial_kernel(const T* __restrict__ g, int m, int cr, int c,
                    const int* __restrict__ meta, int nblocks, int bo,
                    int with_weights, O* __restrict__ out, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* s_key = reinterpret_cast<int*>(smem + L.keys);
  float* s_w = reinterpret_cast<float*>(smem + L.ws);
  int* s_first = reinterpret_cast<int*>(smem + L.bounds);   // [2][BLOCK]
  int* s_last = s_first + 2 * BLOCK;                         // [2][BLOCK]
  int* s_count = s_last + 2 * BLOCK;                         // [2][BLOCK]
  int* s_range = reinterpret_cast<int*>(smem + L.range);
  float* tile = reinterpret_cast<float*>(smem + L.tile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  const RowLayout& R = L.row;
  const int rp = BLOCK / L.parts;                    // ranks of the part
  const int rbase = (blockIdx.x % L.parts) * rp;     // its first local rank
  const int b0 = blockIdx.x / L.parts * bo;
  const int nb = min(bo, nblocks - b0);
  const int o0 = blockIdx.y * R.sw;
  const int sw = min(o0 + R.sw, c_out) - o0;         // slab width
  const int nv = max(0, min(o0 + R.sw, c) - o0);     // value columns
  const int vbase = R.whole ? o0 : 0;                // slab column 0 in a row

  // block j's meta for entry tid (threads < BLOCK); none: a rank past it
  auto load_meta = [&](int j) -> int {
    int mj = 0xFFFF;
    if (j < nb && tid < BLOCK) {
      const int js = (b0 + j) * BLOCK;
      if (tid < m - js) mj = __ldg(meta + js + tid);
    }
    return mj;
  };
  // an entry the part sums: its rank is the part's, its lane selects a weight
  auto in_part = [&](int mj) -> bool {
    const int k = mj & 0xFFFF;
    const int ln = mj >> 16;
    return k >= rbase && k < rbase + rp && (!WEIGHTED || (ln >= 0 && ln < r));
  };
  // each entry warp's first and last + 1 entry of the part in block j
  auto note_range = [&](int mj, int j) {
    if (tid < BLOCK) {
      const unsigned hits = __ballot_sync(0xffffffffu, in_part(mj));
      if (lane == 0) {
        int* rg = s_range + ((j % NS) * EWARPS + warp) * 2;
        rg[0] = hits ? warp * 32 + __ffs(hits) - 1 : BLOCK;
        rg[1] = hits ? warp * 32 + 32 - __clz(hits) : 0;
      }
    }
  };
  // copy block j's rows of the part (noted, then a barrier) into its slot
  auto issue = [&](int j) {
    if (j < nb) {
      const int* rg = s_range + (j % NS) * EWARPS * 2;
      int lo = BLOCK, hi = 0;
#pragma unroll
      for (int w = 0; w < EWARPS; ++w) {
        lo = min(lo, rg[2 * w]);
        hi = max(hi, rg[2 * w + 1]);
      }
      if (hi < lo) lo = hi = 0;      // none of the part's: an empty copy
      const int slot = j % NS;
      stage_rows<T, THREADS>(ring + (slot * BLOCK + lo) * R.spitch, g, cr, c,
                             (b0 + j) * BLOCK + lo, hi - lo, o0, R,
                             &s_bar[slot]);
    }
    cp_async_commit();
  };

  if (tid < BLOCK) {
    s_first[tid] = INT_MAX;
    s_last[tid] = -1;
    s_count[tid] = 0;
  }
  ring_init<NS>(s_bar);
  int mq[NS];                         // metas of blocks i .. i + NS - 1
#pragma unroll
  for (int j = 0; j < NS; ++j) mq[j] = load_meta(j);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) note_range(mq[j], j);
  __syncthreads();
  for (int j = 0; j < NS - 1; ++j) issue(j);
  for (int i = 0; i < nb; ++i) {
    ring_wait<NS>(R, s_bar, i);      // block i landed; block i - 1 stored
    const int mj = shift_in(mq, load_meta(i + NS));
    const int set = i & 1;
    const int js = (b0 + i) * BLOCK;
    const unsigned char* rows = ring + (i % NS) * BLOCK * R.spitch;
    int* first = s_first + set * BLOCK;
    int* last = s_last + set * BLOCK;
    int* count = s_count + set * BLOCK;
    note_range(mq[NS - 2], i + NS - 1);
    // 1. each entry's local rank and weight, once; the part's ranks' first
    //    and last entry and count
    if (tid < BLOCK) {
      s_first[(set ^ 1) * BLOCK + tid] = INT_MAX;    // the next block's set
      s_last[(set ^ 1) * BLOCK + tid] = -1;
      s_count[(set ^ 1) * BLOCK + tid] = 0;
      const int k = mj & 0xFFFF;
      const bool hit = in_part(mj);
      float w = 1.f;
      if (WEIGHTED && hit)
        w = to_f32(reinterpret_cast<const T*>(rows + tid * R.spitch + R.woff)[mj >> 16]);
      s_key[tid] = hit ? k : -1;
      s_w[tid] = w;
      note_entry(first, last, count, hit, k, tid);
    }
    __syncthreads();
    issue(i + NS - 1);               // into block i - 1's slot
    // 2. each owned rank's sums in stream order into the tile
#pragma unroll 2
    for (int kk = 0; kk < rp / WARPS; ++kk) {
      const int k = rbase + warp + WARPS * kk;
      const int a = first[k], b = last[k] + 1;     // empty: a > b
      float acc[NQ];
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[q] = 0.f;
      add_entries<T, WEIGHTED, NQ>(acc, rows, R.spitch, vbase, nv, s_w, s_key,
                                   k, b - a == count[k], a, b);
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int col = lane + 32 * q;
        if (col < sw) tile[(k - rbase) * sw + col] = acc[q];
      }
    }
    __syncthreads();
    // 3. the part's rows of the block out in 16-byte stores
    store_tile<O, THREADS>(out + (long long)(js + rbase) * c_out + o0, c_out,
                           tile, rp, sw);
  }
  cp_async_wait<0>();
}

Layout layout(int c_out, int c, int r, int es, int nq, int parts,
              bool aligned16) {
  Layout L;
  L.row = row_layout(c_out, c, r, es, 32 * nq, aligned16);
  L.nslab = (c_out + L.row.sw - 1) / L.row.sw;
  L.parts = parts;
  const int sw = c_out < L.row.sw ? c_out : L.row.sw;
  L.bars = NS * BLOCK * L.row.spitch;
  L.keys = L.bars + round16(NS * 8);
  L.ws = L.keys + BLOCK * 4;
  L.bounds = L.ws + BLOCK * 4;
  L.range = L.bounds + 6 * BLOCK * 4;
  L.tile = L.range + round16(NS * EWARPS * 2 * 4);
  L.total = L.tile + BLOCK / parts * sw * 4;
  return L;
}

// The split of each CTA's bo blocks: slabs of 96 columns (whole rows up to
// 96), else of 32, each with the fewest rank parts whose grid of
// ceil(blocks / bo) x parts x slabs CTAs has two per SM within the
// shared-memory budget; else 32-column slabs in MAX_PARTS parts (a stream
// too short to fill the card).
Layout choose(int c_out, int c, int r, int es, bool aligned16, int groups,
              int sms) {
  for (int nq = c_out > 32 ? 3 : 1; nq >= 1; nq -= 2)
    for (int parts = 1; parts <= MAX_PARTS; parts *= 2) {
      const Layout L = layout(c_out, c, r, es, nq, parts, aligned16);
      if (L.total <= SMEM_BUDGET &&
          (long long)groups * parts * L.nslab >= 2LL * sms)
        return L;
    }
  return layout(c_out, c, r, es, 1, MAX_PARTS, aligned16);
}

template <typename T, typename O, bool WEIGHTED, int NQ>
cudaError_t launch(const Layout& L, const void* g, int m, int cr, int c,
                   const int* meta, int nblocks, int bo, int with_weights,
                   void* out, cudaStream_t s) {
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(rank_partial_kernel<T, O, WEIGHTED, NQ>,
                                   L.total, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid((nblocks + bo - 1) / bo * L.parts, L.nslab);
  rank_partial_kernel<T, O, WEIGHTED, NQ><<<grid, THREADS, L.total, s>>>(
      static_cast<const T*>(g), m, cr, c, meta, nblocks, bo, with_weights,
      static_cast<O*>(out), L);
  return cudaGetLastError();
}

// One build per slab width (3 or 1 column groups of 32): the count as a
// template keeps a warp's accumulators in registers.
template <typename T, typename O, bool WEIGHTED>
cudaError_t launch_nq(const void* g, int m, int cr, int c, const int* meta,
                      int nblocks, int bo, int with_weights, void* out,
                      cudaStream_t s) {
  int sms = 0;
  const cudaError_t e = sm_count(&sms);
  if (e != cudaSuccess) return e;
  const Layout L = choose(c + (with_weights ? 1 : 0), c, cr - c, (int)sizeof(T),
                          reinterpret_cast<uintptr_t>(g) % 16 == 0,
                          (nblocks + bo - 1) / bo, sms);
  if (L.row.sw == 96)
    return launch<T, O, WEIGHTED, 3>(L, g, m, cr, c, meta, nblocks, bo, with_weights, out, s);
  return launch<T, O, WEIGHTED, 1>(L, g, m, cr, c, meta, nblocks, bo, with_weights, out, s);
}

template <typename T, typename O>
cudaError_t launch_w(const void* g, int m, int cr, int c, const int* meta,
                     int nblocks, int bo, int with_weights, void* out,
                     cudaStream_t s) {
  if (cr > c)
    return launch_nq<T, O, true>(g, m, cr, c, meta, nblocks, bo, with_weights, out, s);
  return launch_nq<T, O, false>(g, m, cr, c, meta, nblocks, bo, 0, out, s);
}

}  // namespace

extern "C" {

// dtype, out_dtype: 0 = float32, 1 = bfloat16.  g: (m, cr) row-major, cr =
// c + r (r = 0: plain rows, no density); meta: (m,) int32, lrank | lane <<
// 16; out: (ceil(m / 128) * 128, c + with_weights).  bo: 128-entry blocks
// per CTA (>= 1).  Returns the CUDA error code of the launch (0 on success).
int hpl_rank_partial(const void* g, int m, int cr, int c, const void* meta,
                     int bo, int with_weights, void* out, int dtype,
                     int out_dtype, void* stream) {
  const int nblocks = (m + BLOCK - 1) / BLOCK;
  if (nblocks <= 0) return 0;
  if (c <= 0 || cr < c || bo < 1 || (cr == c && with_weights))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mp = static_cast<const int*>(meta);
  cudaError_t e;
  if (dtype == 1 && out_dtype == 0)
    e = launch_w<bf16, float>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 1 && out_dtype == 1)
    e = launch_w<bf16, bf16>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 0 && out_dtype == 0)
    e = launch_w<float, float>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else if (dtype == 0 && out_dtype == 1)
    e = launch_w<float, bf16>(g, m, cr, c, mp, nblocks, bo, with_weights, out, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
