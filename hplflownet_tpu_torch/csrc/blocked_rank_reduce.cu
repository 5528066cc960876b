// Fused rank-mode reduction: per-rank weighted sums of a sorted stream whose
// entries carry their global rank.
//
//   out[t, c] = sum_{j in range(t / 128), rank_j == t} round(g[j, c] * w_j)
//   out[t, C] = sum_{j in range(t / 128), rank_j == t} w_j      (density)
//   with rank_j = meta[j] >> 2, w_j = g[j, C + (meta[j] & 3)]     (R >= 1)
//
// or, with R = 0, rank_j = meta[j] and the rows summed unweighted.  Block b
// of 128 ranks reads the stream range [start_rows[b], start_rows[b + 1])
// (the last block up to M), which in a rank-mode plan holds every entry of
// its ranks.  Ranks with no entry get exact zeros; entries whose rank lies
// outside their block (the padding's sentinel rank 1 << 28, say) and
// weighted entries whose lane is >= R add nothing.  In bf16 mode each
// product is rounded to bf16 before the float32 sum, as
// hplflownet_tpu/ops/segment.py _wr_forward does.
//
// Replaces: hplflownet_tpu/ops/pallas_stencil.py blocked_rank_reduce (:648;
// body _rank_reduce_kernel :580, pallas_call :724).  The TPU kernel streams
// two fixed windows of the sorted stream per 1024-rank super-block and folds
// each 128-entry chunk with a one-hot MXU dot at a dynamic offset; entries
// past the windows are dropped and counted.  Hopper needs no windows.
//
// Design (csrc/rank_tile.cuh holds the shared pieces).  A CTA of 256
// threads owns a tile of 32 ranks (a quarter of a 128-rank block), so the
// grid has 4 x ceil(T / 128) CTAs: 404 at the scale-2 splat, 800 at the
// 1024-wide slice adjoint, three to an SM (launch bounds and a 75 KB
// shared-memory budget).  It
//   1. scans its block's stream range for metas of its 32 ranks, four
//      independent loads a thread at a time, and keeps each rank's first
//      and last entry and its count with integer min/max/add in shared
//      memory (the lanes of one rank combine first); a rank whose count
//      fills its first-to-last range is one contiguous run.  Order-free: a
//      stream whose ranks are not monotone is only read more often;
//   2. walks the span [first entry of any of its ranks, last + 1), slab by
//      slab of at most 128 output columns, in stages of up to STAGE rows
//      through a ring of NS shared-memory stages: whole rows whose pitch is
//      a multiple of 16 bytes in one bulk copy (the TMA, tracked by an
//      mbarrier), else a slab's columns and the weight lanes by cp.async
//      row by row; each stage's metas come into registers when the stage
//      is issued, two stages ahead.  The slab width and the stage length
//      are chosen per launch: the fewest ring steps that fit;
//   3. per stage, one thread per entry turns its meta into a tile-local
//      rank (or -1) and its selected weight, once, in shared memory;
//   4. sums (rank_tile::add_entries): warp w owns ranks w, w + 8, w + 16,
//      w + 24 and lane l columns l + 32 q of the slab; for a contiguous run
//      it forms the products of four entries at a time and adds them in
//      stream order, carrying the float32 partial sums in registers from
//      stage to stage (a rank whose run is broken checks each entry's key).
//      No global load lies in this chain;
//   5. after a slab's last stage, writes the tile (zero rows included) to
//      shared memory and out with 16-byte stores.
// Each output is a float32 sum from +0 in stream order with __fadd_rn, the
// order csrc/rank_reduce.cu sums a run in, so on a rank-mode plan the two
// routes agree bit for bit.  No float atomics; nothing is dropped, so
// there is no overflow counter; reruns are bit-identical.
//
// Bound on an H100: bytes.  One multiply and one add per stream element
// against 2-4 bytes read: the floor is the stream (M * (C + R) elements plus
// M metas) in and T_pad * (C + 1) floats out at 3.35 TB/s.
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
constexpr int RANKS = 128;            // ranks per start_rows block
constexpr int SUB = 32;               // ranks per CTA
constexpr int KPW = SUB / WARPS;      // ranks per warp
constexpr int STAGE = 128;            // most stream rows a stage holds
constexpr int NS = 3;                 // ring depth: NS - 1 stages in flight
constexpr int SMEM_PER_CTA = 75 * 1024;   // three blocks to an SM
static_assert(SUB == 32, "the span reduction takes one rank per lane");
static_assert(STAGE <= THREADS, "a thread per staged entry");

template <bool WEIGHTED>
__device__ __forceinline__ int rank_of(int meta) { return WEIGHTED ? (meta >> 2) : meta; }

// Shared-memory layout of one launch (bytes), computed on the host.
struct Layout {
  RowLayout row;  // how staged rows sit (slab width row.sw = 32 nq)
  int stage;      // stream rows per stage (STAGE, or fewer for wide rows)
  int nslab;      // slabs of the output row
  int bars;       // NS stage barriers (bulk copies)
  int keys;       // STAGE tile-local ranks (-1: none) of the stage summed
  int ws;         // STAGE weights of the stage summed
  int bounds;     // first[SUB], last[SUB], count[SUB], span[2]
  int tile;       // SUB x slab float sums
  int total;
};

template <typename T, bool WEIGHTED, int NQ>
__global__ void __launch_bounds__(THREADS, 3)
blocked_rank_reduce_kernel(const T* __restrict__ g, int m, int cr, int c,
                           const int* __restrict__ meta,
                           const int* __restrict__ start_rows, int nblk,
                           int with_weights, float* __restrict__ out,
                           Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(smem + L.bars);
  int* s_key = reinterpret_cast<int*>(smem + L.keys);
  float* s_w = reinterpret_cast<float*>(smem + L.ws);
  int* s_first = reinterpret_cast<int*>(smem + L.bounds);
  int* s_last = s_first + SUB;
  int* s_count = s_last + SUB;
  int* s_span = s_count + SUB;
  float* tile = reinterpret_cast<float*>(smem + L.tile);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int r = cr - c;
  const int c_out = c + (with_weights ? 1 : 0);
  const int blk = blockIdx.x / (RANKS / SUB);
  const int base = blockIdx.x * SUB;                 // first rank of the tile
  const RowLayout& R = L.row;

  if (tid < SUB) {
    s_first[tid] = INT_MAX;
    s_last[tid] = -1;
    s_count[tid] = 0;
  }
  ring_init<NS>(s_bar);
  int lo = start_rows[blk];
  lo = lo < 0 ? 0 : (lo > m ? m : lo);
  int hi = blk + 1 < nblk ? start_rows[blk + 1] : m;
  hi = hi < lo ? lo : (hi > m ? m : hi);
  __syncthreads();
  // 1. each rank's first and last entry and its count in the block's range
  //    (entries that add something: a lane >= R adds nothing)
  for (int j0 = lo; j0 < hi; j0 += 4 * THREADS) {
    int mj[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * THREADS + tid;
      mj[u] = j < hi ? __ldg(meta + j) : -1;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * THREADS + tid;
      const int k = rank_of<WEIGHTED>(mj[u]) - base;
      const bool hit = j < hi && k >= 0 && k < SUB && (!WEIGHTED || (mj[u] & 3) < r);
      note_entry(s_first, s_last, s_count, hit, k, j);
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int f = __reduce_min_sync(0xffffffffu, s_first[lane]);
    const int l = __reduce_max_sync(0xffffffffu, s_last[lane]);
    if (lane == 0) {                 // an empty tile: one stage of no rows
      s_span[0] = f <= l ? f : 0;
      s_span[1] = f <= l ? l + 1 : 0;
    }
  }
  __syncthreads();
  const int s0 = s_span[0], e0 = s_span[1];
  const int nst = max(1, (e0 - s0 + L.stage - 1) / L.stage);   // stages per slab
  const int nstage = nst * L.nslab;
  int kf[KPW], kl[KPW];
  bool contiguous[KPW];           // no other entry between first and last
#pragma unroll
  for (int kk = 0; kk < KPW; ++kk) {
    const int k = warp + WARPS * kk;
    kf[kk] = s_first[k];
    kl[kk] = s_last[k] + 1;
    contiguous[kk] = kl[kk] - kf[kk] == s_count[k];
  }

  // 2. the ring: stage i holds stream rows [s0 + stage (i % nst), ...) of
  //    slab i / nst; its metas come into registers, one per thread, when it
  //    is issued
  auto issue = [&](int i) -> int {
    int mj = -1;
    if (i < nstage) {
      const int slab = i / nst;
      const int js = s0 + (i - slab * nst) * L.stage;
      const int n = max(0, min(L.stage, e0 - js));
      const int slot = i % NS;
      stage_rows<T, THREADS>(ring + slot * L.stage * R.spitch, g, cr, c, js, n,
                             slab * R.sw, R, &s_bar[slot]);
      if (tid < n) mj = __ldg(meta + js + tid);
    }
    cp_async_commit();
    return mj;
  };

  float acc[KPW][NQ];
  int mq[NS - 1];                    // metas of the stages in flight
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) mq[i] = issue(i);
  for (int i = 0; i < nstage; ++i) {
    ring_wait<NS>(R, s_bar, i);      // stage i landed; stage i - 1 summed
    const int mj = shift_in(mq, issue(i + NS - 1));  // into i - 1's slot
    const int slab = i / nst, st = i - slab * nst;
    const int o0 = slab * R.sw;
    const int o1 = min(o0 + R.sw, c_out);
    const int sw = o1 - o0;                          // slab width
    const int nv = max(0, min(o1, c) - o0);          // value columns
    const int js = s0 + st * L.stage;
    const int n = max(0, min(L.stage, e0 - js));
    const unsigned char* rows = ring + (i % NS) * L.stage * R.spitch;
    if (st == 0) {
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[kk][q] = 0.f;
    }
    // 3. each staged entry's tile-local rank and weight, once
    if (tid < n) {
      const int k = rank_of<WEIGHTED>(mj) - base;
      bool ok = k >= 0 && k < SUB;
      float w = 1.f;
      if (WEIGHTED) {
        const int ln = mj & 3;
        ok = ok && ln < r;
        if (ok)
          w = to_f32(reinterpret_cast<const T*>(rows + tid * R.spitch + R.woff)[ln]);
      }
      s_key[tid] = ok ? k : -1;
      s_w[tid] = w;
    }
    __syncthreads();
    // 4. each owned rank's entries of this stage, in stream order; a run
    //    longer than a stage carries its sums in acc
    const int vbase = R.whole ? o0 : 0;              // slab column 0 in a row
#pragma unroll
    for (int kk = 0; kk < KPW; ++kk)
      add_entries<T, WEIGHTED, NQ>(
          acc[kk], rows, R.spitch, vbase, nv, s_w, s_key, warp + WARPS * kk,
          contiguous[kk], max(kf[kk], js) - js, min(kl[kk], js + n) - js);
    // 5. a finished slab: the tile, zero rows included, out in 16-byte stores
    if (st == nst - 1) {
#pragma unroll
      for (int kk = 0; kk < KPW; ++kk)
#pragma unroll
        for (int q = 0; q < NQ; ++q) {
          const int col = lane + 32 * q;
          if (col < sw) tile[(warp + WARPS * kk) * sw + col] = acc[kk][q];
        }
      __syncthreads();
      store_tile<float, THREADS>(out + (long long)base * c_out + o0, c_out,
                                 tile, SUB, sw);
    }
  }
  cp_async_wait<0>();
}

Layout layout(int c_out, int c, int r, int es, int nq, int stage,
              bool aligned16) {
  Layout L;
  L.row = row_layout(c_out, c, r, es, 32 * nq, aligned16);
  L.stage = stage;
  const int sw = c_out < L.row.sw ? c_out : L.row.sw;
  L.nslab = (c_out + L.row.sw - 1) / L.row.sw;
  L.bars = NS * stage * L.row.spitch;
  L.keys = L.bars + round16(NS * 8);
  L.ws = L.keys + stage * 4;
  L.bounds = L.ws + stage * 4;
  L.tile = L.bounds + round16((3 * SUB + 2) * 4);
  L.total = L.tile + SUB * sw * 4;
  return L;
}

// The slab width (nq = 1..4: 32 nq output columns) and stage length
// (32, 64 or 128 rows) whose ring and tile leave room for three blocks on
// an SM and that take the fewest ring steps for a tile's average span of
// ``span`` rows (the longer stage on a tie).
Layout choose(int c_out, int c, int r, int es, bool aligned16, int span) {
  Layout best = layout(c_out, c, r, es, 1, 32, aligned16);
  long long best_steps = -1;
  const int nq_max = (c_out + 31) / 32 < 4 ? (c_out + 31) / 32 : 4;
  for (int nq = nq_max; nq >= 1; --nq)
    for (int stage = STAGE; stage >= 32; stage /= 2) {
      const Layout L = layout(c_out, c, r, es, nq, stage, aligned16);
      const long long steps = (long long)L.nslab * ((span + stage - 1) / stage);
      if (L.total <= SMEM_PER_CTA &&
          (best_steps < 0 || steps < best_steps ||
           (steps == best_steps && stage > best.stage))) {
        best = L;
        best_steps = steps;
      }
    }
  return best;
}

template <typename T, bool WEIGHTED, int NQ>
cudaError_t launch(const Layout& L, const void* g, int m, int cr, int c,
                   const int* meta, const int* start_rows, int nblk,
                   int with_weights, float* out, cudaStream_t s) {
  if (L.total > MAX_SMEM) return cudaErrorInvalidValue;
  static int allowed[MAX_DEVICES] = {};
  const cudaError_t e = allow_smem(blocked_rank_reduce_kernel<T, WEIGHTED, NQ>,
                                   L.total, allowed);
  if (e != cudaSuccess) return e;
  blocked_rank_reduce_kernel<T, WEIGHTED, NQ><<<nblk * (RANKS / SUB), THREADS,
                                                L.total, s>>>(
      static_cast<const T*>(g), m, cr, c, meta, start_rows, nblk, with_weights,
      out, L);
  return cudaGetLastError();
}

// One build per slab width: a warp's column groups as a template count
// keeps its accumulators in registers and its inner loop free of checks
// (a count read at run time took 1.4-1.9x the time on an H100).
template <typename T, bool WEIGHTED>
cudaError_t launch_nq(const void* g, int m, int cr, int c, const int* meta,
                      const int* start_rows, int nblk, int with_weights,
                      float* out, cudaStream_t s) {
  const Layout L = choose(c + (with_weights ? 1 : 0), c, cr - c, (int)sizeof(T),
                          reinterpret_cast<uintptr_t>(g) % 16 == 0,
                          m / (nblk * (RANKS / SUB)) + 1);
  const int nq = L.row.sw / 32;
  if (nq == 1)
    return launch<T, WEIGHTED, 1>(L, g, m, cr, c, meta, start_rows, nblk, with_weights, out, s);
  if (nq == 2)
    return launch<T, WEIGHTED, 2>(L, g, m, cr, c, meta, start_rows, nblk, with_weights, out, s);
  if (nq == 3)
    return launch<T, WEIGHTED, 3>(L, g, m, cr, c, meta, start_rows, nblk, with_weights, out, s);
  return launch<T, WEIGHTED, 4>(L, g, m, cr, c, meta, start_rows, nblk, with_weights, out, s);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  g: (m, cr) row-major with cr = c + r,
// 0 <= r <= 4 (r = 0: plain rows, no density); meta: (m,) int32, rank << 2 |
// lane (r >= 1) or the rank (r = 0); start_rows: (nblk,) int32; out:
// (nblk * 128, c + with_weights) float32.  Returns the CUDA error code of
// the launch (0 on success).
int hpl_blocked_rank_reduce(const void* g, int m, int cr, int c,
                            const void* meta, const void* start_rows,
                            int nblk, int with_weights, void* out, int dtype,
                            void* stream) {
  if (nblk <= 0) return 0;
  const int r = cr - c;
  if (c <= 0 || r < 0 || r > 4 || (r == 0 && with_weights) || m < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* mp = static_cast<const int*>(meta);
  const int* sr = static_cast<const int*>(start_rows);
  float* op = static_cast<float*>(out);
  cudaError_t e;
  if (dtype == 1 && r > 0)
    e = launch_nq<bf16, true>(g, m, cr, c, mp, sr, nblk, with_weights, op, s);
  else if (dtype == 1)
    e = launch_nq<bf16, false>(g, m, cr, c, mp, sr, nblk, 0, op, s);
  else if (dtype == 0 && r > 0)
    e = launch_nq<float, true>(g, m, cr, c, mp, sr, nblk, with_weights, op, s);
  else if (dtype == 0)
    e = launch_nq<float, false>(g, m, cr, c, mp, sr, nblk, 0, op, s);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* hpl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
