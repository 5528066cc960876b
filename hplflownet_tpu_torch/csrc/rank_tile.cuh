// Building blocks of the segmented-sum kernels on Hopper (sm_90a): a tile
// of output rows (ranks) x output columns summed from a sorted stream of
// (C + R)-wide rows whose entries each carry the output row they add to.
// Both kernels step the same ring and sum with the same function, so the
// summation order that makes kernel 5 equal csrc/rank_reduce.cu bit for
// bit is defined here, once.
//
// * Staging (RowLayout, stage_rows).  A stage is a run of consecutive
//   stream rows.  Whole rows whose pitch is a multiple of 16 bytes (144 or
//   288 bytes at C 68 + R 4) are one contiguous range: one thread moves it
//   with a bulk copy (the TMA's 1-D form) whose completion an mbarrier
//   tracks.  Otherwise a channel slab and the R weight lanes go row by row
//   by cp.async, in the widest chunk the row pitch and the segment's
//   address allow: 8 bytes for the 2056-byte pitch of a 1024-channel bf16
//   cotangent with 4 weight lanes, 4 bytes for float32, plain 2-byte loads
//   only for a bf16 row whose pitch is not a multiple of 4 bytes.  A row's
//   last chunk copies what is left and fills the rest with zeros, so no
//   copy reads past a row's segment.
// * The ring (ring_init, stage_rows, ring_wait, shift_in).  NS stages,
//   NS - 1 in flight; the metas of the stages in flight wait in registers
//   (in shared memory, copied with the rows, they took longer on an H100).
// * Per-entry keys and weights.  Once a stage has landed, one thread per
//   stream row turns its meta into the output row it adds to (-1: none)
//   and its selected weight w_j, so the sums read both from shared memory
//   and each weight is converted once; note_entry keeps each output row's
//   first and last entry and count with integer atomics.
// * Sums (entry_term, add_entries).  product() rounds as
//   csrc/rank_reduce.cu does: a float32 product once, a bf16 product to
//   bf16 before the float32 sum.  Each output's entries are added in
//   stream order with __fadd_rn, starting from +0, so every output is the
//   same float32 sum csrc/rank_reduce.cu forms for the same run.
// * Output.  A finished tile of float sums (shared memory, pitch = its
//   width) goes out in 16-byte stores, rounded to the output dtype;
//   a contiguous tile (the slab is the whole output row) is one run, read
//   with 16-byte shared loads where aligned, and only its ragged ends use
//   plain stores.
//
// Included by blocked_rank_reduce.cu and rank_partial.cu.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace rank_tile {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// the stream-dtype product of a channel value and a weight (the weight as
// the exact float32 image of the stream's value)
__device__ __forceinline__ float product(float a, float w) { return __fmul_rn(a, w); }
__device__ __forceinline__ float product(bf16 a, float w) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(__bfloat162float(a), w)));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// The widest chunk (16, 8, 4 or 2 bytes) that divides both the address of
// a segment in row 0 and the row pitch, so it divides the segment's
// address in every row.
__host__ __device__ __forceinline__ int chunk_bytes(const void* p, long long pitch) {
  const unsigned long long a = reinterpret_cast<unsigned long long>(p);
  for (int v = 16; v > 2; v /= 2)
    if (a % v == 0 && pitch % v == 0) return v;
  return 2;
}

// Copy bytes [0, bytes) of rows 0 .. n-1 of a global matrix (rows
// ``gpitch`` bytes apart, from ``src``) to shared memory at ``dst`` (rows
// ``spitch`` bytes apart), in chunks of ``vec`` bytes (chunk_bytes of src
// and gpitch; dst and spitch multiples of 16).  vec 16, 8, 4: cp.async,
// asynchronous, the last chunk of a row cut to what is left (zero fill);
// vec 2: plain loads and stores (bf16 rows with an odd number of 2-byte
// words in their pitch).
template <int THREADS>
__device__ __forceinline__ void copy_rows(unsigned char* dst, int spitch,
                                          const unsigned char* src,
                                          long long gpitch, int n, int bytes,
                                          int vec) {
  if (bytes <= 0 || n <= 0) return;
  const int chunks = (bytes + vec - 1) / vec;
  const int total = n * chunks;
  for (int i = threadIdx.x; i < total; i += THREADS) {
    const int row = i / chunks;
    const int off = (i - row * chunks) * vec;
    unsigned char* d = dst + row * spitch + off;
    const unsigned char* s = src + row * gpitch + off;
    const int left = bytes - off;
    const uint32_t da = smem_u32(d);
    if (vec == 16) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(da), "l"(s), "r"(left < 16 ? left : 16) : "memory");
    } else if (vec == 8) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                   :: "r"(da), "l"(s), "r"(left < 8 ? left : 8) : "memory");
    } else if (vec == 4) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                   :: "r"(da), "l"(s), "r"(left < 4 ? left : 4) : "memory");
    } else {
      *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
    }
  }
}

// mbarrier-tracked bulk copies (the Tensor Memory Accelerator's 1-D form):
// one thread moves a whole stage; the others wait on the stage's barrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// Make initialised barriers visible to the bulk-copy unit (then sync).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive on ``bar`` expecting ``bytes`` more to land, and copy ``bytes``
// (a multiple of 16; both addresses 16-byte aligned) from global ``src`` to
// shared ``dst``: the barrier's phase completes when they have landed.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
  if (bytes > 0)
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
                 " [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
                 : "memory");
}

// Order this thread's earlier shared-memory accesses before its later
// bulk copies (the async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Wait until ``bar`` has completed the phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__host__ __device__ __forceinline__ int round16(int bytes) { return (bytes + 15) & ~15; }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

// 16 bytes of output from 16 / sizeof(O) consecutive float sums
__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&h);
}
__device__ __forceinline__ void store16(bf16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                 pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
}

// Store n consecutive float sums s[0..n) to dst[0..n) as O: plain stores up
// to dst's first 16-byte boundary, 16-byte stores, plain stores for the
// tail.  All THREADS threads of the block take part.
template <typename O, int THREADS>
__device__ __forceinline__ void store_run(O* dst, const float* s, int n) {
  constexpr int V = 16 / sizeof(O);
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst);
  int head = (int)(((16 - a % 16) % 16) / sizeof(O));
  head = head < n ? head : n;
  const int nvec = (n - head) / V;
  const int tail0 = head + nvec * V;
  for (int i = threadIdx.x; i < head; i += THREADS) store1(dst + i, s[i]);
  const bool wide = reinterpret_cast<unsigned long long>(s + head) % 16 == 0;
  for (int v = threadIdx.x; v < nvec; v += THREADS) {
    const int e = head + v * V;
    float x[V];
    if (wide) {                      // 16-byte shared-memory loads too
#pragma unroll
      for (int k = 0; k < V; k += 4) {
        const float4 f = *reinterpret_cast<const float4*>(s + e + k);
        x[k] = f.x; x[k + 1] = f.y; x[k + 2] = f.z; x[k + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = s[e + k];
    }
    store16(dst + e, x);
  }
  for (int i = tail0 + threadIdx.x; i < n; i += THREADS) store1(dst + i, s[i]);
}

// Store a rows x cols tile of float sums (shared, row pitch cols) to
// global rows ``gpitch`` elements apart.  A tile as wide as the output is
// one contiguous run; a narrower one (a channel slab) goes row by row, in
// 16-byte stores where every row start is 16-byte aligned.
template <typename O, int THREADS>
__device__ __forceinline__ void store_tile(O* dst, long long gpitch,
                                           const float* s, int rows, int cols) {
  constexpr int V = 16 / sizeof(O);
  if (cols == gpitch) {
    store_run<O, THREADS>(dst, s, rows * cols);
    return;
  }
  const unsigned long long a = reinterpret_cast<unsigned long long>(dst);
  if (a % 16 == 0 && (gpitch * sizeof(O)) % 16 == 0 && cols % V == 0) {
    const int per_row = cols / V;
    for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
      const int r = i / per_row, e = (i - r * per_row) * V;
      float x[V];
#pragma unroll
      for (int k = 0; k < V; ++k) x[k] = s[r * cols + e + k];
      store16(dst + r * gpitch + e, x);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += THREADS) {
    const int r = i / cols, e = i - r * cols;
    store1(dst + r * gpitch + e, s[i]);
  }
}

constexpr int MAX_DEVICES = 64;

// Set a kernel's dynamic shared-memory limit on the current device the
// first time a launch there needs more than the default 48 KB (and
// whenever it needs more than before).  ``allowed``: MAX_DEVICES entries,
// one array per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev < MAX_DEVICES;
  if (cached && bytes <= allowed[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess && cached) allowed[dev] = bytes;
  return e;
}

// The current device's SM count (read once per device).
inline cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && known[dev] > 0) {
    *sms = known[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < MAX_DEVICES) known[dev] = *sms;
  return e;
}

constexpr int MAX_SMEM = 227 * 1024;    // a block's dynamic shared memory

// How a stage's stream rows sit in shared memory (host-computed).
struct RowLayout {
  int sw;        // output columns per slab
  int whole;     // one slab holds every output column: rows staged whole
  int flat;      // whole rows, pitch a multiple of 16: one contiguous copy
  int woff;      // byte offset of the weight lanes in a staged row
  int spitch;    // staged row pitch (multiple of 16)
};

inline RowLayout row_layout(int c_out, int c, int r, int es, int sw,
                            bool aligned16) {
  RowLayout L;
  L.sw = sw;
  L.whole = c_out <= L.sw;
  L.flat = L.whole && aligned16 && ((c + r) * es) % 16 == 0;
  if (L.whole) {                      // the row as it is: values, then lanes
    L.woff = c * es;
    L.spitch = round16((c + r) * es);
  } else {                            // the slab's values, then the lanes
    L.woff = round16(L.sw * es);
    L.spitch = L.woff + round16(r * es);
  }
  return L;
}

// Issue the copy of stream rows [js, js + n) of g (rows cr elements wide)
// into a ring slot: whole rows by one bulk copy on ``bar`` (L.flat), whole
// rows by cp.async, or the value columns of the slab starting at output
// column o0 and the cr - c weight lanes by cp.async.  All THREADS threads
// call it; the caller commits the cp.async group.
template <typename T, int THREADS>
__device__ __forceinline__ void stage_rows(unsigned char* slot, const T* g,
                                           int cr, int c, int js, int n,
                                           int o0, const RowLayout& L,
                                           uint64_t* bar) {
  constexpr int ES = sizeof(T);
  const long long pitch = (long long)cr * ES;
  const unsigned char* base = reinterpret_cast<const unsigned char*>(g);
  const unsigned char* src = base + (long long)js * pitch;
  if (L.flat) {
    if (threadIdx.x == 0) {
      fence_proxy_async();
      bulk_copy(slot, src, n * (int)pitch, bar);
    }
  } else if (L.whole) {
    copy_rows<THREADS>(slot, L.spitch, src, pitch, n, cr * ES,
                       chunk_bytes(base, pitch));
  } else {
    const int nv = max(0, min(o0 + L.sw, c) - o0);
    copy_rows<THREADS>(slot, L.spitch, src + (long long)o0 * ES, pitch, n,
                       nv * ES, chunk_bytes(base + (long long)o0 * ES, pitch));
    if (cr > c)
      copy_rows<THREADS>(slot + L.woff, L.spitch, src + (long long)c * ES,
                         pitch, n, (cr - c) * ES,
                         chunk_bytes(base + (long long)c * ES, pitch));
  }
}

// Initialise the ring's NS stage barriers (then sync).
template <int NS>
__device__ __forceinline__ void ring_init(uint64_t* bars) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < NS; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
}

// Wait until ring step i's stage has landed; the barrier also ends step
// i - 1, so its slot may be refilled.
template <int NS>
__device__ __forceinline__ void ring_wait(const RowLayout& L, uint64_t* bars,
                                          int i) {
  cp_async_wait<NS - 2>();
  if (L.flat) mbar_wait(&bars[i % NS], (i / NS) & 1);
  __syncthreads();
}

// The metas of the stages in flight: return the oldest, append ``next``.
template <int N>
__device__ __forceinline__ int shift_in(int (&q)[N], int next) {
  const int head = q[0];
#pragma unroll
  for (int k = 0; k < N - 1; ++k) q[k] = q[k + 1];
  q[N - 1] = next;
  return head;
}

// Note entry j of output row k (where ``hit``) in first[k], last[k] and
// count[k]: the lanes of a warp that hit one row combine first (a row's
// entries are usually neighbours), so one lane per row does the shared
// atomics.  The whole warp calls it, j increasing with the lane.
__device__ __forceinline__ void note_entry(int* first, int* last, int* count,
                                           bool hit, int k, int j) {
  const unsigned hits = __ballot_sync(0xffffffffu, hit);
  if (hit) {
    const unsigned peers = __match_any_sync(hits, k);
    const int lane = threadIdx.x % 32;
    if (lane == __ffs(peers) - 1) {
      atomicMin(&first[k], j);
      atomicAdd(&count[k], __popc(peers));
    }
    if (lane == 31 - __clz(peers)) atomicMax(&last[k], j);
  }
}

// The term staged row t adds to slab column col: product(value, w[t]) for
// a value column (col < nv; the value itself unweighted), w[t] for the
// next one, the density where the slab holds it.  Row t is ``rows + t *
// spitch`` with the slab's column 0 at element ``vbase``.
template <typename T, bool WEIGHTED>
__device__ __forceinline__ float entry_term(const unsigned char* rows,
                                            int spitch, int vbase, int nv,
                                            const float* w, int t, int col) {
  const float wt = WEIGHTED ? w[t] : 1.f;
  const T* row = reinterpret_cast<const T*>(rows + t * spitch) + vbase;
  return col < nv ? (WEIGHTED ? product(row[col], wt) : to_f32(row[col])) : wt;
}

// Add output row ``key``'s terms of staged rows [a, b) to acc[q], slab
// column lane + 32 q, in stream order with __fadd_rn (both kernels start
// from +0; kernel 5 carries acc over from earlier stages).
// ``contiguous``: every row of [a, b) is the key's, so the terms of four
// rows are formed ahead of their in-order adds; else each row's keys[t]
// is checked.
template <typename T, bool WEIGHTED, int NQ>
__device__ __forceinline__ void add_entries(float (&acc)[NQ],
                                            const unsigned char* rows,
                                            int spitch, int vbase, int nv,
                                            const float* w, const int* keys,
                                            int key, bool contiguous, int a,
                                            int b) {
  const int lane = threadIdx.x % 32;
  if (contiguous) {
    int t = a;
    for (; t + 4 <= b; t += 4) {
      float p[4][NQ];
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < NQ; ++q)
          p[u][q] = entry_term<T, WEIGHTED>(rows, spitch, vbase, nv, w, t + u,
                                            lane + 32 * q);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int q = 0; q < NQ; ++q) acc[q] = __fadd_rn(acc[q], p[u][q]);
    }
    for (; t < b; ++t)
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        acc[q] = __fadd_rn(acc[q], entry_term<T, WEIGHTED>(rows, spitch, vbase,
                                                           nv, w, t,
                                                           lane + 32 * q));
  } else {
    for (int t = a; t < b; ++t) {
      if (keys[t] != key) continue;
#pragma unroll
      for (int q = 0; q < NQ; ++q)
        acc[q] = __fadd_rn(acc[q], entry_term<T, WEIGHTED>(rows, spitch, vbase,
                                                           nv, w, t,
                                                           lane + 32 * q));
    }
  }
}

}  // namespace rank_tile
