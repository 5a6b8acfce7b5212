// Shared pieces of the wide likelihood kernels: the general [C,S,S] layout
// (protein: S = 20 states; 1..8 rate categories; float32).
//
// The CS-packed DNA kernels give one thread a whole pattern column
// (float[C][4] in registers).  At S = 20 a column is 80 floats per child
// and an edge's matrices 1 600 floats, so the wide kernels spread a
// pattern over threads.  Two layouts:
//
// * row groups (wide_tbar.cu): a block owns a tile of T consecutive
//   patterns with T * C * (S/RPT) threads:
//
//     thread tid:  p  = tid % T         its pattern in the tile
//                  g  = tid / T         its row group: category c = g / NG,
//                                       state rows s0 .. s0+RPT-1 with
//                                       s0 = (g % NG) * RPT, NG = S / RPT.
//
//   Consecutive threads take consecutive patterns, so every [row][pattern]
//   array (the slot pool, the stored partials) is read and written
//   coalesced in device memory and without bank conflicts in shared
//   memory.  A child message m[c][s][p] = sum_t P[c][s][t] x[c][t][p]
//   costs a thread its category's S-value column x and RPT x S
//   multiply-adds against P[c], which is staged in shared memory (the
//   threads of a warp read the same P entries: broadcasts).  The
//   per-pattern max over the C*S rows is a shared-memory reduction over
//   the row groups; barriers separate the load, product, max and
//   normalize phases of a step;
// * thread-block clusters (wide_forward.cu, wide_store.cu, and the reverse
//   walks of wide_newton.cu and wide_down_store.cu): a block a rate
//   category, the second half of this header.
//
// Each block walks the whole slot schedule for its tile, as a TPU grid
// step walks it (schedule rows: left child, right child, left slot,
// right slot (-1 = tip), output slot, output node; see cs_common.cuh).
// The kernels are templates on S and RPT with one instance, S = 20; a
// new state count (codon, S = 61) adds an instance, not a kernel.
#pragma once

#include <cooperative_groups.h>

#include "cs_common.cuh"

namespace iqtw {

using iqt::Step;
using iqt::load_step;

// Largest block: 512 threads keeps the register budget at 128 a thread.
constexpr int MAX_THREADS = 512;

template <int S, int RPT>
struct Lane {
  static_assert(S % RPT == 0, "row groups must tile the state axis");
  static constexpr int NG = S / RPT;  // row groups per category
  static constexpr int SS = S * S;
  int T, p, g, c, s0, G, CS;

  __device__ __forceinline__ Lane(int T_, int C) : T(T_) {
    const int tid = threadIdx.x;
    p = tid % T;
    g = tid / T;
    c = g / NG;
    s0 = (g % NG) * RPT;
    G = C * NG;
    CS = C * S;
  }
  __device__ __forceinline__ int row(int j) const { return c * S + s0 + j; }
};

// Copy n floats from device memory to shared memory, the whole block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// Stage the rows [CS] of one node's stored partial up [2N, CS, P] for the
// tile's patterns into dst [CS][ts] (the tail of a ragged last tile
// repeats pattern P-1).
template <int S, int RPT>
__device__ __forceinline__ void stage_partial(float* dst, int ts,
                                              const float* __restrict__ up, int node,
                                              int P, int pg, const Lane<S, RPT>& L) {
  const float* src = up + (size_t)node * L.CS * P + pg;
  for (int r = L.g; r < L.CS; r += L.G) dst[r * ts + L.p] = __ldg(src + (size_t)r * P);
}

// m[j] = sum_t Pc[s0+j][t] x[t] for this thread's rows; Pc = P[c] [S][S].
template <int S, int RPT>
__device__ __forceinline__ void message(const float* Pc, int s0, const float (&x)[S],
                                        float (&m)[RPT]) {
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const float* row = Pc + (s0 + j) * S;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < S; ++t) acc += row[t] * x[t];
    m[j] = acc;
  }
}

// This thread's category column x[t] = a[(c*S + t) * ts + p] of a
// [CS][ts] shared-memory array.
template <int S, int RPT>
__device__ __forceinline__ void load_column(const float* a, int ts, const Lane<S, RPT>& L,
                                            float (&x)[S]) {
  const float* col = a + L.c * S * ts + L.p;
#pragma unroll
  for (int t = 0; t < S; ++t) x[t] = col[t * ts];
}

// Per-pattern max over the C*S rows, from each row group's partial max:
// one barrier.  The caller passes a barrier before `red` is written again.
template <int S, int RPT>
__device__ __forceinline__ float row_max(float* red, float local, const Lane<S, RPT>& L) {
  red[L.g * L.T + L.p] = local;
  __syncthreads();
  float mx = 0.f;
  for (int k = 0; k < L.G; ++k) mx = fmaxf(mx, red[k * L.T + L.p]);
  return fmaxf(mx, SCALE_TINY);
}

// dd[j] = sum_s Pc[s][s0+j] o[s] (transport through the edge: P^T o), with
// o this thread's category column of a [CS][ts] shared-memory array.
template <int S, int RPT>
__device__ __forceinline__ void transport(const float* Pc, const float* o, int ts,
                                          const Lane<S, RPT>& L, float (&dd)[RPT]) {
  float x[S];
  load_column<S, RPT>(o, ts, L, x);
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) acc += Pc[s * S + L.s0 + j] * x[s];
    dd[j] = acc;
  }
}

// Stage both children's [C,S,S] blocks of an edge-indexed array whose rows
// are `stride` floats apart (trans: C*S*S; the stacked derivatives: 3*C*S*S).
__device__ __forceinline__ void stage_children(float* dst, const float* __restrict__ src,
                                               const Step& st, int stride) {
  stage(dst, src + (size_t)st.l * stride, stride);
  stage(dst + stride, src + (size_t)st.r * stride, stride);
}


// ---------------------------------------------------------------------------
// The upward walk on thread-block clusters (wide_forward.cu, wide_store.cu).
//
// A cluster of C blocks, one a rate category (its rank), owns a tile of
// consecutive patterns.  Thread (pq, g) of a block holds CLUSTER_QT
// consecutive patterns q = pq QT + qq and the RPT state rows g RPT .. g RPT
// + RPT - 1 of its category (G = S / RPT consecutive lanes a pattern
// group), so a block has tile / QT x G threads.  A block keeps only its
// category's rows in its slot pool [slot][S+1][tile] (S rows and the
// patterns' log-scale, which every block of the cluster holds with the same
// bits).  A step's other inputs -- the block's category's [S,S] blocks of
// both children and each tip child's S indicator rows for the tile (every
// block reads its own copy, in 4-byte words: P need not be a multiple of 4)
// -- are cp.async copies into a ring CLUSTER_STAGES deep, issued as the
// stage they replace is released.
//
// The renormalizing max crosses the category's rows in log2(G) shuffle
// rounds and the categories through distributed shared memory: each block
// stores its per-pattern max into every block's buffer [parity][rank][tile]
// (double-buffered by step parity), and one cluster barrier a step, which
// also publishes the ring's landed copies and releases the stage the step
// read, precedes the reads.  A pattern's pool rows cross its G lanes, which
// share a warp, after a __syncwarp.
//
// The arithmetic is the row-group design's upward step: each message's
// products in t order, the product of the two messages, the max (exact in
// any order), the float division's bits (div_rn, without its branches) and
// the scale chain sl + sr + log(max) in that order.  So the pool holds that
// design's bits.
//
// Shared memory a block (floats), with tile patterns, n_slots slots and
// STAGES = CLUSTER_STAGES:
//     STAGES x 2 S^2           both children's matrices
//   + STAGES x 2 S tile        their tip rows
//   + n_slots (S+1) tile       the pool
//   + 2 C tile                 the max buffers
// (pruning.wide_forward_smem).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

// Patterns a thread: each staged matrix word loaded feeds CLUSTER_QT
// multiply-adds.
constexpr int CLUSTER_QT = 2;
// Steps whose matrices and tip rows are in flight at once (a cp.async ring).
constexpr int CLUSTER_STAGES = 2;
// Largest block of a cluster walk.
constexpr int CLUSTER_THREADS_MAX = 256;

// Offsets (floats) of a cluster walk's shared-memory arrays.
template <int S>
struct ClusterSmem {
  int tile;
  __device__ __host__ ClusterSmem(int tile_) : tile(tile_) {}
  __device__ __host__ size_t tips() const { return (size_t)CLUSTER_STAGES * 2 * S * S; }
  __device__ __host__ size_t pool() const {
    return tips() + (size_t)CLUSTER_STAGES * 2 * S * tile;
  }
  __device__ __host__ size_t xmax(int n_slots) const {
    return pool() + (size_t)n_slots * (S + 1) * tile;
  }
  __device__ __host__ size_t floats(int n_slots, int C) const {
    return xmax(n_slots) + 2 * (size_t)C * tile;
  }
};

// Step j's [S,S] blocks of category c for both children (mst_k
// [child][S*S]), as cp.async copies by the whole block.
template <int S>
__device__ __forceinline__ void fetch_blocks(const Step& sj, float* mst_k, int c, int C,
                                             const float* __restrict__ trans) {
  constexpr int SS = S * S;
  const int T = blockDim.x, tid = threadIdx.x;
  if constexpr (SS % 4 == 0) {
    constexpr int V = SS / 4;  // 16-byte rows a block
    for (int q = tid; q < 2 * V; q += T) {
      const int side = q / V, r = q - side * V;
      const int node = side ? sj.r : sj.l;
      __pipeline_memcpy_async(mst_k + side * SS + 4 * r,
                              trans + ((size_t)node * C + c) * SS + 4 * r, 16);
    }
  } else {
    for (int q = tid; q < 2 * SS; q += T) {
      const int side = q / SS, r = q - side * SS;
      const int node = side ? sj.r : sj.l;
      __pipeline_memcpy_async(mst_k + q, trans + ((size_t)node * C + c) * SS + r, 4);
    }
  }
}

// Step j's inputs for category c into stage k: both children's [S,S]
// blocks (mst_k [child][S*S]) and each tip child's S rows for the tile's
// patterns (tst_k [child][S][tile]; a ragged tail repeats P - 1).
template <int S>
__device__ __forceinline__ void cluster_fetch(const Step& sj, float* mst_k, float* tst_k,
                                              int c, int C, int tile, int p0,
                                              const float* __restrict__ trans,
                                              const float* __restrict__ tips, int P) {
  fetch_blocks<S>(sj, mst_k, c, C, trans);
  // a thread copies one pattern's words (T % tile == 0)
  const int T = blockDim.x, tid = threadIdx.x;
  const int qq = tid % tile, p = min(p0 + qq, P - 1);
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    if ((side ? sj.rs : sj.ls) >= 0) continue;
    const int node = side ? sj.r : sj.l;
    for (int t = tid / tile; t < S; t += T / tile)
      __pipeline_memcpy_async(tst_k + (side * S + t) * tile + qq,
                              tips + ((size_t)node * S + t) * P + p, 4);
  }
}

// m[j][qq] = sum_t M[s0+j][t] x[t][qq] for this thread's rows and patterns,
// in message's order (t ascending).
template <int S, int RPT, int QT>
__device__ __forceinline__ void cluster_message(const float* M, int s0,
                                                const float (&x)[S][QT],
                                                float (&m)[RPT][QT]) {
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float acc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) acc[qq] = 0.f;
    const float* row = M + (s0 + j) * S;
    if constexpr (S % 4 == 0) {
#pragma unroll
      for (int t = 0; t < S; t += 4) {
        const float4 w = *reinterpret_cast<const float4*>(row + t);
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) {
          acc[qq] += w.x * x[t][qq];
          acc[qq] += w.y * x[t + 1][qq];
          acc[qq] += w.z * x[t + 2][qq];
          acc[qq] += w.w * x[t + 3][qq];
        }
      }
    } else {
#pragma unroll
      for (int t = 0; t < S; ++t) {
        const float w = row[t];
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) acc[qq] += w * x[t][qq];
      }
    }
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) m[j][qq] = acc[qq];
  }
}

// The whole upward walk for this block's category and tile (patterns p0
// ..).  After each step emit(step, y, sc, slot) sees this thread's
// normalized rows y[RPT][QT], its patterns' log-scales sc[QT] and the
// step's pool slot [S+1][tile], whose columns of the warp's patterns its
// lanes have written (a __syncwarp before); the slot keeps them for the
// parent step, which may overwrite it after the next step's cluster
// barrier.  Returns the root's slot.  Every thread of every block of the
// cluster runs it; the caller passes a cluster barrier before it reads
// another block's pool.
template <int S, int RPT, typename Emit>
__device__ __forceinline__ int cluster_upward_walk(const int* __restrict__ steps,
                                                   int n_steps,
                                                   const float* __restrict__ trans,
                                                   const float* __restrict__ tips, int P,
                                                   int p0, int tile, int n_slots,
                                                   float* smem, Emit emit) {
  constexpr int G = S / RPT, SS = S * S, QT = CLUSTER_QT, NS = CLUSTER_STAGES;
  static_assert(S % RPT == 0 && G <= 32 && (G & (G - 1)) == 0,
                "a pattern's row groups are a power of two of consecutive lanes");
  static_assert(G % QT == 0, "a block's threads are a multiple of its tile");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int tid = threadIdx.x, g = tid % G, s0 = g * RPT, pq = tid / G;
  const ClusterSmem<S> lay(tile);
  float* mst = smem;                   // [NS][2][SS]
  float* tst = smem + lay.tips();      // [NS][2][S][tile]
  float* pool = smem + lay.pool();     // [n_slots][S+1][tile]
  float* xmax = smem + lay.xmax(n_slots);  // [2][C][tile]
  int q[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) q[qq] = pq * QT + qq;

#pragma unroll
  for (int k = 0; k < NS; ++k) {
    if (k < n_steps)
      cluster_fetch<S>(load_step(steps, k), mst + k * 2 * SS, tst + (size_t)k * 2 * S * tile,
                       c, C, tile, p0, trans, tips, P);
    __pipeline_commit();
  }
  __pipeline_wait_prior(NS - 1);  // step 0's copies have landed
  cluster.sync();  // every thread's, and every block of the cluster runs
  Step st = load_step(steps, 0);
  Step st_f = NS < n_steps ? load_step(steps, NS) : st;  // the next step to fetch
  int k = 0;  // the stage of step i
  for (int i = 0; i < n_steps; ++i) {
    const Step st_next = i + 1 < n_steps ? load_step(steps, i + 1) : st;
    const float* Mk = mst + k * 2 * SS;
    const float* Tk = tst + (size_t)k * 2 * S * tile;
    float y[RPT][QT], m[RPT][QT], sc[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) sc[qq] = 0.f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int slot = side ? st.rs : st.ls;
      float x[S][QT];
      if (slot < 0) {
#pragma unroll
        for (int t = 0; t < S; ++t)
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) x[t][qq] = Tk[(side * S + t) * tile + q[qq]];
      } else {
        const float* col = pool + (size_t)slot * (S + 1) * tile;
#pragma unroll
        for (int t = 0; t < S; ++t)
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) x[t][qq] = col[t * tile + q[qq]];
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) sc[qq] += col[S * tile + q[qq]];
      }
      if (side)
        cluster_message<S, RPT, QT>(Mk + SS, s0, x, m);
      else
        cluster_message<S, RPT, QT>(Mk, s0, x, y);
    }
    float mx[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      mx[qq] = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        y[j][qq] *= m[j][qq];
        mx[qq] = fmaxf(mx[qq], y[j][qq]);
      }
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
        mx[qq] = fmaxf(mx[qq], __shfl_xor_sync(0xffffffffu, mx[qq], off));
    float* xm = xmax + (size_t)(i & 1) * C * tile;
    for (int r = g; r < C; r += G) {  // the G lanes of a pattern group share the blocks out
      float* xr = cluster.map_shared_rank(xm, r) + c * tile;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) xr[q[qq]] = mx[qq];
    }
    __pipeline_wait_prior(NS - 2);  // this thread's copies of step i + 1 have landed
    cluster.sync();  // one barrier a step: the maxima, the ring, the stage read
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      mx[qq] = 0.f;
      for (int r = 0; r < C; ++r) mx[qq] = fmaxf(mx[qq], xm[r * tile + q[qq]]);
      mx[qq] = fmaxf(mx[qq], SCALE_TINY);
    }
    // the step's child reads are done: the output slot may be one they held
    float* out = pool + (size_t)st.out * (S + 1) * tile;
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        y[j][qq] = iqt::div_rn(y[j][qq], mx[qq]);
        out[(s0 + j) * tile + q[qq]] = y[j][qq];
      }
      sc[qq] += logf(mx[qq]);
      if (g == 0) out[S * tile + q[qq]] = sc[qq];
    }
    // stage k is free: step i + NS into it
    if (i + NS < n_steps)
      cluster_fetch<S>(st_f, mst + k * 2 * SS, tst + (size_t)k * 2 * S * tile, c, C, tile,
                       p0, trans, tips, P);
    __pipeline_commit();
    __syncwarp();  // the pattern group's pool rows are written
    emit(st, y, sc, static_cast<const float*>(out));
    if (i + NS + 1 < n_steps) st_f = load_step(steps, i + NS + 1);
    st = st_next;
    k = k == NS - 1 ? 0 : k + 1;
  }
  return st.out;
}

// Launch `kernel` as `clusters` thread-block clusters of C blocks (one a
// rate category) of `threads` threads and `smem` bytes of shared memory.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int clusters, int C,
                                   int threads, size_t smem, void* stream, Args... args) {
  cudaError_t e = iqt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * C);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

}  // namespace iqtw

// Dispatch over the state count (template arguments S, RPT); each wide
// kernel has the protein instance S = 20 (4 row groups of 5 states).
#define IQT_DISPATCH_S(S_RT, CALL)               \
  switch (S_RT) {                                \
    case 20: CALL(20, 5); break;                 \
    default: return (int)cudaErrorInvalidValue;  \
  }
