// Shared pieces of the wide likelihood kernels: the general [C,S,S] layout
// (protein: S = 20 states; codons: S = 64, the codon spaces' 60 to 63
// states padded with zero rows and columns; float32).
//
// The CS-packed DNA kernels give a lane a whole category column (S = 4
// floats).  At S = 20 a column is 80 floats per child and an edge's
// matrices 1 600 floats, so the wide kernels spread a pattern over threads
// and a cluster of blocks: a thread-block cluster of K blocks owns a tile
// of consecutive patterns, block k holding the CB rate (or mixture x rate)
// categories k CB .. k CB + CB - 1, and a thread holds some of the
// patterns and RPT of each category's state rows.  CB = 1 up to 8
// categories (K = C, a block a category); past 8 (the protein mixtures,
// C = 40 for C10, 80 for C20) CB = ceil(C / 8) and K = ceil(C / CB) <= 8,
// the portable cluster size, the last block's missing categories padding
// (build.wide_layout).  Two walks of the slot schedule run on that layout:
// the upward walk (wide_forward.cu, wide_store.cu) and the reverse walk
// (wide_down_store.cu, wide_tbar.cu; wide_newton.cu keeps its own copy,
// whose step carries three matrices a child, at C <= 8, and a kernel of
// its own for DNA past 8).
//
// Each cluster walks the whole slot schedule for its tile, as a TPU grid
// step walks it (schedule rows: left child, right child, left slot,
// right slot (-1 = tip), output slot, output node; see cs_common.cuh).
// The kernels are templates on S and RPT with three instances
// (IQT_DISPATCH_WIDE_S): S = 20 (RPT = 5), S = 64 (RPT = CODON_RPT) and
// S = 4 (RPT = DNA_RPT), and on MULTI (CB > 1), instanced at S = 20 and
// S = 4: the codon instance keeps CB = 1 (C <= 8), and the DNA instance
// has MULTI only (multi_only: up to 8 categories the CS-packed kernels of
// cs_common.cuh serve DNA).  The CB = 1 instances run the one-category
// walks (cluster_upward_walk, cluster_reverse_walk).
// What differs at S = 64 is compile-time (`if constexpr (S > 32)`), so the
// S = 20 instance compiles as before:
//   * a message reads the child's rows from shared memory as it goes
//     (cluster_message_smem) where S = 20 loads the whole column into
//     registers first (a [64][QT] column would not fit);
//   * a pattern's G row groups sit GS = 32 / G lanes apart (WalkLane), not
//     on consecutive lanes: GS lanes then share a row group, so a
//     quarter-warp's float4 matrix loads read 8 / GS rows (2 at G = 8)
//     where consecutive lanes would read 8 rows of 64 floats, all in one
//     bank (an 8-way conflict).
// The wrappers pad a codon space's S to 64 with zeros (trans, tips, root
// weights, stored partials): a padded row stays 0 through every message,
// product, max and division, so the real rows, the maxima and the scales
// are those of the unpadded arithmetic.
#pragma once

#include <cooperative_groups.h>

#include "cs_common.cuh"

namespace iqtw {

using iqt::Step;
using iqt::load_step;

// ---------------------------------------------------------------------------
// The upward walk on thread-block clusters (wide_forward.cu, wide_store.cu).
//
// A cluster of K blocks, block k (its rank) holding the categories k CB ..
// k CB + CB - 1, owns a tile of consecutive patterns.  Thread (pq, g) of a
// block holds CLUSTER_QT consecutive patterns q = pq QT + qq and the RPT
// state rows g RPT .. g RPT + RPT - 1 of each of its categories (G = S /
// RPT consecutive lanes a pattern group), so a category warp (below) has
// tile / QT x G threads.  A block keeps only its categories' rows in its
// slot pool [slot][CB S + 1][tile] (category j's S rows at j S, then the
// patterns' log-scale, which every block of the cluster holds with the
// same bits).
// The walk at one category a block (CB = 1, K = C: up to 8 categories),
// cluster_upward_walk, runs a step as one unit: the category's [S,S] blocks
// of both children and each tip child's S indicator rows for the tile
// (every block reads its own copy, in 4-byte words: P need not be a
// multiple of 4) are cp.async copies into a ring CLUSTER_STAGES deep, one
// step a stage, issued as the stage they replace is released.
//
// Past 8 categories (cluster_upward_walk_multi) a block has W category
// warps of tile / QT x G threads each (least_units; a "warp" is one at the
// wrappers' 16 patterns a cluster), warp w taking the block's categories
// w, w + W, w + 2 W, ...: a step runs as U = ceil(CB / W) units, unit u
// the categories u W .. u W + W - 1, one a warp.  A ring stage holds a
// unit's W pairs of [S,S] blocks ([child][W][S*S], each child's blocks one
// run of trans); the tip rows, which do not depend on the category, are
// fetched once a step, with its first unit, into a tip area of their own
// ([step % STAGES][child][S][tile]: a stage's unit is released before the
// area of the step STAGES back is refilled).  Units past CB read nothing;
// a padding category (k CB + j >= C) reads nothing and holds zero rows.
//
// A unit's product rows go to the output slot unnormalized (the last
// unit's stay in registers), after a __syncwarp that ends the warp's reads
// of that category's child rows: the output slot may be a child's, whose
// other categories' rows are still to be read, and only the warp that
// writes a category reads its rows.  Between two units of a step one block
// barrier releases the stage.  The renormalizing max crosses a warp's
// categories' rows in registers, a pattern's G lanes in log2(G) shuffle
// rounds and the warps of every block through distributed shared memory:
// each warp stores its per-pattern max into every block's buffer
// [parity][rank W + warp][tile] (double-buffered by step parity), and one
// cluster barrier a step, which also publishes the ring's landed copies
// and releases the stage the step's last unit read, precedes the reads
// (a pattern's G lanes read a share each and meet in shuffles).  Then each
// thread divides its own rows in place, and every warp writes the
// patterns' scale row with the same bits, so that each warp's scale chain
// reads its own write (the next step reads a child's scale row with no
// barrier after the write).  A pattern's pool rows cross its G lanes,
// which share a warp, after a __syncwarp.
//
// The arithmetic is the row-group design's upward step for every
// category: each message's products in t order, the product of the two
// messages, the max (exact in any order), the float division's bits
// (div_rn, without its branches) and the scale chain sl + sr + log(max) in
// that order.  So the pool holds that design's bits, at any CB and W.
//
// cluster_upward_walk_multi at CB = 1 gives the same bits but made
// wide_forward ~8% slower on an H100 (PERF.md), so both stay, chosen by C.
//
// Shared memory a block (floats), with tile patterns, n_slots slots,
// STAGES = CLUSTER_STAGES and W category warps (1 at CB = 1):
//     STAGES x W x 2 S^2       the ring: W categories' blocks of both children
//   + STAGES x 2 S tile        the tip areas
//   + n_slots (CB S + 1) tile  the pool
//   + 2 K W tile               the max buffers
// (pruning.wide_forward_smem).
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

// State rows a thread at S = 64: G = 8 row groups a pattern.  The probe
// (`--codon`, NVIDIA H100, GY+F3X4+G4 at 80 taxa x 457 patterns; PERF.md)
// measured 8 rows 21% faster than 16 for wide_forward and wide_tbar at
// C=4 and 5-9% for the store and the outside store: at 16 the upward walk
// spilled at 128 registers (80 and no spill at 8), and half the threads
// carry the step's chain; only wide_down_store and wide_tbar at C=8 run
// 6-12% faster at 16.
constexpr int CODON_RPT = 8;

// State rows a thread at S = 4 (DNA past 8 categories): G = 4 row groups a
// pattern, so that a category warp of the upward walk is tile / 2 x 4
// threads and a team of the reverse walk tile x 4, as at S = 20: whole
// warps at the wrappers' 16 patterns a cluster.  A category's row is one
// float4 of its [S,S] block.
constexpr int DNA_RPT = 1;

// Whether the instance at S serves several categories a block only (the
// DNA instance: up to 8 categories the CS-packed kernels serve).
template <int S>
inline constexpr bool multi_only = S == 4;

// A walk thread's row group g (rows g RPT ..) and pattern-group index pq:
// a pattern's G lanes consecutive at S <= 32 (g = tid % G), GS = 32 / G
// lanes apart above (g = lane / GS); shuffles over a pattern's lanes run
// over the offsets GS, 2 GS, .. < GS G.
template <int S, int G>
struct WalkLane {
  static constexpr int GS = S > 32 ? 32 / G : 1;
  int g, pq;
  __device__ __forceinline__ explicit WalkLane(int tid) {
    if constexpr (GS == 1) {
      g = tid % G;
      pq = tid / G;
    } else {
      const int lane = tid & 31;
      g = lane / GS;
      pq = (tid >> 5) * GS + lane % GS;
    }
  }
};

// Patterns a thread: each staged matrix word loaded feeds CLUSTER_QT
// multiply-adds.
constexpr int CLUSTER_QT = 2;
// Steps whose matrices and tip rows are in flight at once (a cp.async ring).
constexpr int CLUSTER_STAGES = 2;
// Largest block of a cluster walk.
constexpr int CLUSTER_THREADS_MAX = 256;
// Largest block of the upward walk past 8 categories (W category warps of
// tile / QT x G threads): ten warps of 32 at C = 80, a register budget of
// 204 a thread (the launch bound of the walk's MULTI instances).
constexpr int MULTI_THREADS_MAX = 320;
// Dynamic shared memory a block may opt in to on an H100 (bytes;
// build.MAX_BLOCK_SMEM), an SM's (SM_SMEM) and what the card keeps of it
// for each resident block (BLOCK_SMEM_RESERVED).
constexpr size_t MAX_BLOCK_SMEM = 232448;
constexpr size_t SM_SMEM = 233472;
constexpr size_t BLOCK_SMEM_RESERVED = 1024;

// The portable cluster size: a cluster walk has at most 8 blocks.
constexpr int MAX_CLUSTER_BLOCKS = 8;

// The layout of C categories: CB categories a block (1 up to 8 categories,
// else ceil(C / 8)) on K = ceil(C / CB) blocks a cluster
// (build.wide_layout).
__device__ __host__ inline int wide_cb(int C) {
  return (C + MAX_CLUSTER_BLOCKS - 1) / MAX_CLUSTER_BLOCKS;
}
__device__ __host__ inline int wide_k(int C) {
  const int cb = wide_cb(C);
  return (C + cb - 1) / cb;
}

// Offsets (floats) of an upward walk's shared-memory arrays, CB categories
// a block on W category warps (MULTI; else one, and the offsets never read
// W: with W in them the one-category instances took 115 / 113 registers
// for 127 / 117 and wide_forward ran 7% slower at C = 4 on an H100,
// PERF.md).
template <int S, bool MULTI = false>
struct ClusterSmem {
  int tile, CB, W;
  __device__ __host__ ClusterSmem(int tile_, int CB_ = 1, int W_ = 1)
      : tile(tile_), CB(CB_), W(W_) {}
  __device__ __host__ size_t tips() const {
    return (size_t)CLUSTER_STAGES * (MULTI ? W : 1) * 2 * S * S;
  }
  __device__ __host__ size_t pool() const {
    return tips() + (size_t)CLUSTER_STAGES * 2 * S * tile;
  }
  __device__ __host__ size_t xmax(int n_slots) const {
    return pool() + (size_t)n_slots * (CB * S + 1) * tile;
  }
  __device__ __host__ size_t floats(int n_slots, int K) const {
    return xmax(n_slots) + 2 * (size_t)K * (MULTI ? W : 1) * tile;
  }
};

// Category warps (or teams) a block of a walk past 8 categories, at CB
// categories a block, `per_warp` threads each and bytes(W) bytes of shared
// memory a block: of the W = ceil(CB / U) whose block fits `threads_max`
// threads and the shared memory a block may have, the one of least (U +
// x) / b for b = min(2, blocks an SM's shared memory holds), then the most
// blocks an SM, then the most W; 1 when none fits (build.least_units).  b
// blocks an SM run side by side, and a step costs U units and about two
// units' time of exchange and cluster barrier upward (x = 2), 2 U units
// and as much reverse ((2 U + 2) / b: x = 1).  At C20's 80 categories on
// an H100 (PERF.md) that ranks every pair the probe timed as the card did
// (upward, 5 slots: 5 warps, two blocks an SM, 9.9 ms, against 10 warps,
// one block, 13.2; reverse, 38-39 ms at 2 teams and two blocks an SM or 5
// and one, 40.6 at 4, 48.7 at 3).  Registers (145-168 a thread) keep a
// third block of 5 upward warps off an SM.
template <typename Bytes>
inline int least_units(int CB, int x, int per_warp, int threads_max, Bytes bytes) {
  int best = 1, bu = CB, bb = 0;  // the best W, its units and its blocks an SM
  for (int U = 1; U <= CB; ++U) {
    const int W = (CB + U - 1) / U;
    const size_t by = bytes(W);
    if (W * per_warp > threads_max || by > MAX_BLOCK_SMEM) continue;
    const int b = SM_SMEM / (by + BLOCK_SMEM_RESERVED) > 1 ? 2 : 1;
    if ((U + x) * bb < (bu + x) * b || ((U + x) * bb == (bu + x) * b && b > bb))
      best = W, bu = U, bb = b;
  }
  return best;
}

// Step j's [S,S] blocks of category c for both children (mst_k
// [child][S*S]), as cp.async copies by the block's first T threads.
template <int S>
__device__ __forceinline__ void fetch_blocks(const Step& sj, float* mst_k, int c, int C,
                                             const float* __restrict__ trans, int T) {
  constexpr int SS = S * S;
  const int tid = threadIdx.x;
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

// Step j's [S,S] blocks of the n categories c .. c + n - 1 for both
// children into a ring stage of W categories' (mst_k [child][W][S*S]; each
// child's n blocks one run of trans), as cp.async copies by the block's
// threads.
template <int S>
__device__ __forceinline__ void fetch_unit_blocks(const Step& sj, float* mst_k, int c, int n,
                                                  int W, int C,
                                                  const float* __restrict__ trans) {
  constexpr int SS = S * S;
  static_assert(SS % 4 == 0, "a block is a run of 16-byte rows");
  const int V = n * SS / 4;  // 16-byte rows a child
  for (int q = threadIdx.x; q < 2 * V; q += blockDim.x) {
    const int side = q >= V, r = q - side * V;
    const int node = side ? sj.r : sj.l;
    __pipeline_memcpy_async(mst_k + (size_t)side * W * SS + 4 * r,
                            trans + ((size_t)node * C + c) * SS + 4 * r, 16);
  }
}

// Step j's tip children's S rows for the tile's patterns (tst_k
// [child][S][tile]; a ragged tail repeats P - 1), as cp.async copies by
// the block's threads, one pattern's words a thread (blockDim.x % tile ==
// 0).
template <int S>
__device__ __forceinline__ void fetch_tip_rows(const Step& sj, float* tst_k, int tile, int p0,
                                               const float* __restrict__ tips, int P) {
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

// Step j's inputs for category c into stage k: both children's [S,S]
// blocks (mst_k [child][S*S]) and each tip child's S rows for the tile's
// patterns (tst_k [child][S][tile]).
template <int S>
__device__ __forceinline__ void cluster_fetch(const Step& sj, float* mst_k, float* tst_k,
                                              int c, int C, int tile, int p0,
                                              const float* __restrict__ trans,
                                              const float* __restrict__ tips, int P) {
  fetch_blocks<S>(sj, mst_k, c, C, trans, blockDim.x);
  fetch_tip_rows<S>(sj, tst_k, tile, p0, tips, P);
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

// m[j][qq] = sum_t M[s0+j][t] x[t][q[qq]] with row t of x at xs + t tile
// in shared memory, read as the sums go, in message's order (t ascending):
// the form of the wide state counts (S > 32), whose [S][QT] column of x
// would not fit in registers.  A step of 4 t loads 4 x QT words of x and a
// float4 of each of the thread's RPT matrix rows.
template <int S, int RPT, int QT>
__device__ __forceinline__ void cluster_message_smem(const float* M, int s0,
                                                     const float* xs, int tile,
                                                     const int (&q)[QT],
                                                     float (&m)[RPT][QT]) {
  static_assert(S % 4 == 0, "matrix rows are float4 runs");
#pragma unroll
  for (int j = 0; j < RPT; ++j)
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) m[j][qq] = 0.f;
#pragma unroll 2
  for (int t = 0; t < S; t += 4) {
    float x[4][QT];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) x[u][qq] = xs[(t + u) * tile + q[qq]];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const float4 w = *reinterpret_cast<const float4*>(M + (s0 + j) * S + t);
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        m[j][qq] += w.x * x[0][qq];
        m[j][qq] += w.y * x[1][qq];
        m[j][qq] += w.z * x[2][qq];
        m[j][qq] += w.w * x[3][qq];
      }
    }
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
  const WalkLane<S, G> wl(threadIdx.x);
  const int g = wl.g, s0 = g * RPT, pq = wl.pq, GS = WalkLane<S, G>::GS;
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
      if constexpr (S > 32) {
        const float* xs = slot < 0 ? Tk + side * S * tile : pool + (size_t)slot * (S + 1) * tile;
        if (slot >= 0)
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) sc[qq] += xs[S * tile + q[qq]];
        if (side)
          cluster_message_smem<S, RPT, QT>(Mk + SS, s0, xs, tile, q, m);
        else
          cluster_message_smem<S, RPT, QT>(Mk, s0, xs, tile, q, y);
        continue;
      }
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
    for (int off = GS; off < GS * G; off <<= 1)
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

// The upward walk at several categories a block on W category warps (see
// above): this block's CB categories of the C and the tile of patterns p0
// ...  After each step emit(step, slot) sees the step's pool slot [CB S +
// 1][tile], normalized, whose columns of the warp's patterns the warp's
// lanes have written for the warp's categories (a __syncwarp before); the
// slot keeps them for the parent step, which may overwrite it after the
// next step's cluster barrier.  Returns the root's slot.  Every thread of
// every block of the cluster runs it; the caller passes a cluster barrier
// before it reads another block's pool.
template <int S, int RPT, typename Emit>
__device__ __forceinline__ int cluster_upward_walk_multi(const int* __restrict__ steps,
                                                         int n_steps,
                                                         const float* __restrict__ trans,
                                                         const float* __restrict__ tips,
                                                         int P, int p0, int tile, int n_slots,
                                                         int C, int CB, int W, float* smem,
                                                         Emit emit) {
  constexpr int G = S / RPT, SS = S * S, QT = CLUSTER_QT, NS = CLUSTER_STAGES;
  static_assert(S <= 32, "several categories a block at the register-column instance");
  static_assert(S % RPT == 0 && G <= 32 && (G & (G - 1)) == 0,
                "a pattern's row groups are a power of two of consecutive lanes");
  static_assert(G % QT == 0, "a block's threads are a multiple of its tile");
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  const int w = (int)threadIdx.x / (tile / QT * G);  // this thread's category warp
  const int g = (int)threadIdx.x % G, s0 = g * RPT, pq = (int)threadIdx.x / G % (tile / QT);
  const int SR = CB * S;            // a slot's state rows; its scale row follows
  const int U = (CB + W - 1) / W;   // units a step
  const int jl = (U - 1) * W + w;   // this warp's category of a step's last unit
  const ClusterSmem<S, true> lay(tile, CB, W);
  float* mst = smem;                       // [NS][2][W][SS]
  float* tst = smem + lay.tips();          // [NS][2][S][tile], a step's
  float* pool = smem + lay.pool();         // [n_slots][CB S + 1][tile]
  float* xmax = smem + lay.xmax(n_slots);  // [2][K W][tile]
  int q[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) q[qq] = pq * QT + qq;
  // unit u: step u / U, the block's categories (u % U) W .., in stage u %
  // NS; the step's first unit also fetches its tip rows
  const int n_units = n_steps * U;
  const auto fetch = [&](int u, const Step& sj, int k) {
    const int j0 = u % U * W, c0 = kb * CB + j0;
    const int n = min(W, min(CB - j0, C - c0));  // the unit's real categories
    if (n > 0) fetch_unit_blocks<S>(sj, mst + (size_t)k * 2 * W * SS, c0, n, W, C, trans);
    if (u % U == 0)
      fetch_tip_rows<S>(sj, tst + (size_t)(u / U % NS) * 2 * S * tile, tile, p0, tips, P);
  };

#pragma unroll
  for (int k = 0; k < NS; ++k) {
    if (k < n_units) fetch(k, load_step(steps, k / U), k);
    __pipeline_commit();
  }
  __pipeline_wait_prior(NS - 1);  // unit 0's copies have landed
  cluster.sync();  // every thread's, and every block of the cluster runs
  Step st = load_step(steps, 0);
  int uf = NS;  // the next unit to fetch
  Step st_f = uf < n_units ? load_step(steps, uf / U) : st;
  // unit uf into stage k, and the unit after it
  const auto fetch_next = [&](int k) {
    if (uf < n_units) fetch(uf, st_f, k);
    __pipeline_commit();
    ++uf;
    if (uf < n_units && uf % U == 0) st_f = load_step(steps, uf / U);
  };
  int k = 0;  // the stage of the unit
  for (int i = 0; i < n_steps; ++i) {
    const Step st_next = i + 1 < n_steps ? load_step(steps, i + 1) : st;
    float* out = pool + (size_t)st.out * (SR + 1) * tile;
    const float* Tt = tst + (size_t)(i % NS) * 2 * S * tile;
    float y[RPT][QT], sc[QT], mx[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) sc[qq] = mx[qq] = 0.f;
#pragma unroll
    for (int side = 0; side < 2; ++side) {  // the children's scales, left then right
      const int slot = side ? st.rs : st.ls;
      if (slot >= 0)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq)
          sc[qq] += pool[((size_t)slot * (SR + 1) + SR) * tile + q[qq]];
    }
    for (int u = 0; u < U; ++u) {
      const int j = u * W + w;  // this warp's category of the unit
      if (j < CB && kb * CB + j < C) {
        const float* Mk = mst + (size_t)k * 2 * W * SS + w * SS;  // [child] W SS apart
        float m[RPT][QT];
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          const int slot = side ? st.rs : st.ls;
          float x[S][QT];
          if (slot < 0) {
#pragma unroll
            for (int t = 0; t < S; ++t)
#pragma unroll
              for (int qq = 0; qq < QT; ++qq) x[t][qq] = Tt[(side * S + t) * tile + q[qq]];
          } else {
            const float* col = pool + ((size_t)slot * (SR + 1) + j * S) * tile;
#pragma unroll
            for (int t = 0; t < S; ++t)
#pragma unroll
              for (int qq = 0; qq < QT; ++qq) x[t][qq] = col[t * tile + q[qq]];
          }
          if (side)
            cluster_message<S, RPT, QT>(Mk + W * SS, s0, x, m);
          else
            cluster_message<S, RPT, QT>(Mk, s0, x, y);
        }
#pragma unroll
        for (int qq = 0; qq < QT; ++qq)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            y[r][qq] *= m[r][qq];
            mx[qq] = fmaxf(mx[qq], y[r][qq]);
          }
      } else {  // a padding category, or none: zero rows
#pragma unroll
        for (int r = 0; r < RPT; ++r)
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) y[r][qq] = 0.f;
      }
      if (u + 1 == U) break;  // the last unit's rows stay in registers
      __syncwarp();  // the warp's reads of category j's child rows are done
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) out[(j * S + s0 + r) * tile + q[qq]] = y[r][qq];
      __pipeline_wait_prior(NS - 2);  // this thread's copies of the next unit have landed
      __syncthreads();                // every thread's; stage k is released
      fetch_next(k);
      k = k == NS - 1 ? 0 : k + 1;
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
        mx[qq] = fmaxf(mx[qq], __shfl_xor_sync(0xffffffffu, mx[qq], off));
    float* xm = xmax + (size_t)(i & 1) * K * W * tile;
    for (int r = g; r < K; r += G) {  // the G lanes of a pattern group share the blocks out
      float* xr = cluster.map_shared_rank(xm, r) + (kb * W + w) * tile;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) xr[q[qq]] = mx[qq];
    }
    __pipeline_wait_prior(NS - 2);  // this thread's copies of the next unit have landed
    cluster.sync();  // one barrier a step: the maxima, the ring, the stage read
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {  // a pattern's G lanes read K W / G maxima each
      mx[qq] = 0.f;
      for (int r = g; r < K * W; r += G) mx[qq] = fmaxf(mx[qq], xm[r * tile + q[qq]]);
    }
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq)
        mx[qq] = fmaxf(mx[qq], __shfl_xor_sync(0xffffffffu, mx[qq], off));
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) mx[qq] = fmaxf(mx[qq], SCALE_TINY);
    // the step's child reads are done: the output slot may be one they
    // held.  The earlier units' rows are this thread's own.
    for (int j = w; j < jl; j += W)
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) {
          float* o = out + (j * S + s0 + r) * tile + q[qq];
          *o = iqt::div_rn(*o, mx[qq]);
        }
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      if (jl < CB)
#pragma unroll
        for (int r = 0; r < RPT; ++r)
          out[(jl * S + s0 + r) * tile + q[qq]] = iqt::div_rn(y[r][qq], mx[qq]);
      sc[qq] += logf(mx[qq]);
      if (g == 0) out[SR * tile + q[qq]] = sc[qq];  // every warp: the same bits
    }
    // stage k is free: the unit NS on into it
    fetch_next(k);
    __syncwarp();  // the pattern group's pool rows are written
    emit(st, static_cast<const float*>(out));
    st = st_next;
    k = k == NS - 1 ? 0 : k + 1;
  }
  return st.out;
}

// ---------------------------------------------------------------------------
// The reverse walk on thread-block clusters (wide_down_store.cu,
// wide_tbar.cu).
//
// The walk runs the slot schedule from its last step (the root's) down.
// Each step takes the parent's pushed outside vector d (at the root the
// seed rootd [C*S]), forms both child messages m = P U (t ascending) from
// the stored partials up [2N, C*S, P] (tip rows filled by the caller), and
// for each child
//     o = d * m_sib,  O = o / max,  osc = dsc + usc_sib + log(max),
// with the max over the pattern's C*S rows, and pushes D = P^T O (s
// ascending) into an internal child's pool slot, where its own step finds
// it.  The root and dummy rows are no step's children.
//
// Layout: the cluster of C blocks, one a rate category, owns a tile of
// consecutive patterns; walk thread (q, g) of a block holds one pattern q
// (REVERSE_QT = 1) and the RPT state rows g RPT .. of its category (G = S
// / RPT consecutive lanes a pattern), tile x G walk threads.  A ring
// REVERSE_STAGES deep brings each step's copies ahead (cp.async): the
// category's [S,S] block of each child and each child's S rows and scale
// for the tile, step i - 1's issued in step i after its exchange, into the
// stage step i + 1 held.  The max crosses the
// category's rows in log2(G) shuffle rounds and the categories through
// distributed shared memory: every block stores its per-pattern maxima
// into every block's buffer [parity][rank][child][tile], double-buffered
// by step parity, before the step's cluster barrier.  O = div_rn(o, max)
// goes to a stage [child][S][tile]; the push reads a pattern's O column
// from it.
//
// Barriers: a step opens with one block barrier, named barrier
// RING_BARRIER over all the block's threads (step i's copies have landed
// everywhere), and has one cluster barrier (the exchange), after which
// step i + 1's ring stage, O's stage and the max buffers of step i + 1's
// parity are rewritten.  Threads of the block outside the walk (wide_tbar's
// sum warps) take part in both, in order, and in the cluster barrier
// before the first step; they may arrive at the block barrier without
// waiting (bar.arrive).
//
// hook(st, ost, osc, Uk) runs once a step, after the __syncwarp that
// follows O's stage: ost is the stage [child][S][tile], whose columns of
// the warp's patterns are written, osc[child][qq] this thread's patterns'
// log-scales, Uk the ring stage [child][S+1][tile] (the children's S rows,
// then their scales).  The stage and the ring stage hold until the next
// step's cluster barrier.
//
// The orders are the row-group design's: messages with t ascending, an
// exact max, the float division's bits (div_rn, without its branches), the
// scale chain dsc + s_sib + log(max) and the push with s ascending.  A
// ragged last tile computes with pattern P - 1.
//
// Past 8 categories (cluster_reverse_walk_multi) a block holds CB
// categories on W category teams of tile / REVERSE_QT x G threads each
// (one team is the walk of one category a block), team w taking the
// block's categories w, w + W, w + 2 W, ...: each phase of a step runs as U
// = ceil(CB / W) units, unit u the categories u W .. u W + W - 1, one a
// team.  A ring stage holds a unit's inputs for its W categories -- both
// children's [S,S] blocks ([child][W][S*S], each child's blocks one run of
// trans) and their S rows and scale for the tile ([W][child][S+1][tile]).
// Phase A: each unit, for each of its categories, d from the pool (the
// root seed), both messages and o = d * m_sib, unnormalized into O's stage
// [child][CB S][tile] (the last unit's stay in registers), and the running
// max.  Then the exchange: each team's per-pattern maxima go into every
// block's buffer [parity][rank][child][tile] (past one team an atomic
// integer max of the float bits: o >= 0, so it is the float max, exact in
// any order; each buffer zeroed again at the step after its reads) and one
// cluster barrier.  Phase B: each unit, its categories' O rows divided
// (div_rn), the hook and the push D = P^T O with the unit's matrices,
// fetched again, except at U = 1, where phase B reads phase A's stage and
// opens no unit.  A unit opens with a block barrier over all the block's
// threads, after which the copies of the unit REVERSE_STAGES - 1 on are
// issued into a free stage of the ring of NS stages (NS = REVERSE_STAGES,
// or one more where wide_tbar's sums lag a unit behind the walk:
// reverse_sums_multi).  A unit's copies are indexed by counters, not
// divisions: at one or two warps a scheduler every instruction between a
// unit's barrier and its arithmetic is on the chain (the first build,
// with a division or two a unit, ran 50% slower at one team than the
// one-team walk before it, on an H100; PERF.md).  A team's categories
// stay its own, so the d it reads in phase A and the child rows it pushes
// in phase B are rows of the same categories (a child may reuse st.out),
// and only team 0 writes a child slot's scale row, which every team reads
// at the child's step, after at least one block barrier.  The orders, and
// so the bits of every category, are those of one category a block, at
// any W.
//
// Shared memory a block (floats), with tile patterns, n_slots slots, CB
// categories a block on K blocks, NS ring stages of W categories (NS =
// REVERSE_STAGES and W = 1 at one category a block;
// cs_kernels.wide_down_store_smem):
//     NS W (2 S^2 + 2 (S+1) tile)   the ring
//   + n_slots (CB S + 1) tile       the pool
//   + 2 CB S tile                   O's stage
//   + 4 K tile                      the max buffers
// ---------------------------------------------------------------------------

// Steps whose matrices and child partials are in flight at once (a
// cp.async ring).
constexpr int REVERSE_STAGES = 2;
// Patterns a walk thread: one, where the upward walk's threads hold two
// (CLUSTER_QT): a reverse step is about twice an upward step's work.
constexpr int REVERSE_QT = 1;
// Largest block of wide_down_store past 8 categories (W category teams of
// tile / REVERSE_QT x G threads): five teams of 64 at 16 patterns a
// cluster (the launch bound of its MULTI instance).
constexpr int REVERSE_MULTI_THREADS_MAX = 320;

// Offsets (floats) of a reverse walk's shared-memory arrays: CB categories
// a block on W category teams and a ring of NS stages of W categories'
// inputs (MULTI; at one category a block the ring is REVERSE_STAGES
// stages of one, and the offsets never read W or NS).
template <int S, bool MULTI = false>
struct ReverseSmem {
  int tile, CB, W, NS;
  __device__ __host__ ReverseSmem(int tile_, int CB_ = 1, int W_ = 1,
                                  int NS_ = REVERSE_STAGES)
      : tile(tile_), CB(CB_), W(W_), NS(NS_) {}
  // the ring's stages of one category's inputs
  __device__ __host__ size_t ring() const {
    return MULTI ? (size_t)NS * W : (size_t)REVERSE_STAGES;
  }
  __device__ __host__ size_t rows() const { return ring() * 2 * S * S; }
  __device__ __host__ size_t pool() const { return rows() + ring() * 2 * (S + 1) * tile; }
  __device__ __host__ size_t ost(int n_slots) const {
    return pool() + (size_t)n_slots * (CB * S + 1) * tile;
  }
  __device__ __host__ size_t xmax(int n_slots) const {
    return ost(n_slots) + 2 * (size_t)CB * S * tile;
  }
  __device__ __host__ size_t floats(int n_slots, int K) const {
    return xmax(n_slots) + 4 * (size_t)K * tile;
  }
};

// Step j's inputs for category c into stage k, by the T walk threads: both
// children's [S,S] blocks (mst_k [child][S*S]) and their S rows and scale
// for the tile's patterns (ust_k [child][S+1][tile]; a ragged tail repeats
// P - 1).
template <int S>
__device__ __forceinline__ void reverse_fetch(const Step& sj, float* mst_k, float* ust_k,
                                              int c, int C, int tile, int p0, int T,
                                              const float* __restrict__ trans,
                                              const float* __restrict__ up,
                                              const float* __restrict__ usc, int P) {
  fetch_blocks<S>(sj, mst_k, c, C, trans, T);
  // a thread copies one pattern's words (T % tile == 0)
  const int tid = threadIdx.x;
  const int qq = tid % tile, p = min(p0 + qq, P - 1);
  for (int row = tid / tile; row < 2 * (S + 1); row += T / tile) {
    const int side = row / (S + 1), t = row - side * (S + 1);
    const int node = side ? sj.r : sj.l;
    const float* src = t < S ? up + ((size_t)node * C * S + c * S + t) * P + p
                             : usc + (size_t)node * P + p;
    __pipeline_memcpy_async(ust_k + row * tile + qq, src, 4);
  }
}

// The cluster barrier of a reverse step's exchange.
__device__ __forceinline__ void reverse_barrier(cg::cluster_group& cluster) {
  cluster.sync();
}

// The named barrier that opens a reverse step (all the block's threads).
constexpr int RING_BARRIER = 2;
__device__ __forceinline__ void ring_barrier() {
  asm volatile("bar.sync %0, %1;" ::"r"(RING_BARRIER), "r"(blockDim.x) : "memory");
}

// The whole reverse walk for this block's category and the tile of
// patterns p0 .. p0 + tile - 1 (see above).  Every walk thread (the
// block's first tile / REVERSE_QT x S / RPT) of every block of the cluster
// runs it.
template <int S, int RPT, typename Hook>
__device__ __forceinline__ void cluster_reverse_walk(const int* __restrict__ steps,
                                                     int n_steps,
                                                     const float* __restrict__ trans,
                                                     const float* __restrict__ rootd,
                                                     const float* __restrict__ up,
                                                     const float* __restrict__ usc, int P,
                                                     int p0, int tile, int n_slots,
                                                     float* smem, Hook hook) {
  constexpr int G = S / RPT, SS = S * S, QT = REVERSE_QT, NS = REVERSE_STAGES;
  static_assert(S % RPT == 0 && G <= 32 && (G & (G - 1)) == 0,
                "a pattern's row groups are a power of two of consecutive lanes");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const WalkLane<S, G> wl(threadIdx.x);
  const int g = wl.g, s0 = g * RPT, pq = wl.pq, GS = WalkLane<S, G>::GS;
  const int T = tile / QT * G;  // the walk threads
  const ReverseSmem<S> lay(tile);
  float* mst = smem;                   // [NS][2][SS]
  float* ust = smem + lay.rows();      // [NS][2][S+1][tile]
  float* pool = smem + lay.pool();     // [n_slots][S+1][tile]
  float* ost = smem + lay.ost(n_slots);    // [2][S][tile]
  float* xmax = smem + lay.xmax(n_slots);  // [2][C][2][tile]
  int q[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) q[qq] = pq * QT + qq;

  // the walk runs from step n_steps - 1 down; step i's inputs sit in stage
  // (n_steps - 1 - i) % NS
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) {
    if (k < n_steps)
      reverse_fetch<S>(load_step(steps, n_steps - 1 - k), mst + k * 2 * SS,
                       ust + (size_t)k * 2 * (S + 1) * tile, c, C, tile, p0, T, trans, up,
                       usc, P);
    __pipeline_commit();
  }
  cluster.sync();  // every block of the cluster runs before the first remote store
  Step st = load_step(steps, n_steps - 1);
  Step st_f = n_steps >= NS ? load_step(steps, n_steps - NS) : st;  // the next fetch
  int k = 0;  // the stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    __pipeline_wait_prior(NS - 2);  // this thread's copies of step i have landed
    ring_barrier();                 // every thread's
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;

    const float* Mk = mst + k * 2 * SS;  // [child][S][S]
    const float* Uk = ust + (size_t)k * 2 * (S + 1) * tile;
    float d[RPT][QT], dsc[QT], s_sib[2][QT];  // s_sib[side]: the other child's scale
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      s_sib[0][qq] = Uk[(2 * S + 1) * tile + q[qq]];
      s_sib[1][qq] = Uk[S * tile + q[qq]];
      if (i == n_steps - 1) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) d[j][qq] = __ldg(rootd + c * S + s0 + j);
        dsc[qq] = 0.f;
      } else {
        const float* col = pool + (size_t)st.out * (S + 1) * tile + q[qq];
#pragma unroll
        for (int j = 0; j < RPT; ++j) d[j][qq] = col[(s0 + j) * tile];
        dsc[qq] = col[S * tile];
      }
    }
    float m[2][RPT][QT];  // both children's messages P U
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      if constexpr (S > 32) {
        cluster_message_smem<S, RPT, QT>(Mk + side * SS, s0, Uk + side * (S + 1) * tile, tile,
                                         q, m[side]);
        continue;
      }
      float x[S][QT];
      const float* U = Uk + side * (S + 1) * tile;
#pragma unroll
      for (int t = 0; t < S; ++t)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) x[t][qq] = U[t * tile + q[qq]];
      cluster_message<S, RPT, QT>(Mk + side * SS, s0, x, m[side]);
    }

    // o = d * m_sib for each child and its max over the pattern's C*S rows
    float o[2][RPT][QT], mx[2][QT];
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        mx[side][qq] = 0.f;
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          o[side][j][qq] = d[j][qq] * m[1 - side][j][qq];
          mx[side][qq] = fmaxf(mx[side][qq], o[side][j][qq]);
        }
      }
#pragma unroll
    for (int off = GS; off < GS * G; off <<= 1)
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq)
          mx[side][qq] = fmaxf(mx[side][qq], __shfl_xor_sync(0xffffffffu, mx[side][qq], off));
    float* xm = xmax + (size_t)(i & 1) * C * 2 * tile;
    for (int r = g; r < C; r += G) {  // the G lanes of a pattern group share the blocks out
      float* xr = cluster.map_shared_rank(xm, r) + c * 2 * tile;
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) xr[side * tile + q[qq]] = mx[side][qq];
    }
    reverse_barrier(cluster);  // the exchange: every block's maxima of step i are written
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        mx[side][qq] = 0.f;
        for (int r = 0; r < C; ++r)
          mx[side][qq] = fmaxf(mx[side][qq], xm[(r * 2 + side) * tile + q[qq]]);
        mx[side][qq] = fmaxf(mx[side][qq], SCALE_TINY);
      }
    // step i + 1's stage is free: step i - NS + 1 into it
    const int kf = k == 0 ? NS - 1 : k - 1;
    if (i >= NS - 1)
      reverse_fetch<S>(st_f, mst + kf * 2 * SS, ust + (size_t)kf * 2 * (S + 1) * tile, c, C,
                       tile, p0, T, trans, up, usc, P);
    __pipeline_commit();
    if (i >= NS) st_f = load_step(steps, i - NS);

    // O = o / max into the stage, and its scale
    float sc[2][QT];
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
#pragma unroll
        for (int j = 0; j < RPT; ++j)
          ost[(side * S + s0 + j) * tile + q[qq]] = iqt::div_rn(o[side][j][qq], mx[side][qq]);
        sc[side][qq] = dsc[qq] + s_sib[side][qq] + logf(mx[side][qq]);
      }
    __syncwarp();  // the pattern group's O rows are staged
    hook(st, static_cast<const float*>(ost), sc, Uk);

    // the children's outside partials, pushed through their edges (P^T O),
    // wait in the pool for their own steps (d is read: a child may reuse
    // st.out); a pattern's O column comes from the stage
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int cslot = side ? st.rs : st.ls;
      if (cslot < 0) continue;
      const float* M = Mk + side * SS;  // the child's P
      const float* os = ost + side * S * tile;
      float dd[RPT][QT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) dd[j][qq] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float os_[QT];
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) os_[qq] = os[s * tile + q[qq]];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float w = M[s * S + s0 + j];
#pragma unroll
          for (int qq = 0; qq < QT; ++qq) dd[j][qq] += w * os_[qq];
        }
      }
      float* col = pool + (size_t)cslot * (S + 1) * tile;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
#pragma unroll
        for (int j = 0; j < RPT; ++j) col[(s0 + j) * tile + q[qq]] = dd[j][qq];
        if (g == 0) col[S * tile + q[qq]] = sc[side][qq];
      }
    }
    st = st_next;
    k = k == NS - 1 ? 0 : k + 1;
  }
}

// A unit's inputs of the reverse walk past 8 categories: the n categories
// c0 .. c0 + n - 1 of step sj (n <= W) into a ring stage of W categories
// (mst_k [child][W][S*S], ust_k [W][child][S+1][tile]; a ragged tail
// repeats P - 1), as cp.async copies by the T walk threads.  A thread
// copies the words of pattern p (its column qq of the tile) in rows r0,
// r0 + rstep, ... of each category's 2 (S+1) (T % tile == 0).  The copies
// open every unit of the walk's chain, so they take no division.
template <int S>
__device__ __forceinline__ void reverse_fetch_unit(const Step& sj, float* mst_k, float* ust_k,
                                                   int c0, int n, int W, int C, int tile,
                                                   int T, int qq, int r0, int rstep, int p,
                                                   const float* __restrict__ trans,
                                                   const float* __restrict__ up,
                                                   const float* __restrict__ usc, int P) {
  constexpr int SS = S * S;
  static_assert(SS % 4 == 0, "a block is a run of 16-byte rows");
  const int V = n * SS / 4;  // 16-byte rows a child
  const float* ml = trans + ((size_t)sj.l * C + c0) * SS;
  const float* mr = trans + ((size_t)sj.r * C + c0) * SS;
  for (int x = threadIdx.x; x < 2 * V; x += T) {
    const int side = x >= V, r = x - side * V;
    __pipeline_memcpy_async(mst_k + (size_t)side * W * SS + 4 * r, (side ? mr : ml) + 4 * r, 16);
  }
  const float* scl = usc + (size_t)sj.l * P + p;
  const float* scr = usc + (size_t)sj.r * P + p;
  for (int jj = 0; jj < n; ++jj) {
    const float* bl = up + ((size_t)sj.l * C + c0 + jj) * S * P + p;
    const float* br = up + ((size_t)sj.r * C + c0 + jj) * S * P + p;
    float* dst = ust_k + (size_t)jj * 2 * (S + 1) * tile + qq;
    for (int row = r0; row < 2 * (S + 1); row += rstep) {
      const int side = row > S, t = row - side * (S + 1);
      const float* src = t < S ? (side ? br : bl) + (size_t)t * P : side ? scr : scl;
      __pipeline_memcpy_async(dst + row * tile, src, 4);
    }
  }
}

// The reverse walk at CB > 1 categories a block on W category teams and a
// ring of NS stages (see above), for the block's categories kb CB .. of the
// C and the tile of patterns p0 .. p0 + tile - 1.  Every walk thread (the
// block's first W x tile x S / RPT) of every block of the cluster runs it;
// the block's other threads run reverse_sums_multi alongside.  hook(st, j,
// c, O, osc, Uk) runs in each phase B unit, after the __syncwarp that
// follows the team's category j's O rows: O those rows in O's stage (child
// `side` at O + side CB S tile, S rows of tile patterns), whose columns of
// the warp's patterns are written, osc[child][qq] this thread's patterns'
// log-scales, Uk the category's rows in the ring stage [child][S+1][tile];
// c >= C is no real category (padding, or j >= CB in a ragged last unit),
// whose rows hold nothing.  j = 0 is team 0's, at each step's first phase
// B unit.
template <int S, int RPT, typename Hook>
__device__ __forceinline__ void cluster_reverse_walk_multi(
    const int* __restrict__ steps, int n_steps, const float* __restrict__ trans,
    const float* __restrict__ rootd, const float* __restrict__ up,
    const float* __restrict__ usc, int P, int p0, int tile, int n_slots, int C, int CB, int W,
    int NS, float* smem, Hook hook) {
  constexpr int G = S / RPT, SS = S * S, QT = REVERSE_QT;
  static_assert(S <= 32 && QT == 1, "the multi-category walk is the register-column instances'");
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  const int T = tile / QT * G;  // a team's threads
  const int w = (int)threadIdx.x / T;  // this thread's team
  const WalkLane<S, G> wl((int)threadIdx.x % T);
  const int g = wl.g, s0 = g * RPT, q = wl.pq;
  const int SR = CB * S, U = (CB + W - 1) / W;  // a slot's state rows; units a phase
  const int F = U == 1 ? 1 : 2 * U;  // fetch units a step
  const int RS = 2 * (S + 1) * tile;  // a category's rows in a stage
  const ReverseSmem<S, true> lay(tile, CB, W, NS);
  float* mst = smem;                       // [NS][2][W][SS]
  float* ust = smem + lay.rows();          // [NS][W][2][S+1][tile]
  float* pool = smem + lay.pool();         // [n_slots][CB S + 1][tile]
  float* ost = smem + lay.ost(n_slots);    // [2][CB S][tile]
  float* xmax = smem + lay.xmax(n_slots);  // [2][K][2][tile]
  const int MS = 2 * W * SS, US = W * RS;  // a stage's floats of each
  // the next fetch unit: its step i (its schedule row sf), its unit fu of
  // the step (phase A's, then B's), its stage fk; a thread copies the
  // words of its pattern column of the rows fr0, fr0 + frs, ...
  const int fq = (int)threadIdx.x % tile, fr0 = (int)threadIdx.x / tile, frs = W * T / tile;
  const int fp = min(p0 + fq, P - 1);
  int fi = n_steps - 1, fu = 0, fk = 0;
  Step sf = load_step(steps, fi);
  const auto fetch = [&]() {
    if (fi >= 0) {
      const int j0 = (fu < U ? fu : fu - U) * W, c0 = kb * CB + j0;
      const int n = min(W, min(CB - j0, C - c0));  // the unit's real categories
      if (n > 0)
        reverse_fetch_unit<S>(sf, mst + (size_t)fk * MS, ust + (size_t)fk * US, c0, n, W, C,
                              tile, W * T, fq, fr0, frs, fp, trans, up, usc, P);
      if (++fu == F) {
        fu = 0;
        if (--fi >= 0) sf = load_step(steps, fi);  // landed by the next fetch
      }
      fk = fk + 1 == NS ? 0 : fk + 1;
    }
    __pipeline_commit();
  };
  // a unit opens: its copies have landed everywhere, every thread is done
  // with the unit NS - REVERSE_STAGES + 1 back, whose stage takes the unit
  // REVERSE_STAGES - 1 on; returns the unit's stage
  int k = 0;  // the stage of the unit that opens next
  const auto open = [&]() {
    __pipeline_wait_prior(REVERSE_STAGES - 2);
    ring_barrier();
    fetch();
    const int ko = k;
    k = k + 1 == NS ? 0 : k + 1;
    return ko;
  };
#pragma unroll
  for (int x = 0; x < REVERSE_STAGES - 1; ++x) fetch();
  if (W > 1)  // the max buffers start at 0 (atomic maxima)
    for (int x = threadIdx.x; x < 4 * K * tile; x += W * T) xmax[x] = 0.f;
  cluster.sync();  // every block of the cluster runs before the first remote store
  Step st = load_step(steps, n_steps - 1);
  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;
    float dsc = 0.f, s_sib[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f}, o[2][RPT];
    const float* dcol = pool + (size_t)st.out * (SR + 1) * tile + q;
    int ka = 0;  // the stage of phase A's last unit
    for (int u = 0; u < U; ++u) {  // phase A
      ka = open();
      const float* Us = ust + (size_t)ka * US;
      if (u == 0) {  // from the unit's first category, real (K = ceil(C / CB))
        s_sib[0] = Us[(2 * S + 1) * tile + q];
        s_sib[1] = Us[S * tile + q];
        dsc = i == n_steps - 1 ? 0.f : dcol[SR * tile];
        if (W > 1 && i < n_steps - 1) {  // step i + 1's maxima are read: zeroed for step i - 1
          float* xp = xmax + (size_t)((i + 1) & 1) * K * 2 * tile;
          for (int x = threadIdx.x; x < 2 * K * tile; x += W * T) xp[x] = 0.f;
        }
      }
      const int j = u * W + w, c = kb * CB + j;  // this team's category of the unit
      if (j >= CB || c >= C) continue;
      const float* Mk = mst + (size_t)ka * MS + w * SS;  // [child] W SS apart
      const float* Uk = Us + w * RS;
      float d[RPT];
#pragma unroll
      for (int r = 0; r < RPT; ++r)
        d[r] = i == n_steps - 1 ? __ldg(rootd + c * S + s0 + r) : dcol[(j * S + s0 + r) * tile];
      float m[2][RPT][QT];  // both children's messages P U
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        float x[S][QT];
        const float* Ux = Uk + side * (S + 1) * tile;
#pragma unroll
        for (int t = 0; t < S; ++t) x[t][0] = Ux[t * tile + q];
        cluster_message<S, RPT, QT>(Mk + side * W * SS, s0, x, m[side]);
      }
#pragma unroll
      for (int side = 0; side < 2; ++side)
#pragma unroll
        for (int r = 0; r < RPT; ++r) {
          const float ov = d[r] * m[1 - side][r][0];
          mx[side] = fmaxf(mx[side], ov);
          if (u + 1 < U)
            ost[(side * SR + j * S + s0 + r) * tile + q] = ov;
          else
            o[side][r] = ov;  // the last unit's rows stay in registers
        }
    }
    // the exchange: the max over the pattern's C S rows
#pragma unroll
    for (int off = 1; off < G; off <<= 1)
#pragma unroll
      for (int side = 0; side < 2; ++side)
        mx[side] = fmaxf(mx[side], __shfl_xor_sync(0xffffffffu, mx[side], off));
    float* xm = xmax + (size_t)(i & 1) * K * 2 * tile;
    for (int r = g; r < K; r += G) {
      float* xr = cluster.map_shared_rank(xm, r) + kb * 2 * tile;
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        if (W == 1)
          xr[side * tile + q] = mx[side];
        else
          atomicMax(reinterpret_cast<unsigned*>(xr + side * tile + q), __float_as_uint(mx[side]));
      }
    }
    reverse_barrier(cluster);
    float sc[2][QT];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      mx[side] = 0.f;
      for (int r = 0; r < K; ++r) mx[side] = fmaxf(mx[side], xm[(r * 2 + side) * tile + q]);
      mx[side] = fmaxf(mx[side], SCALE_TINY);
      sc[side][0] = dsc + s_sib[side] + logf(mx[side]);
    }
    for (int u = 0; u < U; ++u) {  // phase B
      const int kB = U > 1 ? open() : ka;
      const int j = u * W + w, c = kb * CB + j;
      const bool real = j < CB && c < C;
      const float* Mk = mst + (size_t)kB * MS + w * SS;
      const float* Uk = ust + (size_t)kB * US + w * RS;
      float* O = ost + (size_t)j * S * tile;
      if (real)
#pragma unroll
        for (int side = 0; side < 2; ++side)
#pragma unroll
          for (int r = 0; r < RPT; ++r) {
            float* ov = O + (side * SR + s0 + r) * tile + q;
            *ov = iqt::div_rn(u + 1 < U ? *ov : o[side][r], mx[side]);
          }
      __syncwarp();  // the pattern group's O rows are normalized
      hook(st, j, real ? c : C, static_cast<const float*>(O), sc, Uk);
      if (!real) continue;
      // the children's outside partials, pushed through their edges (P^T
      // O), wait in the pool for their own steps (d was read in phase A by
      // this team: a child may reuse st.out)
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int cslot = side ? st.rs : st.ls;
        if (cslot < 0) continue;
        const float* M = Mk + side * W * SS;  // the child's P
        const float* os = O + side * SR * tile;
        float dd[RPT];
#pragma unroll
        for (int r = 0; r < RPT; ++r) dd[r] = 0.f;
#pragma unroll
        for (int s = 0; s < S; ++s) {
          const float ov = os[s * tile + q];
#pragma unroll
          for (int r = 0; r < RPT; ++r) dd[r] += M[s * S + s0 + r] * ov;
        }
        float* col = pool + (size_t)cslot * (SR + 1) * tile + q;
#pragma unroll
        for (int r = 0; r < RPT; ++r) col[(j * S + s0 + r) * tile] = dd[r];
        if (g == 0 && j == 0) col[SR * tile] = sc[side][0];
      }
    }
    st = st_next;
  }
  ring_barrier();  // the last unit's O rows are written for threads outside the walk
}

// The barriers of cluster_reverse_walk_multi for a block's threads outside
// the walk (wide_tbar's sum warps), in its order, and their work: unit(st,
// u, k) runs once for each phase B unit u of step st, with the unit's ring
// stage k.  In lock step (a ring of REVERSE_STAGES) after the unit's hook
// barrier (the walk's sums_arrive, `wait` here) and before the next unit
// opens, so the walk waits for it there.  With a deeper ring a unit's work
// lags one unit behind the walk: it runs after the next unit's opening
// barrier (at U = 1 the next step's first), beside the walk's next unit.
// Its stage is refilled only at the opening after that, its O rows only in
// the next step (phase A keeps its last unit's rows in registers, and a
// unit before the last writes other categories' rows) and fac at the next
// step's phase B, after the exchange these threads join once their work is
// done.  The walk ends with a block barrier more, after which the last
// unit's work runs.
template <typename Wait, typename Unit>
__device__ __forceinline__ void reverse_sums_multi(const int* __restrict__ steps,
                                                   int n_steps, int CB, int W, int NS,
                                                   Wait wait, Unit unit) {
  cg::cluster_group cluster = cg::this_cluster();
  const int U = (CB + W - 1) / W;
  const bool lag = NS > REVERSE_STAGES;
  Step ps = {};        // the lagging unit's step
  int pu = -1, pk = 0;  // the lagging unit (none: -1) and its stage
  int k = 0;           // the stage of the unit that opens next
  const auto open = [&]() {
    ring_barrier();
    if (pu >= 0) unit(ps, pu, pk);
    pu = -1;
    const int ko = k;
    k = k + 1 == NS ? 0 : k + 1;
    return ko;
  };
  cluster.sync();
  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    int ka = 0;
    for (int u = 0; u < U; ++u) ka = open();
    reverse_barrier(cluster);
    for (int u = 0; u < U; ++u) {
      const int k = U > 1 ? open() : ka;
      if (lag) {
        ps = st, pu = u, pk = k;
      } else {
        wait();
        unit(st, u, k);
      }
    }
  }
  ring_barrier();  // the walk's last
  if (pu >= 0) unit(ps, pu, pk);
}

// The launch of `clusters` thread-block clusters of K blocks (wide_k: one a
// rate category up to 8, else CB categories each) of `threads` threads and
// `smem` bytes of shared memory.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int clusters, int K, int threads, size_t smem, void* stream) {
    cfg.gridDim = dim3(clusters * K);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = (cudaStream_t)stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
};

// Launch `kernel` as a ClusterLaunch.
template <typename... Params, typename... Args>
inline cudaError_t launch_clusters(void (*kernel)(Params...), int clusters, int K,
                                   int threads, size_t smem, void* stream, Args... args) {
  cudaError_t e = iqt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  ClusterLaunch l(clusters, K, threads, smem, stream);
  return cudaLaunchKernelEx(&l.cfg, kernel, args...);
}

// The most clusters of `kernel`'s launch the card holds at once
// (cudaOccupancyMaxActiveClusters) into *n.
template <typename... Params>
inline cudaError_t active_clusters(void (*kernel)(Params...), int K, int threads, size_t smem,
                                   int* n) {
  cudaError_t e = iqt::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  ClusterLaunch l(1, K, threads, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(n, kernel, &l.cfg);
}

// An upward walk's launch at C categories, tile patterns a cluster and
// n_slots slots: K blocks of CB categories, W category warps of `team`
// threads (least_units past 8 categories, else 1) and the shared memory of
// ClusterSmem.  `team` is 0 for a tile whose warps are not whole or too
// large.
template <int S, int RPT>
struct UpwardLaunch {
  int K, CB, team, W, threads;
  size_t smem;
  UpwardLaunch(int C, int tile, int n_slots)
      : K(wide_k(C)), CB(wide_cb(C)), team(tile / CLUSTER_QT * (S / RPT)) {
    if (team % 32 || team > CLUSTER_THREADS_MAX) team = 0;
    const auto bytes = [&](int w) {
      return ClusterSmem<S, true>(tile, CB, w).floats(n_slots, K) * sizeof(float);
    };
    W = CB > 1 && team ? least_units(CB, 2, team, MULTI_THREADS_MAX, bytes) : 1;
    threads = W * team;
    smem = ClusterSmem<S, true>(tile, CB, W).floats(n_slots, K) * sizeof(float);
  }
};

}  // namespace iqtw

// Dispatch over the state count (template arguments S, RPT): the protein
// instance S = 20 (4 row groups of 5 states), wide_newton.cu's only
// cluster instance.
#define IQT_DISPATCH_S(S_RT, CALL)               \
  switch (S_RT) {                                \
    case 20: CALL(20, 5); break;                 \
    default: return (int)cudaErrorInvalidValue;  \
  }

// The walks' kernels (wide_forward.cu, wide_store.cu, wide_down_store.cu,
// wide_tbar.cu): S = 20, the codon instance S = 64 (CODON_RPT rows a
// thread) and the DNA instance S = 4 past 8 categories (DNA_RPT).
#define IQT_DISPATCH_WIDE_S(S_RT, CALL)                      \
  switch (S_RT) {                                            \
    case 20: CALL(20, 5); break;                             \
    case 64: CALL(64, iqtw::CODON_RPT); break;               \
    case 4: CALL(4, iqtw::DNA_RPT); break;                   \
    default: return (int)cudaErrorInvalidValue;              \
  }
