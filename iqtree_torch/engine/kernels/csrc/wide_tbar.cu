// Wide gradient sweep: the cotangent of every edge's transition matrices
// at the general [C,S,S] layout (protein, S = 20; codons, S = 64, a codon
// space padded with zeros by the wrapper).
//
// Replaces the TPU kernel _kernel_down_tbar
// (iqtree_tpu/engine/kernels/pruning.py).  Reverse walk of the slot
// schedule: each step forms its two child edges' outside partials O from
// the parent's outside vector D (root seed props * pi) and the sibling's
// message, accumulates
//     tbar[e][c][s][t] += sum_p O[c,s,p] * fac[p] * U_e[c,t,p],
//     fac = exp(min(osc + usc - lnl, 80)) * w_p,
// and pushes D_child = P^T O down the tree.  The children's inside
// partials come from the upward store's up buffer (tip rows filled by the
// caller).
//
// Work layout: cluster_reverse_walk (wide_common.cuh), as
// wide_down_store.cu's: a thread-block cluster of C blocks, one a rate
// category, owns a tile of consecutive patterns (a multiple of 16); a
// block's first tile x 4 threads walk, one pattern and 5 state rows each.
// This kernel's part of a step is the walk's hook and the sums.  The hook
// stages each child's fac [child][tile] (lnl and w_p of a thread's pattern
// are loaded once) and arrives at a named barrier without waiting.  The
// cotangent sums are the sum warps', one for each 16 patterns of the tile,
// after the walk threads in the block: a sum warp waits at the named
// barrier, and lane (child, sb, tb) adds its 5 x 5 entries (s = 5 sb + j,
// t = 5 tb + k) of the category's [S,S] block of the child's edge over the
// warp's 16 patterns, from the walk's O stage times fac and the ring
// stage's U rows, as 25 chains in pattern order.  The entries go through
// the warp's own stage [child][S][S] to the 16 patterns' part row as float4
// runs (each child's block is S x S consecutive floats there).  The walk
// threads meanwhile push O and walk the next step up to its exchange: a
// sum warp arrives at the next step's opening barrier without waiting and
// joins its cluster barrier when its sums are written, after which the
// walk rewrites the O stage, fac and the ring stage they read.  So the
// chains and the stores stay off the walk's step chain.
//
// The TPU grid runs its pattern tiles in order into one [2N,C,S,S]
// accumulator; clusters here run in no order, so the sums of each 16
// patterns go to their own part row part[row][edge][C][S][S] and
// reduce_blocks adds the rows in order (deterministic, no float atomics).
// The rows are the row-group design's blocks (16 patterns) and each entry
// is sum_{q < 16} (O[s,q] fac[q]) U[t,q] added in q order, that design's
// contraction, on the walk's O and scales (that design's bits), so tbar
// keeps its bits at 16, 32 and 64 patterns a cluster.  The part rows are
// large (1 600 floats an edge and row: 0.47 GB for 300 taxa x 1 958
// patterns), so the caller sizes `part` for part_blocks rows and the sweep
// runs in chunks of clusters, each chunk's rows added onto the last.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads the stored
// partials once, 2N x 81 rows x 1 958 x 4 B = 0.39 GB (3.35 TB/s: 0.12 ms);
// per step and pattern both children's messages and cotangent blocks,
// 4 x 1 600 multiply-adds and 6 x 80 row operations, and a 1 600
// multiply-add push into each of the 298 internal non-root children:
// 2 x 1 958 x (299 x 6 880 + 298 x 1 600) = 9.9 GFLOP (67 TFLOP/s:
// 0.15 ms): bound by operations.  A design that keeps the bits also
// writes the part rows and reads them back, 2 x 0.47 GB: ~0.40 ms.  The
// walk is a chain of 299 dependent steps.
//
// Registers: at most 80 a thread (launch bounds), so that every cluster
// stays resident at C=8 (984 blocks of 96 threads at 16 patterns a
// cluster need 8 an SM); past 8 categories a block of up to
// TBAR_MULTI_THREADS_MAX threads, one an SM.
//
// Shared memory a block: ReverseSmem (wide_common.cuh), fac, 2 tile
// floats, and the sum warps' stages, W x tile / 16 x 2 S^2 floats
// (cs_kernels.wide_tbar_smem); S = 20, C = 4, tile 16, 11 slots: 33 472
// bytes.
//
// Past 8 categories (MULTI) a block has W category teams, each of tile x 4
// walk threads running cluster_reverse_walk_multi and a sum warp for each
// 16 patterns running reverse_sums_multi: after each phase B unit (fac
// staged by team 0 at the step's first) a team's sum warps add its
// category's sums to the category's [S,S] blocks at c = kb CB + j of the
// part row, as at one category a block; a padding category's none.  At
// one team (W = 1) the sums run in lock step with the walk; past one they
// lag a unit behind it, beside the walk's next unit, on a ring a stage
// deeper (tbar_stages), so no unit waits for the last one's sums.  W by
// least_units (TbarLaunch): at C = 80 and 16 patterns a cluster 5
// teams, two units a phase and one block an SM at the bench tree's 5
// slots.  Bound (C20, 300 taxa x 1 958 patterns): 198 GFLOP (3.0 ms),
// bound by operations; a design that keeps the bits also writes its 123
// part rows of 600 x 80 x 20 x 20 floats (9.45 GB) and reads them back,
// ~18.9 GB: ~5.6 ms at 3.35 TB/s.
//
// The DNA instance (S = 4, past 8 categories only: MULTI; up to 8 the
// CS-packed csrc/tbar.cu serves): a walk thread holds one row (DNA_RPT), a
// sum lane one entry of a child's [4,4] block, so a 16-pattern group's 32
// lanes are one sum warp, through the stage; at C = 10 and 16 patterns a
// cluster 2 teams of 64 walk threads and a sum warp, one unit a phase.
//
// The codon instance (S = 64): a lane's block of a child's [S,S] is 8 x 8
// entries (SumShape), so a group of 16 patterns has 2 x 8 x 8 = 128 lanes,
// four sum warps, whose lanes store their entries straight to the part row
// as float4 runs (no stage: its rows are whole float4s); the walk threads
// 16 patterns x 8 row groups; one block an SM (137 280 bytes of shared
// memory at C = 4, tile 16, 11 slots), so no register cap past the block's
// 384 threads (launch bounds of one block: 170).  Bound (GY+F3X4+G4, 80
// taxa x 457 patterns, C = 4, the work at S = 61): 5.5 GFLOP by the count
// above (0.082 ms) against 91 MB read (0.027 ms): bound by operations.
#include "wide_common.cuh"

using namespace iqtw;

// Patterns of a part row and of a sum warp: the row-group design's block,
// whose sums the cotangents keep.
constexpr int SUM_PATTERNS = 16;
// Largest block: 64 patterns a cluster, 256 walk threads and 4 sum warps.
constexpr int TBAR_THREADS_MAX = CLUSTER_THREADS_MAX + 4 * 32;
// Largest block past 8 categories: W category teams, each of tile x S /
// RPT walk threads and the sum warps of its 16-pattern groups: five teams
// of 64 + 32 at 16 patterns a cluster (the launch bound of the MULTI
// instance).
constexpr int TBAR_MULTI_THREADS_MAX = 480;

// The sums' lane map: a lane adds an SB x SB block of a child's [S,S]
// (S / SB blocks a side), so a 16-pattern group has 2 (S / SB)^2 lanes,
// WARPS sum warps; STAGED: a lane's rows are no whole float4 runs, so the
// entries go through the group's stage [2][S][S] to the part row.
template <int S>
struct SumShape;
template <>
struct SumShape<20> {
  static constexpr int SB = 5;
};
template <>
struct SumShape<64> {
  static constexpr int SB = 8;
};
template <>
struct SumShape<4> {
  static constexpr int SB = 1;
};
template <int S>
struct SumLanes {
  static constexpr int SB = SumShape<S>::SB, NB = S / SB, WARPS = 2 * NB * NB / 32;
  static constexpr bool STAGED = SB % 4 != 0;
  static_assert(NB * SB == S && 2 * NB * NB % 32 == 0, "the lanes tile both [S,S] blocks");
};

// The ring's stages at W category teams: past one team the sums lag a
// unit behind the walk (reverse_sums_multi), which takes a stage more.
__device__ __host__ inline int tbar_stages(int W) {
  return W > 1 ? REVERSE_STAGES + 1 : REVERSE_STAGES;
}

// Bytes of shared memory a block: the reverse walk's (ReverseSmem, W
// category teams and tbar_stages), fac [2][tile] and, where STAGED, a
// stage [2][S][S] for each sum warp group of each team.
template <int S>
inline size_t wide_tbar_smem(int K, int CB, int tile, int n_slots, int W = 1) {
  const size_t stage = SumLanes<S>::STAGED ? (size_t)W * tile / SUM_PATTERNS * 2 * S * S : 0;
  return (ReverseSmem<S, true>(tile, CB, W, tbar_stages(W)).floats(n_slots, K) +
          2 * (size_t)tile + stage) *
         sizeof(float);
}

// A step's O and fac are staged: the walk threads arrive at named barrier
// 1 and go on, the sum warps wait there (all the block's threads count).
__device__ __forceinline__ void sums_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void sums_wait(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}
// A sum warp at the walk's opening barrier, without waiting.
__device__ __forceinline__ void ring_arrive(int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(RING_BARRIER), "r"(threads) : "memory");
}

// One step's sums of the 16 patterns g16 .. g16 + 15 of the tile by the
// group's sum warps: lane L = (side, sb, tb) of the group adds sum_q
// (O[side][s][q] fac[side][q]) U[side][t][q] in q order for s = SB sb + j,
// t = SB tb + k (SumLanes: the lanes' 2 x NB x NB blocks tile both
// children's [S,S]), from the O rows of category c (child `side` at ost +
// side ostride, S rows of tile patterns), fac [2][tile] and the ring stage
// Uk [2][S+1][tile], into the child's [S,S] block of category c in `row`
// (none: a group past P): through the group's stage pst [2][S][S] (one
// warp) where STAGED, else straight from the lane.
template <int S>
__device__ __forceinline__ void group_sums(const Step& st, const float* ost, int ostride,
                                           const float* fac, const float* Uk, int tile,
                                           int g16, int L, float* pst, float* row, int C,
                                           int c) {
  static_assert(S % 4 == 0, "patterns and rows are float4 runs");
  using SL = SumLanes<S>;
  constexpr int SB = SL::SB, NB = SL::NB, SS = S * S;
  const int lane = threadIdx.x & 31, side = L / (NB * NB), sb = (L / NB) % NB, tb = L % NB;
  const float* O = ost + side * ostride + g16;
  const float* F = fac + side * tile + g16;
  const float* U = Uk + side * (S + 1) * tile + g16;
  float acc[SB][SB];
#pragma unroll
  for (int j = 0; j < SB; ++j)
#pragma unroll
    for (int k = 0; k < SB; ++k) acc[j][k] = 0.f;
#pragma unroll
  for (int q = 0; q < SUM_PATTERNS; q += 4) {
    const float4 f = *reinterpret_cast<const float4*>(F + q);
    float4 a[SB], b[SB];
#pragma unroll
    for (int j = 0; j < SB; ++j) {
      a[j] = *reinterpret_cast<const float4*>(O + (sb * SB + j) * tile + q);
      a[j].x *= f.x;
      a[j].y *= f.y;
      a[j].z *= f.z;
      a[j].w *= f.w;
      b[j] = *reinterpret_cast<const float4*>(U + (tb * SB + j) * tile + q);
    }
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int k = 0; k < SB; ++k) {
        acc[j][k] += a[j].x * b[k].x;
        acc[j][k] += a[j].y * b[k].y;
        acc[j][k] += a[j].z * b[k].z;
        acc[j][k] += a[j].w * b[k].w;
      }
  }
  if constexpr (!SL::STAGED) {
    if (row) {
      float* dst = row + ((size_t)(side ? st.r : st.l) * C + c) * SS + tb * SB;
#pragma unroll
      for (int j = 0; j < SB; ++j)
#pragma unroll
        for (int k = 0; k < SB; k += 4)
          *reinterpret_cast<float4*>(dst + (sb * SB + j) * S + k) =
              make_float4(acc[j][k], acc[j][k + 1], acc[j][k + 2], acc[j][k + 3]);
    }
    return;
  }
  if (row) {
#pragma unroll
    for (int j = 0; j < SB; ++j)
#pragma unroll
      for (int k = 0; k < SB; ++k) pst[side * SS + (sb * SB + j) * S + tb * SB + k] = acc[j][k];
    __syncwarp();
    // each child's block: SS consecutive floats of the row, SS / 4 float4s
    constexpr int W = SS / 4;
    for (int v = lane; v < 2 * W; v += 32) {
      const int sv = v / W, w = v - sv * W;
      reinterpret_cast<float4*>(row + ((size_t)(sv ? st.r : st.l) * C + c) * SS)[w] =
          reinterpret_cast<const float4*>(pst + sv * SS)[w];
    }
    __syncwarp();  // the stage is free for the next step
  }
}

// A sum warp of group w of a block (lanes L of the group's SumLanes): the
// walk's barriers in its order (see cluster_reverse_walk), and after each
// step's named barrier the step's sums of the tile's patterns 16 w .. 16 w
// + 15 into `row`, before the next step's exchange.
template <int S>
__device__ __forceinline__ void sum_warp(const int* __restrict__ steps, int n_steps,
                                         float* smem, int tile, int n_slots, int w, int L,
                                         float* row, int C, int c) {
  const ReverseSmem<S> lay(tile);
  const float* ust = smem + lay.rows();
  const float* ost = smem + lay.ost(n_slots);
  const float* fac = smem + lay.floats(n_slots, C);
  float* pst = smem + lay.floats(n_slots, C) + 2 * tile + (size_t)w * 2 * S * S;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();            // the walk's, before its first step
  ring_arrive(blockDim.x);   // step n_steps - 1 opens
  reverse_barrier(cluster);  // its exchange
  int k = 0;                 // the ring stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    sums_wait(blockDim.x);  // step i's O and fac are staged
    if (i > 0) ring_arrive(blockDim.x);  // step i - 1 opens: it reads nothing of ours
    group_sums<S>(st, ost, S * tile, fac, ust + (size_t)k * 2 * (S + 1) * tile, tile,
                  w * SUM_PATTERNS, L, pst, row, C, c);
    if (i > 0) reverse_barrier(cluster);  // step i - 1's exchange; the stages are rewritten
    k = k == REVERSE_STAGES - 1 ? 0 : k + 1;
  }
}

template <int S, int RPT, bool MULTI>
__global__ void __launch_bounds__(MULTI ? TBAR_MULTI_THREADS_MAX : TBAR_THREADS_MAX,
                                  MULTI || S > 32 ? 1 : 2)
wide_tbar_kernel(const int* __restrict__ steps, int n_steps,
                 const float* __restrict__ trans, const float* __restrict__ rootd,
                 const float* __restrict__ lnl, const float* __restrict__ wp,
                 const float* __restrict__ up, const float* __restrict__ usc, int P,
                 int n_nodes, float* __restrict__ part, int n_slots, int tile,
                 int cluster0, int C, int CB) {
  constexpr int G = S / RPT, QT = REVERSE_QT, SS = S * S, WARPS = SumLanes<S>::WARPS;
  static_assert(QT == 1, "a walk thread holds one pattern");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  if constexpr (!MULTI) C = K;  // a block a category
  const int cl = (int)(blockIdx.x / K);  // the cluster in this chunk
  const int p0 = (cluster0 + cl) * tile, groups = tile / SUM_PATTERNS;
  // W category teams (past 8 categories; else one) of T walk threads, the
  // sum warps after all the walk threads
  const int T = tile / QT * G, tid = threadIdx.x;
  const int W = MULTI ? (int)blockDim.x / (T + groups * WARPS * 32) : 1, walkers = W * T;
  const ReverseSmem<S, MULTI> lay(tile, MULTI ? CB : 1, W, tbar_stages(W));
  float* fac = smem + lay.floats(n_slots, K);  // [2][tile]
  // the part row of the tile's patterns 16 w .. 16 w + 15 (none past P)
  const auto part_row = [&](int w) {
    return p0 + w * SUM_PATTERNS < P ? part + ((size_t)cl * groups + w) * n_nodes * C * SS
                                     : nullptr;
  };
  if (tid >= walkers) {
    const int sw = (tid - walkers) >> 5;  // the sum warp
    const int w = MULTI ? sw / WARPS % groups : sw / WARPS;  // its group
    const int L = (sw % WARPS) * 32 + (tid & 31);
    if constexpr (MULTI) {
      // the sum warps of team wt: category j = u W + wt of each phase B unit u
      const int wt = sw / (WARPS * groups);
      const float* ust = smem + lay.rows();
      const float* ost = smem + lay.ost(n_slots);
      float* pst = fac + 2 * tile + (size_t)(wt * groups + w) * 2 * S * S;
      float* row = part_row(w);
      reverse_sums_multi(steps, n_steps, CB, W, tbar_stages(W),
                         [&]() { sums_wait(blockDim.x); },
                         [&](const Step& st, int u, int k) {
                           const int j = u * W + wt, c = kb * CB + j;
                           if (j < CB && c < C)
                             group_sums<S>(st, ost + (size_t)j * S * tile, CB * S * tile, fac,
                                           ust + ((size_t)k * W + wt) * 2 * (S + 1) * tile,
                                           tile, w * SUM_PATTERNS, L, pst, row, C, c);
                         });
    } else {
      sum_warp<S>(steps, n_steps, smem, tile, n_slots, w, L, part_row(w), C, kb);
    }
  } else {
    const WalkLane<S, G> wl(MULTI ? tid % T : tid);
    const int g = wl.g, q = wl.pq, p = p0 + q;
    const bool valid = p < P;  // a ragged tail computes with P - 1 and adds 0
    const int pg = min(p, P - 1);
    const float lnl_p = __ldg(lnl + pg), w_p = valid ? __ldg(wp + pg) : 0.f;
    // lane g < 2 of the pattern group: child g's fac
    const auto stage_fac = [&](const float (&sc)[2][QT], const float* Uk) {
      if (g < 2) {
        const float osc = g ? sc[1][0] : sc[0][0];
        const float usc_e = Uk[(g * (S + 1) + S) * tile + q];
        fac[g * tile + q] = valid ? expf(fminf(osc + usc_e - lnl_p, 80.f)) * w_p : 0.f;
      }
    };
    if constexpr (MULTI) {
      // team 0 stages fac at a step's first phase B unit; in lock step (one
      // team) every unit's sums wait for its hook
      const bool lock_step = W == 1;
      const auto hook = [&](const Step&, int j, int, const float*, const float (&sc)[2][QT],
                            const float* Uk) {
        if (j == 0) stage_fac(sc, Uk);
        if (lock_step) sums_arrive(blockDim.x);
      };
      cluster_reverse_walk_multi<S, RPT>(steps, n_steps, trans, rootd, up, usc, P, p0, tile,
                                         n_slots, C, CB, W, tbar_stages(W), smem, hook);
    } else {
      const auto hook = [&](const Step& st, const float* ost, const float (&sc)[2][QT],
                            const float* Uk) {
        stage_fac(sc, Uk);
        sums_arrive(blockDim.x);
      };
      cluster_reverse_walk<S, RPT>(steps, n_steps, trans, rootd, up, usc, P, p0, tile,
                                   n_slots, smem, hook);
    }
  }
}

// The launch of the instance <S, RPT> at C categories, tile patterns a
// cluster and n_slots slots: K blocks of CB categories on W category teams
// (least_units past 8 categories, else one) of T walk threads and the
// sum warps of their 16-pattern groups, the shared memory of
// wide_tbar_smem, and the kernel (nullptr: no instance).  T is 0 for a
// tile whose teams are not whole warps or too large.
template <int S, int RPT>
struct TbarLaunch {
  int K, CB, T, W, threads;
  size_t smem;
  void (*kernel)(const int*, int, const float*, const float*, const float*, const float*,
                 const float*, const float*, int, int, float*, int, int, int, int, int);
  TbarLaunch(int C, int tile, int n_slots)
      : K(wide_k(C)), CB(wide_cb(C)), T(tile / REVERSE_QT * (S / RPT)) {
    const int sums = tile / SUM_PATTERNS * SumLanes<S>::WARPS * 32;
    if (T % 32 || T + sums > TBAR_THREADS_MAX) T = 0;
    const auto bytes = [&](int w) { return wide_tbar_smem<S>(K, CB, tile, n_slots, w); };
    W = CB > 1 && T ? least_units(CB, 1, T + sums, TBAR_MULTI_THREADS_MAX, bytes) : 1;
    threads = W * (T + sums);
    smem = bytes(W);
    if constexpr (multi_only<S>)
      kernel = CB > 1 ? wide_tbar_kernel<S, RPT, true> : nullptr;
    else if constexpr (S <= 32)
      kernel = CB > 1 ? wide_tbar_kernel<S, RPT, true> : wide_tbar_kernel<S, RPT, false>;
    else
      kernel = CB > 1 ? nullptr : wide_tbar_kernel<S, RPT, false>;
  }
};

// tile: patterns a cluster, a multiple of 16 up to 64 (a team has tile x
// 4 walk threads and a sum warp for each 16 patterns); part holds
// part_blocks rows of 16 patterns, at least tile / 16.  C categories on
// wide_k(C) blocks a cluster, wide_cb(C) a block (past 8 the S = 20 and
// S = 4 instances; S = 4 only past 8) on TbarLaunch's W category teams.
extern "C" int iqt_wide_tbar(const int* steps, int n_steps, const float* trans,
                             const float* rootd, const float* lnl, const float* wp,
                             const float* up, const float* usc, int P, int n_nodes,
                             float* part, int part_blocks, float* tbar, int C, int S,
                             int n_slots, int tile, void* stream) {
  if (C < 1 || tile <= 0 || tile % SUM_PATTERNS) return (int)cudaErrorInvalidValue;
  const int groups = tile / SUM_PATTERNS, per_chunk = part_blocks / groups;
  const int clusters = (P + tile - 1) / tile, rows = (P + SUM_PATTERNS - 1) / SUM_PATTERNS;
  if (per_chunk < 1) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
  for (int c0 = 0; c0 < clusters; c0 += per_chunk) {
    const int nc = min(per_chunk, clusters - c0);
#define IQT_LAUNCH(SS_, RPT_)                                                              \
  {                                                                                        \
    const TbarLaunch<SS_, RPT_> l(C, tile, n_slots);                                       \
    if (!l.T || !l.kernel) return (int)cudaErrorInvalidValue;                              \
    e = launch_clusters(l.kernel, nc, l.K, l.threads, l.smem, stream, steps, n_steps,      \
                        trans, rootd, lnl, wp, up, usc, P, n_nodes, part, n_slots, tile,   \
                        c0, C, l.CB);                                                      \
  }
    IQT_DISPATCH_WIDE_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = iqt::launch_reduce(part, tbar, min(nc * groups, rows - c0 * groups),
                           n_nodes * C * S * S, c0 > 0, (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}

// The launch iqt_wide_tbar makes at these sizes: info = {category teams W,
// threads a block, shared memory bytes a block, the most clusters the card
// holds at once}.
extern "C" int iqt_wide_tbar_layout(int C, int S, int n_slots, int tile, int* info) {
  if (C < 1 || tile <= 0 || tile % SUM_PATTERNS) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAYOUT(SS_, RPT_)                                                     \
  {                                                                               \
    const TbarLaunch<SS_, RPT_> l(C, tile, n_slots);                              \
    if (!l.T || !l.kernel) return (int)cudaErrorInvalidValue;                     \
    info[0] = l.W, info[1] = l.threads, info[2] = (int)l.smem;                    \
    e = active_clusters(l.kernel, l.K, l.threads, l.smem, info + 3);              \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAYOUT)
#undef IQT_LAYOUT
  return (int)e;
}
