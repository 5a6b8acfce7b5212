// Wide forward likelihood kernel: per-pattern log-likelihood of the whole
// tree at the general [C,S,S] layout (protein, S = 20; codons, S = 64).
//
// Replaces the TPU kernel _kernel (iqtree_tpu/engine/kernels/pruning.py),
// the general forward lnL with [C,S,S] x [C,S,T] child contractions.
//
// Work layout: a thread-block cluster of C blocks, one a rate category,
// owns a tile of consecutive patterns and walks the slot schedule with
// cluster_upward_walk (wide_common.cuh): a thread 2 patterns x 5 rows, the
// block's category's matrices and the tip rows fetched with cp.async as
// the ring releases a stage, the max across the categories through
// distributed shared memory at one cluster barrier a step.  At the root,
// rank 0 reads the other blocks' root columns through distributed shared
// memory, mixes them with rootw = props * pi in root_site_lnl's order
// (k = c S + s), and log-adds the invariant-site class.  The message rows
// keep their t order and the division its bits (div_rn), so the
// per-pattern lnL is the thread-per-row-group design's bit for bit.
//
// The codon instance (S = 64, a codon space's 60 to 63 states padded with
// zeros by the wrapper; wide_common.cuh): a thread 2 patterns x 8 rows,
// whose messages read the child's rows from shared memory as they go; at
// 16 patterns a cluster a block is two warps.  Bound on an H100 (GY+F3X4+G4,
// 80 taxa x 457 patterns, C = 4, the work at the codon space's S = 61):
// 2.2 GFLOP (0.032 ms at 67 TFLOP/s) against 18 MB of tip rows and
// matrices read once (0.006 ms): bound by operations; the chain is 79
// steps, and the padded rows are the instance's overhead.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): 2 children x C*S*S
// multiply-adds per step and pattern, 2*2*1600*299*1958 = 3.7 GFLOP of
// float32 FMA (67 TFLOP/s: 0.056 ms), against 47 MB of tip indicators read
// once (3.35 TB/s: 0.014 ms): bound by operations.  The walk is a chain of
// 299 dependent steps; a step costs a block's 2 x 5 x 2 x 20 multiply-adds
// a thread, a shuffle round trip and a cluster barrier.
//
// Past 8 categories (the protein mixtures: C20 is 80) a block holds CB =
// ceil(C / 8) of them on K = ceil(C / CB) blocks a cluster, on W category
// warps (cluster_upward_walk_multi: a step runs ceil(CB / W) units, each
// warp a category a unit; W by least_units: at C = 80 and 16 patterns a
// cluster 5 warps, two units a step and two blocks an SM at the bench
// tree's 5 slots, 4 at 6, 10 warps, one unit and one block an SM from 7 to
// 11).  The block keeps its categories' rows in its pool, and the root mix
// reads block r's category j as c = r CB + j, so its order and the lnL's
// bits are those of one category a block.  Bound on an H100 (C20, 300 taxa
// x 1 958 patterns): 20x the work above, 74 GFLOP (1.1 ms at 67 TFLOP/s),
// bound by operations.
//
// The DNA instance (S = 4, DNA_RPT = 1 row a thread) runs past 8 categories
// only (MULTI; up to 8 the CS-packed csrc/forward.cu serves): +R9/+R10 and
// DNA mixtures such as MIX{JC,HKY,GTR}+G4 (C = 12).  At C = 10 a cluster
// is 5 blocks of 2 categories, each on 2 category warps of 32 threads at
// 16 patterns a cluster, one unit a step.  Bound on an H100 (GTR+R10, 1 000
// taxa x 9 962 patterns): 2 x 10 x 16 multiply-adds a step and pattern,
// 2 x 2 x 160 x 999 x 9 962 = 6.4 GFLOP (0.095 ms at 67 TFLOP/s) against
// 160 MB of tip rows (0.048 ms): bound by operations; the walk is a chain
// of 999 steps.
//
// Shared memory: ClusterSmem (wide_common.cuh; pruning.wide_forward_smem).
#include "wide_common.cuh"

using namespace iqtw;

template <int S, int RPT, bool MULTI>
__global__ void __launch_bounds__(MULTI ? MULTI_THREADS_MAX : CLUSTER_THREADS_MAX)
wide_forward_kernel(const int* __restrict__ steps, int n_steps,
                    const float* __restrict__ trans, const float* __restrict__ tips,
                    int P, const float* __restrict__ rootw,
                    const float* __restrict__ invar, float* __restrict__ out,
                    int n_slots, int tile, int C, int cb) {
  extern __shared__ __align__(16) float smem[];
  const int CB = MULTI ? cb : 1;
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks();
  const int p0 = (int)(blockIdx.x / K) * tile;
  int root_slot;
  const int W = MULTI ? (int)blockDim.x / (tile / CLUSTER_QT * (S / RPT)) : 1;
  if constexpr (MULTI)
    root_slot = cluster_upward_walk_multi<S, RPT>(steps, n_steps, trans, tips, P, p0, tile,
                                                  n_slots, C, CB, W, smem,
                                                  [](const Step&, const float*) {});
  else
    root_slot = cluster_upward_walk<S, RPT>(
        steps, n_steps, trans, tips, P, p0, tile, n_slots, smem,
        [](const Step&, const auto&, const auto&, const float*) {});
  cluster.sync();  // every block's root rows are written
  const int q = threadIdx.x;
  if (cluster.block_rank() == 0 && q < tile) {
    const int SR = CB * S;
    const size_t col =
        ClusterSmem<S, MULTI>(tile, CB, W).pool() + (size_t)root_slot * (SR + 1) * tile + q;
    float mix = 0.f;
    for (int r = 0; r < K; ++r) {  // category c = r CB + j, ascending
      const float* rows = cluster.map_shared_rank(smem, r) + col;
      for (int j = 0; j < CB && (!MULTI || r * CB + j < C); ++j)
#pragma unroll
        for (int s = 0; s < S; ++s)
          mix += __ldg(rootw + (r * CB + j) * S + s) * rows[(j * S + s) * tile];
    }
    float lnl = logf(fmaxf(mix, SCALE_TINY)) + smem[col + SR * tile];
    const int p_raw = p0 + q;
    const float inv = __ldg(invar + min(p_raw, P - 1));
    if (inv > 0.f) {
      const float b = logf(fmaxf(inv, SCALE_TINY));
      const float hi = fmaxf(lnl, b), lo = fminf(lnl, b);
      lnl = hi + log1pf(expf(lo - hi));
    }
    if (p_raw < P) out[p_raw] = lnl;
  }
  cluster.sync();  // no block leaves while rank 0 reads its pool
}

// The instance <S, RPT> at CB categories a block (MULTI past one; the
// codon instance has none; the DNA instance has MULTI only), or nullptr.
template <int S, int RPT>
auto wide_forward_instance(int CB) {
  if constexpr (multi_only<S>)
    return CB > 1 ? wide_forward_kernel<S, RPT, true> : nullptr;
  else if constexpr (S <= 32)
    return CB > 1 ? wide_forward_kernel<S, RPT, true> : wide_forward_kernel<S, RPT, false>;
  else
    return CB > 1 ? nullptr : wide_forward_kernel<S, RPT, false>;
}

// tile: patterns a cluster, a multiple of 16 (a category warp has tile / 2
// x 4 threads, whole warps) up to 128.  C categories on wide_k(C) blocks a
// cluster, wide_cb(C) a block (past 8 the S = 20 and S = 4 instances; S = 4
// only past 8) on
// UpwardLaunch's W category warps.
extern "C" int iqt_wide_forward(const int* steps, int n_steps, const float* trans,
                                const float* tips, int P, const float* rootw,
                                const float* invar, float* out, int C, int S,
                                int n_slots, int tile, void* stream) {
  if (C < 1 || tile <= 0 || tile % CLUSTER_QT) return (int)cudaErrorInvalidValue;
  const int clusters = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                              \
  {                                                                                        \
    const UpwardLaunch<SS_, RPT_> l(C, tile, n_slots);                                     \
    const auto kernel = wide_forward_instance<SS_, RPT_>(l.CB);                            \
    if (!l.team || !kernel) return (int)cudaErrorInvalidValue;                             \
    e = launch_clusters(kernel, clusters, l.K, l.threads, l.smem, stream, steps, n_steps,  \
                        trans, tips, P, rootw, invar, out, n_slots, tile, C, l.CB);        \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch iqt_wide_forward makes at these sizes: info = {category warps
// W, threads a block, shared memory bytes a block, the most clusters the
// card holds at once}.
extern "C" int iqt_wide_forward_layout(int C, int S, int n_slots, int tile, int* info) {
  if (C < 1 || tile <= 0 || tile % CLUSTER_QT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAYOUT(SS_, RPT_)                                                     \
  {                                                                               \
    const UpwardLaunch<SS_, RPT_> l(C, tile, n_slots);                            \
    const auto kernel = wide_forward_instance<SS_, RPT_>(l.CB);                   \
    if (!l.team || !kernel) return (int)cudaErrorInvalidValue;                    \
    info[0] = l.W, info[1] = l.threads, info[2] = (int)l.smem;                    \
    e = active_clusters(kernel, l.K, l.threads, l.smem, info + 3);                \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAYOUT)
#undef IQT_LAYOUT
  return (int)e;
}
