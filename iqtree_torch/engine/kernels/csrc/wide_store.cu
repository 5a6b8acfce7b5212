// Wide upward-store kernel: the forward sweep at the general [C,S,S]
// layout (protein, S = 20; codons, S = 64: a codon space padded with zeros
// by the wrapper), also storing every internal node's normalized partial
// and log-scale for the reverse sweeps.
//
// Replaces the TPU kernel _kernel_store (want_mb=False;
// iqtree_tpu/engine/kernels/pruning.py), which also feeds the wide
// branch-Newton sweep.  The TPU's padding of S to 24 rows (Mosaic's 8-row
// DMA tiling) and its 8-row replicated scale rows are not carried over.
//
// Work layout: wide_forward.cu's.  A thread-block cluster of C blocks, one
// a rate category, owns a tile of consecutive patterns and walks the slot
// schedule with cluster_upward_walk (wide_common.cuh): a thread 2 patterns
// x 5 rows, the category's matrices and the tip rows fetched with cp.async
// as the ring releases a stage, the max across the categories through
// distributed shared memory at one cluster barrier a step.  After a step
// each warp copies its own patterns' columns of the step's pool slot (16
// patterns x S rows, and rank 0 the scale row) to up[node] [C*S, P] and
// usc[node] [P]: a store instruction writes 2 rows x 16 patterns, two
// 64-byte runs, where the thread's own registers (2 patterns x 5 rows)
// would write half of each run at a time.  The copy reads only the warp's
// columns, after the walk's __syncwarp, and ends before the next step's
// cluster barrier, after which the parent step may reuse the slot.  The
// pool holds the row-group design's bits (the walk's message order, max,
// div_rn quotient and scale chain), so up and usc are that design's bit for
// bit.  A ragged last tile computes with pattern P - 1 and writes no
// column past P.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): the 3.7 GFLOP of
// the forward kernel (67 TFLOP/s: 0.056 ms) and the stored partials, 299 x
// 81 rows x 1 958 patterns x 4 B = 190 MB written (3.35 TB/s: 0.057 ms):
// bytes and operations about even.  Like the forward kernel it runs at the
// latency of its step chain, 299 dependent steps.
//
// Past 8 categories a block holds CB of them on W category warps
// (cluster_upward_walk_multi, as in wide_forward.cu); each warp copies its
// own real categories' rows to up (category kb CB + j from pool rows j S
// .., j = w, w + W, ..), a padding category none, and the first warp of
// rank 0 the scale row to usc.  Bound (C20, 300 taxa x 1 958 patterns): 74
// GFLOP (1.1 ms) against 3.8 GB of partials stored (1.1 ms): bytes and
// operations about even.
//
// Shared memory: ClusterSmem (wide_common.cuh; pruning.wide_forward_smem),
// 25 472 bytes a block at S = 20, C = 4, 16 patterns a cluster and 10
// slots; at S = 64 (codon), C = 4, 16 patterns and 11 slots 128 192 bytes,
// under the 232 448 a block may have.  The codon instance's bound (GY+F3X4+G4,
// 80 taxa x 457 patterns, C = 4, the work at S = 61): the forward kernel's
// 2.2 GFLOP (0.032 ms) against 79 x 245 rows x 457 x 4 B = 35 MB stored
// and 18 MB read (0.016 ms): bound by operations.
// The DNA instance (S = 4, DNA_RPT = 1 row a thread) runs past 8 categories
// only (MULTI; up to 8 the CS-packed csrc/store.cu serves), as wide_forward.cu's.
#include "wide_common.cuh"

using namespace iqtw;

template <int S, int RPT, bool MULTI>
__global__ void __launch_bounds__(MULTI ? MULTI_THREADS_MAX : CLUSTER_THREADS_MAX)
wide_store_kernel(const int* __restrict__ steps, int n_steps,
                  const float* __restrict__ trans, const float* __restrict__ tips,
                  int P, float* __restrict__ up, float* __restrict__ usc, int n_slots,
                  int tile, int C, int CB) {
  // a warp's patterns, and the rows one of its store instructions covers
  constexpr int WP = 32 / (S / RPT) * CLUSTER_QT, RW = 32 / WP;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  if constexpr (!MULTI) C = K;  // a block a category
  const int p0 = (int)(blockIdx.x / K) * tile;
  const int lane = threadIdx.x & 31, r0 = lane / WP;
  if constexpr (MULTI) {
    // category warp w's real categories' rows from its warps' patterns; a
    // padding category writes none
    const int team = tile / CLUSTER_QT * (S / RPT), W = (int)blockDim.x / team;
    const int w = (int)threadIdx.x / team;
    const int q = (int)(threadIdx.x % team >> 5) * WP + lane % WP, p = p0 + q;
    const auto emit = [&](const Step& st, const float* slot) {
      if (p < P) {
        for (int j = w; j < CB && kb * CB + j < C; j += W) {
          float* dst = up + ((size_t)st.node * C + kb * CB + j) * S * P + p;
          const float* src = slot + j * S * tile + q;
          for (int r = r0; r < S; r += RW) dst[(size_t)r * P] = src[r * tile];
        }
        if (kb == 0 && w == 0 && r0 == 0) usc[(size_t)st.node * P + p] = slot[CB * S * tile + q];
      }
    };
    cluster_upward_walk_multi<S, RPT>(steps, n_steps, trans, tips, P, p0, tile, n_slots, C, CB,
                                      W, smem, emit);
  } else {
    const int q = (int)(threadIdx.x >> 5) * WP + lane % WP, p = p0 + q;
    const int c = kb;
    const auto emit = [&](const Step& st, const auto&, const auto&, const float* slot) {
      if (p < P) {
        float* dst = up + ((size_t)st.node * C + c) * S * P + p;
        for (int r = r0; r < S; r += RW) dst[(size_t)r * P] = slot[r * tile + q];
        if (c == 0 && r0 == 0) usc[(size_t)st.node * P + p] = slot[S * tile + q];
      }
    };
    cluster_upward_walk<S, RPT>(steps, n_steps, trans, tips, P, p0, tile, n_slots, smem, emit);
  }
}

// The instance <S, RPT> at CB categories a block (MULTI past one; the
// codon instance has none; the DNA instance has MULTI only), or nullptr.
template <int S, int RPT>
auto wide_store_instance(int CB) {
  if constexpr (multi_only<S>)
    return CB > 1 ? wide_store_kernel<S, RPT, true> : nullptr;
  else if constexpr (S <= 32)
    return CB > 1 ? wide_store_kernel<S, RPT, true> : wide_store_kernel<S, RPT, false>;
  else
    return CB > 1 ? nullptr : wide_store_kernel<S, RPT, false>;
}

// tile: patterns a cluster, a multiple of 16 (a category warp has tile / 2
// x 4 threads, whole warps) up to 128.  C categories on wide_k(C) blocks a
// cluster, wide_cb(C) a block (past 8 the S = 20 and S = 4 instances; S = 4
// only past 8) on
// UpwardLaunch's W category warps.
extern "C" int iqt_wide_store(const int* steps, int n_steps, const float* trans,
                              const float* tips, int P, float* up, float* usc, int C,
                              int S, int n_slots, int tile, void* stream) {
  if (C < 1 || tile <= 0 || tile % CLUSTER_QT) return (int)cudaErrorInvalidValue;
  const int clusters = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                             \
  {                                                                                       \
    const UpwardLaunch<SS_, RPT_> l(C, tile, n_slots);                                    \
    const auto kernel = wide_store_instance<SS_, RPT_>(l.CB);                             \
    if (!l.team || !kernel) return (int)cudaErrorInvalidValue;                            \
    e = launch_clusters(kernel, clusters, l.K, l.threads, l.smem, stream, steps, n_steps, \
                        trans, tips, P, up, usc, n_slots, tile, C, l.CB);                 \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch iqt_wide_store makes at these sizes: info = {category warps W,
// threads a block, shared memory bytes a block, the most clusters the card
// holds at once}.
extern "C" int iqt_wide_store_layout(int C, int S, int n_slots, int tile, int* info) {
  if (C < 1 || tile <= 0 || tile % CLUSTER_QT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAYOUT(SS_, RPT_)                                                     \
  {                                                                               \
    const UpwardLaunch<SS_, RPT_> l(C, tile, n_slots);                            \
    const auto kernel = wide_store_instance<SS_, RPT_>(l.CB);                     \
    if (!l.team || !kernel) return (int)cudaErrorInvalidValue;                    \
    info[0] = l.W, info[1] = l.threads, info[2] = (int)l.smem;                    \
    e = active_clusters(kernel, l.K, l.threads, l.smem, info + 3);                \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAYOUT)
#undef IQT_LAYOUT
  return (int)e;
}
