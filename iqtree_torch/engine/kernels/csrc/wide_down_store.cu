// Wide outside-partial store: every node's normalized outside partial and
// its log-scale at the general [C,S,S] layout (protein, S = 20; codons,
// S = 64, a codon space padded with zeros by the wrapper), the second of
// the NNI evaluator's two global passes and of the codon branch Newton's
// theta path.
//
// Replaces the TPU kernel _kernel_down_store
// (iqtree_tpu/engine/kernels/pruning.py).  Reverse walk of the slot
// schedule: each step takes the parent's pushed outside vector d (at the
// root the bare state frequencies: the class weights are applied later,
// by the evaluator's theta reductions), forms both child messages m = P U
// from the upward store's partials (tip rows filled by the caller), and
// for each child
//     O = d * m_sib / max,  osc = dsc + usc_sib + log(max),
// writes O [C*S, P] and osc [P] to out/osc, and, when the child is
// internal, pushes D = P^T O into the child's slot.  The root and dummy
// rows are never written (the caller zeroes them).
//
// Work layout: cluster_reverse_walk (wide_common.cuh), wide_newton.cu's
// reverse walk with one matrix in place of three.  A thread-block cluster
// of C blocks, one a rate category, owns a tile of consecutive patterns;
// thread (q, g) of a block holds one pattern q and the RPT = 5 state rows
// g RPT .. of its category.  A two-stage cp.async ring brings each step's
// copies one step ahead; the max crosses the categories through
// distributed shared memory at one cluster barrier a step; O = div_rn(o,
// max) goes to a stage [child][S][tile].  This kernel's part is the walk's
// hook: after the __syncwarp that follows O's stage each warp writes its
// own 8 patterns' O rows from the stage as 4 rows x 8 patterns a store
// instruction (32-byte runs), and rank 0 the scales.  A step has one block
// barrier (the ring's release) and one cluster barrier.
//
// The walk is a chain of dependent steps whose latency a few warps an SM
// hide: one pattern a thread gives twice the warps of two (1 958 patterns,
// C=4: 980 warps, 7.4 an SM).  At most 128 registers a thread keep every
// cluster resident at C=8 (984 blocks of 64 threads need at most 136);
// past 8 categories a block of up to REVERSE_MULTI_THREADS_MAX threads.
//
// The walk keeps the row-group design's orders, so out and osc are that
// design's bit for bit.  A ragged last tile computes with pattern P - 1 and
// writes no column past P.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads up and usc
// and writes out and osc once, 2 x 600 x 81 rows x 1 958 x 4 B = 0.76 GB
// (3.35 TB/s: 0.23 ms); per step and pattern both children's messages,
// 2 x 1 600 multiply-adds, and per child 3 x 80 row operations, and a
// 1 600 multiply-add push into each of the 298 internal non-root
// children: 2 x 1 958 x (299 x 3 200 + 298 x 1 600) + 1 958 x 598 x 240
// = 5.9 GFLOP (67 TFLOP/s: 0.09 ms): bound by bytes.  The walk is a chain
// of 299 dependent steps.
//
// Past 8 categories (MULTI) a block holds CB of them on W category teams
// of tile x 4 threads and runs cluster_reverse_walk_multi: each phase of a
// step (o into O's stage, the exchange, then O divided, stored and
// pushed) as ceil(CB / W) units, each team a category a unit, so every
// category keeps the bits of one category a block; the hook writes a real
// category's O rows, a padding category's none.  W by least_units
// (DownStoreLaunch): at C = 80 and 16 patterns a cluster 2 teams, five
// units a phase and two blocks an SM at the bench tree's 5 slots.  Bound
// (C20, 300 taxa x 1 958 patterns): 15 GB of partials read and written
// (4.5 ms at 3.35 TB/s), bound by bytes.
//
// Shared memory a block: ReverseSmem (wide_common.cuh;
// cs_kernels.wide_down_store_smem), S = 20, C = 4, tile 16, 11 slots:
// 30 144 bytes; S = 64 (codon): 137 152 bytes, under the 232 448 a block
// may have: one block an SM, so the codon instance takes no register cap
// (launch bounds of one block).  Its bound (GY+F3X4+G4, 80 taxa x 457
// patterns, C = 4, the work at S = 61): reads up and writes out, 2 x 160 x
// 245 rows x 457 x 4 B = 153 MB (0.046 ms); 3.3 GFLOP by the count above
// (0.049 ms): bound by operations.
// The DNA instance (S = 4, DNA_RPT = 1 row a thread) runs past 8 categories
// only (MULTI; up to 8 the CS-packed csrc/down_store.cu serves), as wide_forward.cu's.
#include "wide_common.cuh"

using namespace iqtw;

template <int S, int RPT, bool MULTI>
__global__ void __launch_bounds__(MULTI ? REVERSE_MULTI_THREADS_MAX : CLUSTER_THREADS_MAX,
                                  MULTI || S > 32 ? 1 : 2)
wide_down_store_kernel(const int* __restrict__ steps, int n_steps,
                       const float* __restrict__ trans, const float* __restrict__ rootd,
                       const float* __restrict__ up, const float* __restrict__ usc, int P,
                       float* __restrict__ out, float* __restrict__ osc, int n_slots,
                       int tile, int C, int CB) {
  constexpr int G = S / RPT, QT = REVERSE_QT;
  // a warp's patterns, and the rows one of its store instructions covers
  constexpr int WP = 32 / G * QT, RW = 32 / WP;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int K = (int)cluster.num_blocks(), kb = (int)cluster.block_rank();
  if constexpr (!MULTI) C = K;  // a block a category
  // the thread's index in its category team (past 8 categories W teams of
  // T threads a block, else one)
  const int T = tile / QT * G, tid = MULTI ? (int)threadIdx.x % T : (int)threadIdx.x;
  const WalkLane<S, G> wl(tid);
  const int g = wl.g, pq = wl.pq;
  const int p0 = (int)(blockIdx.x / K) * tile;
  const int r0 = (tid & 31) / WP, qw = (tid >> 5) * WP + (tid & 31) % WP;
  const bool stores = p0 + qw < P;  // this lane's pattern of its warp's row stores
  if constexpr (MULTI) {
    // category c's O rows of the warp's patterns to out, and (rank 0, at
    // the first category) the scales to osc
    const auto hook = [&](const Step& st, int j, int c, const float* O,
                          const float (&sc)[2][QT], const float*) {
      if (c < C && stores)
#pragma unroll
        for (int side = 0; side < 2; ++side) {
          float* dst = out + ((size_t)(side ? st.r : st.l) * C + c) * S * P + p0 + qw;
          const float* src = O + (size_t)side * CB * S * tile + qw;
          for (int r = r0; r < S; r += RW) dst[(size_t)r * P] = src[r * tile];
        }
      if (kb == 0 && j == 0 && g < 2) {
        const int p = p0 + pq;
        if (p < P) osc[(size_t)(g ? st.r : st.l) * P + p] = g ? sc[1][0] : sc[0][0];
      }
    };
    cluster_reverse_walk_multi<S, RPT>(steps, n_steps, trans, rootd, up, usc, P, p0, tile,
                                       n_slots, C, CB, (int)blockDim.x / T, REVERSE_STAGES,
                                       smem, hook);
    return;
  }
  const int c = kb;
  // the warp's patterns' O rows to out, and (rank 0) their scales to osc: a
  // pattern group's G lanes share out its (child, pattern) pairs
  const auto hook = [&](const Step& st, const float* ost, const float (&sc)[2][QT],
                        const float*) {
    if (stores) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        float* dst = out + ((size_t)(side ? st.r : st.l) * C + c) * S * P + p0 + qw;
        for (int r = r0; r < S; r += RW) dst[(size_t)r * P] = ost[(side * S + r) * tile + qw];
      }
    }
    if (c == 0)
      for (int v = g; v < 2 * QT; v += G) {
        const int side = v / QT, qq = v - side * QT, p = p0 + pq * QT + qq;
        float val = 0.f;
#pragma unroll
        for (int u = 0; u < 2 * QT; ++u)
          if (u == v) val = sc[u / QT][u % QT];
        if (p < P) osc[(size_t)(side ? st.r : st.l) * P + p] = val;
      }
  };
  cluster_reverse_walk<S, RPT>(steps, n_steps, trans, rootd, up, usc, P, p0, tile, n_slots,
                               smem, hook);
}

// The launch of the instance <S, RPT> at C categories, tile patterns a
// cluster and n_slots slots: K blocks of CB categories on W category teams
// of T walk threads (least_units past 8 categories, else one), the
// shared memory of ReverseSmem, and the kernel (nullptr: no instance).  T
// is 0 for a tile whose teams are not whole warps or too large.
template <int S, int RPT>
struct DownStoreLaunch {
  int K, CB, T, W, threads;
  size_t smem;
  void (*kernel)(const int*, int, const float*, const float*, const float*, const float*, int,
                 float*, float*, int, int, int, int);
  DownStoreLaunch(int C, int tile, int n_slots)
      : K(wide_k(C)), CB(wide_cb(C)), T(tile / REVERSE_QT * (S / RPT)) {
    if (T % 32 || T > CLUSTER_THREADS_MAX) T = 0;
    const auto bytes = [&](int w) {
      return ReverseSmem<S, true>(tile, CB, w).floats(n_slots, K) * sizeof(float);
    };
    W = CB > 1 && T ? least_units(CB, 1, T, REVERSE_MULTI_THREADS_MAX, bytes) : 1;
    threads = W * T;
    smem = bytes(W);
    if constexpr (multi_only<S>)
      kernel = CB > 1 ? wide_down_store_kernel<S, RPT, true> : nullptr;
    else if constexpr (S <= 32)
      kernel = CB > 1 ? wide_down_store_kernel<S, RPT, true> : wide_down_store_kernel<S, RPT, false>;
    else
      kernel = CB > 1 ? nullptr : wide_down_store_kernel<S, RPT, false>;
  }
};

// tile: patterns a cluster, a multiple of 8 (a team has tile x 4 threads,
// whole warps) up to 64.  C categories on wide_k(C) blocks a cluster,
// wide_cb(C) a block (past 8 the S = 20 and S = 4 instances; S = 4 only
// past 8) on
// DownStoreLaunch's W category teams.
extern "C" int iqt_wide_down_store(const int* steps, int n_steps, const float* trans,
                                   const float* rootd, const float* up,
                                   const float* usc, int P, float* out, float* osc,
                                   int C, int S, int n_slots, int tile, void* stream) {
  if (C < 1 || tile <= 0 || tile % REVERSE_QT) return (int)cudaErrorInvalidValue;
  const int clusters = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                              \
  {                                                                                        \
    const DownStoreLaunch<SS_, RPT_> l(C, tile, n_slots);                                  \
    if (!l.T || !l.kernel) return (int)cudaErrorInvalidValue;                              \
    e = launch_clusters(l.kernel, clusters, l.K, l.threads, l.smem, stream, steps,         \
                        n_steps, trans, rootd, up, usc, P, out, osc, n_slots, tile, C,     \
                        l.CB);                                                             \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The launch iqt_wide_down_store makes at these sizes: info = {category
// teams W, threads a block, shared memory bytes a block, the most clusters
// the card holds at once}.
extern "C" int iqt_wide_down_store_layout(int C, int S, int n_slots, int tile, int* info) {
  if (C < 1 || tile <= 0 || tile % REVERSE_QT) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAYOUT(SS_, RPT_)                                                     \
  {                                                                               \
    const DownStoreLaunch<SS_, RPT_> l(C, tile, n_slots);                         \
    if (!l.T || !l.kernel) return (int)cudaErrorInvalidValue;                     \
    info[0] = l.W, info[1] = l.threads, info[2] = (int)l.smem;                    \
    e = active_clusters(l.kernel, l.K, l.threads, l.smem, info + 3);              \
  }
  IQT_DISPATCH_WIDE_S(S, IQT_LAYOUT)
#undef IQT_LAYOUT
  return (int)e;
}
