// Wide outside-partial store: every node's normalized outside partial and
// its log-scale at the general [C,S,S] layout (protein, S = 20), the
// second of the NNI evaluator's two global passes.
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
// Work layout: wide_newton.cu's reverse walk with one matrix in place of
// three.  A thread-block cluster of C blocks, one a rate category, owns a
// tile of consecutive patterns; thread (q, g) of a block holds one pattern
// q (QT = 1) and the RPT = 5 state rows g RPT .. of its category (G = S /
// RPT consecutive lanes a pattern).  A two-stage cp.async ring brings each
// step's copies one step ahead: the category's [S,S] block of each child
// and each child's S rows and scale for the tile.  A step forms both
// messages (t ascending), o = d * m_sib for each child, and the max over
// the pattern's C*S rows: the category's rows in log2(G) shuffle rounds,
// the categories through distributed shared memory (every block stores its
// per-pattern maxima into every block's buffer [parity][rank][child][tile],
// double-buffered by step parity) at one cluster barrier.  Then O =
// div_rn(o, max) goes to a stage [child][S][tile], and after a __syncwarp
// each warp writes its own 8 patterns' O rows from the stage as 4 rows x 8
// patterns a store instruction (32-byte runs), rank 0 the scales, and
// pushes P^T O (s ascending) into the pool [slot][S+1][tile] from the
// stage's columns.  A step has one block barrier (the ring's release) and
// one cluster barrier.
//
// The walk is a chain of dependent steps whose latency a few warps an SM
// hide: one pattern a thread gives twice the warps of two (1 958 patterns,
// C=4: 980 warps, 7.4 an SM).  At most 128 registers a thread keep every
// cluster resident at C=8 (984 blocks of 64 threads need at most 136).
//
// The orders are the row-group design's: messages with t ascending, an
// exact max, the float division's bits (div_rn), the scale chain
// dsc + s_sib + log(max) and the push with s ascending, so out and osc are
// that design's bit for bit.  A ragged last tile computes with pattern
// P - 1 and writes no column past P.
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
// Shared memory a block (floats), with tile patterns, n_slots slots and
// STAGES = 2 (cs_kernels.wide_down_store_smem):
//     STAGES x (2 S^2 + 2 (S+1) tile)   the ring
//   + n_slots (S+1) tile                the pool
//   + 2 S tile                          O's stage
//   + 4 C tile                          the max buffers
// S = 20, C = 4, tile 16, 11 slots: 30 144 bytes; S = 61 (codon): 127 888
// bytes, under the 232 448 a block may have.
#include "wide_common.cuh"

using namespace iqtw;

// Steps whose matrices and child partials are in flight at once (a
// cp.async ring).
constexpr int STAGES = 2;
// Patterns a thread: one, where the forward walk's threads hold two
// (CLUSTER_QT): a step here is about twice a forward step's work.
constexpr int QT = 1;

template <int S>
inline size_t down_store_smem(int C, int tile, int n_slots) {
  return ((size_t)STAGES * (2 * S * S + 2 * (S + 1) * tile) +
          (size_t)n_slots * (S + 1) * tile + 2 * (size_t)S * tile + 4 * (size_t)C * tile) *
         sizeof(float);
}

// Step j's inputs for category c into stage k: both children's [S,S]
// blocks (mst_k [child][S*S]) and their S rows and scale for the tile's
// patterns (ust_k [child][S+1][tile]; a ragged tail repeats P - 1).
template <int S>
__device__ __forceinline__ void fetch_step(const Step& sj, float* mst_k, float* ust_k, int c,
                                           int C, int tile, int p0,
                                           const float* __restrict__ trans,
                                           const float* __restrict__ up,
                                           const float* __restrict__ usc, int P) {
  fetch_blocks<S>(sj, mst_k, c, C, trans);
  // a thread copies one pattern's words (T % tile == 0)
  const int T = blockDim.x, tid = threadIdx.x;
  const int qq = tid % tile, p = min(p0 + qq, P - 1);
  for (int row = tid / tile; row < 2 * (S + 1); row += T / tile) {
    const int side = row / (S + 1), t = row - side * (S + 1);
    const int node = side ? sj.r : sj.l;
    const float* src = t < S ? up + ((size_t)node * C * S + c * S + t) * P + p
                             : usc + (size_t)node * P + p;
    __pipeline_memcpy_async(ust_k + row * tile + qq, src, 4);
  }
}

template <int S, int RPT>
__global__ void __launch_bounds__(CLUSTER_THREADS_MAX, 2)
wide_down_store_kernel(const int* __restrict__ steps, int n_steps,
                       const float* __restrict__ trans, const float* __restrict__ rootd,
                       const float* __restrict__ up, const float* __restrict__ usc, int P,
                       float* __restrict__ out, float* __restrict__ osc, int n_slots,
                       int tile) {
  constexpr int G = S / RPT, SS = S * S;
  // a warp's patterns, and the rows one of its store instructions covers
  constexpr int WP = 32 / G * QT, RW = 32 / WP;
  static_assert(S % RPT == 0 && G <= 32 && (G & (G - 1)) == 0,
                "a pattern's row groups are a power of two of consecutive lanes");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int tid = threadIdx.x, g = tid % G, s0 = g * RPT, pq = tid / G;
  const int p0 = (int)(blockIdx.x / C) * tile;
  const int r0 = (tid & 31) / WP, qw = (tid >> 5) * WP + (tid & 31) % WP;
  const bool stores = p0 + qw < P;  // this lane's pattern of its warp's row stores
  float* mst = smem;                                        // [STAGES][2][SS]
  float* ust = mst + STAGES * 2 * SS;                       // [STAGES][2][S+1][tile]
  float* pool = ust + (size_t)STAGES * 2 * (S + 1) * tile;  // [n_slots][S+1][tile]
  float* ost = pool + (size_t)n_slots * (S + 1) * tile;     // [2][S][tile]
  float* xmax = ost + 2 * S * tile;                         // [2][C][2][tile]
  int q[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) q[qq] = pq * QT + qq;

  // the walk runs from step n_steps - 1 down; step i's inputs sit in stage
  // (n_steps - 1 - i) % STAGES
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < n_steps)
      fetch_step<S>(load_step(steps, n_steps - 1 - k), mst + k * 2 * SS,
                    ust + (size_t)k * 2 * (S + 1) * tile, c, C, tile, p0, trans, up, usc, P);
    __pipeline_commit();
  }
  cluster.sync();  // every block of the cluster runs before the first remote store
  Step st = load_step(steps, n_steps - 1);
  Step st_f = n_steps >= STAGES ? load_step(steps, n_steps - STAGES) : st;  // the next fetch
  int k = 0;  // the stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    __pipeline_wait_prior(STAGES - 2);  // this thread's copies of step i have landed
    __syncthreads();                    // every thread's, and step i + 1's stage is free
    const int kf = k == 0 ? STAGES - 1 : k - 1;
    if (i >= STAGES - 1)
      fetch_step<S>(st_f, mst + kf * 2 * SS, ust + (size_t)kf * 2 * (S + 1) * tile, c, C,
                    tile, p0, trans, up, usc, P);
    __pipeline_commit();
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;
    if (i >= STAGES) st_f = load_step(steps, i - STAGES);

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
    for (int off = 1; off < G; off <<= 1)
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
    cluster.sync();  // the exchange: every block's maxima of step i are written
#pragma unroll
    for (int side = 0; side < 2; ++side)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        mx[side][qq] = 0.f;
        for (int r = 0; r < C; ++r)
          mx[side][qq] = fmaxf(mx[side][qq], xm[(r * 2 + side) * tile + q[qq]]);
        mx[side][qq] = fmaxf(mx[side][qq], SCALE_TINY);
      }

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

    // the warp's patterns' O rows to out, and (rank 0) their scales to
    // osc: a pattern group's G lanes share out its (child, pattern) pairs
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
    k = k == STAGES - 1 ? 0 : k + 1;
  }
}

// tile: patterns a cluster, a multiple of 8 (a block has tile x 4 threads,
// whole warps) up to 64.
extern "C" int iqt_wide_down_store(const int* steps, int n_steps, const float* trans,
                                   const float* rootd, const float* up,
                                   const float* usc, int P, float* out, float* osc,
                                   int C, int S, int n_slots, int tile, void* stream) {
  if (C < 1 || C > 8 || tile <= 0 || tile % QT) return (int)cudaErrorInvalidValue;
  const int clusters = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                          \
  {                                                                                    \
    const int threads = tile / QT * (SS_ / RPT_);                                      \
    if (threads % 32 || threads > CLUSTER_THREADS_MAX)                                 \
      return (int)cudaErrorInvalidValue;                                               \
    e = launch_clusters(wide_down_store_kernel<SS_, RPT_>, clusters, C, threads,       \
                        down_store_smem<SS_>(C, tile, n_slots), stream, steps, n_steps, \
                        trans, rootd, up, usc, P, out, osc, n_slots, tile);            \
  }
  IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
