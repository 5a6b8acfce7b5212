// Wide branch-Newton sweep: first and second derivatives of lnL with
// respect to every branch length at once, at the general [C,S,S] layout
// (protein, S = 20, up to 8 categories; DNA, S = 4, past 8 categories:
// wide_newton_multi_kernel below).
//
// Replaces the TPU kernel _kernel_newton_cs_stream / _newton_body
// (iqtree_tpu/engine/kernels/cs_kernels.py), which streams each child's
// stacked [3CS, CS] block from HBM because the stacked matrices of all
// edges do not fit VMEM at CS = 80.  Reverse walk of the slot schedule:
// for each child edge e it forms the outside partial O_e and, with
// f_k = sum_cs O_e * (P_e^(k) U_e) for P, P', P'' of the edge,
//     d1[e] = sum_p w_p f1/den,   d2[e] = sum_p w_p (f2/den - (f1/den)^2),
// where den = f0 + the invariant-site term in the scaled frame.  The root
// and dummy rows stay 0.
//
// Work layout at S = 20: a thread-block cluster of C blocks, one a rate
// category, owns a tile of `tile` consecutive patterns.  A block stages its
// category's (P, P', P'') blocks of the step's two children only, so its
// shared memory barely grows with C.  Thread (pq, g) of a block holds
// QT consecutive patterns (q = pq QT + qq) and the RPT state rows
// g RPT .. g RPT + RPT - 1 of the category (G = S / RPT row groups, G
// consecutive lanes a pattern group): a message row costs it S / 4
// float4 loads of the staged P row, each word feeding QT multiply-adds,
// and the child's S-value columns, each feeding 3 RPT.  The renormalizing
// max crosses the category's rows in log2(G) shuffle rounds and the
// categories through distributed shared memory: each block writes its
// per-pattern max into every block's buffer [rank][...] (remote stores),
// a cluster barrier, and every block takes the max of the C values in its
// own buffer.  The f0, f1, f2 sums are the rank-0 block's: every thread
// writes its RPT rows' sums into its block's buffer [g][...], a second
// cluster barrier, and rank 0 reads the C x G row groups and adds them in
// order,
// forms each pattern's edge terms and adds each group of SUM_PATTERNS
// patterns in order into its row of part; reduce_blocks adds the rows in
// order.  These are the earlier thread-per-row-group design's orders (its
// tile was 16 patterns), so d1/d2 keep its bits; no float atomics.  The
// pushed outside partials P^T O wait in a shared-memory pool
// [slot][S+1][tile] (a thread's own rows, and the patterns' log-scales);
// a pattern's O rows cross its G lanes through a shared-memory stage.
//
// Loads off the chain: step i - 1's matrices and its children's partials
// and scales are cp.async copies into a two-stage ring, issued as step i
// starts; one block barrier a step releases the ring.
//
// Numerics: the 1e-30 floor, the exp clamp at 80, IEEE float32 products
// and divisions (div_rn: the float division's bits without its branches),
// the earlier design's message, transport and sum orders.
//
// Shared memory a block (floats), with tile patterns and n_slots slots:
//     STAGES x 6 S^2            the matrices' ring
//   + STAGES x 2 (S+1) tile     the children's rows and scales
//   + n_slots (S+1) tile        the pool
//   + 2 S tile                  O's stage
//   + (2 C + 6 G + 4) tile      the exchange buffers, the edge terms
// S = 20, C = 4, tile 32, 10 slots: 16 640 floats (66 560 bytes).  Only
// the max buffers grow with C: at S = 61, C = 4, G = 4, tile 8 and 10
// slots it is 52 860 floats (211 440 bytes), under the 232 448 bytes (227
// KiB) a block may have; the earlier design staged all C categories of
// both children, 357 216 bytes.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads the stored
// partials once, 0.39 GB (3.35 TB/s: 0.12 ms); per step and pattern
// (P, P', P'') U for both children, 6 x 1 600 multiply-adds and 12 x 80
// row operations, and a 1 600 multiply-add push into each of the 298
// internal non-root children:
// 2 x 1 958 x (299 x 10 560 + 298 x 1 600) = 14.2 GFLOP (67 TFLOP/s:
// 0.21 ms): bound by operations.  At tile 32: 62 clusters of 4 blocks of
// 64 threads (248 blocks, 496 warps, ~3.8 an SM).
#include <cooperative_groups.h>

#include "wide_common.cuh"

namespace cg = cooperative_groups;
using namespace iqtw;

// Steps whose matrices and child partials are in flight at once (a
// cp.async ring).
constexpr int STAGES = 2;
// Patterns a thread: each staged P word loaded feeds QT multiply-adds.
constexpr int QT = 2;
// Patterns whose edge terms are added in order into one row of part: the
// earlier design's tile, so that d1/d2 keep its bits (a smaller cluster
// tile adds its own patterns).
constexpr int SUM_PATTERNS = 16;
// Largest block (the register budget stays at 255 a thread).
constexpr int NEWTON_THREADS_MAX = 256;

template <int S, int G>
inline size_t wide_newton_smem(int C, int tile, int n_slots) {
  return ((size_t)STAGES * 6 * S * S + (size_t)STAGES * 2 * (S + 1) * tile +
          (size_t)n_slots * (S + 1) * tile + 2 * (size_t)S * tile +
          (2 * (size_t)C + 6 * G + 4) * tile) *
         sizeof(float);
}

// Step j's inputs for category c into stage k: both children's (P, P', P'')
// [S,S] blocks (mst_k [child][3][S*S]) and their S rows and scale for the
// tile's patterns (ust_k [child][S+1][tile]; a ragged tail repeats P - 1).
template <int S>
__device__ __forceinline__ void fetch_step(const Step& sj, float* mst_k, float* ust_k, int c,
                                           int C, int tile, int p0,
                                           const float* __restrict__ mats,
                                           const float* __restrict__ up,
                                           const float* __restrict__ usc, int P) {
  constexpr int SS = S * S;
  const int T = blockDim.x, tid = threadIdx.x;
  if constexpr (SS % 4 == 0) {
    constexpr int V = SS / 4;  // 16-byte rows a block
    for (int q = tid; q < 6 * V; q += T) {
      const int blk = q / V, r = q - blk * V;  // blk = child * 3 + matrix
      const int node = blk < 3 ? sj.l : sj.r;
      __pipeline_memcpy_async(mst_k + blk * SS + 4 * r,
                              mats + (((size_t)node * 3 + blk % 3) * C + c) * SS + 4 * r, 16);
    }
  } else {
    for (int q = tid; q < 6 * SS; q += T) {
      const int blk = q / SS, r = q - blk * SS;
      const int node = blk < 3 ? sj.l : sj.r;
      __pipeline_memcpy_async(mst_k + q, mats + (((size_t)node * 3 + blk % 3) * C + c) * SS + r,
                              4);
    }
  }
  // a thread copies one pattern's words (T % tile == 0)
  const int qq = tid % tile, p = min(p0 + qq, P - 1);
  for (int row = tid / tile; row < 2 * (S + 1); row += T / tile) {
    const int side = row / (S + 1), t = row - side * (S + 1);
    const int node = side ? sj.r : sj.l;
    const float* src = t < S ? up + ((size_t)node * C * S + c * S + t) * P + p
                             : usc + (size_t)node * P + p;
    __pipeline_memcpy_async(ust_k + row * tile + qq, src, 4);
  }
}

// m[j][qq] = sum_t M[s0+j][t] x[t][qq] for this thread's rows and patterns,
// in the order of the earlier design's message (t ascending).
template <int S, int RPT>
__device__ __forceinline__ void message_tile(const float* M, int s0, const float (&x)[S][QT],
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

// Shuffle rounds over the G row-group lanes of a pattern group (K values).
template <int G, int K>
__device__ __forceinline__ void rows_max(float (&v)[K]) {
#pragma unroll
  for (int off = 1; off < G; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] = fmaxf(v[k], __shfl_xor_sync(0xffffffffu, v[k], off));
}

// One barrier of the cluster between the blocks' writes into each other's
// exchange buffers and their reads of their own.
__device__ __forceinline__ void exchange_barrier(cg::cluster_group& cluster) {
  cluster.sync();
}

template <int S, int RPT>
__global__ void __launch_bounds__(NEWTON_THREADS_MAX)
wide_newton_kernel(const int* __restrict__ steps, int n_steps,
                   const float* __restrict__ mats,  // [2N][3][C][S][S]
                   const float* __restrict__ rootd, const float* __restrict__ wp,
                   const float* __restrict__ invar, const float* __restrict__ up,
                   const float* __restrict__ usc, int P, int n_nodes,
                   float* __restrict__ part, int n_slots, int tile) {
  constexpr int G = S / RPT, SS = S * S;
  static_assert(S % RPT == 0 && G <= 32 && (G & (G - 1)) == 0,
                "a pattern's row groups are a power of two of consecutive lanes");
  static_assert(G % QT == 0, "a block's threads are a multiple of its tile");
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), c = (int)cluster.block_rank();
  const int T = blockDim.x, tid = threadIdx.x;
  const int g = tid % G, s0 = g * RPT, pq = tid / G;
  const int group = min(tile, SUM_PATTERNS), groups = tile / group;
  const int cluster_id = blockIdx.x / C, p0 = cluster_id * tile;
  float* mst = smem;                                    // [STAGES][2][3][SS]
  float* ust = mst + STAGES * 6 * SS;                   // [STAGES][2][S+1][tile]
  float* pool = ust + (size_t)STAGES * 2 * (S + 1) * tile;  // [n_slots][S+1][tile]
  float* ost = pool + (size_t)n_slots * (S + 1) * tile;    // [2][S][tile]
  float* xmax = ost + 2 * S * tile;                     // [C][2][tile]
  float* xsum = xmax + 2 * C * tile;                    // [G][2][3][tile]
  float* vsum = xsum + 6 * G * tile;                    // [2][2][tile] (rank 0's)
  int q[QT];
  float w_p[QT], inv_p[QT];
#pragma unroll
  for (int qq = 0; qq < QT; ++qq) {
    q[qq] = pq * QT + qq;
    const int p = min(p0 + q[qq], P - 1);
    w_p[qq] = p0 + q[qq] < P ? __ldg(wp + p) : 0.f;  // a ragged tail adds 0
    inv_p[qq] = __ldg(invar + p);
  }

  // the walk runs from step n_steps - 1 down; step i's inputs sit in
  // stage (n_steps - 1 - i) % STAGES
  fetch_step<S>(load_step(steps, n_steps - 1), mst, ust, c, C, tile, p0, mats, up, usc, P);
  __pipeline_commit();
  Step st = load_step(steps, n_steps - 1);
  int k = 0;  // the stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    __pipeline_wait_prior(0);  // this thread's copies of step i have landed
    __syncthreads();           // every thread's, and step i + 1's stage is free
    const int k_next = k == STAGES - 1 ? 0 : k + 1;
    if (i > 0)
      fetch_step<S>(load_step(steps, i - 1), mst + k_next * 6 * SS,
                    ust + (size_t)k_next * 2 * (S + 1) * tile, c, C, tile, p0, mats, up,
                    usc, P);
    __pipeline_commit();
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;

    const float* Mk = mst + k * 6 * SS;  // [child][P, P', P''][S][S]
    const float* Uk = ust + (size_t)k * 2 * (S + 1) * tile;
    float d[RPT][QT], dsc[QT], sl[QT], sr[QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      sl[qq] = Uk[S * tile + q[qq]];
      sr[qq] = Uk[(2 * S + 1) * tile + q[qq]];
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
    // the messages (P, P', P'') U of both children, m[side][matrix]
    float m[2][3][RPT][QT];
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      float x[S][QT];
      const float* U = Uk + side * (S + 1) * tile;
#pragma unroll
      for (int t = 0; t < S; ++t)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) x[t][qq] = U[t * tile + q[qq]];
#pragma unroll
      for (int mm = 0; mm < 3; ++mm)
        message_tile<S, RPT>(Mk + (side * 3 + mm) * SS, s0, x, m[side][mm]);
    }

    // exchange 1: the max of o = d * m_sib over the pattern's C*S rows
    float mx[2 * QT];  // left edge's patterns, then the right's
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      mx[qq] = mx[QT + qq] = 0.f;
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        mx[qq] = fmaxf(mx[qq], d[j][qq] * m[1][0][j][qq]);
        mx[QT + qq] = fmaxf(mx[QT + qq], d[j][qq] * m[0][0][j][qq]);
      }
    }
    rows_max<G>(mx);
    for (int r = g; r < C; r += G) {  // the G lanes of a pattern group share the blocks out
      float* xr = cluster.map_shared_rank(xmax, r) + c * 2 * tile;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        xr[q[qq]] = mx[qq];
        xr[tile + q[qq]] = mx[QT + qq];
      }
    }
    exchange_barrier(cluster);
#pragma unroll
    for (int v = 0; v < 2 * QT; ++v) mx[v] = 0.f;
    for (int r = 0; r < C; ++r) {
      const float* xr = xmax + r * 2 * tile;
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        mx[qq] = fmaxf(mx[qq], xr[q[qq]]);
        mx[QT + qq] = fmaxf(mx[QT + qq], xr[tile + q[qq]]);
      }
    }
#pragma unroll
    for (int v = 0; v < 2 * QT; ++v) mx[v] = fmaxf(mx[v], SCALE_TINY);

    // exchange 2: f_k = sum over the C*S rows of O * (P^(k) U), O = o / max
    float f[2 * 3 * QT];  // [side][k][qq]
#pragma unroll
    for (int v = 0; v < 6 * QT; ++v) f[v] = 0.f;
    float* os = ost + s0 * tile;
#pragma unroll
    for (int j = 0; j < RPT; ++j)
#pragma unroll
      for (int qq = 0; qq < QT; ++qq) {
        const float ol = iqt::div_rn(d[j][qq] * m[1][0][j][qq], mx[qq]);
        const float orr = iqt::div_rn(d[j][qq] * m[0][0][j][qq], mx[QT + qq]);
        os[j * tile + q[qq]] = ol;
        os[(S + j) * tile + q[qq]] = orr;
#pragma unroll
        for (int mm = 0; mm < 3; ++mm) {
          f[mm * QT + qq] += ol * m[0][mm][j][qq];
          f[(3 + mm) * QT + qq] += orr * m[1][mm][j][qq];
        }
      }
    {  // each thread's row-group sums, which rank 0 reads after the barrier
      float* xr = xsum + g * 6 * tile;
#pragma unroll
      for (int v = 0; v < 6; ++v)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) xr[v * tile + q[qq]] = f[v * QT + qq];
    }
    exchange_barrier(cluster);
    float osc[2][QT];
#pragma unroll
    for (int qq = 0; qq < QT; ++qq) {
      osc[0][qq] = dsc[qq] + sr[qq] + logf(mx[qq]);
      osc[1][qq] = dsc[qq] + sl[qq] + logf(mx[QT + qq]);
    }

    // the edges' per-pattern terms (rank 0): f_k over the C x G row groups
    // in order, then each group of SUM_PATTERNS patterns summed in order;
    // a pattern group's G lanes share out its (side, pattern) pairs
    if (c == 0) {
      for (int sq = g; sq < 2 * QT; sq += G) {
        const int side = sq / QT, qq = sq - side * QT, qp = pq * QT + qq;
        float s_child = 0.f, osc_s = 0.f, w = 0.f, inv = 0.f;
#pragma unroll
        for (int u = 0; u < QT; ++u)
          if (u == qq) {
            s_child = side ? sr[u] : sl[u];
            osc_s = side ? osc[1][u] : osc[0][u];
            w = w_p[u];
            inv = inv_p[u];
          }
        float fk[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int cc = 0; cc < 8; ++cc)
          if (cc < C) {
            const float* xs = cluster.map_shared_rank(xsum, cc) + 3 * side * tile + qp;
#pragma unroll
            for (int gg = 0; gg < G; ++gg)
#pragma unroll
              for (int mm = 0; mm < 3; ++mm) fk[mm] += xs[(gg * 6 + mm) * tile];
          }
        const float inv_t = inv > 0.f ? inv * expf(fminf(-(osc_s + s_child), 80.f)) : 0.f;
        const float den = fmaxf(fk[0], SCALE_TINY) + inv_t;
        const float r1 = iqt::div_rn(fk[1], den), r2 = iqt::div_rn(fk[2], den);
        vsum[(2 * side) * tile + qp] = w * r1;
        vsum[(2 * side + 1) * tile + qp] = w * (r2 - r1 * r1);
      }
      __syncthreads();  // the block's per-pattern terms are written
      if (tid < 4 * groups) {  // (group, side, term)
        const int grp = tid >> 2, w = tid & 3;
        const float* vp = vsum + w * tile + grp * group;
        float acc = 0.f;
#pragma unroll
        for (int u = 0; u < SUM_PATTERNS; ++u)
          if (u < group) acc += vp[u];
        part[((size_t)cluster_id * groups + grp) * n_nodes * 2 +
             2 * (w < 2 ? st.l : st.r) + (w & 1)] = acc;
      }
    }

    // the children's outside partials, pushed through their edges (P^T O),
    // wait in the pool for their own steps (d is read: a child may reuse
    // st.out); a pattern's O rows come from the O stage, which its G lanes
    // wrote before exchange 2's barrier
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int cslot = side ? st.rs : st.ls;
      if (cslot < 0) continue;
      const float* M = Mk + side * 3 * SS;  // the child's P
      const float* o = ost + side * S * tile;
      float dd[RPT][QT];
#pragma unroll
      for (int j = 0; j < RPT; ++j)
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) dd[j][qq] = 0.f;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        float os_[QT];
#pragma unroll
        for (int qq = 0; qq < QT; ++qq) os_[qq] = o[s * tile + q[qq]];
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
        if (g == 0) col[S * tile + q[qq]] = osc[side][qq];
      }
    }
    st = st_next;
    k = k_next;
  }
  cluster.sync();  // no block leaves while another may read its buffers
}

// ---------------------------------------------------------------------------
// Past 8 categories at S = 4 (DNA FreeRate +R9 .., a DNA mixture of more
// than 8 classes), up to C S = 128 rows a pattern (MULTI_ROWS_MAX: the JAX
// package's streamed sweep serves C S <= 128): one block, no cluster, owns
// a tile of patterns and all C categories.  Thread (c, q) = (tid / tile,
// tid % tile) holds pattern q's S rows of category c, so a category's
// message, its O rows and its push P^T O are the thread's own and only the
// per-pattern max and the f0, f1, f2 sums cross categories, through shared
// memory: every thread writes its value into [c][...][q], a block barrier,
// and each thread takes the max of the C values of its pattern in category
// order; threads (side, q) of the first 2 tile add the C sums of child
// `side` in category order, form the edge terms as above, and the first
// 4 groups threads add each group of SUM_PATTERNS patterns in order into
// its row of part.  A step's matrices (P, P', P'': 3 S float4 rows a child
// and category) and the children's S rows come straight from global
// memory (__ldg; a warp reads tile / 32 categories' rows, the tile's
// patterns of a row coalesced).  Four block barriers a step order the
// pool's scale rows, the max buffer, the sums and the edge terms.
//
// Shared memory a block (floats): n_slots (C S + 1) tile (the pool) +
// 2 C tile (the maxima) + 6 C tile (the sums) + 4 tile (the edge terms).
// C = 10, tile 16, 11 slots: 8 560 floats (34 240 bytes); C = 32: 26 864
// floats (107 456 bytes).
// ---------------------------------------------------------------------------

// The most rows a pattern (C S) and the largest block of the multi-category
// instance (tile x C threads, rounded up to whole warps).
constexpr int MULTI_ROWS_MAX = 128;
constexpr int MULTI_NEWTON_THREADS_MAX = 512;

inline size_t wide_newton_multi_smem(int C, int S, int tile, int n_slots) {
  return ((size_t)n_slots * (C * S + 1) + 8 * (size_t)C + 4) * tile * sizeof(float);
}

template <int S>
__global__ void __launch_bounds__(MULTI_NEWTON_THREADS_MAX)
wide_newton_multi_kernel(const int* __restrict__ steps, int n_steps,
                         const float* __restrict__ mats,  // [2N][3][C][S][S]
                         const float* __restrict__ rootd, const float* __restrict__ wp,
                         const float* __restrict__ invar, const float* __restrict__ up,
                         const float* __restrict__ usc, int P, int n_nodes,
                         float* __restrict__ part, int n_slots, int tile, int C) {
  static_assert(S == 4, "a category's rows are one float4 each");
  constexpr int SS = S * S;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, c = tid / tile, q = tid % tile;
  const bool real = c < C;  // the last warp's other threads only join the barriers
  const int CR = C * S;     // a slot's rows
  const int group = min(tile, SUM_PATTERNS), groups = tile / group;
  const int p0 = blockIdx.x * tile, p = min(p0 + q, P - 1);
  float* pool = smem;                                    // [n_slots][CR+1][tile]
  float* xmax = pool + (size_t)n_slots * (CR + 1) * tile;  // [C][2][tile]
  float* xsum = xmax + 2 * (size_t)C * tile;             // [C][2][3][tile]
  float* vsum = xsum + 6 * (size_t)C * tile;             // [2][2][tile]
  const float w_p = p0 + q < P ? __ldg(wp + p) : 0.f;    // a ragged tail adds 0
  const float inv_p = __ldg(invar + p);

  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    __syncthreads();  // the last step's scale rows, sums and edge terms are read
    float d[S], dsc = 0.f, sc[2] = {0.f, 0.f}, mx[2] = {0.f, 0.f}, esc = 0.f;
    float m[2][3][S], o[2][S];  // the children's (P, P', P'') U; o = d * m_sib
    if (real) {
      if (i == n_steps - 1) {
#pragma unroll
        for (int j = 0; j < S; ++j) d[j] = __ldg(rootd + c * S + j);
      } else {
        const float* col = pool + (size_t)st.out * (CR + 1) * tile + q;
#pragma unroll
        for (int j = 0; j < S; ++j) d[j] = col[(c * S + j) * tile];
        dsc = col[CR * tile];
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        const int node = side ? st.r : st.l;
        const float* u = up + ((size_t)node * C + c) * S * P + p;
        float x[S];
#pragma unroll
        for (int t = 0; t < S; ++t) x[t] = __ldg(u + (size_t)t * P);
        sc[side] = __ldg(usc + (size_t)node * P + p);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4* M = reinterpret_cast<const float4*>(
              mats + (((size_t)node * 3 + k) * C + c) * SS);
#pragma unroll
          for (int j = 0; j < S; ++j) {
            const float4 w = __ldg(M + j);
            float acc = 0.f;
            acc += w.x * x[0];
            acc += w.y * x[1];
            acc += w.z * x[2];
            acc += w.w * x[3];
            m[side][k][j] = acc;
          }
        }
      }
#pragma unroll
      for (int side = 0; side < 2; ++side) {
#pragma unroll
        for (int j = 0; j < S; ++j) {
          o[side][j] = d[j] * m[1 - side][0][j];
          mx[side] = fmaxf(mx[side], o[side][j]);
        }
        xmax[(c * 2 + side) * tile + q] = mx[side];
      }
    }
    __syncthreads();  // every category's maxima of step i are written
    if (real) {
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        float v = 0.f;
        for (int r = 0; r < C; ++r) v = fmaxf(v, xmax[(r * 2 + side) * tile + q]);
        mx[side] = fmaxf(v, SCALE_TINY);
      }
      float os[2];  // the children's outside scales
      os[0] = dsc + sc[1] + logf(mx[0]);
      os[1] = dsc + sc[0] + logf(mx[1]);
#pragma unroll
      for (int side = 0; side < 2; ++side) {
        float f[3] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < S; ++j) {
          o[side][j] = iqt::div_rn(o[side][j], mx[side]);
#pragma unroll
          for (int k = 0; k < 3; ++k) f[k] += o[side][j] * m[side][k][j];
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) xsum[((c * 2 + side) * 3 + k) * tile + q] = f[k];
        // the child's outside partial, pushed through its edge (P^T O), waits
        // in the pool for its own step (d is read: a child may reuse st.out)
        const int cslot = side ? st.rs : st.ls;
        if (cslot >= 0) {
          const float4* M = reinterpret_cast<const float4*>(
              mats + (((size_t)(side ? st.r : st.l) * 3) * C + c) * SS);
          float dd[S] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int s = 0; s < S; ++s) {
            const float4 w = __ldg(M + s);
            dd[0] += w.x * o[side][s];
            dd[1] += w.y * o[side][s];
            dd[2] += w.z * o[side][s];
            dd[3] += w.w * o[side][s];
          }
          float* col = pool + (size_t)cslot * (CR + 1) * tile + q;
#pragma unroll
          for (int j = 0; j < S; ++j) col[(c * S + j) * tile] = dd[j];
          if (c == 0) col[CR * tile] = os[side];
        }
      }
      esc = c == 0 ? os[0] + sc[0] : os[1] + sc[1];  // edge c's scale (read at c < 2)
    }
    __syncthreads();  // every category's sums of step i are written
    if (tid < 2 * tile) {  // (side = c, pattern q)
      float fk[3] = {0.f, 0.f, 0.f};
      for (int r = 0; r < C; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k) fk[k] += xsum[((r * 2 + c) * 3 + k) * tile + q];
      const float inv_t = inv_p > 0.f ? inv_p * expf(fminf(-esc, 80.f)) : 0.f;
      const float den = fmaxf(fk[0], SCALE_TINY) + inv_t;
      const float r1 = iqt::div_rn(fk[1], den), r2 = iqt::div_rn(fk[2], den);
      vsum[(2 * c) * tile + q] = w_p * r1;
      vsum[(2 * c + 1) * tile + q] = w_p * (r2 - r1 * r1);
    }
    __syncthreads();  // the edge terms are written
    if (tid < 4 * groups) {  // (group, side, term)
      const int grp = tid >> 2, w = tid & 3;
      const float* vp = vsum + w * tile + grp * group;
      float acc = 0.f;
      for (int u = 0; u < group; ++u) acc += vp[u];
      part[((size_t)blockIdx.x * groups + grp) * n_nodes * 2 + 2 * (w < 2 ? st.l : st.r) +
           (w & 1)] = acc;
    }
  }
}

// tile: patterns a cluster (a multiple of 16, or 8); a block has tile / QT
// x G threads (a multiple of 32), and part must have ceil(P / tile) x
// tile / min(tile, 16) rows of [n_nodes][2] (a row a group of 16 patterns;
// cs_kernels.wide_newton_part_rows sizes it so).
extern "C" int iqt_wide_newton(const int* steps, int n_steps, const float* mats,
                               const float* rootd, const float* wp, const float* invar,
                               const float* up, const float* usc, int P, int n_nodes,
                               float* part, float* d12, int C, int S, int n_slots,
                               int tile, void* stream) {
  const int group = tile < SUM_PATTERNS ? tile : SUM_PATTERNS;
  if (tile <= 0 || tile % QT || tile % group) return (int)cudaErrorInvalidValue;
  const int clusters = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
  if (S == 4) {  // past 8 categories only: up to 8 the CS-packed newton.cu serves DNA
    const int threads = (C * tile + 31) / 32 * 32;
    const size_t smem = wide_newton_multi_smem(C, S, tile, n_slots);
    if (C <= 8 || C * S > MULTI_ROWS_MAX || threads > MULTI_NEWTON_THREADS_MAX ||
        smem > MAX_BLOCK_SMEM)
      return (int)cudaErrorInvalidValue;
    e = iqt::allow_smem(wide_newton_multi_kernel<4>, smem);
    if (e == cudaSuccess)
      wide_newton_multi_kernel<4><<<clusters, threads, smem, (cudaStream_t)stream>>>(
          steps, n_steps, mats, rootd, wp, invar, up, usc, P, n_nodes, part, n_slots, tile,
          C);
  } else {
    if (C < 1 || C > 8) return (int)cudaErrorInvalidValue;
#define IQT_LAUNCH(SS_, RPT_)                                                       \
  {                                                                                 \
    constexpr int G = SS_ / RPT_;                                                   \
    const int threads = tile / QT * G;                                              \
    if (threads % 32 || threads > NEWTON_THREADS_MAX)                               \
      return (int)cudaErrorInvalidValue;                                            \
    const size_t smem = wide_newton_smem<SS_, G>(C, tile, n_slots);                 \
    e = iqt::allow_smem(wide_newton_kernel<SS_, RPT_>, smem);                       \
    if (e == cudaSuccess) {                                                         \
      cudaLaunchConfig_t cfg = {};                                                  \
      cfg.gridDim = dim3(clusters * C);                                             \
      cfg.blockDim = dim3(threads);                                                 \
      cfg.dynamicSmemBytes = smem;                                                  \
      cfg.stream = (cudaStream_t)stream;                                            \
      cudaLaunchAttribute attr[1];                                                  \
      attr[0].id = cudaLaunchAttributeClusterDimension;                             \
      attr[0].val.clusterDim.x = C;                                                 \
      attr[0].val.clusterDim.y = 1;                                                 \
      attr[0].val.clusterDim.z = 1;                                                 \
      cfg.attrs = attr;                                                             \
      cfg.numAttrs = 1;                                                             \
      e = cudaLaunchKernelEx(&cfg, wide_newton_kernel<SS_, RPT_>, steps, n_steps,   \
                             mats, rootd, wp, invar, up, usc, P, n_nodes, part,     \
                             n_slots, tile);                                        \
    }                                                                               \
  }
    IQT_DISPATCH_S(S, IQT_LAUNCH)
  }
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)iqt::launch_reduce(part, d12, clusters * (tile / group), n_nodes * 2, 0,
                                 (cudaStream_t)stream);
}
