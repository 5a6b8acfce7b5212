// Gradient sweep: the cotangent of every edge's transition matrices.
//
// Replaces the TPU kernel _kernel_tbar_cs
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Reverse walk of the slot
// schedule: each step forms its two child edges' outside partials O from
// the parent's outside vector D (root seed props * pi) and the sibling's
// message, accumulates
//     tbar[e][c][s][t] += sum_p O[c,s,p] * fac[p] * U_e[c,t,p],
//     fac = exp(min(osc + usc - lnl, 80)) * w_p,
// and pushes D_child = P^T O down the tree.  Children's inside partials
// come from the upward store's up buffer (tip rows filled by the caller).
//
// The TPU grid runs its pattern tiles in order and accumulates into one
// output; blocks here run in no order, so each block writes its own
// partial sums part[block][edge][C][S][S] (only the C diagonal [S,S]
// blocks -- the rest of the TPU's packed [CS,CS] cotangent is never used)
// and a second deterministic pass sums the blocks.
//
// Work layout: down_store.cu's walk (cs_common.cuh's lane layout), one lane
// a (pattern, rate category), category-major: a block holds PB = 64
// consecutive patterns and lane (category c, pattern q) is thread c PB + q,
// so a category's lanes are whole warps over all the block's patterns.  A
// step's inputs -- both children's up rows and usc scales (a lane's own
// words, into its column of a ring stage) and the [S,S] edge blocks of the
// warp's category (into the warp's padded stage, SSP) -- are cp.async copies
// into a ring STAGES deep, a stage refilled as soon as the step's block
// barrier frees it.  The renormalizing max crosses the
// categories through shared memory at one block barrier a step; O is
// div_rn's quotient (the float division's bits without its branches);
// apply_p1 and apply_pt1 form the messages and the push, which waits in
// the pool [slot][S+1][lanes].
//
// The cotangent sums keep the thread-a-pattern design's order: a block's
// PB = 64 patterns are that design's block, and each entry of its part row
// is sum_{j < 64} (O fac)[c,s,j] U[c,t,j] added in j order.  These ordered
// 64-term chains would lengthen every walk warp's step, so more warps, the
// sum warps (one for every SUM_CATEGORIES categories), run them beside the
// walk: after the step's O the walk lanes stage O * fac [c][side][s][j]
// (rows padded to PB + 4 words) and arrive at a named barrier (bar.arrive,
// without waiting); the sum warps wait there (bar.sync), and lane (side, s,
// t) of a sum warp runs its categories' sums of its entry as interleaved
// chains, reading O * fac and the ring stage's U rows (padded to lanes + 4
// words) as float4s, the 8 rows of a quarter warp in distinct 16-byte bank
// groups.  The walk warps meanwhile push O and start the next step; a sum
// warp joins the next step's block barrier when its sums are written, so
// the stage and the ring slot are free before they are written again.
//
// Instances: S = 4 (DNA; S = 3 zero-padded by the wrapper) and S = 2
// (binary), C = 1..8 each (IQT_DISPATCH_CS).  At S = 2 an edge's entries
// (side, s, t) are 2 x 2 x 2 = 8: a sum warp's lanes past them repeat an
// entry's sums and store the same bits to the same place.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 9 962 patterns): reads the stored
// partials once, 2N x 17 rows x 9 962 x 4 B = 1.36 GB (3.35 TB/s: 0.40 ms);
// the work is 2 x 64 (messages) + 64 (cotangent) + 64 (push) FMA per edge
// and pattern, about 10 GFLOP (67 TFLOP/s: 0.15 ms): byte-bound.
//
// Shared memory (floats), T = C PB walk lanes, TS = T + 4, W = T / 32:
//   W STAGES 2 SSP + STAGES (2 S + 2) TS + C 2 S (PB + 4)
//   + n_slots (S + 1) T + 4 T       (cs_kernels.tbar_smem);
// 23 120 floats (92 480 bytes) at S = 4, C = 4 and 11 slots; 225 600 bytes
// at S = 4, C = 8 and 15 slots (a 16 384-taxon tree's).
#include "cs_common.cuh"

using namespace iqt;

// Steps whose children's partials and edge blocks are in flight at once
// (a cp.async ring; two deep measured as fast as three at C = 4 and 8,
// 5% faster at C = 3).
constexpr int STAGES = 2;
// A lane's words in one stage: the two children's S rows, then their scales.
template <int S>
__host__ __device__ constexpr int stage_words() {
  return 2 * S + 2;
}
// Padding of the ring's and the O stage's rows (words).
constexpr int PAD = 4;
// Patterns a block: the thread-a-pattern design's block, whose sum order
// (64 patterns a part row) the cotangents keep.
constexpr int PB = 64;
// Categories a sum warp adds (one warp for all of them measured 1.4 ms
// slower at C = 8: its chains outlasted the walk's step).
constexpr int SUM_CATEGORIES = 2;
// Sum warps of a block of C categories.
template <int C>
__host__ __device__ constexpr int sum_warps() {
  return (C + SUM_CATEGORIES - 1) / SUM_CATEGORIES;
}
// Largest block: 8 categories x PB patterns and their sum warps.
constexpr int TBAR_THREADS_MAX = 8 * PB + 32 * sum_warps<8>();

template <int C, int S>
inline size_t tbar_smem(int n_slots) {
  const size_t T = (size_t)C * PB;
  return ((T / 32) * STAGES * 2 * Block<S>::SSP + STAGES * stage_words<S>() * (T + PAD) +
          (size_t)C * 2 * S * (PB + PAD) + (n_slots * (S + 1) + 4) * T) *
         sizeof(float);
}

// A lane's entry of N categories: acc[n] = sum_{j < PB} O[n OC + j]
// U[n UC + j], each added in j order; the N chains advance together a
// float4 at a time, so their loads and multiply-adds overlap.
template <int N>
__device__ __forceinline__ void ordered_dots(const float* O, int OC, const float* U, int UC,
                                             float (&acc)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] = 0.f;
#pragma unroll
  for (int j = 0; j < PB; j += 4) {
    float4 a[N], b[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      a[n] = *reinterpret_cast<const float4*>(O + n * OC + j);
      b[n] = *reinterpret_cast<const float4*>(U + n * UC + j);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      acc[n] += a[n].x * b[n].x;
      acc[n] += a[n].y * b[n].y;
      acc[n] += a[n].z * b[n].z;
      acc[n] += a[n].w * b[n].w;
    }
  }
}

// A step's O * fac rows are staged: the walk lanes arrive at named barrier
// 1 and go on, the sum warps wait there (all the block's threads count).
__device__ __forceinline__ void sums_arrive(int threads) {
  asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");
}
__device__ __forceinline__ void sums_wait(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Sum warp w: lane (side, s, t) of each step's two edges (lane e + 2 S S
// repeats lane e's entry), over categories c0 = w SUM_CATEGORIES .. (a
// category past C is a copy of C - 1, not written); one block barrier and
// one wait a step in step with the walk.
template <int C, int S>
__device__ __forceinline__ void sum_warp(const int* __restrict__ steps, int n_steps,
                                         const float* ring, const float* ost, int TS,
                                         int w, float* part_b) {
  constexpr int OS = PB + PAD, N = C < SUM_CATEGORIES ? C : SUM_CATEGORIES;
  constexpr int SS = S * S, STAGE_WORDS = stage_words<S>();
  const int lane = (threadIdx.x & 31) % (2 * SS);
  const int side = lane / SS, s = (lane / S) % S, t = lane % S;
  const int c0 = w * SUM_CATEGORIES, dc = c0 + N - 1 < C ? 1 : 0;  // categories apart
  int k = 0;  // the ring stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    __syncthreads();                               // the walk's max barrier of step i
    sums_wait(C * PB + 32 * sum_warps<C>());       // step i's O * fac rows are staged
    const float* U = ring + k * STAGE_WORDS * TS + (side * S + t) * TS + c0 * PB;
    float acc[N];
    ordered_dots<N>(ost + ((c0 * 2 + side) * S + s) * OS, dc * 2 * S * OS, U, dc * PB, acc);
    float* dst = part_b + ((size_t)(side ? st.r : st.l) * C + c0) * SS + s * S + t;
#pragma unroll
    for (int n = 0; n < N; ++n)
      if (c0 + n < C) dst[n * SS] = acc[n];
    k = k == STAGES - 1 ? 0 : k + 1;
  }
}

// Step j's children into stage k: this lane's rows of their partials and
// their scales into its column (rows TS apart), and the [S,S] blocks of
// the warp's category of both edges into the warp's stage.
template <int C, int S>
__device__ __forceinline__ void fetch_tbar(const Step& sj, float* stage_k, float* warp_k,
                                           int TS, int c, int lane,
                                           const float* __restrict__ trans,
                                           const float* __restrict__ up,
                                           const float* __restrict__ usc, int P, int p) {
  constexpr int SS = Block<S>::SS, SSP = Block<S>::SSP, R = Block<S>::ROWS;
  // 16-byte copies: (child, copy), 2 R of them
  if (lane < 2 * R) {
    const int child = lane / R, s = lane - child * R;
    const int node = child ? sj.r : sj.l;
    __pipeline_memcpy_async(warp_k + child * SSP + s * 4,
                            trans + ((size_t)node * C + c) * SS + s * 4, 16);
  }
  const float* ul = up + ((size_t)sj.l * C + c) * S * P + p;
  const float* ur = up + ((size_t)sj.r * C + c) * S * P + p;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    __pipeline_memcpy_async(stage_k + s * TS, ul + (size_t)s * P, 4);
    __pipeline_memcpy_async(stage_k + (S + s) * TS, ur + (size_t)s * P, 4);
  }
  __pipeline_memcpy_async(stage_k + 2 * S * TS, usc + (size_t)sj.l * P + p, 4);
  __pipeline_memcpy_async(stage_k + (2 * S + 1) * TS, usc + (size_t)sj.r * P + p, 4);
}

template <int C, int S>
__global__ void __launch_bounds__(TBAR_THREADS_MAX)
tbar_kernel(const int* __restrict__ steps, int n_steps, const float* __restrict__ trans,
            const float* __restrict__ rootd, const float* __restrict__ lnl,
            const float* __restrict__ wp, const float* __restrict__ up,
            const float* __restrict__ usc, int P, int n_nodes, float* __restrict__ part,
            int n_slots) {
  extern __shared__ __align__(16) float smem[];
  constexpr int T = C * PB, TS = T + PAD, OS = PB + PAD;  // T walk lanes, then the sum warp
  constexpr int SS = S * S, SSP = Block<S>::SSP, STAGE_WORDS = stage_words<S>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = tid / PB, q = tid - c * PB;
  const int p_raw = blockIdx.x * PB + q;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);  // a ragged tail computes a copy, adds 0
  const float lnl_p = __ldg(lnl + p);
  const float w_p = valid ? __ldg(wp + p) : 0.f;
  // [warp][STAGES][2 SSP], then [STAGES][STAGE_WORDS][TS], [C][2][S][OS],
  // the pool [slot][S+1][T] and the max buffers [2][2][T]
  float* wstage = smem + (size_t)warp * STAGES * 2 * SSP;
  float* ring = smem + (size_t)(T / 32) * STAGES * 2 * SSP;
  float* ost = ring + (size_t)STAGES * STAGE_WORDS * TS;
  float* col = ost + (size_t)C * 2 * S * OS + tid;  // this lane's pool column
  float* xm = ost + (size_t)C * 2 * S * OS + (size_t)n_slots * (S + 1) * T;
  float* part_b = part + (size_t)blockIdx.x * n_nodes * C * SS;
  if (tid >= T) {
    sum_warp<C, S>(steps, n_steps, ring, ost, TS, warp - T / 32, part_b);
    return;
  }

  // the walk runs from step n_steps - 1 down; step i's children sit in
  // stage (n_steps - 1 - i) % STAGES, fetched STAGES - 1 steps ahead
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (n_steps - 1 - k >= 0)
      fetch_tbar<C, S>(load_step(steps, n_steps - 1 - k), ring + tid + k * STAGE_WORDS * TS,
                       wstage + k * 2 * SSP, TS, c, lane, trans, up, usc, P, p);
    __pipeline_commit();
  }
  int j = n_steps - STAGES;  // the next step to fetch
  Step st_j = j >= 0 ? load_step(steps, j) : Step{};
  Step st = load_step(steps, n_steps - 1);
  int k = 0;    // the stage of step i
  int par = 0;  // the max buffer of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    const int k_free = k == 0 ? STAGES - 1 : k - 1;  // held step i + 1
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;
    __pipeline_wait_prior(STAGES - 2);  // this lane's copies of step i have landed
    __syncwarp();                       // and so have the other lanes' of the warp

    const float* sk = ring + k * STAGE_WORDS * TS;  // [STAGE_WORDS][TS]
    const float* Ml = wstage + k * 2 * SSP;         // the left edge's block
    const float* Mr = Ml + SSP;
    const float sl = sk[2 * S * TS + tid], sr = sk[(2 * S + 1) * TS + tid];
    float d[S], dsc, ul[S], ur[S], ml[S], mr[S];
    if (i == n_steps - 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) d[s] = __ldg(rootd + c * S + s);
      dsc = 0.f;
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) d[s] = col[(st.out * (S + 1) + s) * T];
      dsc = col[(st.out * (S + 1) + S) * T];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ul[s] = sk[s * TS + tid];
      ur[s] = sk[(S + s) * TS + tid];
    }
    apply_p1<S>(Ml, ul, ml);
    apply_p1<S>(Mr, ur, mr);

    // both child edges at once: O = d * m_sib over the pattern's max, which
    // crosses the categories' warps through xm
    float ol[S], orr[S], mx[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ol[s] = d[s] * mr[s];
      orr[s] = d[s] * ml[s];
      mx[0] = fmaxf(mx[0], ol[s]);
      mx[1] = fmaxf(mx[1], orr[s]);
    }
    float* xp = xm + par * 2 * T;
    xp[tid] = mx[0];
    xp[T + tid] = mx[1];
    __syncthreads();  // every category's max of step i is written
#pragma unroll
    for (int cc = 0; cc < C; ++cc) {
      mx[0] = fmaxf(mx[0], xp[cc * PB + q]);
      mx[1] = fmaxf(mx[1], xp[T + cc * PB + q]);
    }
    par ^= 1;
    // every lane is done with step i + 1: its stage takes step j
    if (j >= 0)
      fetch_tbar<C, S>(st_j, ring + tid + k_free * STAGE_WORDS * TS,
                       wstage + k_free * 2 * SSP, TS, c, lane, trans, up, usc, P, p);
    __pipeline_commit();
    if (--j >= 0) st_j = load_step(steps, j);
    mx[0] = fmaxf(mx[0], SCALE_TINY);
    mx[1] = fmaxf(mx[1], SCALE_TINY);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ol[s] = div_rn(ol[s], mx[0]);
      orr[s] = div_rn(orr[s], mx[1]);
    }
    const float oscl = dsc + sr + logf(mx[0]), oscr = dsc + sl + logf(mx[1]);
    const float facl = valid ? expf(fminf(oscl + sl - lnl_p, 80.f)) * w_p : 0.f;
    const float facr = valid ? expf(fminf(oscr + sr - lnl_p, 80.f)) * w_p : 0.f;

    // the cotangent sums of both edges, each in pattern order: the sum warp's
    float* oc = ost + (size_t)c * 2 * S * OS;  // [side][s][OS]
#pragma unroll
    for (int s = 0; s < S; ++s) {
      oc[s * OS + q] = ol[s] * facl;
      oc[(S + s) * OS + q] = orr[s] * facr;
    }
    sums_arrive(T + 32 * sum_warps<C>());

    // the children's outside partials, pushed through their edges, wait in
    // the pool for their own steps (d is read: a child may reuse st.out)
    if (st.ls >= 0) {
      float dd[S];
      apply_pt1<S>(Ml, ol, dd);
#pragma unroll
      for (int s = 0; s < S; ++s) col[(st.ls * (S + 1) + s) * T] = dd[s];
      col[(st.ls * (S + 1) + S) * T] = oscl;
    }
    if (st.rs >= 0) {
      float dd[S];
      apply_pt1<S>(Mr, orr, dd);
#pragma unroll
      for (int s = 0; s < S; ++s) col[(st.rs * (S + 1) + s) * T] = dd[s];
      col[(st.rs * (S + 1) + S) * T] = oscr;
    }
    st = st_next;
    k = k == STAGES - 1 ? 0 : k + 1;
  }
}

// tile: patterns a block, PB (the earlier design's, whose sums the
// cotangents keep); C x PB walk lanes and the sum warps a block.
extern "C" int iqt_tbar(const int* steps, int n_steps, const float* trans,
                        const float* rootd, const float* lnl, const float* wp,
                        const float* up, const float* usc, int P, int n_nodes,
                        float* part, float* tbar, int C, int S, int n_slots, int tile,
                        void* stream) {
  if (tile != PB) return (int)cudaErrorInvalidValue;
  const int n_blocks = (P + PB - 1) / PB;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC, SV)                                                         \
  {                                                                                \
    const size_t smem = tbar_smem<CC, SV>(n_slots);                                \
    const int threads = CC * PB + 32 * sum_warps<CC>();                            \
    e = allow_smem(tbar_kernel<CC, SV>, smem);                                     \
    if (e == cudaSuccess)                                                          \
      tbar_kernel<CC, SV><<<n_blocks, threads, smem, (cudaStream_t)stream>>>(      \
          steps, n_steps, trans, rootd, lnl, wp, up, usc, P, n_nodes, part,        \
          n_slots);                                                                \
  }
  IQT_DISPATCH_CS(C, S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(part, tbar, n_blocks, n_nodes * C * S * S, 0,
                            (cudaStream_t)stream);
}
