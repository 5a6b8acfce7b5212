// Outside-partial store: every node's normalized outside partial and its
// log-scale, the second half of the NNI evaluator's two global passes.
//
// Replaces the TPU kernel _kernel_down_store_cs
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Reverse walk of the slot
// schedule: each step takes the parent's pushed outside vector d (at the
// root the bare state frequencies: the class weights are applied later,
// by the evaluator's theta reductions), forms both child messages
// m = P U from the upward store's partials (tip rows filled by the
// caller), and for each child c
//     O_c = d * m_sib / max,  osc_c = dsc + usc_sib + log(max),
// writes O_c [CS, P] and osc_c [P] to out/osc, and, when c is internal,
// pushes D_c = P_c^T O_c into c's slot.  The root row is never written.
//
// Work layout: newton.cu's reverse walk with one matrix in place of three,
// no sums and two writes a step, one lane a (pattern, rate category).  A
// block holds `patterns` consecutive patterns (pb) and its lanes run
// category-major: lane (category c, pattern q) is thread c pb + q, so the
// lanes of one category cover pb consecutive patterns and a warp's store
// of one row of O is a run of min(pb, 32) x 4 bytes (128 at pb >= 32: a
// whole line; the row stores are most of the kernel's time).  A block has
// C x pb threads at pb >= 32, and CL x pb below (C rounded up to a power
// of two, whole warps; a lane past C computes a copy of category C - 1
// and writes nothing).  The renormalizing max crosses the categories, so
// it crosses warps: each lane writes its S rows' max to a shared-memory
// buffer (two, by step parity), one block barrier, and each lane takes
// the max of its pattern's C entries -- every lane of a pattern the same
// bits.  The outside partials waiting for their subtree sit in a
// shared-memory pool [slot][S+1][lanes] (a lane's rows and the pattern's
// log-scale), one column a lane.
//
// Loads off the chain: a step's inputs -- both children's up rows and
// usc scales (a lane's own words, into its column of a stage) and the
// [S,S] edge blocks of the warp's categories (16-byte rows shared out over
// its lanes, into the warp's padded stage, SSP) -- are cp.async copies
// issued STAGES - 1 steps ahead; a step waits for its own copies and a
// __syncwarp.
//
// Bits: a category's arithmetic is the thread-a-pattern step's (apply_p1
// and apply_pt1 are apply_p's and apply_pt's rows, the max is exact in any
// order, the IEEE division and the log of the earlier design's outside
// partial are kept), so O and osc carry the bits of the thread-a-pattern
// design.  The division is div_rn: the float division's bits without its
// branches.
//
// Instances: S = 4 (DNA; S = 3 zero-padded by the wrapper) and S = 2
// (binary), C = 1..8 each (IQT_DISPATCH_CS).
//
// Bound on an H100 (DNA+G4, 1000 taxa x 9 962 patterns): reads up and usc
// and writes out and osc once, 2 x 2000 x 17 rows x 9 962 x 4 B = 2.7 GB
// (3.35 TB/s: 0.81 ms); the work is 2 x 64 (messages) + 2 x 64 (push) FMA
// and 2 x 32 mul/div per edge and pattern, about 6 GFLOP (67 TFLOP/s:
// 0.09 ms): byte-bound.
//
// Shared memory (floats), with T lanes and W = T / 32 warps of NCW =
// max(1, 32 / pb) categories each: (n_slots (S + 1) + STAGES (2 S + 2) + 4)
// T + W STAGES 2 NCW SSP; 23 744 (94 976 bytes) at S = 4, C = 4, pb = 64,
// 11 slots.
#include "cs_common.cuh"

using namespace iqt;

// Steps whose children's partials and edge blocks are in flight at once
// (a cp.async ring; three deep measured 7% faster than two at C = 4).
constexpr int STAGES = 3;
// A lane's words in one stage: the two children's S rows, then their scales.
template <int S>
__host__ __device__ constexpr int stage_words() {
  return 2 * S + 2;
}

// Categories (whole warps of pb lanes each) of a block of pb patterns.
template <int C>
inline int down_categories(int pb) {
  return pb >= 32 ? C : Lanes<C>::CL;
}

template <int C, int S>
inline size_t down_smem(int pb, int n_slots) {
  const int T = pb * down_categories<C>(pb), ncw = pb >= 32 ? 1 : 32 / pb;
  return (((size_t)n_slots * (S + 1) + STAGES * stage_words<S>() + 4) * T +
          (size_t)(T / 32) * STAGES * 2 * ncw * Block<S>::SSP) *
         sizeof(float);
}

// Step j's children into stage k: this lane's rows of their partials and
// their scales into its column, and the [S,S] blocks of the warp's NCW
// categories (from cw0) of both edges into the warp's stage.
template <int C, int S>
__device__ __forceinline__ void fetch_down(const Step& sj, float* stage_k, float* warp_k,
                                           int T, int c, int cw0, int ncw, int lane,
                                           const float* __restrict__ trans,
                                           const float* __restrict__ up,
                                           const float* __restrict__ usc, int P, int p) {
  constexpr int SS = Block<S>::SS, SSP = Block<S>::SSP, R = Block<S>::ROWS;
  // 16-byte copies: (child, the warp's category, copy), 2 NCW R of them
  for (int q = lane; q < 2 * ncw * R; q += 32) {
    const int child = q / (ncw * R), rem = q - child * ncw * R;
    const int node = child ? sj.r : sj.l, cat = min(cw0 + rem / R, C - 1);
    __pipeline_memcpy_async(warp_k + (child * ncw + rem / R) * SSP + (rem % R) * 4,
                            trans + ((size_t)node * C + cat) * SS + (rem % R) * 4, 16);
  }
  const float* ul = up + ((size_t)sj.l * C + c) * S * P + p;
  const float* ur = up + ((size_t)sj.r * C + c) * S * P + p;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    __pipeline_memcpy_async(stage_k + s * T, ul + (size_t)s * P, 4);
    __pipeline_memcpy_async(stage_k + (S + s) * T, ur + (size_t)s * P, 4);
  }
  __pipeline_memcpy_async(stage_k + 2 * S * T, usc + (size_t)sj.l * P + p, 4);
  __pipeline_memcpy_async(stage_k + (2 * S + 1) * T, usc + (size_t)sj.r * P + p, 4);
}

template <int C, int S>
__global__ void down_store_kernel(const int* __restrict__ steps, int n_steps,
                                  const float* __restrict__ trans,
                                  const float* __restrict__ rootd,
                                  const float* __restrict__ up,
                                  const float* __restrict__ usc, int P,
                                  float* __restrict__ out, float* __restrict__ osc,
                                  int n_slots, int pb) {
  extern __shared__ float smem[];
  constexpr int SSP = Block<S>::SSP, STAGE_WORDS = stage_words<S>();
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_raw = tid / pb, q = tid - c_raw * pb;
  const int c = min(c_raw, C - 1);  // a lane past C computes a copy of C - 1
  const int ncw = pb >= 32 ? 1 : 32 / pb, cw0 = warp * 32 / pb;  // the warp's categories
  const int p_raw = blockIdx.x * pb + q;
  const bool valid = p_raw < P, writes = valid && c_raw < C;
  const int p = min(p_raw, P - 1);  // a ragged tail computes a copy, writes nothing
  const int ws = 2 * ncw * SSP;     // a warp's words in one stage
  float* col = smem + tid;          // this lane's column of the pool [slot][S+1][T]
  float* stage = col + (size_t)n_slots * (S + 1) * T;  // [STAGES][STAGE_WORDS][T]
  float* xm = smem + ((size_t)n_slots * (S + 1) + STAGES * STAGE_WORDS) * T;  // [2][2][T]
  // [warp][STAGES][ws] after the lanes' columns (16-byte aligned: T % 32 == 0)
  float* wstage = xm + 4 * T + (size_t)warp * STAGES * ws;
  const float* Mc = wstage + (c_raw - cw0) * SSP;  // this category's block, left edge

  // the walk runs from step n_steps - 1 down; step i's children sit in
  // stage (n_steps - 1 - i) % STAGES, fetched STAGES - 1 steps ahead
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (n_steps - 1 - k >= 0)
      fetch_down<C, S>(load_step(steps, n_steps - 1 - k), stage + k * STAGE_WORDS * T,
                       wstage + k * ws, T, c, cw0, ncw, lane, trans, up, usc, P, p);
    __pipeline_commit();
  }
  int j = n_steps - STAGES;  // the next step to fetch
  Step st_j = j >= 0 ? load_step(steps, j) : Step{};
  Step st = load_step(steps, n_steps - 1);
  int k = 0;    // the stage of step i
  int par = 0;  // the max buffer of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    const int k_free = k == 0 ? STAGES - 1 : k - 1;  // held step i + 1
    __syncwarp();  // every lane has read the warp's stage of step i + 1
    if (j >= 0)
      fetch_down<C, S>(st_j, stage + k_free * STAGE_WORDS * T, wstage + k_free * ws, T, c,
                       cw0, ncw, lane, trans, up, usc, P, p);
    __pipeline_commit();
    if (--j >= 0) st_j = load_step(steps, j);
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;
    __pipeline_wait_prior(STAGES - 1);  // this lane's copies of step i have landed
    __syncwarp();                       // and so have the other lanes'

    const float* sk = stage + k * STAGE_WORDS * T;
    const float* Ml = Mc + k * ws;  // the left edge's block; the right's ncw SSP on
    const float* Mr = Ml + ncw * SSP;
    const float sl = sk[2 * S * T], sr = sk[(2 * S + 1) * T];
    float d[S], dsc, u[S], ml[S], mr[S];
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
    for (int s = 0; s < S; ++s) u[s] = sk[s * T];
    apply_p1<S>(Ml, u, ml);
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = sk[(S + s) * T];
    apply_p1<S>(Mr, u, mr);

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
      mx[0] = fmaxf(mx[0], xp[cc * pb + q]);
      mx[1] = fmaxf(mx[1], xp[T + cc * pb + q]);
    }
    par ^= 1;
    mx[0] = fmaxf(mx[0], SCALE_TINY);
    mx[1] = fmaxf(mx[1], SCALE_TINY);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ol[s] = div_rn(ol[s], mx[0]);
      orr[s] = div_rn(orr[s], mx[1]);
    }
    const float oscl = dsc + sr + logf(mx[0]), oscr = dsc + sl + logf(mx[1]);

    // O and osc of both children
    if (writes) {
      float* dl = out + ((size_t)st.l * C + c) * S * P + p_raw;
      float* dr = out + ((size_t)st.r * C + c) * S * P + p_raw;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        dl[(size_t)s * P] = ol[s];
        dr[(size_t)s * P] = orr[s];
      }
      if (c_raw == 0) {
        osc[(size_t)st.l * P + p_raw] = oscl;
        osc[(size_t)st.r * P + p_raw] = oscr;
      }
    }
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

// patterns: patterns a block (pb), a multiple of 32 or a divisor of 32
// that leaves whole warps (down_categories x pb lanes a block).
extern "C" int iqt_down_store(const int* steps, int n_steps, const float* trans,
                              const float* rootd, const float* up, const float* usc,
                              int P, float* out, float* osc, int C, int S, int n_slots,
                              int patterns, void* stream) {
  if (patterns <= 0 || (patterns < 32 ? 32 % patterns : patterns % 32))
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC, SV)                                                      \
  {                                                                             \
    const int threads = patterns * down_categories<CC>(patterns);               \
    if (threads % 32 || threads > 1024) return (int)cudaErrorInvalidValue;      \
    const size_t smem = down_smem<CC, SV>(patterns, n_slots);                   \
    e = allow_smem(down_store_kernel<CC, SV>, smem);                            \
    if (e == cudaSuccess)                                                       \
      down_store_kernel<CC, SV><<<(P + patterns - 1) / patterns, threads, smem, \
                                  (cudaStream_t)stream>>>(                      \
          steps, n_steps, trans, rootd, up, usc, P, out, osc, n_slots, patterns); \
  }
  IQT_DISPATCH_CS(C, S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
