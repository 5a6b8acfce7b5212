// Branch-Newton sweep: first and second derivatives of lnL with respect
// to every branch length at once.
//
// Replaces the TPU kernel _kernel_newton_cs / _newton_body
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Reverse walk of the slot
// schedule: for each child edge e it forms the outside partial O_e and,
// with f_k = sum_cs O_e * (P_e^(k) U_e) for P, P', P'' of the edge,
//     d1[e] = sum_p w_p f1/den,   d2[e] = sum_p w_p (f2/den - (f1/den)^2),
// where den = f0 + the invariant-site term in the scaled frame.  Nothing
// but the per-warp sums leaves the chip: no theta or outside buffer.
//
// Work layout: one lane a (pattern, rate category), the lane layout of
// cs_common.cuh (CL = C rounded up to a power of two lanes a pattern,
// 32 / CL patterns a warp).  A lane holds its category's S states of d,
// U, the messages and O; the renormalizing max and the sums over
// categories of f0, f1, f2 are log2(CL) shuffle rounds in its group, the
// two child edges of a step side by side so that their rounds overlap.
// The outside partials waiting for their subtree sit in a shared-memory
// pool [slot][S+1][threads] (S rows and the log-scale), one column a
// lane.  The per-edge sums over patterns are shuffles across the warp's
// pattern groups; lane 0 writes part[warp][edge][2], and the
// deterministic reduce_blocks adds the warps in a fixed order.  So the
// step loop has no block barrier and no float atomics: two launches give
// the same bits.
//
// Loads off the chain: a step's inputs -- the children's partials and
// scales (a lane's own words, into its column) and their (P, P', P'')
// blocks (a warp's, 16-byte rows shared out over its lanes, into the
// warp's stage) -- are cp.async copies issued STAGES - 1 steps ahead; a
// step waits for its own group and a __syncwarp, never for the block.
//
// What each access costs (a warp, one step, CL = 4): a child's partial,
// 4 requests of 4 whole 32-byte sectors (8 patterns x 4 categories x 4 B
// a row), every byte used; its scale one sector, read by the 4 lanes of a
// pattern alike; the edge matrices 2 x 3 x 4 x 64 B in 96 16-byte copies,
// 3 a lane, read back as float4 rows with the categories' blocks padded
// apart (no bank conflict); the pool and the lane stages, consecutive
// words of consecutive lanes (no bank conflict); part, one 8-byte store a
// warp and edge.  Measured on an H100, the edge matrices read straight
// from L1 cost ~0.6 ms of a 2.6 ms sweep and the partials read a step
// ahead into registers ~3.6 ms of 6.2 (PERF.md).
//
// Instances: S = 4 (DNA; S = 3 zero-padded by the wrapper) and S = 2
// (binary), C = 1..8 each (IQT_DISPATCH_CS).  At S = 2 a category's three
// matrices are three float4s, one 16-byte copy each.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): reads the stored
// partials once, 1.36 GB (3.35 TB/s: 0.4 ms); the work is
// 2 x 3 x 64 + 64 FMA per edge and pattern, about 11 GFLOP (67 TFLOP/s:
// 0.17 ms): byte-bound.  At C = 4 the sweep runs 4x the threads of a
// thread-a-pattern layout (1 246 warps at 9 962 patterns, ~9.4 an SM).
#include "cs_common.cuh"

using namespace iqt;

// Steps whose children's partials and edge matrices are in flight at
// once (a cp.async ring).
constexpr int STAGES = 2;
// A lane's words in one stage (the two children's S rows, then their
// scales), and a warp's (both children's (P, P', P'') [C] blocks).
template <int C, int S>
struct WarpStage {
  static constexpr int STAGE_WORDS = 2 * S + 2;
  static constexpr int MATP = C * Block<S>::SSP;
  static constexpr int WORDS = 2 * 3 * MATP;
};

// group_sums (cs_common.cuh) over the pattern groups of a warp (offsets CL .. 16).
template <int CL, int K>
__device__ __forceinline__ void warp_group_sums(float (&v)[K]) {
#pragma unroll
  for (int off = CL; off < 32; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// Step j's children into stage k: this lane's words of their partials and
// scales into its column, and the warp's share of their edge matrices
// into the warp's stage.  cp.async, so the copies run while the steps
// before j are computed.
template <int C, int S>
__device__ __forceinline__ void fetch_children(const Step& sj, float* stage_k, float* warp_k,
                                               int T, int c, int lane,
                                               const float* __restrict__ mats,
                                               const float* __restrict__ up,
                                               const float* __restrict__ usc, int P,
                                               int p) {
  constexpr int SS = Block<S>::SS, SSP = Block<S>::SSP, R = Block<S>::ROWS;
  constexpr int MAT = C * SS, MATP = WarpStage<C, S>::MATP;
  // 16-byte copies: (child, matrix, category, copy), 6 C R of them; a copy's
  // index by shift and mask (signed / and % cost 7% of the sweep at S = 4)
  for (int q = lane; q < 6 * C * R; q += 32) {
    const int child = q / (3 * C * R), rem = q - child * 3 * C * R;
    const int m = rem / (C * R), cc = (rem >> Block<S>::ROW_SHIFT) % C, s = rem & (R - 1);
    const int node = child ? sj.r : sj.l;
    __pipeline_memcpy_async(warp_k + (child * 3 + m) * MATP + cc * SSP + s * 4,
                            mats + ((size_t)node * 3 + m) * MAT + cc * SS + s * 4, 16);
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
__global__ void newton_kernel(const int* __restrict__ steps, int n_steps,
                              const float* __restrict__ mats,  // [2N][3][C][S][S]
                              const float* __restrict__ rootd,
                              const float* __restrict__ wp,
                              const float* __restrict__ invar,
                              const float* __restrict__ up,
                              const float* __restrict__ usc, int P, int n_nodes,
                              float* __restrict__ part, int n_slots) {
  extern __shared__ float smem[];
  constexpr int CL = Lanes<C>::CL, SSP = Block<S>::SSP;
  constexpr int MATP = WarpStage<C, S>::MATP, WS = WarpStage<C, S>::WORDS;
  constexpr int STAGE_WORDS = WarpStage<C, S>::STAGE_WORDS;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int cl = tid & (CL - 1);
  const float act = cl < C ? 1.f : 0.f;
  const int c = min(cl, C - 1);
  const int p_raw = blockIdx.x * (T / CL) + tid / CL;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);  // ragged tail computes a copy, adds 0
  float* col = smem + tid;          // this lane's column of the pool [slot][S+1][T]
  float* stage = col + (size_t)n_slots * (S + 1) * T;  // [STAGES][STAGE_WORDS][T]
  // [warp][STAGES][WS] after the lanes' columns (16-byte aligned: T % 32 == 0)
  float* wstage = smem + ((size_t)n_slots * (S + 1) + STAGES * STAGE_WORDS) * T +
                  (size_t)(tid >> 5) * STAGES * WS;
  const float w_p = valid ? __ldg(wp + p) : 0.f;
  const float inv_p = __ldg(invar + p);
  float* part_w = part + (size_t)((blockIdx.x * T + tid) >> 5) * n_nodes * 2;

  // the walk runs from step n_steps - 1 down; step i's children sit in
  // stage (n_steps - 1 - i) % STAGES, fetched STAGES - 1 steps ahead
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (n_steps - 1 - k >= 0)
      fetch_children<C, S>(load_step(steps, n_steps - 1 - k), stage + k * STAGE_WORDS * T,
                           wstage + k * WS, T, c, lane, mats, up, usc, P, p);
    __pipeline_commit();
  }
  int j = n_steps - STAGES;  // the next step to fetch
  Step st_j = j >= 0 ? load_step(steps, j) : Step{};
  Step st = load_step(steps, n_steps - 1);
  int k = 0;  // the stage of step i
  for (int i = n_steps - 1; i >= 0; --i) {
    const int k_free = k == 0 ? STAGES - 1 : k - 1;  // held step i + 1
    __syncwarp();  // every lane has read the warp's stage of step i + 1
    if (j >= 0)
      fetch_children<C, S>(st_j, stage + k_free * STAGE_WORDS * T, wstage + k_free * WS, T,
                           c, lane, mats, up, usc, P, p);
    __pipeline_commit();
    if (--j >= 0) st_j = load_step(steps, j);
    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;
    __pipeline_wait_prior(STAGES - 1);  // this lane's copies of step i have landed
    __syncwarp();                       // and so have the other lanes'

    const float* sk = stage + k * STAGE_WORDS * T;
    float ul[S], ur[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ul[s] = sk[s * T];
      ur[s] = sk[(S + s) * T];
    }
    const float sl = sk[2 * S * T], sr = sk[(2 * S + 1) * T];
    float d[S], dsc;
    if (i == n_steps - 1) {
#pragma unroll
      for (int s = 0; s < S; ++s) d[s] = __ldg(rootd + c * S + s);
      dsc = 0.f;
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) d[s] = col[(st.out * (S + 1) + s) * T];
      dsc = col[(st.out * (S + 1) + S) * T];
    }
    const float* Ml = wstage + k * WS + c * SSP;  // this category's P of the left edge
    const float* Mr = Ml + 3 * MATP;
    float ml[S], mr[S], m1l[S], m2l[S], m1r[S], m2r[S];
    apply_p1<S>(Ml, ul, ml);
    apply_p1<S>(Mr, ur, mr);
    apply_p1<S>(Ml + MATP, ul, m1l);
    apply_p1<S>(Ml + 2 * MATP, ul, m2l);
    apply_p1<S>(Mr + MATP, ur, m1r);
    apply_p1<S>(Mr + 2 * MATP, ur, m2r);

    // both child edges at once: the outside partials o = d * m_sib,
    // renormalized by their group max
    float ol[S], orr[S], mx[2] = {0.f, 0.f};
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ol[s] = d[s] * mr[s];
      orr[s] = d[s] * ml[s];
      mx[0] = fmaxf(mx[0], ol[s]);
      mx[1] = fmaxf(mx[1], orr[s]);
    }
#pragma unroll
    for (int off = 1; off < CL; off <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
    }
    mx[0] = fmaxf(mx[0], SCALE_TINY);
    mx[1] = fmaxf(mx[1], SCALE_TINY);
    const float rl = __frcp_rn(mx[0]), rr = __frcp_rn(mx[1]);
    float f[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};  // f0, f1, f2 left, then right
#pragma unroll
    for (int s = 0; s < S; ++s) {
      ol[s] *= rl;
      orr[s] *= rr;
      f[0] += ol[s] * ml[s];
      f[1] += ol[s] * m1l[s];
      f[2] += ol[s] * m2l[s];
      f[3] += orr[s] * mr[s];
      f[4] += orr[s] * m1r[s];
      f[5] += orr[s] * m2r[s];
    }
    const float oscl = dsc + sr + logf(mx[0]), oscr = dsc + sl + logf(mx[1]);
#pragma unroll
    for (int q = 0; q < 6; ++q) f[q] *= act;
    group_sums<CL>(f);
    float v[4];  // (v1, v2) left, then right
#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const float osc = side ? oscr : oscl, s_child = side ? sr : sl;
      const float inv_t = inv_p > 0.f ? inv_p * expf(fminf(-(osc + s_child), 80.f)) : 0.f;
      const float rden = __frcp_rn(fmaxf(f[3 * side], SCALE_TINY) + inv_t);
      const float r1 = f[3 * side + 1] * rden, r2 = f[3 * side + 2] * rden;
      v[2 * side] = w_p * r1;
      v[2 * side + 1] = w_p * (r2 - r1 * r1);
    }
    warp_group_sums<CL>(v);
    if (lane == 0) {
      reinterpret_cast<float2*>(part_w)[st.l] = make_float2(v[0], v[1]);
      reinterpret_cast<float2*>(part_w)[st.r] = make_float2(v[2], v[3]);
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

// threads: lanes a block (a multiple of 32); a block holds threads / CL
// patterns, and part must have (blocks x threads / 32) rows of
// [n_nodes][2] -- the wrapper sizes it the same way.
extern "C" int iqt_newton(const int* steps, int n_steps, const float* mats,
                          const float* rootd, const float* wp, const float* invar,
                          const float* up, const float* usc, int P, int n_nodes,
                          float* part, float* d12, int C, int S, int n_slots, int threads,
                          void* stream) {
  if (threads <= 0 || threads > 1024 || threads % 32) return (int)cudaErrorInvalidValue;
  int n_blocks = 0;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC, SV)                                                      \
  {                                                                             \
    const size_t smem = (((size_t)n_slots * (SV + 1) +                          \
                          STAGES * WarpStage<CC, SV>::STAGE_WORDS) * threads +  \
                         (size_t)(threads / 32) * STAGES * WarpStage<CC, SV>::WORDS) * \
                        sizeof(float);                                          \
    const int per_block = threads / Lanes<CC>::CL;                              \
    n_blocks = (P + per_block - 1) / per_block;                                 \
    e = allow_smem(newton_kernel<CC, SV>, smem);                                \
    if (e == cudaSuccess)                                                       \
      newton_kernel<CC, SV><<<n_blocks, threads, smem, (cudaStream_t)stream>>>( \
          steps, n_steps, mats, rootd, wp, invar, up, usc, P, n_nodes, part,    \
          n_slots);                                                             \
  }
  IQT_DISPATCH_CS(C, S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(part, d12, n_blocks * (threads / 32), n_nodes * 2, 0,
                            (cudaStream_t)stream);
}
