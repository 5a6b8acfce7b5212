// Wide branch-Newton sweep: first and second derivatives of lnL with
// respect to every branch length at once, at the general [C,S,S] layout
// (protein, S = 20).
//
// Replaces the TPU kernel _kernel_newton_cs_stream / _newton_body
// (iqtree_tpu/engine/kernels/cs_kernels.py), which streams each child's
// stacked [3CS, CS] block from HBM because the stacked matrices of all
// edges do not fit VMEM at CS = 80.  Here each step stages its two
// children's (P, P', P'') [3][C][S][S] blocks in shared memory (38 KB at
// C = 4): the per-category blocks, not the TPU's dense block-diagonal
// [3CS, CS] padded to 128 lanes.  Reverse walk of the slot schedule: for
// each child edge e it forms the outside partial O_e and, with
// f_k = sum_cs O_e * (P_e^(k) U_e),
//     d1[e] = sum_p w_p f1/den,   d2[e] = sum_p w_p (f2/den - (f1/den)^2),
// where den = f0 + the invariant-site term in the scaled frame.  Each
// thread sums its rows' share of f_k; a shared-memory pass over the row
// groups gives each pattern's f_k, and one thread adds the tile's patterns
// in order into part[block][edge][2]; a second pass adds the blocks in
// block order (deterministic).  The root and dummy rows stay 0.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads the stored
// partials once, 0.39 GB (3.35 TB/s: 0.12 ms); per step and pattern
// (P, P', P'') U for both children, 6 x 1 600 multiply-adds and 12 x 80
// row operations, and a 1 600 multiply-add push into each of the 298
// internal non-root children:
// 2 x 1 958 x (299 x 10 560 + 298 x 1 600) = 14.2 GFLOP (67 TFLOP/s:
// 0.21 ms): bound by operations.
#include "wide_common.cuh"

using namespace iqtw;

// One child edge of a reverse step: O, the edge's (d1, d2) sums into
// part_b, and the push of P^T O into the child's slot.
template <int S, int RPT>
__device__ __forceinline__ void newton_side(
    int child, int cslot, const float (&d)[RPT], float dsc, const float (&m_sib)[RPT],
    float s_sib, float s_child, const float (&mk)[3][RPT], const float* mst_child,
    float w_p, float inv_p, float* stage_o, float* red, float* red3, float* vred,
    float* dslots, float* dscale, float* part_b, const Lane<S, RPT>& L, int TS) {
  const int T = L.T;
  float o[RPT], local = 0.f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    o[j] = d[j] * m_sib[j];
    local = fmaxf(local, o[j]);
  }
  const float mx = row_max<S, RPT>(red, local, L);
  const float osc = dsc + s_sib + logf(mx);
  float f[3] = {0.f, 0.f, 0.f};
  float* so = stage_o + L.row(0) * TS + L.p;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    o[j] = o[j] / mx;
    so[j * TS] = o[j];
#pragma unroll
    for (int k = 0; k < 3; ++k) f[k] += o[j] * mk[k][j];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) red3[(k * L.G + L.g) * T + L.p] = f[k];
  __syncthreads();
  if (L.g == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      float acc = 0.f;
      for (int gg = 0; gg < L.G; ++gg) acc += red3[(k * L.G + gg) * T + L.p];
      f[k] = acc;
    }
    const float f0 = fmaxf(f[0], SCALE_TINY);
    const float inv_t = inv_p > 0.f ? inv_p * expf(fminf(-(osc + s_child), 80.f)) : 0.f;
    const float den = f0 + inv_t;
    const float r1 = f[1] / den, r2 = f[2] / den;
    vred[L.p] = w_p * r1;
    vred[T + L.p] = w_p * (r2 - r1 * r1);
  }
  if (cslot >= 0) {
    float dd[RPT];
    transport<S, RPT>(mst_child + L.c * L.SS, stage_o, TS, L, dd);
    float* dst = dslots + ((size_t)cslot * L.CS + L.row(0)) * T + L.p;
#pragma unroll
    for (int j = 0; j < RPT; ++j) dst[j * T] = dd[j];
    if (L.g == 0) dscale[cslot * T + L.p] = osc;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a1 = 0.f, a2 = 0.f;
    for (int q = 0; q < T; ++q) {
      a1 += vred[q];
      a2 += vred[T + q];
    }
    part_b[2 * child] = a1;
    part_b[2 * child + 1] = a2;
  }
}

template <int S, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
wide_newton_kernel(const int* __restrict__ steps, int n_steps,
                   const float* __restrict__ mats,  // [2N][3][C][S][S]
                   const float* __restrict__ rootd, const float* __restrict__ wp,
                   const float* __restrict__ invar, const float* __restrict__ up,
                   const float* __restrict__ usc, int P, int n_nodes,
                   float* __restrict__ part, int C, int n_slots, int T) {
  extern __shared__ float smem[];
  const Lane<S, RPT> L(T, C);
  const int CS = L.CS, CSS = CS * S, TS = T + 1;
  const int p_raw = blockIdx.x * T + L.p;
  const bool valid = p_raw < P;
  const int pg = min(p_raw, P - 1);
  float* dslots = smem;                               // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;  // [n_slots][T]
  float* mst = dscale + (size_t)n_slots * T;          // [2][3][C][S][S]
  float* ustage = mst + 6 * CSS;                      // [2][CS][T+1]
  float* stage_o = ustage + 2 * CS * TS;              // [CS][T+1]
  float* red = stage_o + CS * TS;                     // [G][T]
  float* red3 = red + L.G * T;                        // [3][G][T]
  float* vred = red3 + 3 * L.G * T;                   // [2][T]
  const float w_p = valid ? __ldg(wp + pg) : 0.f;
  const float inv_p = __ldg(invar + pg);
  float* part_b = part + (size_t)blockIdx.x * n_nodes * 2;

  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    stage_children(mst, mats, st, 3 * CSS);
    stage_partial<S, RPT>(ustage, TS, up, st.l, P, pg, L);
    stage_partial<S, RPT>(ustage + CS * TS, TS, up, st.r, P, pg, L);
    float d[RPT], dsc = 0.f;
    if (i == n_steps - 1) {
#pragma unroll
      for (int j = 0; j < RPT; ++j) d[j] = __ldg(rootd + L.row(j));
    } else {
      const float* col = dslots + ((size_t)st.out * CS + L.row(0)) * T + L.p;
#pragma unroll
      for (int j = 0; j < RPT; ++j) d[j] = col[j * T];
      dsc = dscale[st.out * T + L.p];
    }
    const float sl = __ldg(usc + (size_t)st.l * P + pg);
    const float sr = __ldg(usc + (size_t)st.r * P + pg);
    __syncthreads();  // matrices and child partials staged
    float x[S], ml[3][RPT], mr[3][RPT];
    load_column<S, RPT>(ustage, TS, L, x);
#pragma unroll
    for (int k = 0; k < 3; ++k) message<S, RPT>(mst + k * CSS + L.c * L.SS, L.s0, x, ml[k]);
    load_column<S, RPT>(ustage + CS * TS, TS, L, x);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      message<S, RPT>(mst + (3 + k) * CSS + L.c * L.SS, L.s0, x, mr[k]);
    newton_side<S, RPT>(st.l, st.ls, d, dsc, mr[0], sr, sl, ml, mst, w_p, inv_p, stage_o,
                        red, red3, vred, dslots, dscale, part_b, L, TS);
    newton_side<S, RPT>(st.r, st.rs, d, dsc, ml[0], sl, sr, mr, mst + 3 * CSS, w_p, inv_p,
                        stage_o, red, red3, vred, dslots, dscale, part_b, L, TS);
  }
}

extern "C" int iqt_wide_newton(const int* steps, int n_steps, const float* mats,
                               const float* rootd, const float* wp, const float* invar,
                               const float* up, const float* usc, int P, int n_nodes,
                               float* part, float* d12, int C, int S, int n_slots,
                               int tile, void* stream) {
  const int CS = C * S, TS = tile + 1;
  const size_t smem = ((size_t)n_slots * (CS + 1) * tile + 6 * (size_t)CS * S +
                       3 * (size_t)CS * TS + 2 * (size_t)tile) * sizeof(float);
  const int n_blocks = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                       \
  {                                                                                 \
    const int threads = tile * C * (SS_ / RPT_);                                    \
    if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;           \
    const size_t bytes = smem + 4 * (size_t)C * (SS_ / RPT_) * tile * sizeof(float); \
    e = iqt::allow_smem(wide_newton_kernel<SS_, RPT_>, bytes);                      \
    if (e == cudaSuccess)                                                           \
      wide_newton_kernel<SS_, RPT_><<<n_blocks, threads, bytes, (cudaStream_t)stream>>>( \
          steps, n_steps, mats, rootd, wp, invar, up, usc, P, n_nodes, part, C,     \
          n_slots, tile);                                                           \
  }
  IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)iqt::launch_reduce(part, d12, n_blocks, n_nodes * 2, 0,
                                 (cudaStream_t)stream);
}
