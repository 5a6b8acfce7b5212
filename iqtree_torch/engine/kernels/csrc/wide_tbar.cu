// Wide gradient sweep: the cotangent of every edge's transition matrices
// at the general [C,S,S] layout (protein, S = 20).
//
// Replaces the TPU kernel _kernel_down_tbar
// (iqtree_tpu/engine/kernels/pruning.py).  Reverse walk of the slot
// schedule: each step forms its two child edges' outside partials O from
// the parent's outside vector D (root seed props * pi) and the sibling's
// message, accumulates
//     tbar[e][c][s][t] += sum_p O[c,s,p] * fac[p] * U_e[c,t,p],
//     fac = exp(min(osc + usc - lnl, 80)) * w_p,
// and pushes D_child = P^T O down the tree.  The children's inside
// partials are staged per step from the upward store's up buffer (tip
// rows filled by the caller), coalesced over the tile's patterns.
//
// The TPU grid runs its pattern tiles in order into one [2N,C,S,S]
// accumulator; blocks here run in no order, so each block writes its own
// sums part[block][edge][C][S][S] and a second pass adds the blocks in
// block order (deterministic, no float atomics).  At this width the
// per-block sums are large (1 600 floats an edge and block: 0.47 GB for
// 300 taxa x 1 958 patterns at T = 16), so the caller sizes `part` for
// `part_blocks` blocks and the sweep runs in chunks of that many blocks,
// each chunk's sums added onto the last.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads the stored
// partials once, 2N x 81 rows x 1 958 x 4 B = 0.39 GB (3.35 TB/s: 0.12 ms);
// per step and pattern both children's messages and cotangent blocks,
// 4 x 1 600 multiply-adds and 6 x 80 row operations, and a 1 600
// multiply-add push into each of the 298 internal non-root children:
// 2 x 1 958 x (299 x 6 880 + 298 x 1 600) = 9.9 GFLOP (67 TFLOP/s:
// 0.15 ms): bound by operations.  Seven barriers a step; this first
// version runs at the latency of its step chain.
#include "wide_common.cuh"

using namespace iqtw;

// One child edge of a reverse step (see the header): O, its cotangent
// block into part_b, and the push of P^T O into the child's slot.
template <int S, int RPT>
__device__ __forceinline__ void tbar_side(
    int child, int cslot, const float (&d)[RPT], float dsc, const float (&m_sib)[RPT],
    float s_sib, float s_child, const float* u_child, const float* pst_child, float lnl_p,
    float w_p, bool valid, float* stage_o, float* fac_s, float* red, float* dslots,
    float* dscale, float* part_b, const Lane<S, RPT>& L, int TS) {
  float o[RPT], local = 0.f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    o[j] = d[j] * m_sib[j];
    local = fmaxf(local, o[j]);
  }
  const float mx = row_max<S, RPT>(red, local, L);
  float* so = stage_o + L.row(0) * TS + L.p;
#pragma unroll
  for (int j = 0; j < RPT; ++j) so[j * TS] = o[j] / mx;
  const float osc = dsc + s_sib + logf(mx);
  if (L.g == 0)
    fac_s[L.p] = valid ? expf(fminf(osc + s_child - lnl_p, 80.f)) * w_p : 0.f;
  __syncthreads();
  const int CSS = L.CS * S;
  for (int k = threadIdx.x; k < CSS; k += blockDim.x) {
    const int c = k / L.SS, s = (k / S) % S, t = k % S;
    const float* a = stage_o + (c * S + s) * TS;
    const float* b = u_child + (c * S + t) * TS;
    float acc = 0.f;
    for (int q = 0; q < L.T; ++q) acc += (a[q] * fac_s[q]) * b[q];
    part_b[(size_t)child * CSS + k] = acc;
  }
  if (cslot >= 0) {
    float dd[RPT];
    transport<S, RPT>(pst_child + L.c * L.SS, stage_o, TS, L, dd);
    float* dst = dslots + ((size_t)cslot * L.CS + L.row(0)) * L.T + L.p;
#pragma unroll
    for (int j = 0; j < RPT; ++j) dst[j * L.T] = dd[j];
    if (L.g == 0) dscale[cslot * L.T + L.p] = osc;
  }
  __syncthreads();  // stage_o, fac_s and red are free for the next edge
}

template <int S, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
wide_tbar_kernel(const int* __restrict__ steps, int n_steps,
                 const float* __restrict__ trans, const float* __restrict__ rootd,
                 const float* __restrict__ lnl, const float* __restrict__ wp,
                 const float* __restrict__ up, const float* __restrict__ usc, int P,
                 int n_nodes, float* __restrict__ part, int C, int n_slots, int T,
                 int block0) {
  extern __shared__ float smem[];
  const Lane<S, RPT> L(T, C);
  const int CS = L.CS, CSS = CS * S, TS = T + 1;  // padded stride: see the reduction
  const int p_raw = (blockIdx.x + block0) * T + L.p;
  const bool valid = p_raw < P;
  const int pg = min(p_raw, P - 1);
  float* dslots = smem;                              // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;  // [n_slots][T]
  float* pst = dscale + (size_t)n_slots * T;          // [2][C][S][S]
  float* ustage = pst + 2 * CSS;                      // [2][CS][T+1]
  float* stage_o = ustage + 2 * CS * TS;              // [CS][T+1]
  float* fac_s = stage_o + CS * TS;                   // [T]
  float* red = fac_s + T;                             // [G][T]
  const float lnl_p = __ldg(lnl + pg);
  const float w_p = valid ? __ldg(wp + pg) : 0.f;
  float* part_b = part + (size_t)blockIdx.x * n_nodes * CSS;

  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    stage_children(pst, trans, st, CSS);
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
    float x[S], ml[RPT], mr[RPT];
    load_column<S, RPT>(ustage, TS, L, x);
    message<S, RPT>(pst + L.c * L.SS, L.s0, x, ml);
    load_column<S, RPT>(ustage + CS * TS, TS, L, x);
    message<S, RPT>(pst + CSS + L.c * L.SS, L.s0, x, mr);
    tbar_side<S, RPT>(st.l, st.ls, d, dsc, mr, sr, sl, ustage, pst, lnl_p, w_p, valid,
                      stage_o, fac_s, red, dslots, dscale, part_b, L, TS);
    tbar_side<S, RPT>(st.r, st.rs, d, dsc, ml, sl, sr, ustage + CS * TS, pst + CSS,
                      lnl_p, w_p, valid, stage_o, fac_s, red, dslots, dscale, part_b,
                      L, TS);
  }
}

extern "C" int iqt_wide_tbar(const int* steps, int n_steps, const float* trans,
                             const float* rootd, const float* lnl, const float* wp,
                             const float* up, const float* usc, int P, int n_nodes,
                             float* part, int part_blocks, float* tbar, int C, int S,
                             int n_slots, int tile, void* stream) {
  const int CS = C * S, TS = tile + 1;
  const size_t smem = ((size_t)n_slots * (CS + 1) * tile + 2 * (size_t)CS * S +
                       3 * (size_t)CS * TS + tile) * sizeof(float);
  const int n_blocks = (P + tile - 1) / tile;
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (part_blocks < 1) return (int)cudaErrorInvalidValue;
  for (int b0 = 0; b0 < n_blocks; b0 += part_blocks) {
    const int nb = min(part_blocks, n_blocks - b0);
#define IQT_LAUNCH(SS_, RPT_)                                                     \
  {                                                                               \
    const int threads = tile * C * (SS_ / RPT_);                                  \
    if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;         \
    const size_t bytes = smem + (size_t)C * (SS_ / RPT_) * tile * sizeof(float);  \
    e = iqt::allow_smem(wide_tbar_kernel<SS_, RPT_>, bytes);                      \
    if (e == cudaSuccess)                                                         \
      wide_tbar_kernel<SS_, RPT_><<<nb, threads, bytes, st>>>(                    \
          steps, n_steps, trans, rootd, lnl, wp, up, usc, P, n_nodes, part, C,    \
          n_slots, tile, b0);                                                     \
  }
    IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
    if (e != cudaSuccess) return (int)e;
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    e = iqt::launch_reduce(part, tbar, nb, n_nodes * CS * S, b0 > 0, st);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaSuccess;
}
