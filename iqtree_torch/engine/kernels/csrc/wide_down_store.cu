// Wide outside-partial store: every node's normalized outside partial and
// its log-scale at the general [C,S,S] layout (protein, S = 20), the
// second of the NNI evaluator's two global passes.
//
// Replaces the TPU kernel _kernel_down_store
// (iqtree_tpu/engine/kernels/pruning.py).  Reverse walk of the slot
// schedule, as in wide_tbar.cu without the cotangent sums: each step
// takes the parent's pushed outside vector d (at the root the bare state
// frequencies: the class weights are applied later, by the evaluator's
// theta reductions), forms both child messages m = P U from the upward
// store's partials (tip rows filled by the caller), and for each child
//     O = d * m_sib / max,  osc = dsc + usc_sib + log(max),
// writes O [C*S, P] and osc [P] to out/osc, and, when the child is
// internal, pushes D = P^T O into the child's slot.  The root and dummy
// rows are never written (the caller zeroes them).
//
// Layout: the Lane<S,RPT> thread map of wide_common.cuh (T patterns x
// C*S/RPT row groups).  The children's matrices and inside partials are
// staged per step in shared memory; O is staged once more for the push,
// whose column needs the other row groups' rows.  Nothing is summed
// across patterns, so there are no per-block sums and no second pass
// (compare down_store.cu for S = 4).  The writes of out are coalesced
// over the tile's patterns: T = 16 floats, 64-byte runs.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): reads up and usc
// and writes out and osc once, 2 x 600 x 81 rows x 1 958 x 4 B = 0.76 GB
// (3.35 TB/s: 0.23 ms); per step and pattern both children's messages,
// 2 x 1 600 multiply-adds, and per child 3 x 80 row operations, and a
// 1 600 multiply-add push into each of the 298 internal non-root
// children: 2 x 1 958 x (299 x 3 200 + 298 x 1 600) + 1 958 x 598 x 240
// = 5.9 GFLOP (67 TFLOP/s: 0.09 ms): bound by bytes.  Five to seven
// barriers a step; this first version runs at the latency of its step
// chain.
#include "wide_common.cuh"

using namespace iqtw;

// One child of a reverse step: O and its scale to out/osc, and the push
// P^T O into the child's slot when it is internal.  Ends in a barrier, after
// which stage_o and red are free.
template <int S, int RPT>
__device__ __forceinline__ void store_side(
    int child, int cslot, const float (&d)[RPT], float dsc, const float (&m_sib)[RPT],
    float s_sib, const float* pst_child, bool valid, int P, int p_raw,
    float* __restrict__ out, float* __restrict__ osc, float* stage_o, float* red,
    float* dslots, float* dscale, const Lane<S, RPT>& L, int TS) {
  float o[RPT], local = 0.f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    o[j] = d[j] * m_sib[j];
    local = fmaxf(local, o[j]);
  }
  const float mx = row_max<S, RPT>(red, local, L);
#pragma unroll
  for (int j = 0; j < RPT; ++j) o[j] = o[j] / mx;
  const float sc = dsc + s_sib + logf(mx);
  if (valid) {
    float* dst = out + ((size_t)child * L.CS + L.row(0)) * P + p_raw;
#pragma unroll
    for (int j = 0; j < RPT; ++j) dst[(size_t)j * P] = o[j];
    if (L.g == 0) osc[(size_t)child * P + p_raw] = sc;
  }
  if (cslot >= 0) {
    float* so = stage_o + L.row(0) * TS + L.p;
#pragma unroll
    for (int j = 0; j < RPT; ++j) so[j * TS] = o[j];
    __syncthreads();  // the child's O staged: a column spans the row groups
    float dd[RPT];
    transport<S, RPT>(pst_child + L.c * L.SS, stage_o, TS, L, dd);
    float* dst = dslots + ((size_t)cslot * L.CS + L.row(0)) * L.T + L.p;
#pragma unroll
    for (int j = 0; j < RPT; ++j) dst[j * L.T] = dd[j];
    if (L.g == 0) dscale[cslot * L.T + L.p] = sc;
  }
  __syncthreads();  // stage_o and red are free for the next child
}

template <int S, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
wide_down_store_kernel(const int* __restrict__ steps, int n_steps,
                       const float* __restrict__ trans, const float* __restrict__ rootd,
                       const float* __restrict__ up, const float* __restrict__ usc,
                       int P, float* __restrict__ out, float* __restrict__ osc, int C,
                       int n_slots, int T) {
  extern __shared__ float smem[];
  const Lane<S, RPT> L(T, C);
  const int CS = L.CS, CSS = CS * S, TS = T + 1;  // padded stride, as in wide_tbar.cu
  const int p_raw = blockIdx.x * T + L.p;
  const bool valid = p_raw < P;
  const int pg = min(p_raw, P - 1);
  float* dslots = smem;                               // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;  // [n_slots][T]
  float* pst = dscale + (size_t)n_slots * T;          // [2][C][S][S]
  float* ustage = pst + 2 * CSS;                      // [2][CS][T+1]
  float* stage_o = ustage + 2 * CS * TS;              // [CS][T+1]
  float* red = stage_o + CS * TS;                     // [G][T]

  for (int i = n_steps - 1; i >= 0; --i) {
    const Step st = load_step(steps, i);
    stage_children(pst, trans, st, CSS);
    stage_partial<S, RPT>(ustage, TS, up, st.l, P, pg, L);
    stage_partial<S, RPT>(ustage + CS * TS, TS, up, st.r, P, pg, L);
    // d and dsc are this thread's own rows and pattern; a push of this
    // step into the same slot (the forward pass may reuse st.out for a
    // child) writes only the writer's own rows, after the reads
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
    store_side<S, RPT>(st.l, st.ls, d, dsc, mr, sr, pst, valid, P, p_raw, out, osc,
                       stage_o, red, dslots, dscale, L, TS);
    store_side<S, RPT>(st.r, st.rs, d, dsc, ml, sl, pst + CSS, valid, P, p_raw, out,
                       osc, stage_o, red, dslots, dscale, L, TS);
  }
}

extern "C" int iqt_wide_down_store(const int* steps, int n_steps, const float* trans,
                                   const float* rootd, const float* up,
                                   const float* usc, int P, float* out, float* osc,
                                   int C, int S, int n_slots, int tile, void* stream) {
  const int CS = C * S, TS = tile + 1;
  const size_t smem = ((size_t)n_slots * (CS + 1) * tile + 2 * (size_t)CS * S +
                       3 * (size_t)CS * TS) * sizeof(float);
  const dim3 grid((P + tile - 1) / tile);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                      \
  {                                                                                \
    const int threads = tile * C * (SS_ / RPT_);                                   \
    if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;          \
    const size_t bytes = smem + (size_t)C * (SS_ / RPT_) * tile * sizeof(float);   \
    e = iqt::allow_smem(wide_down_store_kernel<SS_, RPT_>, bytes);                 \
    if (e == cudaSuccess)                                                          \
      wide_down_store_kernel<SS_, RPT_>                                            \
          <<<grid, threads, bytes, (cudaStream_t)stream>>>(                        \
              steps, n_steps, trans, rootd, up, usc, P, out, osc, C, n_slots, tile); \
  }
  IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
