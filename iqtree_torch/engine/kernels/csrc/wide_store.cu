// Wide upward-store kernel: the forward sweep at the general [C,S,S]
// layout (protein, S = 20), also storing every internal node's normalized
// partial and log-scale for the reverse sweeps.
//
// Replaces the TPU kernel _kernel_store (want_mb=False;
// iqtree_tpu/engine/kernels/pruning.py), which also feeds the wide
// branch-Newton sweep.  Same walk as wide_forward.cu; each step's partial
// goes both to its shared-memory slot (read by the parent step) and to
// up[node] [C*S, P] / usc[node] [P] in device memory, coalesced over the
// tile's patterns.  The TPU's padding of S to 24 rows (Mosaic's 8-row DMA
// tiling) and its 8-row replicated scale rows are not carried over.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): the 3.7 GFLOP of
// the forward kernel (67 TFLOP/s: 0.056 ms) and the stored partials, 299 x
// 81 rows x 1 958 patterns x 4 B = 190 MB written (3.35 TB/s: 0.057 ms):
// bytes and operations about even.  Like the forward kernel, this first
// version runs at the latency of its step chain.
#include "wide_common.cuh"

using namespace iqtw;

template <int S, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
wide_store_kernel(const int* __restrict__ steps, int n_steps,
                  const float* __restrict__ trans, const float* __restrict__ tips,
                  int P, float* __restrict__ up, float* __restrict__ usc, int C,
                  int n_slots, int T) {
  extern __shared__ float smem[];
  const Lane<S, RPT> L(T, C);
  const int p_raw = blockIdx.x * T + L.p;
  const int pg = min(p_raw, P - 1);
  const int CSS = L.CS * S;
  float* slots = smem;                                 // [n_slots][CS][T]
  float* sscale = slots + (size_t)n_slots * L.CS * T;  // [n_slots][T]
  float* pst = sscale + (size_t)n_slots * T;           // [2][C][S][S]
  float* red = pst + 2 * CSS;                          // [G][T]

  stage_children(pst, trans, load_step(steps, 0), CSS);
  __syncthreads();
  float y[RPT];
  for (int i = 0; i < n_steps; ++i) {
    const Step st = load_step(steps, i);
    const float sc = upward_step<S, RPT>(st, pst, tips, P, pg, slots, sscale, red, L, y);
    if (p_raw < P) {
      float* dst = up + ((size_t)st.node * L.CS + L.row(0)) * P + p_raw;
#pragma unroll
      for (int j = 0; j < RPT; ++j) dst[(size_t)j * P] = y[j];
      if (L.g == 0) usc[(size_t)st.node * P + p_raw] = sc;
    }
    if (i + 1 < n_steps) stage_children(pst, trans, load_step(steps, i + 1), CSS);
    __syncthreads();
  }
}

extern "C" int iqt_wide_store(const int* steps, int n_steps, const float* trans,
                              const float* tips, int P, float* up, float* usc, int C,
                              int S, int n_slots, int tile, void* stream) {
  const int CS = C * S;
  const size_t smem =
      ((size_t)n_slots * (CS + 1) * tile + 2 * (size_t)CS * S) * sizeof(float);
  const dim3 grid((P + tile - 1) / tile);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(SS_, RPT_)                                                     \
  {                                                                               \
    const int threads = tile * C * (SS_ / RPT_);                                  \
    if (threads > MAX_THREADS) return (int)cudaErrorInvalidConfiguration;         \
    const size_t bytes = smem + (size_t)C * (SS_ / RPT_) * tile * sizeof(float);  \
    e = iqt::allow_smem(wide_store_kernel<SS_, RPT_>, bytes);                     \
    if (e == cudaSuccess)                                                         \
      wide_store_kernel<SS_, RPT_><<<grid, threads, bytes, (cudaStream_t)stream>>>( \
          steps, n_steps, trans, tips, P, up, usc, C, n_slots, tile);             \
  }
  IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
