// Wide forward likelihood kernel: per-pattern log-likelihood of the whole
// tree at the general [C,S,S] layout (protein, S = 20).
//
// Replaces the TPU kernel _kernel (iqtree_tpu/engine/kernels/pruning.py),
// the general forward lnL with [C,S,S] x [C,S,T] child contractions.  Each
// block walks the slot schedule for its tile of T patterns with the live
// partials in a shared-memory slot pool; per step the two children's
// matrices are staged in shared memory, each thread forms its RPT rows of
// both messages, and a shared-memory max over the row groups renormalizes
// the product.  The root mixes with props * pi and adds the invariant-site
// class in log space.  See wide_common.cuh for the layout.
//
// Bound on an H100 (LG+G4, 300 taxa x 1 958 patterns): 2 children x C*S*S
// multiply-adds per step and pattern, 2*2*1600*299*1958 = 3.7 GFLOP of
// float32 FMA (67 TFLOP/s: 0.056 ms), against 47 MB of tip indicators read
// once (3.35 TB/s: 0.014 ms): bound by operations.  This first version does
// not reach it: two barriers a step along a 299-step dependent chain, and
// ~123 blocks of 256 threads for 132 SMs at T = 16.  Tensor-core products
// of the [S,S] x [S,T] blocks are later work.
#include "wide_common.cuh"

using namespace iqtw;

template <int S, int RPT>
__global__ void __launch_bounds__(MAX_THREADS)
wide_forward_kernel(const int* __restrict__ steps, int n_steps,
                    const float* __restrict__ trans, const float* __restrict__ tips,
                    int P, const float* __restrict__ rootw,
                    const float* __restrict__ invar, float* __restrict__ out, int C,
                    int n_slots, int T) {
  extern __shared__ float smem[];
  const Lane<S, RPT> L(T, C);
  const int p_raw = blockIdx.x * T + L.p;
  const int pg = min(p_raw, P - 1);  // ragged tail computes a copy, writes nothing
  const int CSS = L.CS * S;
  float* slots = smem;                                 // [n_slots][CS][T]
  float* sscale = slots + (size_t)n_slots * L.CS * T;  // [n_slots][T]
  float* pst = sscale + (size_t)n_slots * T;           // [2][C][S][S]
  float* red = pst + 2 * CSS;                          // [G][T]

  stage_children(pst, trans, load_step(steps, 0), CSS);
  __syncthreads();
  float y[RPT];
  for (int i = 0; i < n_steps; ++i) {
    upward_step<S, RPT>(load_step(steps, i), pst, tips, P, pg, slots, sscale, red, L, y);
    // the step's matrix reads ended at its barrier: stage the next step's
    if (i + 1 < n_steps) stage_children(pst, trans, load_step(steps, i + 1), CSS);
    __syncthreads();
  }
  if (L.g != 0) return;
  const int root_slot = load_step(steps, n_steps - 1).out;
  const float* col = slots + (size_t)root_slot * L.CS * T + L.p;
  float mix = 0.f;
  for (int k = 0; k < L.CS; ++k) mix += __ldg(rootw + k) * col[k * T];
  float lnl = logf(fmaxf(mix, SCALE_TINY)) + sscale[root_slot * T + L.p];
  const float inv = __ldg(invar + pg);
  if (inv > 0.f) {
    const float b = logf(fmaxf(inv, SCALE_TINY));
    const float hi = fmaxf(lnl, b), lo = fminf(lnl, b);
    lnl = hi + log1pf(expf(lo - hi));
  }
  if (p_raw < P) out[p_raw] = lnl;
}

extern "C" int iqt_wide_forward(const int* steps, int n_steps, const float* trans,
                                const float* tips, int P, const float* rootw,
                                const float* invar, float* out, int C, int S,
                                int n_slots, int tile, void* stream) {
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
    e = iqt::allow_smem(wide_forward_kernel<SS_, RPT_>, bytes);                   \
    if (e == cudaSuccess)                                                         \
      wide_forward_kernel<SS_, RPT_><<<grid, threads, bytes, (cudaStream_t)stream>>>( \
          steps, n_steps, trans, tips, P, rootw, invar, out, C, n_slots, tile);    \
  }
  IQT_DISPATCH_S(S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
