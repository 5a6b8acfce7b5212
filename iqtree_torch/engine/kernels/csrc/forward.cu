// Forward likelihood kernel: per-pattern log-likelihood of the whole tree.
//
// Replaces the TPU kernels _kernel_cs / _kernel_cs_packed
// (iqtree_tpu/engine/kernels/pruning.py).  Each block walks the slot
// schedule for its tile of patterns with the live partials in a shared
// memory slot pool; the root mixes with props * pi and adds the
// invariant-site class in log space.  See cs_common.cuh for the layout.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): the needed work is
// 2 children x C*S*S multiply-adds per step and pattern, about
// 2*2*64*999*1e4 = 2.6 GFLOP of float32 FMA (67 TFLOP/s: 0.04 ms), against
// 160 MB of tip partials read once (3.35 TB/s: 0.05 ms).  Neither bound is
// near what limits this first version: one thread per pattern gives ~2.4
// warps per SM at 10k patterns, so the 999-step dependent chain runs at
// instruction latency.  Making the kernel fast (more threads per pattern,
// tensor-core products of 16-row packs) is later work.
#include "cs_common.cuh"

using namespace iqt;

template <int C>
__global__ void forward_kernel(const int* __restrict__ steps, int n_steps,
                               const float* __restrict__ trans,
                               const float* __restrict__ tips, int P,
                               const float* __restrict__ rootw,
                               const float* __restrict__ invar,
                               float* __restrict__ out, int n_slots) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * T + tid;
  const int p = min(p_raw, P - 1);  // ragged tail computes a copy, writes nothing
  float* slots = smem;                                  // [n_slots][C*S][T]
  float* sscale = smem + (size_t)n_slots * C * S * T;   // [n_slots][T]

  float y[C][S];
  for (int i = 0; i < n_steps; ++i) {
    Step st = load_step(steps, i);
    float sc = upward_step<C>(st, trans, tips, P, p, slots, sscale, T, tid, y);
    store_slot<C>(slots, sscale, st.out, T, tid, y, sc);
  }
  const int root_slot = load_step(steps, n_steps - 1).out;
  float lnl = root_site_lnl<C>(slots, sscale, root_slot, T, tid, rootw, __ldg(invar + p));
  if (p_raw < P) out[p_raw] = lnl;
}

extern "C" int iqt_forward(const int* steps, int n_steps, const float* trans,
                           const float* tips, int P, const float* rootw,
                           const float* invar, float* out, int C, int n_slots,
                           int tile, void* stream) {
  const size_t smem = (size_t)n_slots * (C * S + 1) * tile * sizeof(float);
  const dim3 grid((P + tile - 1) / tile);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC)                                                        \
  e = allow_smem(forward_kernel<CC>, smem);                                   \
  if (e == cudaSuccess)                                                       \
    forward_kernel<CC><<<grid, tile, smem, (cudaStream_t)stream>>>(           \
        steps, n_steps, trans, tips, P, rootw, invar, out, n_slots);
  IQT_DISPATCH_C(C, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
