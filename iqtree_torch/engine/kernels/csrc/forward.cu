// Forward likelihood kernel: per-pattern log-likelihood of the whole tree.
//
// Replaces the TPU kernels _kernel_cs / _kernel_cs_packed
// (iqtree_tpu/engine/kernels/pruning.py).  Each block walks the slot
// schedule for its patterns with the live partials in a shared-memory
// slot pool; the root mixes with props * pi and adds the invariant-site
// class in log space.
//
// Work layout: one lane a (pattern, rate category), the upward sweep of
// cs_common.cuh (upward_lanes): CL = C rounded up to a power of two lanes
// a pattern, a lane past C computing a copy that adds nothing and writes
// nothing; a tip child's words and both edge blocks fetched with cp.async
// a step ahead; the renormalizing max a log2(CL)-round butterfly; no
// block barrier.  The root's mix runs in the order of the thread-a-pattern
// step, so the kernel gives the bits of that design (PERF.md).
//
// Instances: S = 4 (DNA; S = 3 zero-padded by the wrapper) and S = 2
// (binary), C = 1..8 each (IQT_DISPATCH_CS).  At S = 2 a category's block
// is one float4 and a lane's step is 2 x 4 multiply-adds.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): the needed work is
// 2 children x C*S*S multiply-adds per step and pattern, about
// 2*2*64*999*1e4 = 2.6 GFLOP of float32 FMA (67 TFLOP/s: 0.04 ms), against
// 160 MB of tip partials read once (3.35 TB/s: 0.05 ms).  Neither bound is
// near what limits the kernel: the 999-step dependent chain of each lane.
// A thread a pattern gave ~2.4 warps an SM at 10k patterns and its loads
// sat on that chain; a lane a category gives C times the warps and takes
// the loads off it.
#include "cs_common.cuh"

using namespace iqt;

template <int C, int S>
__global__ void forward_kernel(const int* __restrict__ steps, int n_steps,
                               const float* __restrict__ trans,
                               const float* __restrict__ tips, int P,
                               const float* __restrict__ rootw,
                               const float* __restrict__ invar,
                               float* __restrict__ out, int n_slots) {
  extern __shared__ float smem[];
  constexpr int CL = Lanes<C>::CL;
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * (T / CL) + tid / CL;
  const int p = min(p_raw, P - 1);  // ragged tail computes a copy, writes nothing
  auto emit = [](const Step&, const float (&)[S], float) {};
  float y[S], sc;
  upward_lanes<C, S>(steps, n_steps, trans, tips, P, p, smem, n_slots, emit, y, sc);
  const int root_slot = load_step(steps, n_steps - 1).out;
  const float lnl = lane_root_lnl<C, S>(smem, root_slot, T, tid & ~(CL - 1), rootw, sc,
                                        __ldg(invar + p));
  if ((tid & (CL - 1)) == 0 && p_raw < P) out[p_raw] = lnl;
}

// lanes: threads a block (a multiple of 32); a block holds lanes / CL patterns.
extern "C" int iqt_forward(const int* steps, int n_steps, const float* trans,
                           const float* tips, int P, const float* rootw,
                           const float* invar, float* out, int C, int S, int n_slots,
                           int lanes, void* stream) {
  if (lanes <= 0 || lanes > 1024 || lanes % 32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC, SV)                                                    \
  {                                                                           \
    const size_t smem = upward_smem<CC, SV>(n_slots, lanes);                  \
    const int per_block = lanes / Lanes<CC>::CL;                              \
    e = allow_smem(forward_kernel<CC, SV>, smem);                             \
    if (e == cudaSuccess)                                                     \
      forward_kernel<CC, SV><<<(P + per_block - 1) / per_block, lanes, smem,  \
                               (cudaStream_t)stream>>>(                       \
          steps, n_steps, trans, tips, P, rootw, invar, out, n_slots);        \
  }
  IQT_DISPATCH_CS(C, S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
