// Upward-store kernel: the forward sweep, also storing every internal
// node's normalized partial and log-scale for the reverse sweeps.
//
// Replaces the TPU kernel _kernel_store_cs
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Same walk as forward.cu
// (upward_lanes of cs_common.cuh: a lane a (pattern, rate category), the
// inputs fetched with cp.async a step ahead, no block barrier); each
// step's partial goes both to its shared-memory slot (read by the parent
// step) and to up[node] [C*S, P] / usc[node] [P] in device memory.  The
// TPU's 8-row replicated scale rows are not carried over.
//
// Instances: S = 4 (DNA; S = 3 zero-padded by the wrapper) and S = 2
// (binary), C = 1..8 each (IQT_DISPATCH_CS).
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): the same 2.6 GFLOP
// as the forward kernel, plus the stored partials, 999 x 17 rows x 10k
// patterns x 4 B = 0.68 GB written (3.35 TB/s: 0.2 ms): byte-bound.  A
// warp's store of one of its lanes' rows covers CL runs of 32 / CL
// consecutive patterns: whole 32-byte sectors at CL <= 4.  Active lanes
// (category < C) write their S rows, the group's first lane the scale;
// the stores are off the step's chain.  At CL = 8 (C = 5-8) a run is a
// 16-byte half sector, and the writes cost 3x the rest of the kernel
// (PERF.md): two categories a lane there is open work.
#include "cs_common.cuh"

using namespace iqt;

template <int C, int S>
__global__ void store_kernel(const int* __restrict__ steps, int n_steps,
                             const float* __restrict__ trans,
                             const float* __restrict__ tips, int P,
                             float* __restrict__ up, float* __restrict__ usc,
                             int n_slots) {
  extern __shared__ float smem[];
  constexpr int CL = Lanes<C>::CL;
  const int T = blockDim.x, tid = threadIdx.x, cl = tid & (CL - 1);
  const int p_raw = blockIdx.x * (T / CL) + tid / CL;
  const int p = min(p_raw, P - 1);
  const bool writes = cl < C && p_raw < P;
  auto emit = [&](const Step& st, const float (&ys)[S], float s_node) {
    if (!writes) return;
    float* dst = up + ((size_t)st.node * C + cl) * S * P + p_raw;
#pragma unroll
    for (int s = 0; s < S; ++s) dst[(size_t)s * P] = ys[s];
    if (cl == 0) usc[(size_t)st.node * P + p_raw] = s_node;
  };
  float y[S], sc;
  upward_lanes<C, S>(steps, n_steps, trans, tips, P, p, smem, n_slots, emit, y, sc);
}

// lanes: threads a block (a multiple of 32); a block holds lanes / CL patterns.
extern "C" int iqt_store(const int* steps, int n_steps, const float* trans,
                         const float* tips, int P, float* up, float* usc, int C, int S,
                         int n_slots, int lanes, void* stream) {
  if (lanes <= 0 || lanes > 1024 || lanes % 32) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC, SV)                                                    \
  {                                                                           \
    const size_t smem = upward_smem<CC, SV>(n_slots, lanes);                  \
    const int per_block = lanes / Lanes<CC>::CL;                              \
    e = allow_smem(store_kernel<CC, SV>, smem);                               \
    if (e == cudaSuccess)                                                     \
      store_kernel<CC, SV><<<(P + per_block - 1) / per_block, lanes, smem,    \
                             (cudaStream_t)stream>>>(                         \
          steps, n_steps, trans, tips, P, up, usc, n_slots);                  \
  }
  IQT_DISPATCH_CS(C, S, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
