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
// Layout as in tbar.cu: one thread per pattern, the slot pool in shared
// memory [slot][CS][tile], each thread on its own column, so the sweep
// needs no barrier; nothing is summed across patterns, so there are no
// per-block partials and no second pass.  Stores are coalesced over
// patterns (consecutive threads, consecutive addresses).
//
// Bound on an H100 (DNA+G4, 1000 taxa x 9 962 patterns): reads up and usc
// and writes out and osc once, 2 x 2000 x 17 rows x 9 962 x 4 B = 2.7 GB
// (3.35 TB/s: 0.81 ms); the work is 2 x 64 (messages) + 2 x 64 (push) FMA
// and 2 x 32 mul/div per edge and pattern, about 6 GFLOP (67 TFLOP/s:
// 0.09 ms): byte-bound.  Like its siblings this first version walks a
// 999-step dependent chain per block and is expected to run at latency.
#include "cs_common.cuh"

using namespace iqt;

template <int C>
__global__ void down_store_kernel(const int* __restrict__ steps, int n_steps,
                                  const float* __restrict__ trans,
                                  const float* __restrict__ rootd,
                                  const float* __restrict__ up,
                                  const float* __restrict__ usc, int P,
                                  float* __restrict__ out, float* __restrict__ osc,
                                  int n_slots) {
  extern __shared__ float smem[];
  constexpr int CS = C * S;
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * T + tid;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);
  float* dslots = smem;                               // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;  // [n_slots][T]

  for (int i = n_steps - 1; i >= 0; --i) {
    Step st = load_step(steps, i);
    float d[C][S], dsc;
    if (i == n_steps - 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) d[c][s] = __ldg(rootd + c * S + s);
      dsc = 0.f;
    } else {
      const float* col = dslots + (size_t)st.out * CS * T + tid;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) d[c][s] = col[(c * S + s) * T];
      dsc = dscale[st.out * T + tid];
    }
    float u[C][S], ml[C][S], mr[C][S];
    const float sl = load_up<C>(up, usc, st.l, P, p, u);
    apply_p<C>(trans + (size_t)st.l * C * SS, u, ml);
    const float sr = load_up<C>(up, usc, st.r, P, p, u);
    apply_p<C>(trans + (size_t)st.r * C * SS, u, mr);

#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int child = side ? st.r : st.l;
      const int cslot = side ? st.rs : st.ls;
      float o[C][S];
      const float sc = side ? outside<C>(d, ml, dsc, sl, o)
                            : outside<C>(d, mr, dsc, sr, o);
      if (valid) {
        float* dst = out + (size_t)child * CS * P + p_raw;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int s = 0; s < S; ++s) dst[(size_t)(c * S + s) * P] = o[c][s];
        osc[(size_t)child * P + p_raw] = sc;
      }
      if (cslot >= 0) {
        float dd[C][S];
        apply_pt<C>(trans + (size_t)child * C * SS, o, dd);
        store_slot<C>(dslots, dscale, cslot, T, tid, dd, sc);
      }
    }
  }
}

extern "C" int iqt_down_store(const int* steps, int n_steps, const float* trans,
                              const float* rootd, const float* up, const float* usc,
                              int P, float* out, float* osc, int C, int n_slots,
                              int tile, void* stream) {
  const size_t smem = (size_t)n_slots * (C * S + 1) * tile * sizeof(float);
  const dim3 grid((P + tile - 1) / tile);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC)                                                        \
  e = allow_smem(down_store_kernel<CC>, smem);                                \
  if (e == cudaSuccess)                                                       \
    down_store_kernel<CC><<<grid, tile, smem, (cudaStream_t)stream>>>(        \
        steps, n_steps, trans, rootd, up, usc, P, out, osc, n_slots);
  IQT_DISPATCH_C(C, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
