// Gradient sweep: the cotangent of every edge's transition matrices.
//
// Replaces the TPU kernel _kernel_tbar_cs
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Reverse walk of the slot
// schedule: each step forms its two child edges' outside partials O from
// the parent's outside vector D (root seed props * pi) and the sibling's
// message, accumulates
//     tbar[e][c][s][t] += sum_p O[c,s,p] * fac[p] * U_e[c,t,p],
//     fac = exp(min(osc + usc - lnl, 80)) * w_p,
// and pushes D_child = P^T O down the tree.  Children's inside partials
// come from the upward store's up buffer (tip rows filled by the caller).
//
// The TPU grid runs its pattern tiles in order and accumulates into one
// output; blocks here run in no order, so each block writes its own
// partial sums part[block][edge][C][S][S] (only the C diagonal [S,S]
// blocks -- the rest of the TPU's packed [CS,CS] cotangent is never used)
// and a second deterministic pass sums the blocks.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): reads the stored
// partials once, 2N x 17 rows x 10k x 4 B = 1.36 GB (3.35 TB/s: 0.4 ms);
// the work is 2 x 64 (messages) + 64 (cotangent) + 64 (push) FMA per edge
// and pattern, about 10 GFLOP (67 TFLOP/s: 0.15 ms): byte-bound.  The
// per-step block reduction through shared memory costs two barriers per
// edge; this first version runs at latency, not at either bound.
#include "cs_common.cuh"

using namespace iqt;

template <int C>
__global__ void tbar_kernel(const int* __restrict__ steps, int n_steps,
                            const float* __restrict__ trans,
                            const float* __restrict__ rootd,
                            const float* __restrict__ lnl,
                            const float* __restrict__ wp,
                            const float* __restrict__ up,
                            const float* __restrict__ usc, int P, int n_nodes,
                            float* __restrict__ part, int n_slots) {
  extern __shared__ float smem[];
  constexpr int CS = C * S;
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * T + tid;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);
  const int TS = T + 1;  // padded stride: conflict-free column reads below
  float* dslots = smem;                                // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;   // [n_slots][T]
  float* stage_o = dscale + (size_t)n_slots * T;       // [CS][T+1]
  float* stage_u = stage_o + (size_t)CS * TS;          // [CS][T+1]
  const float lnl_p = __ldg(lnl + p);
  const float w_p = valid ? __ldg(wp + p) : 0.f;
  float* part_b = part + (size_t)blockIdx.x * n_nodes * C * SS;

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
    float ul[C][S], ur[C][S], ml[C][S], mr[C][S];
    const float sl = load_up<C>(up, usc, st.l, P, p, ul);
    const float sr = load_up<C>(up, usc, st.r, P, p, ur);
    apply_p<C>(trans + (size_t)st.l * C * SS, ul, ml);
    apply_p<C>(trans + (size_t)st.r * C * SS, ur, mr);

#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int child = side ? st.r : st.l;
      const int cslot = side ? st.rs : st.ls;
      const float s_child = side ? sr : sl;
      float o[C][S];
      const float osc = side ? outside<C>(d, ml, dsc, sl, o)
                             : outside<C>(d, mr, dsc, sr, o);
      const float fac = valid ? expf(fminf(osc + s_child - lnl_p, 80.f)) * w_p : 0.f;
      __syncthreads();  // the previous edge's reduction is done with the stage
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          stage_o[(c * S + s) * TS + tid] = o[c][s] * fac;
          stage_u[(c * S + s) * TS + tid] = side ? ur[c][s] : ul[c][s];
        }
      __syncthreads();
      for (int k = tid; k < C * SS; k += T) {
        const int c = k / SS, s = (k / S) % S, t = k % S;
        const float* a = stage_o + (c * S + s) * TS;
        const float* b = stage_u + (c * S + t) * TS;
        float acc = 0.f;
        for (int j = 0; j < T; ++j) acc += a[j] * b[j];
        part_b[(size_t)child * C * SS + k] = acc;
      }
      if (cslot >= 0) {
        float dd[C][S];
        apply_pt<C>(trans + (size_t)child * C * SS, o, dd);
        store_slot<C>(dslots, dscale, cslot, T, tid, dd, osc);
      }
    }
  }
}

extern "C" int iqt_tbar(const int* steps, int n_steps, const float* trans,
                        const float* rootd, const float* lnl, const float* wp,
                        const float* up, const float* usc, int P, int n_nodes,
                        float* part, float* tbar, int C, int n_slots, int tile,
                        void* stream) {
  const int CS = C * S;
  const size_t smem =
      ((size_t)n_slots * (CS + 1) * tile + 2 * (size_t)CS * (tile + 1)) * sizeof(float);
  const int n_blocks = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC)                                                        \
  e = allow_smem(tbar_kernel<CC>, smem);                                      \
  if (e == cudaSuccess)                                                       \
    tbar_kernel<CC><<<n_blocks, tile, smem, (cudaStream_t)stream>>>(          \
        steps, n_steps, trans, rootd, lnl, wp, up, usc, P, n_nodes, part,     \
        n_slots);
  IQT_DISPATCH_C(C, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(part, tbar, n_blocks, n_nodes * C * SS, 0,
                            (cudaStream_t)stream);
}
