// Branch-Newton sweep: first and second derivatives of lnL with respect
// to every branch length at once.
//
// Replaces the TPU kernel _kernel_newton_cs / _newton_body
// (iqtree_tpu/engine/kernels/cs_kernels.py).  Reverse walk of the slot
// schedule: for each child edge e it forms the outside partial O_e and,
// with f_k = sum_cs O_e * (P_e^(k) U_e) for P, P', P'' of the edge,
//     d1[e] = sum_p w_p f1/den,   d2[e] = sum_p w_p (f2/den - (f1/den)^2),
// where den = f0 + the invariant-site term in the scaled frame.  Nothing
// but the per-block sums leaves the chip: no theta or outside buffer.
//
// The TPU kernel accumulated across its in-order grid; here each block
// writes part[block][edge][2] and a second deterministic pass sums them.
//
// Bound on an H100 (DNA+G4, 1000 taxa x 10k patterns): reads the stored
// partials once, 1.36 GB (3.35 TB/s: 0.4 ms); the work is
// 2 x 3 x 64 + 64 FMA per edge and pattern, about 11 GFLOP (67 TFLOP/s:
// 0.17 ms): byte-bound.  The derivative messages are folded into the f_k
// sums instead of being materialized, which keeps the per-thread state to
// a few dozen registers.
#include "cs_common.cuh"

using namespace iqt;

template <int C>
__device__ __forceinline__ float dot_msg(const float* __restrict__ M, const float (&u)[C][S],
                                         const float (&o)[C][S]) {
  // sum_{c,s} o[c][s] * (M u)[c][s]
  float m[C][S];
  apply_p<C>(M, u, m);
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) acc += o[c][s] * m[c][s];
  return acc;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int C>
__global__ void newton_kernel(const int* __restrict__ steps, int n_steps,
                              const float* __restrict__ mats,  // [2N][3][C][S][S]
                              const float* __restrict__ rootd,
                              const float* __restrict__ wp,
                              const float* __restrict__ invar,
                              const float* __restrict__ up,
                              const float* __restrict__ usc, int P, int n_nodes,
                              float* __restrict__ part, int n_slots) {
  extern __shared__ float smem[];
  constexpr int CS = C * S;
  constexpr size_t MAT = (size_t)C * SS;  // one [C,S,S] matrix
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * T + tid;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);
  const int n_warps = T / 32, warp = tid / 32, lane = tid % 32;
  float* dslots = smem;                                // [n_slots][CS][T]
  float* dscale = dslots + (size_t)n_slots * CS * T;   // [n_slots][T]
  float* red = dscale + (size_t)n_slots * T;           // [n_warps][2]
  const float w_p = valid ? __ldg(wp + p) : 0.f;
  const float inv_p = __ldg(invar + p);
  float* part_b = part + (size_t)blockIdx.x * n_nodes * 2;

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
    const float* Ml = mats + (size_t)st.l * 3 * MAT;
    const float* Mr = mats + (size_t)st.r * 3 * MAT;
    apply_p<C>(Ml, ul, ml);
    apply_p<C>(Mr, ur, mr);

#pragma unroll
    for (int side = 0; side < 2; ++side) {
      const int child = side ? st.r : st.l;
      const int cslot = side ? st.rs : st.ls;
      const float s_child = side ? sr : sl;
      const float* M = side ? Mr : Ml;
      float o[C][S];
      const float osc = side ? outside<C>(d, ml, dsc, sl, o)
                             : outside<C>(d, mr, dsc, sr, o);
      float f0 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) f0 += o[c][s] * (side ? mr[c][s] : ml[c][s]);
      f0 = fmaxf(f0, SCALE_TINY);
      const float f1 = side ? dot_msg<C>(M + MAT, ur, o) : dot_msg<C>(M + MAT, ul, o);
      const float f2 =
          side ? dot_msg<C>(M + 2 * MAT, ur, o) : dot_msg<C>(M + 2 * MAT, ul, o);
      const float inv_t = inv_p > 0.f ? inv_p * expf(fminf(-(osc + s_child), 80.f)) : 0.f;
      const float den = f0 + inv_t;
      const float r1 = f1 / den, r2 = f2 / den;
      float v1 = w_p * r1, v2 = w_p * (r2 - r1 * r1);
      v1 = warp_sum(v1);
      v2 = warp_sum(v2);
      __syncthreads();  // the previous edge's sums are read
      if (lane == 0) {
        red[2 * warp] = v1;
        red[2 * warp + 1] = v2;
      }
      __syncthreads();
      if (tid == 0) {
        float a1 = 0.f, a2 = 0.f;
        for (int w = 0; w < n_warps; ++w) {
          a1 += red[2 * w];
          a2 += red[2 * w + 1];
        }
        part_b[2 * child] = a1;
        part_b[2 * child + 1] = a2;
      }
      if (cslot >= 0) {
        float dd[C][S];
        apply_pt<C>(M, o, dd);
        store_slot<C>(dslots, dscale, cslot, T, tid, dd, osc);
      }
    }
  }
}

extern "C" int iqt_newton(const int* steps, int n_steps, const float* mats,
                          const float* rootd, const float* wp, const float* invar,
                          const float* up, const float* usc, int P, int n_nodes,
                          float* part, float* d12, int C, int n_slots, int tile,
                          void* stream) {
  if (tile % 32) return (int)cudaErrorInvalidValue;
  const int CS = C * S;
  const size_t smem =
      ((size_t)n_slots * (CS + 1) * tile + 2 * (size_t)(tile / 32)) * sizeof(float);
  const int n_blocks = (P + tile - 1) / tile;
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC)                                                        \
  e = allow_smem(newton_kernel<CC>, smem);                                    \
  if (e == cudaSuccess)                                                       \
    newton_kernel<CC><<<n_blocks, tile, smem, (cudaStream_t)stream>>>(        \
        steps, n_steps, mats, rootd, wp, invar, up, usc, P, n_nodes, part,    \
        n_slots);
  IQT_DISPATCH_C(C, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)launch_reduce(part, d12, n_blocks, n_nodes * 2, 0, (cudaStream_t)stream);
}
