// Ablation variants of the forward kernel: the forward walk of the slot
// schedule, a thread a pattern, with parts of the per-step work taken out, to find where a
// step's time goes.  Each variant writes the root slot's log-scale [P].
//
// Replaces the TPU kernel variants of make_kernel
// (scripts/kernel_ablate.py:42).  Variants (the template argument V):
//   0 full       the forward step: both children loaded and through their
//                edges, product, max renormalization, scale and slot written
//   1 nomatmul   the children's columns multiplied without their edge
//                product (an identity edge)
//   2 norescale  no max, divide or log: the product is stored as it is and
//                the scale is sl + sr (0 for every node: tips have scale 0)
//   3 nostage    no per-step child loads: both children are a fixed column
//                of ones with scale 0 (the edge product, rescale and stores
//                stay); the root's scale is the root step's log(max)
//   4 noscale    no scale reads or writes in shared memory: the root's
//                scale is the root step's log(max), kept in a register
//   5 empty      the loop reads each step row and does nothing else; 0
//   6 highprec3  full, each edge product at the MXU's 3-pass precision
//                (Precision.HIGH): hi*hi + hi*lo + lo*hi
//   7 defprec    full, each edge product at the MXU's 1-pass precision
//                (Precision.DEFAULT): hi*hi
// The precision variants: a pass of the TPU's matrix unit multiplies two
// bf16-rounded operands and accumulates in float32.  Both operands of
// each product are split as hi = bf16_rn(x), lo = bf16_rn(x - hi); a
// product of two bf16 values (8 + 8 significand bits) is exact in
// float32, so the CUDA cores give each pass's products exactly, and the
// passes accumulate in float32 FMAs.
//
// Bound on an H100 (full, 1000 taxa x 9 962 patterns, C=4, S=4): as
// forward.cu, (N-1) x P x (4*C*S*S + 3*C*S) = 3.03 GFLOP (0.045 ms)
// against 160 MB of tips (0.048 ms), bytes by a hair; variants 1-5 do a
// part of that work.  6-7 make 3 or 1 passes of bf16 products (7.6 or
// 2.5 GFLOP at the tensor cores' 989 TFLOP/s) and split each child's
// values a step and each edge matrix once (1.4 GFLOP of float32 with the
// product and rescale): also bytes, 0.048 ms.  The kernel is a measuring tool on the thread-a-pattern step
// that forward.cu had before its lane layout (cs_common.cuh upward_step_rows),
// so every variant runs at the latency of its chain.
// Instanced at C=4 only (the bench shapes).
#include <cuda_bf16.h>

#include "cs_common.cuh"

using namespace iqt;
using namespace iqt::dna;

enum Variant { FULL, NOMATMUL, NORESCALE, NOSTAGE, NOSCALE, EMPTY, HIGHPREC3, DEFPREC };

__device__ __forceinline__ void bf16_split(float x, float& hi, float& lo) {
  hi = __bfloat162float(__float2bfloat16_rn(x));
  lo = __bfloat162float(__float2bfloat16_rn(x - hi));
}

// apply_p at a precision variant's passes: m[c][s] = sum_t of
// hi(P)hi(x) (DEFPREC), + hi(P)lo(x) + lo(P)hi(x) (HIGHPREC3).
template <int C, int V>
__device__ __forceinline__ void apply_p_passes(const float* __restrict__ P,
                                               const float (&x)[C][S], float (&m)[C][S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float xh[S], xl[S];
#pragma unroll
    for (int t = 0; t < S; ++t) bf16_split(x[c][t], xh[t], xl[t]);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 row = __ldg(P4 + c * S + s);
      const float pr[S] = {row.x, row.y, row.z, row.w};
      float acc = 0.f;
#pragma unroll
      for (int t = 0; t < S; ++t) {
        float ph, pl;
        bf16_split(pr[t], ph, pl);
        acc = fmaf(ph, xh[t], acc);
        if constexpr (V == HIGHPREC3) {
          acc = fmaf(ph, xl[t], acc);
          acc = fmaf(pl, xh[t], acc);
        }
      }
      m[c][s] = acc;
    }
  }
}

template <int V>
__global__ void ablate_kernel(const int* __restrict__ steps, int n_steps,
                              const float* __restrict__ trans,
                              const float* __restrict__ tips, int P,
                              float* __restrict__ out, int n_slots) {
  constexpr int C = 4;
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x;
  const int p_raw = blockIdx.x * T + tid;
  const int p = min(p_raw, P - 1);
  float* slots = smem;                                  // [n_slots][C*S][T]
  float* sscale = smem + (size_t)n_slots * C * S * T;   // [n_slots][T]

  float sc = 0.f;
  for (int i = 0; i < n_steps; ++i) {
    Step st = load_step(steps, i);
    if constexpr (V == EMPTY) {
      asm volatile("" ::"r"(st.l), "r"(st.r), "r"(st.ls), "r"(st.rs), "r"(st.out),
                   "r"(st.node));
      continue;
    }
    float xl[C][S], xr[C][S], y[C][S], m[C][S];
    float sl = 0.f, sr = 0.f;
    if constexpr (V == NOSTAGE) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) xl[c][s] = xr[c][s] = 1.f;
    } else {
      sl = load_child<C>(st.l, st.ls, tips, P, p, slots, sscale, T, tid, xl);
      sr = load_child<C>(st.r, st.rs, tips, P, p, slots, sscale, T, tid, xr);
      if constexpr (V == NOSCALE) sl = sr = 0.f;  // the scale loads are dead
    }
    if constexpr (V == NOMATMUL) {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) {
          y[c][s] = xl[c][s];
          m[c][s] = xr[c][s];
        }
    } else if constexpr (V == HIGHPREC3 || V == DEFPREC) {
      apply_p_passes<C, V>(trans + (size_t)st.l * C * SS, xl, y);
      apply_p_passes<C, V>(trans + (size_t)st.r * C * SS, xr, m);
    } else {
      apply_p<C>(trans + (size_t)st.l * C * SS, xl, y);
      apply_p<C>(trans + (size_t)st.r * C * SS, xr, m);
    }
    float mx = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int s = 0; s < S; ++s) {
        y[c][s] *= m[c][s];
        if constexpr (V != NORESCALE) mx = fmaxf(mx, y[c][s]);
      }
    if constexpr (V == NORESCALE) {
      sc = sl + sr;
    } else {
      mx = fmaxf(mx, SCALE_TINY);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int s = 0; s < S; ++s) y[c][s] = y[c][s] / mx;
      sc = sl + sr + logf(mx);
    }
    float* col = slots + (size_t)st.out * C * S * T + tid;
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int s = 0; s < S; ++s) col[(c * S + s) * T] = y[c][s];
    if constexpr (V != NOSCALE) sscale[st.out * T + tid] = sc;
  }
  float res = 0.f;
  if constexpr (V == NOSCALE) res = sc;
  else if constexpr (V != EMPTY)
    res = sscale[load_step(steps, n_steps - 1).out * T + tid];
  if (p_raw < P) out[p_raw] = res;
}

extern "C" int iqt_forward_ablate(int variant, const int* steps, int n_steps,
                                  const float* trans, const float* tips, int P, float* out,
                                  int C, int n_slots, int tile, void* stream) {
  if (C != 4) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n_slots * (C * S + 1) * tile * sizeof(float);
  const dim3 grid((P + tile - 1) / tile);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(VV)                                                        \
  e = allow_smem(ablate_kernel<VV>, smem);                                    \
  if (e == cudaSuccess)                                                       \
    ablate_kernel<VV><<<grid, tile, smem, (cudaStream_t)stream>>>(            \
        steps, n_steps, trans, tips, P, out, n_slots);                        \
  break;
  switch (variant) {
    case FULL: IQT_LAUNCH(FULL)
    case NOMATMUL: IQT_LAUNCH(NOMATMUL)
    case NORESCALE: IQT_LAUNCH(NORESCALE)
    case NOSTAGE: IQT_LAUNCH(NOSTAGE)
    case NOSCALE: IQT_LAUNCH(NOSCALE)
    case EMPTY: IQT_LAUNCH(EMPTY)
    case HIGHPREC3: IQT_LAUNCH(HIGHPREC3)
    case DEFPREC: IQT_LAUNCH(DEFPREC)
    default: return (int)cudaErrorInvalidValue;
  }
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
