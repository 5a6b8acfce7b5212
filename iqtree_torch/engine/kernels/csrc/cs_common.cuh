// Shared pieces of the CS-packed likelihood kernels (DNA shapes: S = 4
// states, C <= 8 rate categories, float32).
//
// Work layout common to all four kernels: the pattern axis is the
// parallel axis.  One thread owns one pattern; a block owns a tile of
// `blockDim.x` consecutive patterns and walks the whole slot schedule in
// order (forward) or in reverse (the two reverse sweeps), exactly as one
// TPU grid step walks it for its pattern tile.  Partials of the live
// nodes sit in a shared-memory slot pool laid out [slot][C*S][tile], so
// each thread reads and writes only its own column and the sweep needs
// no barrier; a barrier appears only where a reverse sweep reduces over
// the block's patterns.
//
// Schedule rows (int32 x 6): left child, right child, left slot, right
// slot (-1 = the child is a tip), output slot, output node.  Node ids are
// the device numbering of engine/likelihood.py (tips 0..N-1).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define SCALE_TINY 1e-30f

namespace iqt {

constexpr int S = 4;
constexpr int SS = S * S;

struct Step {
  int l, r, ls, rs, out, node;
};

__device__ __forceinline__ Step load_step(const int* __restrict__ steps, int i) {
  const int* s = steps + 6 * i;
  return Step{__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3), __ldg(s + 4),
              __ldg(s + 5)};
}

// m[c][s] = sum_t P[c][s][t] * x[c][t]; P points at one node's [C,S,S]
// block (16-byte aligned: every block is a multiple of 64 bytes).
template <int C>
__device__ __forceinline__ void apply_p(const float* __restrict__ P,
                                        const float (&x)[C][S], float (&m)[C][S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float4 row = __ldg(P4 + c * S + s);
      m[c][s] = row.x * x[c][0] + row.y * x[c][1] + row.z * x[c][2] + row.w * x[c][3];
    }
  }
}

// dd[c][t] = sum_s P[c][s][t] * o[c][s]  (transport through the edge: P^T o)
template <int C>
__device__ __forceinline__ void apply_pt(const float* __restrict__ P,
                                         const float (&o)[C][S], float (&dd)[C][S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      float4 row = __ldg(P4 + c * S + s);
      a0 += row.x * o[c][s];
      a1 += row.y * o[c][s];
      a2 += row.z * o[c][s];
      a3 += row.w * o[c][s];
    }
    dd[c][0] = a0; dd[c][1] = a1; dd[c][2] = a2; dd[c][3] = a3;
  }
}

// Load one child's partial for this thread's pattern: a tip's S-row
// indicator (the same for every category) from tips [N,S,P], or an
// internal node's packed column from the slot pool.  Returns its scale.
template <int C>
__device__ __forceinline__ float load_child(int node, int slot,
                                            const float* __restrict__ tips, int P, int p,
                                            const float* slots, const float* sscale,
                                            int T, int tid, float (&x)[C][S]) {
  if (slot < 0) {
    float t[S];
#pragma unroll
    for (int s = 0; s < S; ++s) t[s] = __ldg(tips + ((size_t)node * S + s) * P + p);
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int s = 0; s < S; ++s) x[c][s] = t[s];
    return 0.f;
  }
  const float* col = slots + (size_t)slot * C * S * T + tid;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) x[c][s] = col[(c * S + s) * T];
  return sscale[slot * T + tid];
}

// One post-order step for this thread's pattern: both children through
// their edges, elementwise product, per-pattern max renormalization.
// Leaves the normalized partial in y and returns the new log-scale.
// The children's edge matrices are trans rows tl and tr (upward_step:
// the children's own node ids).
template <int C>
__device__ __forceinline__ float upward_step_rows(const Step& st, int tl, int tr,
                                                  const float* __restrict__ trans,
                                                  const float* __restrict__ tips, int P,
                                                  int p, const float* slots,
                                                  const float* sscale, int T, int tid,
                                                  float (&y)[C][S]) {
  float x[C][S], m[C][S];
  float sl = load_child<C>(st.l, st.ls, tips, P, p, slots, sscale, T, tid, x);
  apply_p<C>(trans + (size_t)tl * C * SS, x, y);
  float sr = load_child<C>(st.r, st.rs, tips, P, p, slots, sscale, T, tid, x);
  apply_p<C>(trans + (size_t)tr * C * SS, x, m);
  float mx = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      y[c][s] *= m[c][s];
      mx = fmaxf(mx, y[c][s]);
    }
  mx = fmaxf(mx, SCALE_TINY);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) y[c][s] = y[c][s] / mx;
  return sl + sr + logf(mx);
}

template <int C>
__device__ __forceinline__ float upward_step(const Step& st, const float* __restrict__ trans,
                                             const float* __restrict__ tips, int P, int p,
                                             const float* slots, const float* sscale,
                                             int T, int tid, float (&y)[C][S]) {
  return upward_step_rows<C>(st, st.l, st.r, trans, tips, P, p, slots, sscale, T, tid, y);
}

template <int C>
__device__ __forceinline__ void store_slot(float* slots, float* sscale, int slot, int T,
                                           int tid, const float (&y)[C][S], float sc) {
  float* col = slots + (size_t)slot * C * S * T + tid;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) col[(c * S + s) * T] = y[c][s];
  sscale[slot * T + tid] = sc;
}

// The root of a forward sweep: this thread's pattern log-likelihood from
// the root slot, mixed with rootw = props * pi [C*S], with the invariant
// class `inv` log-added.
template <int C>
__device__ __forceinline__ float root_site_lnl(const float* slots, const float* sscale,
                                              int root_slot, int T, int tid,
                                              const float* __restrict__ rootw, float inv) {
  const float* col = slots + (size_t)root_slot * C * S * T + tid;
  float mix = 0.f;
#pragma unroll
  for (int k = 0; k < C * S; ++k) mix += __ldg(rootw + k) * col[k * T];
  float lnl = logf(fmaxf(mix, SCALE_TINY)) + sscale[root_slot * T + tid];
  if (inv > 0.f) {
    float b = logf(fmaxf(inv, SCALE_TINY));
    float hi = fmaxf(lnl, b), lo = fminf(lnl, b);
    lnl = hi + log1pf(expf(lo - hi));
  }
  return lnl;
}

// Reverse sweeps: this thread's column of a stored node partial
// up [2N, C*S, P] and its scale usc [2N, P].
template <int C>
__device__ __forceinline__ float load_up(const float* __restrict__ up,
                                         const float* __restrict__ usc, int node, int P,
                                         int p, float (&u)[C][S]) {
  const float* base = up + (size_t)node * C * S * P + p;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) u[c][s] = __ldg(base + (size_t)(c * S + s) * P);
  return __ldg(usc + (size_t)node * P + p);
}

// Outside partial of one child edge, normalized per pattern:
// o = d * m_sib / max, with log-scale dsc + s_sib + log(max).
template <int C>
__device__ __forceinline__ float outside(const float (&d)[C][S], const float (&m_sib)[C][S],
                                         float dsc, float s_sib, float (&o)[C][S]) {
  float mx = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) {
      o[c][s] = d[c][s] * m_sib[c][s];
      mx = fmaxf(mx, o[c][s]);
    }
  mx = fmaxf(mx, SCALE_TINY);
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int s = 0; s < S; ++s) o[c][s] = o[c][s] / mx;
  return dsc + s_sib + logf(mx);
}

// ---------------------------------------------------------------------------
// Lane layout: several threads a pattern, one a rate category.
//
// P, P' and P'' are block-diagonal over categories, so a category's
// messages (apply_p, apply_pt, outside) need only its own S states; what
// crosses categories (the renormalizing max, the sums over c) is a
// butterfly of __shfl_xor_sync rounds inside a group of CL = C rounded up
// to a power of two lanes.  Lane (pattern q, category c) of a block is
// thread q * CL + c: a warp holds 32 / CL patterns, and a load of one
// packed row of up [2N, C*S, P] reads CL runs of 32 / CL consecutive
// floats, whole 32-byte sectors at CL <= 8.  A lane past C (C = 3, 5-7)
// computes a copy of category C-1: harmless to the max, and it adds 0
// to the sums.  Butterfly rounds leave every lane of a group the same
// bits (each round adds or maxes a pair in both orders, which float
// addition and fmaxf give alike).
// ---------------------------------------------------------------------------

template <int C>
struct Lanes {
  static constexpr int CL = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
};

// m[s] = sum_t P[s][t] x[t] for one category's [S,S] block staged in
// shared memory (16-byte aligned rows).
__device__ __forceinline__ void apply_p1(const float* P, const float (&x)[S], float (&m)[S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float4 row = P4[s];
    m[s] = row.x * x[0] + row.y * x[1] + row.z * x[2] + row.w * x[3];
  }
}

// dd[t] = sum_s P[s][t] o[s] for one category's staged [S,S] block.
__device__ __forceinline__ void apply_pt1(const float* P, const float (&o)[S],
                                          float (&dd)[S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float4 row = P4[s];
    a0 += row.x * o[s];
    a1 += row.y * o[s];
    a2 += row.z * o[s];
    a3 += row.w * o[s];
  }
  dd[0] = a0; dd[1] = a1; dd[2] = a2; dd[3] = a3;
}

// Second, deterministic pass of a reverse sweep: out[i] = sum over blocks
// of part[b][i] (per-block partial sums; the blocks of the sweep run in
// no order, so they cannot accumulate into one buffer in sequence).  With
// `add` the sum goes onto out[i]: a sweep run in chunks of blocks adds
// each chunk onto the earlier ones, still in block order.
__global__ void reduce_blocks(const float* __restrict__ part, float* __restrict__ out,
                              int n_blocks, int n, int add) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float acc = add ? out[i] : 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += part[(size_t)b * n + i];
  out[i] = acc;
}

inline cudaError_t launch_reduce(const float* part, float* out, int n_blocks, int n,
                                 int add, cudaStream_t stream) {
  reduce_blocks<<<(n + 255) / 256, 256, 0, stream>>>(part, out, n_blocks, n, add);
  return cudaGetLastError();
}

// Dynamic shared memory above the 48 KB default needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace iqt

// C dispatch over the category count (template argument) for 1..8.
#define IQT_DISPATCH_C(C_RT, CALL) \
  switch (C_RT) {                  \
    case 1: CALL(1); break;        \
    case 2: CALL(2); break;        \
    case 3: CALL(3); break;        \
    case 4: CALL(4); break;        \
    case 5: CALL(5); break;        \
    case 6: CALL(6); break;        \
    case 7: CALL(7); break;        \
    case 8: CALL(8); break;        \
    default: return (int)cudaErrorInvalidValue; \
  }

extern "C" const char* iqt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
