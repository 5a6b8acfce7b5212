// Shared pieces of the wide likelihood kernels: the general [C,S,S] layout
// (protein: S = 20 states; 1..8 rate categories; float32).
//
// The CS-packed DNA kernels give one thread a whole pattern column
// (float[C][4] in registers).  At S = 20 a column is 80 floats per child
// and an edge's matrices 1 600 floats, so here a block owns a tile of T
// consecutive patterns with T * C * (S/RPT) threads:
//
//   thread tid:  p  = tid % T         its pattern in the tile
//                g  = tid / T         its row group: category c = g / NG,
//                                     state rows s0 .. s0+RPT-1 with
//                                     s0 = (g % NG) * RPT, NG = S / RPT.
//
// Consecutive threads take consecutive patterns, so every [row][pattern]
// array (the slot pool, the stored partials, the tips) is read and
// written coalesced in device memory and without bank conflicts in
// shared memory.  A child message m[c][s][p] = sum_t P[c][s][t] x[c][t][p]
// costs a thread its category's S-value column x (from shared memory or
// the tips) and RPT x S multiply-adds against P[c], which is staged in
// shared memory (the threads of a warp read the same P entries:
// broadcasts).  The per-pattern max over the C*S rows is a shared-memory
// reduction over the row groups; barriers separate the load, product,
// max and normalize phases of a step.
//
// Each block walks the whole slot schedule for its tile, as a TPU grid
// step walks it (schedule rows: left child, right child, left slot,
// right slot (-1 = tip), output slot, output node; see cs_common.cuh).
// The kernels are templates on S and RPT with one instance, S = 20; a
// new state count (codon, S = 61) adds an instance, not a kernel.
#pragma once

#include "cs_common.cuh"

namespace iqtw {

using iqt::Step;
using iqt::load_step;

// Largest block: 512 threads keeps the register budget at 128 a thread.
constexpr int MAX_THREADS = 512;

template <int S, int RPT>
struct Lane {
  static_assert(S % RPT == 0, "row groups must tile the state axis");
  static constexpr int NG = S / RPT;  // row groups per category
  static constexpr int SS = S * S;
  int T, p, g, c, s0, G, CS;

  __device__ __forceinline__ Lane(int T_, int C) : T(T_) {
    const int tid = threadIdx.x;
    p = tid % T;
    g = tid / T;
    c = g / NG;
    s0 = (g % NG) * RPT;
    G = C * NG;
    CS = C * S;
  }
  __device__ __forceinline__ int row(int j) const { return c * S + s0 + j; }
};

// Copy n floats from device memory to shared memory, the whole block.
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int n) {
  for (int k = threadIdx.x; k < n; k += blockDim.x) dst[k] = __ldg(src + k);
}

// Stage the rows [CS] of one node's stored partial up [2N, CS, P] for the
// tile's patterns into dst [CS][ts] (the tail of a ragged last tile
// repeats pattern P-1).
template <int S, int RPT>
__device__ __forceinline__ void stage_partial(float* dst, int ts,
                                              const float* __restrict__ up, int node,
                                              int P, int pg, const Lane<S, RPT>& L) {
  const float* src = up + (size_t)node * L.CS * P + pg;
  for (int r = L.g; r < L.CS; r += L.G) dst[r * ts + L.p] = __ldg(src + (size_t)r * P);
}

// m[j] = sum_t Pc[s0+j][t] x[t] for this thread's rows; Pc = P[c] [S][S].
template <int S, int RPT>
__device__ __forceinline__ void message(const float* Pc, int s0, const float (&x)[S],
                                        float (&m)[RPT]) {
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const float* row = Pc + (s0 + j) * S;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < S; ++t) acc += row[t] * x[t];
    m[j] = acc;
  }
}

// This thread's category column x[t] = a[(c*S + t) * ts + p] of a
// [CS][ts] shared-memory array.
template <int S, int RPT>
__device__ __forceinline__ void load_column(const float* a, int ts, const Lane<S, RPT>& L,
                                            float (&x)[S]) {
  const float* col = a + L.c * S * ts + L.p;
#pragma unroll
  for (int t = 0; t < S; ++t) x[t] = col[t * ts];
}

// Per-pattern max over the C*S rows, from each row group's partial max:
// one barrier.  The caller passes a barrier before `red` is written again.
template <int S, int RPT>
__device__ __forceinline__ float row_max(float* red, float local, const Lane<S, RPT>& L) {
  red[L.g * L.T + L.p] = local;
  __syncthreads();
  float mx = 0.f;
  for (int k = 0; k < L.G; ++k) mx = fmaxf(mx, red[k * L.T + L.p]);
  return fmaxf(mx, SCALE_TINY);
}

// dd[j] = sum_s Pc[s][s0+j] o[s] (transport through the edge: P^T o), with
// o this thread's category column of a [CS][ts] shared-memory array.
template <int S, int RPT>
__device__ __forceinline__ void transport(const float* Pc, const float* o, int ts,
                                          const Lane<S, RPT>& L, float (&dd)[RPT]) {
  float x[S];
  load_column<S, RPT>(o, ts, L, x);
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    float acc = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) acc += Pc[s * S + L.s0 + j] * x[s];
    dd[j] = acc;
  }
}

// One post-order step of the upward sweeps.  The children's matrices are
// staged in pst [2][C][S][S].  A tip child's column comes from its [S,P]
// indicator rows, an internal child's from the slot pool [n_slots][CS][T].
// Leaves this thread's normalized rows in y, writes them and the scale to
// the output slot, and returns the new log-scale.  Contains one barrier,
// after which every child read of the step is done (the output slot may
// be one the children held).
template <int S, int RPT>
__device__ __forceinline__ float upward_step(const Step& st, const float* pst,
                                             const float* __restrict__ tips, int P, int pg,
                                             float* slots, float* sscale, float* red,
                                             const Lane<S, RPT>& L, float (&y)[RPT]) {
  const int T = L.T;
  float x[S], m[RPT], sc = 0.f;
#pragma unroll
  for (int side = 0; side < 2; ++side) {
    const int node = side ? st.r : st.l, slot = side ? st.rs : st.ls;
    if (slot < 0) {
      const float* t0 = tips + (size_t)node * S * P + pg;
#pragma unroll
      for (int t = 0; t < S; ++t) x[t] = __ldg(t0 + (size_t)t * P);
    } else {
      load_column<S, RPT>(slots + (size_t)slot * L.CS * T, T, L, x);
      sc += sscale[slot * T + L.p];
    }
    const float* Pc = pst + side * L.CS * S + L.c * L.SS;
    if (side)
      message<S, RPT>(Pc, L.s0, x, m);
    else
      message<S, RPT>(Pc, L.s0, x, y);
  }
  float local = 0.f;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    y[j] *= m[j];
    local = fmaxf(local, y[j]);
  }
  const float mx = row_max<S, RPT>(red, local, L);
  float* out = slots + ((size_t)st.out * L.CS + L.row(0)) * T + L.p;
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    y[j] = y[j] / mx;
    out[j * T] = y[j];
  }
  sc += logf(mx);
  if (L.g == 0) sscale[st.out * T + L.p] = sc;
  return sc;
}

// Stage both children's [C,S,S] blocks of an edge-indexed array whose rows
// are `stride` floats apart (trans: C*S*S; the stacked derivatives: 3*C*S*S).
__device__ __forceinline__ void stage_children(float* dst, const float* __restrict__ src,
                                               const Step& st, int stride) {
  stage(dst, src + (size_t)st.l * stride, stride);
  stage(dst + stride, src + (size_t)st.r * stride, stride);
}

}  // namespace iqtw

// Dispatch over the state count (template arguments S, RPT); each wide
// kernel has the protein instance S = 20 (4 row groups of 5 states).
#define IQT_DISPATCH_S(S_RT, CALL)               \
  switch (S_RT) {                                \
    case 20: CALL(20, 5); break;                 \
    default: return (int)cudaErrorInvalidValue;  \
  }
