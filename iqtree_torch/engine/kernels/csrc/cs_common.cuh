// Shared pieces of the CS-packed likelihood kernels (S = 2 binary and
// S = 4 DNA states, C <= 8 rate categories, float32).
//
// Two work layouts, both with the pattern axis as the parallel axis and a
// block walking the whole slot schedule in order (forward) or in reverse
// (the reverse sweeps), as one TPU grid step walks it for its pattern tile:
//
// * a thread a pattern (stream_forward.cu, forward_ablate.cu; DNA only,
//   namespace iqt::dna): a block owns a tile of `blockDim.x` consecutive
//   patterns; the partials of the live nodes sit in a shared-memory slot
//   pool laid out [slot][C*S][tile], so each thread reads and writes only
//   its own column and the sweep needs no barrier;
// * a lane a (pattern, rate category) (forward.cu, store.cu, newton.cu,
//   down_store.cu, tbar.cu): the second half of this header, a template
//   over the state count S (2 or 4) beside the category count C.
//
// Schedule rows (int32 x 6): left child, right child, left slot, right
// slot (-1 = the child is a tip), output slot, output node.  Node ids are
// the device numbering of engine/likelihood.py (tips 0..N-1).
#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math.h>

#define SCALE_TINY 1e-30f

namespace iqt {

struct Step {
  int l, r, ls, rs, out, node;
};

__device__ __forceinline__ Step load_step(const int* __restrict__ steps, int i) {
  const int* s = steps + 6 * i;
  return Step{__ldg(s), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3), __ldg(s + 4),
              __ldg(s + 5)};
}

// The thread-a-pattern layout, DNA's states only.
namespace dna {

constexpr int S = 4;
constexpr int SS = S * S;

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
// The children's edge matrices are trans rows tl and tr.
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

}  // namespace dna

// x / y for a float x and a normal y > 0, with the bits of the IEEE float
// division but without its branches (the float division's check and slow
// path, which a dividend or quotient near the bottom of the float range
// takes: a slow rate category's partials far below their pattern's max).
// In double: the hardware's approximate reciprocal (~2^-22) refined by two
// Newton steps, the product, and one residual correction give the
// quotient to well under half a double ulp, and one rounding to float then
// gives the correctly rounded float quotient, subnormal results included
// (a quotient of two floats is a float midpoint exactly or lies > 2^-49
// relative from one).
__device__ __forceinline__ float div_rn(float x, float y) {
  const double xd = x, yd = y;
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(yd));
  r = fma(r, fma(-yd, r, 1.0), r);
  r = fma(r, fma(-yd, r, 1.0), r);
  const double q = xd * r;
  return (float)fma(fma(-yd, q, xd), r, q);
}

// ---------------------------------------------------------------------------
// Lane layout: several threads a pattern, one a rate category.
//
// P, P' and P'' are block-diagonal over categories, so a category's
// messages (apply_p1, apply_pt1, the outside partial) need only its own S
// states; what crosses categories (the renormalizing max, the sums over c)
// is a butterfly of __shfl_xor_sync rounds inside a group of CL = C
// rounded up to a power of two lanes.  Lane (pattern q, category c) of a block is
// thread q * CL + c: a warp holds 32 / CL patterns, and a load of one
// packed row of up [2N, C*S, P] reads CL runs of 32 / CL consecutive
// floats: whole 32-byte sectors at CL <= 4, 16-byte halves at CL = 8.
// A lane past C (C = 3, 5-7) computes a copy of category C-1: harmless to
// the max, and it adds 0 to the sums.  Butterfly rounds leave every lane
// of a group the same bits (each round adds or maxes a pair in both
// orders, which float addition and fmaxf give alike).
//
// Everything below is a template over the state count S (PACKED_STATES of
// build.py: 2, binary; 4, DNA, and S = 3 zero-padded to it by the
// wrappers).  S = 4 compiles to the arithmetic of the earlier S = 4-only
// code in the same order.
// ---------------------------------------------------------------------------

template <int C>
struct Lanes {
  static constexpr int CL = C <= 1 ? 1 : C <= 2 ? 2 : C <= 4 ? 4 : 8;
};

// A category's [S,S] block as the walks stage it in shared memory: SS
// words and ROWS 16-byte copies (a row at S = 4, the whole block at S = 2;
// ROW_SHIFT = log2 ROWS), at a stride of SSP words.  At S = 4 the 4 words
// of padding put the float4 rows that the categories of a warp read at
// once in distinct banks; at S = 2 a block is one float4 and the CL <= 8
// consecutive blocks of a warp's categories already cover distinct
// 16-byte bank groups, so none is added.
template <int S>
struct Block {
  static_assert(S == 2 || S == 4, "the CS-packed kernels have S = 2 and S = 4 instances");
  static constexpr int SS = S * S;
  static constexpr int ROWS = SS / 4;
  static constexpr int ROW_SHIFT = S == 2 ? 0 : 2;
  static constexpr int SSP = S == 2 ? SS : SS + 4;
};

// m[s] = sum_t P[s][t] x[t] for one category's [S,S] block staged in
// shared memory (16-byte aligned).
template <int S>
__device__ __forceinline__ void apply_p1(const float* P, const float (&x)[S], float (&m)[S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
  if constexpr (S == 4) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float4 row = P4[s];
      m[s] = row.x * x[0] + row.y * x[1] + row.z * x[2] + row.w * x[3];
    }
  } else {  // the block's rows are (x, y) and (z, w)
    const float4 b = P4[0];
    m[0] = b.x * x[0] + b.y * x[1];
    m[1] = b.z * x[0] + b.w * x[1];
  }
}

// dd[t] = sum_s P[s][t] o[s] for one category's staged [S,S] block.
template <int S>
__device__ __forceinline__ void apply_pt1(const float* P, const float (&o)[S],
                                          float (&dd)[S]) {
  const float4* P4 = reinterpret_cast<const float4*>(P);
  if constexpr (S == 4) {
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
  } else {
    const float4 b = P4[0];
    float a0 = 0.f, a1 = 0.f;
    a0 += b.x * o[0];
    a1 += b.y * o[0];
    a0 += b.z * o[1];
    a1 += b.w * o[1];
    dd[0] = a0; dd[1] = a1;
  }
}

// Shuffle rounds over the categories of a group, over the K values of v at
// once so that their latencies overlap.
template <int CL, int K>
__device__ __forceinline__ void group_sums(float (&v)[K]) {
#pragma unroll
  for (int off = 1; off < CL; off <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k) v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
}

// The largest v over the categories of a group (every lane gets it).
template <int CL>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 1; off < CL; off <<= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// ---------------------------------------------------------------------------
// The upward sweep on the lane layout (forward.cu, store.cu).
//
// Lane (pattern q, category c) is thread q * CL + c and holds its
// category's S states of a partial.  The live partials sit in a
// shared-memory pool [slot][S+1][lanes]: a lane's column holds its
// category's S rows and the pattern's log-scale, which every lane of a
// group holds with the same bits, so the walk needs no block barrier.  A
// slot child is already in the pool; a step's other inputs -- a tip
// child's S words for the lane's pattern (tips [N,S,P]) into the lane's
// column of a stage, and both children's [C,S,S] edge blocks (16-byte
// copies shared out over the warp's lanes) into the warp's stage, SSP words a
// category -- are cp.async copies issued UP_STAGES - 1 steps ahead.  A
// step waits for its own group and a __syncwarp, never for the block; the
// schedule rows are read a step ahead of the copies that need them.
//
// The step is the thread-a-pattern step's arithmetic for one category:
// the same products in the same order (apply_p1 is apply_p's row), the
// max over a group (exact in any order), the same division and log.  So
// a category's partial and scale carry the bits of upward_step_rows'.
// ---------------------------------------------------------------------------

// Steps whose inputs are in flight at once (a cp.async ring).
constexpr int UP_STAGES = 2;

// A lane's words in one stage (the two children's tip rows), and a warp's
// (both children's [C] blocks).
template <int C, int S>
struct UpStage {
  static constexpr int LANE_WORDS = 2 * S;
  static constexpr int CSSP = C * Block<S>::SSP;
  static constexpr int WORDS = 2 * CSSP;
};

// Shared memory of an upward launch: the pool and the lanes' stages, then
// the warps' stages (16-byte aligned: lanes % 32 == 0).
template <int C, int S>
inline size_t upward_smem(int n_slots, int lanes) {
  return (((size_t)n_slots * (S + 1) + UP_STAGES * UpStage<C, S>::LANE_WORDS) * lanes +
          (size_t)(lanes / 32) * UP_STAGES * UpStage<C, S>::WORDS) *
         sizeof(float);
}

// Step j's inputs into stage k: the warp's share of both edge blocks,
// and this lane's tip words of a tip child.
template <int C, int S>
__device__ __forceinline__ void fetch_upward(const Step& sj, float* stage_k, float* warp_k,
                                             int T, int lane,
                                             const float* __restrict__ trans,
                                             const float* __restrict__ tips, int P, int p) {
  constexpr int SS = Block<S>::SS, SSP = Block<S>::SSP, R = Block<S>::ROWS;
  constexpr int CSSP = UpStage<C, S>::CSSP;
  // 16-byte copies: (child, category, copy), 2 C R of them
  for (int q = lane; q < 2 * C * R; q += 32) {
    const int child = q / (C * R), rem = q - child * C * R;
    const int node = child ? sj.r : sj.l;
    __pipeline_memcpy_async(warp_k + child * CSSP + (rem / R) * SSP + (rem % R) * 4,
                            trans + (size_t)node * C * SS + rem * 4, 16);
  }
  if (sj.ls < 0)
#pragma unroll
    for (int s = 0; s < S; ++s)
      __pipeline_memcpy_async(stage_k + s * T, tips + ((size_t)sj.l * S + s) * P + p, 4);
  if (sj.rs < 0)
#pragma unroll
    for (int s = 0; s < S; ++s)
      __pipeline_memcpy_async(stage_k + (S + s) * T, tips + ((size_t)sj.r * S + s) * P + p,
                              4);
}

// The whole upward walk for this lane's (pattern p, category c); after
// each step emit(step, y, scale) sees the normalized partial and its
// log-scale.  Leaves the root's in y and sc.  All lanes of a warp run it
// (a ragged tail computes a copy of pattern P - 1).
template <int C, int S, typename Emit>
__device__ __forceinline__ void upward_lanes(const int* __restrict__ steps, int n_steps,
                                             const float* __restrict__ trans,
                                             const float* __restrict__ tips, int P, int p,
                                             float* smem, int n_slots, Emit emit,
                                             float (&y)[S], float& sc) {
  constexpr int CL = Lanes<C>::CL, SSP = Block<S>::SSP;
  constexpr int CSSP = UpStage<C, S>::CSSP, WS = UpStage<C, S>::WORDS;
  constexpr int UP_STAGE_WORDS = UpStage<C, S>::LANE_WORDS;
  const int T = blockDim.x, tid = threadIdx.x, lane = tid & 31;
  const int c = min(tid & (CL - 1), C - 1);
  float* col = smem + tid;  // this lane's column of the pool [slot][S+1][T]
  float* stage = col + (size_t)n_slots * (S + 1) * T;  // [UP_STAGES][UP_STAGE_WORDS][T]
  float* wstage = smem + ((size_t)n_slots * (S + 1) + UP_STAGES * UP_STAGE_WORDS) * T +
                  (size_t)(tid >> 5) * UP_STAGES * WS;  // [warp][UP_STAGES][WS]

#pragma unroll
  for (int k = 0; k < UP_STAGES - 1; ++k) {
    if (k < n_steps)
      fetch_upward<C, S>(load_step(steps, k), stage + k * UP_STAGE_WORDS * T,
                         wstage + k * WS, T, lane, trans, tips, P, p);
    __pipeline_commit();
  }
  int j = UP_STAGES - 1;  // the next step to fetch
  Step st_j = j < n_steps ? load_step(steps, j) : Step{};
  Step st = load_step(steps, 0);
  int k = 0;  // the stage of step i
  for (int i = 0; i < n_steps; ++i) {
    const int k_free = k == 0 ? UP_STAGES - 1 : k - 1;  // held step i - 1
    __syncwarp();  // every lane has read the warp's stage of step i - 1
    if (j < n_steps)
      fetch_upward<C, S>(st_j, stage + k_free * UP_STAGE_WORDS * T, wstage + k_free * WS, T,
                         lane, trans, tips, P, p);
    __pipeline_commit();
    if (++j < n_steps) st_j = load_step(steps, j);
    const Step st_next = i + 1 < n_steps ? load_step(steps, i + 1) : st;
    __pipeline_wait_prior(UP_STAGES - 1);  // this lane's copies of step i have landed
    __syncwarp();                          // and so have the other lanes'

    const float* sk = stage + k * UP_STAGE_WORDS * T;
    float xl[S], xr[S], sl = 0.f, sr = 0.f;
    if (st.ls < 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) xl[s] = sk[s * T];
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) xl[s] = col[(st.ls * (S + 1) + s) * T];
      sl = col[(st.ls * (S + 1) + S) * T];
    }
    if (st.rs < 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) xr[s] = sk[(S + s) * T];
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) xr[s] = col[(st.rs * (S + 1) + s) * T];
      sr = col[(st.rs * (S + 1) + S) * T];
    }
    const float* Ml = wstage + k * WS + c * SSP;  // this category's block of the left edge
    float mr[S];
    apply_p1<S>(Ml, xl, y);
    apply_p1<S>(Ml + CSSP, xr, mr);
    float mx = 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      y[s] *= mr[s];
      mx = fmaxf(mx, y[s]);
    }
    mx = fmaxf(group_max<CL>(mx), SCALE_TINY);
#pragma unroll
    for (int s = 0; s < S; ++s) y[s] = y[s] / mx;
    sc = sl + sr + logf(mx);
#pragma unroll
    for (int s = 0; s < S; ++s) col[(st.out * (S + 1) + s) * T] = y[s];
    col[(st.out * (S + 1) + S) * T] = sc;
    emit(st, y, sc);
    st = st_next;
    k = k == UP_STAGES - 1 ? 0 : k + 1;
  }
}

// The root of a forward sweep on the lane layout: the pattern's
// log-likelihood, mixed with rootw = props * pi [C*S] in root_site_lnl's
// order from the root slot's columns of the group (lanes g0 .. g0 + C - 1),
// the invariant class `inv` log-added.  Every lane of the group returns it.
template <int C, int S>
__device__ __forceinline__ float lane_root_lnl(const float* smem, int root_slot, int T,
                                               int g0, const float* __restrict__ rootw,
                                               float sc, float inv) {
  __syncwarp();  // the group's root columns are written
  const float* cols = smem + (size_t)root_slot * (S + 1) * T + g0;
  float mix = 0.f;
#pragma unroll
  for (int k = 0; k < C * S; ++k) mix += __ldg(rootw + k) * cols[(k % S) * T + k / S];
  float lnl = logf(fmaxf(mix, SCALE_TINY)) + sc;
  if (inv > 0.f) {
    float b = logf(fmaxf(inv, SCALE_TINY));
    float hi = fmaxf(lnl, b), lo = fminf(lnl, b);
    lnl = hi + log1pf(expf(lo - hi));
  }
  return lnl;
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

// C dispatch over the category count for 1..8 at the state count SV
// (template arguments CALL(C, SV)).
#define IQT_DISPATCH_C_AT(C_RT, SV, CALL) \
  switch (C_RT) {                         \
    case 1: CALL(1, SV); break;           \
    case 2: CALL(2, SV); break;           \
    case 3: CALL(3, SV); break;           \
    case 4: CALL(4, SV); break;           \
    case 5: CALL(5, SV); break;           \
    case 6: CALL(6, SV); break;           \
    case 7: CALL(7, SV); break;           \
    case 8: CALL(8, SV); break;           \
    default: return (int)cudaErrorInvalidValue; \
  }

// The lane layout's dispatch over the state count (2 or 4) and the
// category count (1..8).
#define IQT_DISPATCH_CS(C_RT, S_RT, CALL)          \
  switch (S_RT) {                                  \
    case 2: IQT_DISPATCH_C_AT(C_RT, 2, CALL) break; \
    case 4: IQT_DISPATCH_C_AT(C_RT, 4, CALL) break; \
    default: return (int)cudaErrorInvalidValue;    \
  }

extern "C" const char* iqt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
