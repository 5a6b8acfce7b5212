// Multi-tree forward kernel: per-pattern log-likelihoods of K trees that
// share one alignment, in one launch.
//
// Replaces the TPU kernel _kernel_cs_stream
// (iqtree_tpu/engine/kernels/pruning.py:246).  That kernel streamed the
// group matrices and the tip tiles from HBM with double-buffered DMA so
// that VMEM could hold an 8x larger pattern tile; the kernels here read
// trans and tips from global memory through the read-only path anyway
// (cs_common.cuh load_child, apply_p), so what carries over is the K-tree
// batch.
//
// Schedule (pruning.py multi_tree_schedule): the K trees' rows interleaved
// one at a time, row j of tree k at j*K+k, each tree's slots offset into
// one global slot space.  Block (tile, k) walks only tree k's rows and
// rebases their slots by tree k's first slot: the first row of a
// Sethi-Ullman schedule joins two tips into the tree's slot 0.  The
// shared-memory pool is then one tree's (`pool` slots, 11 at most at 1000
// taxa) and not all K trees' (89 slots at K=8, which would leave room for
// 32 patterns a block and one block an SM).  A child's edge matrix is the
// trans row of the gather schedule (tree k's rows at k*2N+id of the
// concatenated trans), a tip's partial the row of the kernel schedule (raw
// tip ids: the tips are shared).  Numerics are forward.cu's:
// upward_step_rows and store_slot of cs_common.cuh (whose bits forward.cu's
// lane layout keeps), the 1e-30 floor, max renormalization, IEEE float32.
//
// Bound on an H100 at K=8, 1000 taxa x 9 962 patterns, C=4, S=4: per tree
// (N-1) x P x (4*C*S*S + 3*C*S) = 3.03 GFLOP, 24.2 GFLOP for K=8 (67
// TFLOP/s: 0.36 ms), against 160 MB of tips read once, 4 MB of trans and
// 0.6 MB of invariant classes and outputs (3.35 TB/s: 0.049 ms):
// operations bound it.  A thread still owns one pattern of one tree and
// its 999-step chain runs at instruction latency, as in forward.cu; what
// the K-tree grid adds is K times the blocks (K x 156 of 64 threads at
// 9 962 patterns), so more warps an SM to hide that latency.
#include "cs_common.cuh"

using namespace iqt;
using namespace iqt::dna;

template <int C>
__global__ void stream_forward_kernel(const int* __restrict__ steps,
                                      const int* __restrict__ gather, int n_rows, int K,
                                      const int* __restrict__ roots,
                                      const float* __restrict__ trans,
                                      const float* __restrict__ tips, int P,
                                      const float* __restrict__ rootw,
                                      const float* __restrict__ invar,
                                      float* __restrict__ out, int pool) {
  extern __shared__ float smem[];
  const int T = blockDim.x, tid = threadIdx.x, k = blockIdx.y;
  const int p_raw = blockIdx.x * T + tid;
  const int p = min(p_raw, P - 1);  // ragged tail computes a copy, writes nothing
  float* slots = smem;                               // [pool][C*S][T]
  float* sscale = smem + (size_t)pool * C * S * T;   // [pool][T]
  const int base = __ldg(steps + 6 * k + 4);         // tree k's slot 0

  float y[C][S];
  for (int j = 0; j < n_rows; ++j) {
    const int i = j * K + k;
    Step st = load_step(steps, i);
    if (st.ls >= 0) st.ls -= base;
    if (st.rs >= 0) st.rs -= base;
    const int tl = __ldg(gather + 6 * i), tr = __ldg(gather + 6 * i + 1);
    float sc = upward_step_rows<C>(st, tl, tr, trans, tips, P, p, slots, sscale, T, tid, y);
    store_slot<C>(slots, sscale, st.out - base, T, tid, y, sc);
  }
  const size_t kp = (size_t)k * P;
  float lnl = root_site_lnl<C>(slots, sscale, __ldg(roots + k) - base, T, tid, rootw,
                               __ldg(invar + kp + p));
  if (p_raw < P) out[kp + p_raw] = lnl;
}

// steps/gather [n_rows*K, 6], roots [K] (global root slots), invar and out
// [K, P]; pool = the most slots one tree's rows use.
extern "C" int iqt_stream_forward(const int* steps, const int* gather, int n_rows, int K,
                                  const int* roots, const float* trans, const float* tips,
                                  int P, const float* rootw, const float* invar, float* out,
                                  int C, int pool, int tile, void* stream) {
  const size_t smem = (size_t)pool * (C * S + 1) * tile * sizeof(float);
  const dim3 grid((P + tile - 1) / tile, K);
  cudaError_t e = cudaSuccess;
#define IQT_LAUNCH(CC)                                                        \
  e = allow_smem(stream_forward_kernel<CC>, smem);                            \
  if (e == cudaSuccess)                                                       \
    stream_forward_kernel<CC><<<grid, tile, smem, (cudaStream_t)stream>>>(    \
        steps, gather, n_rows, K, roots, trans, tips, P, rootw, invar, out, pool);
  IQT_DISPATCH_C(C, IQT_LAUNCH)
#undef IQT_LAUNCH
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
