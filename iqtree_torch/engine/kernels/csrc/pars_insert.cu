// Stepwise-addition parsimony: the cost of attaching one new leaf on the
// edge above every node of a partial tree, in one launch.
//
// Replaces the JAX package's device function _insertion_scores
// (iqtree_tpu/engine/parsimony.py; plain XLA, no Pallas kernel), whose
// level-batched form costs one round of small tensor ops per tree level:
// stepwise-addition trees are deep (hundreds of levels at 1000 taxa), and
// launch overhead then dominates.  Here one thread owns one pattern and
// walks the whole tree:
//   up pass, children first:   up[v] = fitch(up[a], up[b])
//   rest pass, parents first:  rest[v] = fitch(rest[parent], up[sibling]),
//                              rest[root] = all states
//   cost[v] += freq[p] * [leaf & (up[v] | rest[v]) == 0]
// fitch(x, y) = x & y if non-empty, else x | y.  State sets are one byte
// (S <= 8 states); up/rest live in device memory [2N, P] (bytes), each
// thread on its own column, coalesced over patterns.  The per-node sums
// over patterns reduce within a warp by shuffles, then one atomicAdd per
// warp and node; pattern weights are integers, so the float64 sums are
// exact in any order.
//
// Bound on an H100 (1000 taxa x 9 962 patterns, a full tree): the tips
// read and up/rest written once and read back, about 2 x 2 000 x 9 962
// bytes x 3 = 120 MB (3.35 TB/s: 0.036 ms); a few integer operations per
// node and pattern.  The dependent walk of 2 000 nodes per thread bounds
// it instead, as it does the likelihood sweeps.
#include <cuda_runtime.h>

__device__ __forceinline__ unsigned char fitch(unsigned char x, unsigned char y) {
  const unsigned char i = x & y;
  return i ? i : (unsigned char)(x | y);
}

__global__ void pars_insert_kernel(const int* __restrict__ post, int n_post,
                                   const int* __restrict__ pre, int n_pre,
                                   const unsigned char* __restrict__ tips, int n_taxa,
                                   int leaf, const double* __restrict__ freq, int P,
                                   unsigned char* __restrict__ up,
                                   unsigned char* __restrict__ rest,
                                   double* __restrict__ cost) {
  const int p_raw = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);
  const int lane = threadIdx.x & 31;
  auto val = [&](int v) -> unsigned char {
    return v < n_taxa ? __ldg(tips + (size_t)v * P + p) : up[(size_t)v * P + p];
  };
  for (int i = 0; i < n_post; ++i) {
    const int v = __ldg(post + 3 * i), a = __ldg(post + 3 * i + 1),
              b = __ldg(post + 3 * i + 2);
    up[(size_t)v * P + p] = fitch(val(a), val(b));
  }
  const unsigned char lm = __ldg(tips + (size_t)leaf * P + p);
  const double w = valid ? __ldg(freq + p) : 0.0;
  for (int i = 0; i < n_pre; ++i) {
    // (node, parent, sibling); a parent of -1 is the root, whose rest
    // is the full state set
    const int v = __ldg(pre + 3 * i), par = __ldg(pre + 3 * i + 1),
              sib = __ldg(pre + 3 * i + 2);
    const unsigned char r = par < 0 ? (unsigned char)0xFF : rest[(size_t)par * P + p];
    const unsigned char rv = fitch(r, val(sib));
    rest[(size_t)v * P + p] = rv;
    double miss = (lm & (val(v) | rv)) ? 0.0 : w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) miss += __shfl_down_sync(0xffffffffu, miss, o);
    if (lane == 0 && miss != 0.0) atomicAdd(cost + v, miss);
  }
}

extern "C" int iqt_pars_insert(const int* post, int n_post, const int* pre, int n_pre,
                               const unsigned char* tips, int n_taxa, int leaf,
                               const double* freq, int P, unsigned char* up,
                               unsigned char* rest, double* cost, int tile,
                               void* stream) {
  const dim3 grid((P + tile - 1) / tile);
  pars_insert_kernel<<<grid, tile, 0, (cudaStream_t)stream>>>(
      post, n_post, pre, n_pre, tips, n_taxa, leaf, freq, P, up, rest, cost);
  return (int)cudaGetLastError();
}

extern "C" const char* iqt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
