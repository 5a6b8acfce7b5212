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
// fitch(x, y) = x & y if non-empty, else x | y.  A state set is one word,
// the kernel a template on its type: a byte for S <= 8 states (DNA), a
// 32-bit word for S <= 32 (protein); the root's full set is all ones of
// the word.  up/rest live in device memory [2N, P] (words), each thread
// on its own column, coalesced over patterns.  The per-node sums
// over patterns reduce within a warp by shuffles, then one atomicAdd per
// warp and node; pattern weights are integers, so the float64 sums are
// exact in any order.
//
// Bound on an H100 (1000 taxa x 9 962 patterns, a full tree): the tips
// read and up/rest written once and read back, about 2 x 2 000 x 9 962
// words x 3 (120 MB in bytes; four times that for 32-bit words) at
// 3.35 TB/s; a few integer operations per node and pattern.  The
// dependent walk of 2 000 nodes per thread bounds it instead, as it does
// the likelihood sweeps.
#include <cuda_runtime.h>
#include <stdint.h>

template <typename W>
__device__ __forceinline__ W fitch(W x, W y) {
  const W i = x & y;
  return i ? i : (W)(x | y);
}

template <typename W>
__global__ void pars_insert_kernel(const int* __restrict__ post, int n_post,
                                   const int* __restrict__ pre, int n_pre,
                                   const W* __restrict__ tips, int n_taxa, int leaf,
                                   const double* __restrict__ freq, int P,
                                   W* __restrict__ up, W* __restrict__ rest,
                                   double* __restrict__ cost) {
  const int p_raw = blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = p_raw < P;
  const int p = min(p_raw, P - 1);
  const int lane = threadIdx.x & 31;
  auto val = [&](int v) -> W {
    return v < n_taxa ? __ldg(tips + (size_t)v * P + p) : up[(size_t)v * P + p];
  };
  for (int i = 0; i < n_post; ++i) {
    const int v = __ldg(post + 3 * i), a = __ldg(post + 3 * i + 1),
              b = __ldg(post + 3 * i + 2);
    up[(size_t)v * P + p] = fitch<W>(val(a), val(b));
  }
  const W lm = __ldg(tips + (size_t)leaf * P + p);
  const double w = valid ? __ldg(freq + p) : 0.0;
  for (int i = 0; i < n_pre; ++i) {
    // (node, parent, sibling); a parent of -1 is the root, whose rest
    // is the full state set
    const int v = __ldg(pre + 3 * i), par = __ldg(pre + 3 * i + 1),
              sib = __ldg(pre + 3 * i + 2);
    const W r = par < 0 ? (W)~(W)0 : rest[(size_t)par * P + p];
    const W rv = fitch<W>(r, val(sib));
    rest[(size_t)v * P + p] = rv;
    double miss = (lm & (val(v) | rv)) ? 0.0 : w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) miss += __shfl_down_sync(0xffffffffu, miss, o);
    if (lane == 0 && miss != 0.0) atomicAdd(cost + v, miss);
  }
}

// word_bytes: 1 (uint8 sets, S <= 8) or 4 (uint32 sets, S <= 32)
extern "C" int iqt_pars_insert(const int* post, int n_post, const int* pre, int n_pre,
                               const void* tips, int n_taxa, int leaf,
                               const double* freq, int P, void* up, void* rest,
                               double* cost, int word_bytes, int tile, void* stream) {
  const dim3 grid((P + tile - 1) / tile);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (word_bytes) {
    case 1:
      pars_insert_kernel<uint8_t><<<grid, tile, 0, st>>>(
          post, n_post, pre, n_pre, (const uint8_t*)tips, n_taxa, leaf, freq, P,
          (uint8_t*)up, (uint8_t*)rest, cost);
      break;
    case 4:
      pars_insert_kernel<uint32_t><<<grid, tile, 0, st>>>(
          post, n_post, pre, n_pre, (const uint32_t*)tips, n_taxa, leaf, freq, P,
          (uint32_t*)up, (uint32_t*)rest, cost);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* iqt_error_string(int e) {
  return cudaGetErrorString((cudaError_t)e);
}
