// Stepwise-addition parsimony: the cost of attaching one new leaf on the
// edge above every node of a partial tree, in one launch.
//
// Replaces the JAX package's device function _insertion_scores
// (iqtree_tpu/engine/parsimony.py; plain XLA, no Pallas kernel), whose
// level-batched form costs one round of small tensor ops per tree level:
// stepwise-addition trees are deep (hundreds of levels at 1000 taxa), and
// launch overhead then dominates.  Here one thread owns one word of
// patterns and walks the whole tree:
//   up pass, children first:   up[v] = fitch(up[a], up[b])
//   rest pass, parents first:  rest[v] = fitch(rest[parent], up[sibling]),
//                              rest[root] = all states
//   miss[v] = [leaf & (up[v] | rest[v]) == 0]      (a bit a pattern)
// and a second kernel adds cost[v] = sum_p w_p miss[v][p].
//
// Words.  A state set is a lane of a word: 4-bit lanes, 8 patterns a
// 32-bit word, up to 4 states (DNA); one 32-bit lane up to 32 states
// (protein); one 64-bit lane up to 64 states (codons: the JAX package's
// W = 2 words of a set in one).  Fitch runs on all lanes of a word at once
// (SWAR):
//   i = x & y;  h = (((i & L) + L) | i) & H   (H: each lane's top bit,
//   L = ~H; h has a lane's top bit iff the lane of i is non-empty)
//   m = h | (h - (h >> (B-1)))                (that lane all ones)
//   fitch(x, y) = i | (~m & (x | y))
// -- about 10 integer operations for 8 DNA patterns.  A 64-bit lane is the
// whole word: fitch = i ? i : x | y, empty = i == 0, so a set is empty only
// when both of its 32-bit halves are (the JAX package's all-words test).
// The codon padding bits (past the code's 60-63 states) are never set by a
// tip, so rest[root]'s ones there drop out at the first intersection.
//
// On chip.  The walk's dependent chain is a read of a value written a few
// rows earlier, ~3 000 rows long at 1000 taxa.  A block's words keep the
// whole walk in shared memory, one column a thread (no bank conflict, no
// barrier): val[node] (the tips, staged once, then up of the internal
// nodes, indexed by node id) and rest of the internal non-root nodes,
// 3N words a column (4 or 8 bytes a word).  The walk rows are the same
// for every thread; they are 16-byte vectors fetched a chunk ahead into
// registers, so no index load sits in front of a data load.  The miss bits go out as one byte a
// word and node, coalesced and never read back by the walk; the sums over
// patterns run in the cost kernel, a warp a node, in int64 (the pattern
// weights are integers, so the sums are exact in any order).
//
// Words a block: the launch picks the fewest that spread the words over
// every SM (latency, not issue, bounds a walk), within the shared memory
// a block may opt into; a tree whose one column does not fit (about
// 19 000 taxa on an H100 with 32-bit words, 9 700 with 64-bit) is refused
// with an error, never run elsewhere.
//
// Bound on an H100 (1000 taxa x 9 962 patterns, a full tree): the packed
// tips read once (5 MB), about 14 integer operations a word and walk row;
// the chain of ~3 000 dependent shared-memory rows (tens of cycles each)
// bounds it instead, as the likelihood sweeps are bounded by their steps.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 8;            // walk rows fetched ahead
constexpr int ERR_TOO_LARGE = 1000; // a column of the walk exceeds shared memory

// B: lane width in bits (4, 32 or 64); Word: the word that holds the lanes
template <int B>
struct Lane {
  using Word = std::conditional_t<B == 64, uint64_t, uint32_t>;
  static constexpr uint32_t H = B == 4 ? 0x88888888u : 0x80000000u;
  static constexpr uint32_t L = ~H;
  static constexpr int PER_WORD = B == 64 ? 1 : 32 / B;
};

// top bit of every non-empty lane of x (32-bit words)
template <int B>
__device__ __forceinline__ uint32_t nonempty(uint32_t x) {
  return (((x & Lane<B>::L) + Lane<B>::L) | x) & Lane<B>::H;
}

template <int B, typename W = typename Lane<B>::Word>
__device__ __forceinline__ W fitch(W x, W y) {
  const W i = x & y;
  if constexpr (B == 64) {
    return i ? i : x | y;
  } else {
    const uint32_t h = nonempty<B>(i);
    const uint32_t m = h | (h - (h >> (B - 1)));
    return i | (~m & (x | y));
  }
}

// one bit a lane: bit k set iff lane k of x is empty
template <int B, typename W = typename Lane<B>::Word>
__device__ __forceinline__ uint32_t empty_bits(W x) {
  if constexpr (B == 64) {
    return x == 0;
  } else {
    uint32_t t = (~nonempty<B>(x) & Lane<B>::H) >> (B - 1);
    if (B == 4) {  // bits 0, 4, ..., 28 -> 0..7
      t = (t | (t >> 3)) & 0x03030303u;
      t = (t | (t >> 6)) & 0x000F000Fu;
      t = (t | (t >> 12)) & 0xFFu;
    }
    return t;
  }
}

__device__ __forceinline__ void fetch_rows(const int4* __restrict__ rows, int i0, int end,
                                           int4 (&r)[CHUNK]) {
#pragma unroll
  for (int j = 0; j < CHUNK; ++j)
    r[j] = i0 + j < end ? __ldg(rows + i0 + j) : make_int4(0, 0, 0, 0);
}

// rows [begin, end) in order, each handed to row(); the next chunk's rows
// are in flight while this chunk's run
template <typename F>
__device__ __forceinline__ void walk(const int4* __restrict__ rows, int begin, int end,
                                     F&& row) {
  int4 cur[CHUNK], nxt[CHUNK];
  fetch_rows(rows, begin, end, cur);
  for (int i0 = begin; i0 < end; i0 += CHUNK) {
    fetch_rows(rows, i0 + CHUNK, end, nxt);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j)
      if (i0 + j < end) row(cur[j]);
#pragma unroll
    for (int j = 0; j < CHUNK; ++j) cur[j] = nxt[j];
  }
}

// rows: n_post rows (node, child0, child1, -) then n_pre rows (node,
// parent or -1 under the root, sibling, -); tips [N][n_words]; miss
// [2N][n_words] bytes (bit k of byte w: pattern w * PER_WORD + k)
template <int B, typename W = typename Lane<B>::Word>
__global__ void pars_insert_kernel(const int4* __restrict__ rows, int n_post, int n_pre,
                                   const W* __restrict__ tips, int n_taxa, int leaf,
                                   int n_words, uint8_t* __restrict__ miss) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  W* smem_words = reinterpret_cast<W*>(smem_raw);
  const int TW = blockDim.x, tw = threadIdx.x;
  const int w_raw = blockIdx.x * TW + tw;
  const bool valid = w_raw < n_words;
  const int w = min(w_raw, n_words - 1);  // the ragged tail walks a copy, writes nothing
  const int N = n_taxa;
  // this thread's column: val[0 .. N + n_post) then rest[N .. N + n_post - 1)
  W* val = smem_words + tw;
  W* rest = val + (size_t)n_post * TW;  // rest[v * TW], N <= v < root
  // stage the tips with every copy in flight at once (cp.async)
  for (int u = 0; u < N; ++u)
    __pipeline_memcpy_async(val + u * TW, tips + (size_t)u * n_words + w, sizeof(W));
  __pipeline_commit();
  __pipeline_wait_prior(0);
  const W lm = val[leaf * TW];

  walk(rows, 0, n_post, [&](const int4& r) {
    val[r.x * TW] = fitch<B>(val[r.y * TW], val[r.z * TW]);
  });
  walk(rows, n_post, n_post + n_pre, [&](const int4& r) {
    const W rp = r.y < 0 ? ~W(0) : rest[r.y * TW];
    const W rv = fitch<B>(rp, val[r.z * TW]);
    if (r.x >= N) rest[r.x * TW] = rv;
    const uint32_t bits = empty_bits<B>(lm & (val[r.x * TW] | rv));
    if (valid) miss[(size_t)r.x * n_words + w] = (uint8_t)bits;
  });
}

// cost[v] = sum of the weights of v's miss bits, for every node v of the
// pre rows: a warp a node, int64 sums (exact), then float64
template <int B>
__global__ void pars_insert_cost_kernel(const int4* __restrict__ pre, int n_pre,
                                        const uint8_t* __restrict__ miss, int n_words,
                                        const int* __restrict__ wts,
                                        double* __restrict__ cost) {
  const int i = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32, lane = threadIdx.x & 31;
  if (i >= n_pre) return;  // the whole warp
  const int v = __ldg(&pre[i].x);
  const uint8_t* m = miss + (size_t)v * n_words;
  long long acc = 0;
  for (int w = lane; w < n_words; w += 32) {
    uint32_t bits = m[w];
    while (bits) {
      acc += __ldg(wts + w * Lane<B>::PER_WORD + __ffs(bits) - 1);
      bits &= bits - 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) cost[v] = (double)acc;
}

template <int B, typename W = typename Lane<B>::Word>
cudaError_t launch(const int4* rows, int n_post, int n_pre, const void* tips,
                   int n_taxa, int leaf, const int* wts, int n_words, uint8_t* miss,
                   double* cost, cudaStream_t st) {
  int dev, sm_count, optin;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  const size_t column = (size_t)(n_taxa + 2 * n_post - 1) * sizeof(W);
  const int fit = (int)((size_t)optin / column);
  if (fit < 1) return (cudaError_t)ERR_TOO_LARGE;
  int tw = (n_words + sm_count - 1) / sm_count;
  tw = tw < fit ? tw : fit;
  tw = tw < 1024 ? tw : 1024;
  const size_t smem = column * tw;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(pars_insert_kernel<B>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  pars_insert_kernel<B><<<(n_words + tw - 1) / tw, tw, smem, st>>>(
      rows, n_post, n_pre, (const W*)tips, n_taxa, leaf, n_words, miss);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  pars_insert_cost_kernel<B><<<(n_pre + 7) / 8, 256, 0, st>>>(rows + n_post, n_pre, miss,
                                                               n_words, wts, cost);
  return cudaGetLastError();
}

}  // namespace

// rows [n_post + n_pre][4] int32; tips [N][n_words] words of lanes `bits`
// wide (4: 8 sets a 32-bit word, 32: one set a 32-bit word, 64: one set a
// 64-bit word); wts [n_words * patterns a word] int32 pattern weights (0
// past P); miss [2N][n_words] bytes of scratch; cost [2N] float64, written
// at the nodes of the pre rows.  The words a block come from the card; a
// tree too large for one column raises.
extern "C" int iqt_pars_insert(const int* rows, int n_post, int n_pre, const void* tips,
                               int n_taxa, int leaf, const int* wts, int n_words,
                               void* miss, double* cost, int bits, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int4* r = reinterpret_cast<const int4*>(rows);
  switch (bits) {
    case 4:
      return (int)launch<4>(r, n_post, n_pre, tips, n_taxa, leaf, wts, n_words,
                            (uint8_t*)miss, cost, st);
    case 32:
      return (int)launch<32>(r, n_post, n_pre, tips, n_taxa, leaf, wts, n_words,
                             (uint8_t*)miss, cost, st);
    case 64:
      return (int)launch<64>(r, n_post, n_pre, tips, n_taxa, leaf, wts, n_words,
                             (uint8_t*)miss, cost, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* iqt_error_string(int e) {
  if (e == ERR_TOO_LARGE)
    return "the parsimony walk of this tree does not fit in shared memory: one "
           "column of it (3 words a taxon, 4 or 8 bytes a word) exceeds what a "
           "block may use on this card";
  return cudaGetErrorString((cudaError_t)e);
}
