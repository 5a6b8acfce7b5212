"""Source variants of the redesigned kernels: what their time is made of.

    python -m iqtree_torch.engine.kernels.probe [-C N[,N...]] [--base DIR] [--only V[,V]]
        [--slots N] [newton|forward|store|down_store|wide_newton|wide_forward|
         wide_store|wide_down_store|tbar|wide_tbar ...]
    python -m iqtree_torch.engine.kernels.probe --codon [-C N[,N...]]
        [wide_forward|wide_store|wide_down_store|wide_tbar ...]

On a CUDA card, at the bench shapes (bench_data.npz: its tree, 1000 taxa,
9 962 patterns, GTR+G4 at the model's start values; GTR+GN with -C N, each
of a list in turn; the wide kernels at bench_data_protein.npz's: 300 taxa,
1 958 patterns, LG+GN), builds each variant of a kernel -- a text edit of
csrc/<kernel>.cu or of a header it includes that takes one cost out --
loads it in place of the kernel and prints ms a call of the kernel's
wrapper (CUDA events around 10 calls after a warm-up) at 32, 64 and 128
lanes a block (down_store: 8, 32, 64 and 128 patterns a block; tbar: 64
patterns a block, the only size that keeps its bits; the wide kernels: 16,
32 and 64 patterns a cluster).  With no kernel named, all ten.

--codon times the S=64 instances of the four wide kernels on the codon
path at bench_data_codon.npz's shapes (80 taxa, 457 patterns, GY+F3X4+GN,
the codon space's 61 states padded to 64), with the variants
  as built         CODON_RPT = 8 state rows a thread (8 row groups)
  rows 16 a thread  CODON_RPT = 16 (4 row groups: half the threads)

--only NAME[,NAME...] builds and times only those variants (with `base`
under --base), e.g. `--only "as built"` for the two designs alone.

--slots N gives the kernels a slot pool of N slots where the bench tree
takes fewer (a deeper tree's shared memory; the extra slots stay unused).
For the four wide walks the probe prints the launch each makes at each
size (build.walk_launch: category warps or teams, threads, shared memory,
the most clusters at once).

--base DIR adds the variant `base`: <kernel>.cu and its headers taken
whole from DIR, e.g. an earlier commit's csrc/ (`git archive COMMIT
iqtree_torch/engine/kernels/csrc`), with the same C entry point (an
earlier CS-packed kernel's, before the S = 2 instances, is called without
the S argument: load_library).  It is
timed first and last, `as built` second and second to last, so that the
two designs are compared in one process on one card, and the probe says
whether the two give the same bits.  The earlier thread-a-pattern
forward.cu, store.cu and down_store.cu read the block argument as
patterns a block, the earlier wide_newton.cu and wide_forward.cu as
patterns a block of C x 4 row groups of threads (a block past 512 threads
is refused), as do the earlier wide_store.cu, wide_down_store.cu and
wide_tbar.cu.

newton (newton_sweep; the per-warp sums' zeroing and reduction inside):
  as built         csrc/newton.cu
  partials cached  every step fetches node 0's partials and scales (cache
                   hits): the cost of reading the stored partials
  no shuffles      no cross-category max or sums (wrong values)
  stages 3, 4      the cp.async ring three and four steps deep

forward (fused_site_lnl) and store (fused_upward_store_cs), the upward
walk of cs_common.cuh:
  as built         csrc/forward.cu, csrc/store.cu
  tips cached      every tip child fetches tip 0's words (cache hits): the
                   cost of reading the tips
  no shuffles      no cross-category max (wrong values)
  stages 3         the cp.async ring three steps deep
  reciprocal       a reciprocal and a multiply in place of the division
  no stores        (store) nothing written to up and usc
  one row          (store) only the first of a lane's S rows written

down_store (fused_down_store_cs), newton's walk with one matrix, timed at
8, 32, 64 and 128 patterns a block (a warp's row store a run of 32, 128,
128 and 128 bytes):
  as built         csrc/down_store.cu
  partials cached  every step fetches node 0's partials and scales
  no max barrier   the block barrier before the cross-category max read
                   a __syncwarp (wrong values)
  stages 2         the cp.async ring two steps deep
  no stores        nothing written to out and osc
  float division   x / y in place of div_rn's branch-free double quotient
                   (the same bits)
  scaled division  (x 2^64) / (y 2^64) in float (the same bits)
  reciprocal       x * __frcp_rn(y) (other bits)

wide_newton (wide_newton_sweep; a cluster of C blocks, one a category):
  as built         csrc/wide_newton.cu
  one pattern a thread  QT = 1: twice the threads, a P word feeds one FMA
  partials cached  every step fetches node 0's partials and scales
  matrices cached  every step fetches node 0's (P, P', P'')
  no cluster barriers  the two exchanges a step without their barrier
                   (wrong values)
  float division, scaled division, reciprocal  as for down_store
  loads on the chain  each step waits for the next step's copies before
                   its own arithmetic

wide_forward (wide_site_lnl; the cluster walk of wide_common.cuh):
  as built         csrc/wide_forward.cu
  one pattern a thread  CLUSTER_QT = 1, as for wide_newton
  tips cached      every tip child fetches tip 0's rows
  matrices cached  (one category a block) every step fetches node 0's
                   [S,S] blocks
  no cluster barrier  the step's cluster barrier a block barrier (wrong
                   values)
  stages 3         the cp.async ring three steps (past 8 categories: units)
                   deep
  float division, scaled division, reciprocal  as for down_store
  loads on the chain  (one category a block) each step waits for the
                   copies it has just issued
  warps 10, warps 5, warps 4, warps 2, warps 1  (past 8 categories) W
                   category warps a block (at most CB), not the chooser's
                   (at C = 80 and the bench tree's 5 slots 5 as built: two
                   blocks an SM; 10 takes one); a block that does not fit
                   is refused (the same bits)

wide_store (pruning.fused_upward_store; the same cluster walk):
  as built         csrc/wide_store.cu
  one pattern a thread  CLUSTER_QT = 1 (a warp's row stores 8 patterns)
  tips cached      as for wide_forward
  no stores        nothing written to up and usc
  stores from registers  (one category a block) each thread writes its own
                   2 patterns x 5 rows (and the scale) from registers: half
                   of each 64-byte run an instruction, no copy from the pool
  no cluster barrier  as for wide_forward (wrong values; a cluster
                   barrier before the blocks leave)
  float division   as for down_store
  stages 3, warps 10, warps 5, warps 4, warps 2, warps 1  as for wide_forward

wide_down_store (cs_kernels.fused_down_store; the cluster reverse walk of
wide_common.cuh, wide_newton's with one matrix, one cluster barrier a step):
  as built         csrc/wide_down_store.cu
  partials cached  every step fetches node 0's partials and scales
  matrices cached  every step fetches node 0's [S,S] blocks
  no stores        nothing written to out and osc
  no cluster barrier  the exchange's cluster barrier a block barrier
                   (wrong values; a cluster barrier before the blocks leave)
  stages 3         the cp.async ring three steps (past 8 categories:
                   units) deep, the copies two ahead
  loads on the chain  each step waits for the copies it has just issued
  fetch at the step's start  step i - 1's copies issued as step i starts,
                   not after its exchange (the same bits)
  two patterns a thread  QT = 2 (the forward walk's): half the threads
  registers 255    no cap of 128 registers a thread (the cap keeps every
                   cluster resident at C=8)
  no push          nothing pushed into the children's slots (wrong values)
  no division      O = o, no division by the max (wrong values)
  float division, reciprocal  as for down_store
  teams 5, teams 4, teams 3, teams 2, teams 1  (past 8 categories) W
                   category teams a block (at most CB), not the chooser's
                   (least_units; at C = 80 and the bench tree's 5 slots 2
                   as built, two blocks an SM); a block that does not fit
                   is refused (the same bits)

wide_tbar (cs_kernels.fused_downward_tbar; the same reverse walk, the
ordered cotangent sums in a sum warp for each 16 patterns):
  as built         csrc/wide_tbar.cu
  no sums          the sum warps add nothing (wrong values)
  sums on the walk warps  (one category a block) no sum warps: after the
                   hook the walk threads wait for each other and one walk
                   warp of each 16 patterns runs their sums (the same bits)
  no part stores   the sums are not written (wrong values)
  sums before the next step opens  a sum warp arrives at the next step's
                   opening barrier after its sums, not before them (the
                   same bits)
  no cluster barrier  as for wide_down_store
  registers 255    no cap of 80 registers a thread (the cap keeps every
                   cluster resident at C=8)
  float division   as for down_store
  stages 3         as for wide_down_store (past one team a ring of 4)
  teams 5, teams 4, teams 3, teams 2, teams 1  as for wide_down_store (at
                   C = 80 and 5 slots 5 as built: the sum warps lag a unit
                   behind the walk on a ring a stage deeper)

tbar (fused_tbar_cs), down_store's walk and the ordered cotangent sums:
  as built         csrc/tbar.cu
  partials cached  every step fetches node 0's partials and scales
  matrices cached  every step fetches node 0's edge blocks
  no barriers      no block barrier before the cross-category max and no
                   named barrier for the sum warp, each a __syncwarp
                   (wrong values; the sum warps run on their own)
  block barrier    the named barrier between the walk and the sum warps a
                   block barrier (the walk waits for the sum warps)
  stages 3         the cp.async ring three steps deep
  one sum warp     one sum warp for all the categories (SUM_CATEGORIES 8)
  a sum warp a category  SUM_CATEGORIES 1
  no sums          the sum warps add nothing (wrong values)
  no stage         nor do the walk lanes stage O * fac (nor form fac)
  butterfly sums   the sums as each walk warp's shuffle butterflies, the
                   two warps of a category added through shared memory
                   (other bits)
  float division, scaled division, reciprocal  as for down_store

Only the variants' times mean something; their results are wrong by
design.  The variants build beside the kernels, under build/<hash>/probe.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from . import build
from . import cs_kernels as csk
from . import pruning
from .ablate import BENCH_DATA
from .pruning import device_slot_schedule

HEADER = "cs_common.cuh"
# the header the wide kernels' sources include besides HEADER
WIDE_HEADER = "wide_common.cuh"
_UPWARD = {
    "as built": (),
    "tips cached": (("tips + ((size_t)sj.l * S + s) * P + p",
                     "tips + ((size_t)0 * S + s) * P + p"),
                    ("tips + ((size_t)sj.r * S + s) * P + p",
                     "tips + ((size_t)0 * S + s) * P + p")),
    "no shuffles": (("for (int off = 1; off < CL; off <<= 1) v = fmaxf",
                     "for (int off = CL; off < CL; off <<= 1) v = fmaxf"),),
    "stages 3": (("constexpr int UP_STAGES = 2;", "constexpr int UP_STAGES = 3;"),),
    "reciprocal": (("for (int s = 0; s < S; ++s) y[s] = y[s] / mx;",
                    "for (int s = 0; s < S; ++s) y[s] = y[s] * __frcp_rn(mx);"),),
}
# the quotient O = o / max (div_rn, branch-free in double): the float
# division (the same bits, with its check and slow path), the float
# division of both operands scaled by 2^64 (the same bits, no slow path for
# a tiny dividend) or a reciprocal and a product (other bits)
_DIV = "return (float)fma(fma(-yd, q, xd), r, q);"
_DIVISION = {
    "float division": ((_DIV, "return x / y;"),),
    "scaled division": ((_DIV, "return (x * 0x1p64f) / (y * 0x1p64f);"),),
    "reciprocal": ((_DIV, "return x * __frcp_rn(y);"),),
}
# tbar's sums: the sum warp's ordered sums (none: zeros), the walk lanes'
# O * fac stage (none), or in its place each walk warp's sums as shuffle
# butterflies, the category's two warps added through its stage (other bits)
_TBAR_SUMS = ("    ordered_dots<N>(ost + ((c0 * 2 + side) * S + s) * OS, dc * 2 * S * OS, U, "
              "dc * PB, acc);")
_TBAR_NO_SUMS = "    for (int n = 0; n < N; ++n) acc[n] = 0.f;"
_TBAR_STAGE = """    for (int s = 0; s < S; ++s) {
      oc[s * OS + q] = ol[s] * facl;
      oc[(S + s) * OS + q] = orr[s] * facr;
    }"""
_TBAR_NO_STAGE = """    for (int s = 0; s < 0; ++s) {
      oc[s * OS + q] = ol[s] * facl;
      oc[(S + s) * OS + q] = orr[s] * facr;
    }"""
_TBAR_BUTTERFLY = """    for (int s = 0; s < 1; ++s) {
      float v[2 * SS];  // [side][s][t] of this lane's pattern
      for (int s2 = 0; s2 < S; ++s2)
        for (int t2 = 0; t2 < S; ++t2) {
          v[s2 * S + t2] = ol[s2] * facl * ul[t2];
          v[SS + s2 * S + t2] = orr[s2] * facr * ur[t2];
        }
      group_sums<32, 2 * SS>(v);
      if (lane == 0)
        for (int w = 0; w < 2 * SS; ++w) oc[(q >> 5) * 2 * SS + w] = v[w];
      asm volatile("bar.sync %0, %1;" ::"r"(c + 2), "r"(PB) : "memory");
      if (q < 2 * SS) {
        float acc = 0.f;
        for (int w = 0; w < PB / 32; ++w) acc += oc[w * 2 * SS + q];
        part_b[((size_t)(q < SS ? st.l : st.r) * C + c) * SS + q % SS] = acc;
      }
    }"""
# wide_tbar's sums: the sum warps' (as built), or after the hook each walk
# warp waits for the others' O and fac and one walk warp of each 16 patterns
# runs their sums
_TBAR_SUM_WARPS_ARRIVE = "        stage_fac(sc, Uk);\n        sums_arrive(blockDim.x);\n      };"
_TBAR_WALK_WARPS_SUM = """        stage_fac(sc, Uk);
        sums_wait(blockDim.x);
        constexpr int WARPS = SUM_PATTERNS * G / 32;  // walk warps a group
        const int ww = tid >> 5;
        if (ww % WARPS == 0)
          group_sums<S>(st, ost, S * tile, fac, Uk, tile, ww / WARPS * SUM_PATTERNS,
                        tid & 31, fac + 2 * tile + (size_t)ww / WARPS * 2 * SS,
                        part_row(ww / WARPS), C, kb);
      };"""
# the wide store's row stores at one category a block: each warp's 16
# patterns from the pool slot (as built), or each thread's own rows and
# scale from its registers
_STORE_FROM_POOL = """    const auto emit = [&](const Step& st, const auto&, const auto&, const float* slot) {
      if (p < P) {
        float* dst = up + ((size_t)st.node * C + c) * S * P + p;
        for (int r = r0; r < S; r += RW) dst[(size_t)r * P] = slot[r * tile + q];
        if (c == 0 && r0 == 0) usc[(size_t)st.node * P + p] = slot[S * tile + q];
      }
    };"""
_STORE_FROM_REGISTERS = """    const auto emit = [&](const Step& st, const auto& y, const auto& sc, const float*) {
      const int g = threadIdx.x % (S / RPT), pq = threadIdx.x / (S / RPT);
#pragma unroll
      for (int qq = 0; qq < CLUSTER_QT; ++qq) {
        const int pr = p0 + pq * CLUSTER_QT + qq;
        if (pr >= P) continue;
        float* dst = up + ((size_t)st.node * C + c) * S * P + pr;
#pragma unroll
        for (int j = 0; j < RPT; ++j) dst[(size_t)(g * RPT + j) * P] = y[j][qq];
        if (c == 0 && g == 0) usc[(size_t)st.node * P + pr] = sc[qq];
      }
    };"""
_ONE_PATTERN = (("constexpr int CLUSTER_QT = 2;", "constexpr int CLUSTER_QT = 1;"),)
_STAGES_3 = (("constexpr int CLUSTER_STAGES = 2;", "constexpr int CLUSTER_STAGES = 3;"),)
# the category warps (upward) or teams (reverse) of the walks past 8
# categories: the chooser's (as built) or W (least_units of wide_common.cuh)
def _forced_warps(w):
    return (("bb = b;\n  }\n  return best;", f"bb = b;\n  }}\n  return {w} < CB ? {w} : CB;"),)


_WARPS = {f"warps {w}": _forced_warps(w) for w in (10, 5, 4, 2, 1)}
_TEAMS = {f"teams {w}": _forced_warps(w) for w in (5, 4, 3, 2, 1)}
# the reverse walks' copies REVERSE_STAGES - 1 steps (past 8 categories:
# units) ahead on a ring a stage deeper
_REVERSE_STAGES_3 = (("constexpr int REVERSE_STAGES = 2;", "constexpr int REVERSE_STAGES = 3;"),)
_TIPS_CACHED = (("tips + ((size_t)node * S + t) * P + p, 4);",
                 "tips + ((size_t)0 * S + t) * P + p, 4);"),)
_MATRICES_CACHED = (("trans + ((size_t)node * C + c) * SS + 4 * r, 16);",
                     "trans + ((size_t)0 * C + c) * SS + 4 * r, 16);"),)
_WALK_BARRIER = (("    cluster.sync();  // one barrier a step",
                  "    __syncthreads();  // one barrier a step"),)
# the reverse walk's exchange a block barrier (wrong values), and a cluster
# barrier before the blocks leave, after the last line of `kernel`'s walk call
_REVERSE_BARRIER = (("void reverse_barrier(cg::cluster_group& cluster) {\n  cluster.sync();",
                     "void reverse_barrier(cg::cluster_group& cluster) {\n  __syncthreads();"),)


def _no_reverse_barrier(last_line):
    return (*_REVERSE_BARRIER, (last_line + "\n}", last_line + "\n  cluster.sync();\n}"))


# the reverse walk's fetch of step i - 1: after step i's exchange (as
# built), or at step i's start (into the stage step i + 1 held), or after
# the exchange and waited for at once
_REVERSE_FETCH = """    // step i + 1's stage is free: step i - NS + 1 into it
    const int kf = k == 0 ? NS - 1 : k - 1;
    if (i >= NS - 1)
      reverse_fetch<S>(st_f, mst + kf * 2 * SS, ust + (size_t)kf * 2 * (S + 1) * tile, c, C,
                       tile, p0, T, trans, up, usc, P);
    __pipeline_commit();
    if (i >= NS) st_f = load_step(steps, i - NS);
"""
_RING_BARRIER = ("    ring_barrier();                 // every thread's\n"
                 "    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;\n")
_FETCH_AT_START = ((_REVERSE_FETCH, ""),
                   (_RING_BARRIER, _RING_BARRIER.replace(
                       "    const Step", _REVERSE_FETCH.replace(
                           "step i + 1's stage is free", "at the step's start") + "    const Step")))
_REVERSE_LOADS_ON_THE_CHAIN = (("    __pipeline_commit();\n    if (i >= NS) st_f",
                                "    __pipeline_commit();\n    __pipeline_wait_prior(0);\n"
                                "    __syncthreads();\n    if (i >= NS) st_f"),)


_LOADS_ON_THE_CHAIN = (("    __pipeline_commit();\n"
                        "    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;",
                        "    __pipeline_commit();\n"
                        "    __pipeline_wait_prior(0);\n"
                        "    __syncthreads();\n"
                        "    const Step st_next = i > 0 ? load_step(steps, i - 1) : st;"),)
# kernel: {variant: ((old, new) text edits of csrc/<kernel>.cu and cs_common.cuh)}
KERNELS: Dict[str, Dict[str, Tuple[Tuple[str, str], ...]]] = {
    "newton": {
        "as built": (),
        "partials cached": (("((size_t)sj.l * C + c)", "((size_t)0 * C + c)"),
                            ("((size_t)sj.r * C + c)", "((size_t)0 * C + c)"),
                            ("usc + (size_t)sj.l * P", "usc"),
                            ("usc + (size_t)sj.r * P", "usc")),
        "no shuffles": (("for (int off = 1; off < CL; off <<= 1)",
                         "for (int off = CL; off < CL; off <<= 1)"),),
        "stages 3": (("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),),
        "stages 4": (("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),),
    },
    "forward": _UPWARD,
    "store": {**_UPWARD, "no stores": (("if (!writes) return;", "return;"),),
              "one row": (("for (int s = 0; s < S; ++s) dst[(size_t)s * P] = ys[s];",
                           "for (int s = 0; s < 1; ++s) dst[(size_t)s * P] = ys[s];"),)},
    "down_store": {
        "as built": (),
        "partials cached": (("up + ((size_t)sj.l * C + c)", "up + ((size_t)0 * C + c)"),
                            ("up + ((size_t)sj.r * C + c)", "up + ((size_t)0 * C + c)"),
                            ("usc + (size_t)sj.l * P", "usc"),
                            ("usc + (size_t)sj.r * P", "usc")),
        "no max barrier": (("    __syncthreads();  // every category's max of step i is written",
                            "    __syncwarp();  // every category's max of step i is written"),),
        "stages 2": (("constexpr int STAGES = 3;", "constexpr int STAGES = 2;"),),
        "no stores": (("    if (writes) {", "    if (false) {"),),
        **_DIVISION,
    },
    "wide_newton": {
        "as built": (),
        "one pattern a thread": (("constexpr int QT = 2;", "constexpr int QT = 1;"),),
        "partials cached": (("up + ((size_t)node * C * S + c * S + t) * P + p",
                             "up + ((size_t)0 * C * S + c * S + t) * P + p"),
                            ("usc + (size_t)node * P + p;", "usc + p;")),
        "matrices cached": (("(((size_t)node * 3 + blk % 3) * C + c)",
                             "(((size_t)0 * 3 + blk % 3) * C + c)"),),
        "no cluster barriers": (("void exchange_barrier(cg::cluster_group& cluster) {\n"
                                 "  cluster.sync();",
                                 "void exchange_barrier(cg::cluster_group& cluster) {\n"
                                 "  __syncthreads();"),),
        **_DIVISION,
        "loads on the chain": _LOADS_ON_THE_CHAIN,
    },
    "wide_forward": {
        "as built": (),
        "one pattern a thread": _ONE_PATTERN,
        "tips cached": _TIPS_CACHED,
        "matrices cached": _MATRICES_CACHED,
        "no cluster barrier": _WALK_BARRIER,
        "stages 3": _STAGES_3,
        **_DIVISION,
        "loads on the chain": (("    __pipeline_commit();\n"
                                "    __syncwarp();  // the pattern group's pool rows are written",
                                "    __pipeline_commit();\n"
                                "    __pipeline_wait_prior(0);\n"
                                "    __syncwarp();  // the pattern group's pool rows are written"),),
        **_WARPS,
    },
    "wide_store": {
        "as built": (),
        "one pattern a thread": _ONE_PATTERN,
        "tips cached": _TIPS_CACHED,
        "no stores": (("    if (p < P) {", "    if (false) {"),),
        "stores from registers": ((_STORE_FROM_POOL, _STORE_FROM_REGISTERS),),
        "no cluster barrier": (*_WALK_BARRIER,
                               ("n_slots, smem, emit);\n  }\n}",
                                "n_slots, smem, emit);\n  }\n  cluster.sync();\n}")),
        "float division": _DIVISION["float division"],
        "stages 3": _STAGES_3,
        **_WARPS,
    },
    "wide_down_store": {
        "as built": (),
        "partials cached": (("up + ((size_t)node * C * S + c * S + t) * P + p",
                             "up + ((size_t)0 * C * S + c * S + t) * P + p"),
                            ("usc + (size_t)node * P + p;", "usc + p;")),
        "matrices cached": _MATRICES_CACHED,
        "no stores": (("    if (stores) {", "    if (false) {"),
                      ("    if (c == 0)\n      for (int v = g;",
                       "    if (false)\n      for (int v = g;")),
        "no cluster barrier": _no_reverse_barrier("                               smem, hook);"),
        "stages 3": _REVERSE_STAGES_3,
        "loads on the chain": _REVERSE_LOADS_ON_THE_CHAIN,
        "fetch at the step's start": _FETCH_AT_START,
        "two patterns a thread": (("constexpr int REVERSE_QT = 1;",
                                   "constexpr int REVERSE_QT = 2;"),),
        "registers 255": (("MULTI || S > 32 ? 1 : 2)\nwide_down_store_kernel",
                           "1)\nwide_down_store_kernel"),),
        "no push": (("      if (cslot < 0) continue;", "      if (true) continue;"),),
        "no division": (("iqt::div_rn(o[side][j][qq], mx[side][qq]);", "o[side][j][qq];"),),
        "float division": _DIVISION["float division"],
        "reciprocal": _DIVISION["reciprocal"],
        **_TEAMS,
    },
    "wide_tbar": {
        "as built": (),
        "no sums": (("        acc[j][k] += a[j].x * b[k].x;\n"
                     "        acc[j][k] += a[j].y * b[k].y;\n"
                     "        acc[j][k] += a[j].z * b[k].z;\n"
                     "        acc[j][k] += a[j].w * b[k].w;\n", ""),),
        "sums on the walk warps": ((_TBAR_SUM_WARPS_ARRIVE, _TBAR_WALK_WARPS_SUM),
                                   ("const int sums = tile / SUM_PATTERNS * SumLanes<S>::WARPS * 32;",
                                    "const int sums = 0;")),
        "no part stores": (("  if (row) {", "  if (row && st.node < -1) {"),),
        "sums before the next step opens": (
            ("    if (i > 0) ring_arrive(blockDim.x);  // step i - 1 opens: it reads nothing of ours\n"
             "    group_sums<S>(st, ost, S * tile, fac, ust + (size_t)k * 2 * (S + 1) * tile, tile,\n"
             "                  w * SUM_PATTERNS, L, pst, row, C, c);\n",
             "    group_sums<S>(st, ost, S * tile, fac, ust + (size_t)k * 2 * (S + 1) * tile, tile,\n"
             "                  w * SUM_PATTERNS, L, pst, row, C, c);\n"
             "    if (i > 0) ring_arrive(blockDim.x);\n"),),
        "no cluster barrier": _no_reverse_barrier("                                   n_slots, smem, hook);\n    }\n  }"),
        "registers 255": (("MULTI || S > 32 ? 1 : 2)\nwide_tbar_kernel",
                           "1)\nwide_tbar_kernel"),),
        "float division": _DIVISION["float division"],
        "stages 3": _REVERSE_STAGES_3,
        **_TEAMS,
    },
    "tbar": {
        "as built": (),
        "partials cached": (("up + ((size_t)sj.l * C + c)", "up + ((size_t)0 * C + c)"),
                            ("up + ((size_t)sj.r * C + c)", "up + ((size_t)0 * C + c)"),
                            ("usc + (size_t)sj.l * P", "usc"),
                            ("usc + (size_t)sj.r * P", "usc")),
        "matrices cached": (("trans + ((size_t)node * C + c) * SS + s * 4, 16);",
                             "trans + ((size_t)0 * C + c) * SS + s * 4, 16);"),),
        "no barriers": (("    __syncthreads();  // every category's max of step i is written",
                         "    __syncwarp();  // every category's max of step i is written"),
                        ("    __syncthreads();                               // the walk's max",
                         "    __syncwarp();                               // the walk's max"),
                        ('asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");',
                         "__syncwarp();"),
                        ('asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");',
                         "__syncwarp();")),
        "block barrier": (('asm volatile("bar.arrive 1, %0;" ::"r"(threads) : "memory");',
                           "__syncthreads();"),
                          ('asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");',
                           "__syncthreads();")),
        "stages 3": (("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),),
        "no sums": ((_TBAR_SUMS, _TBAR_NO_SUMS),),
        "no stage": ((_TBAR_SUMS, _TBAR_NO_SUMS), (_TBAR_STAGE, _TBAR_NO_STAGE)),
        "butterfly sums": ((_TBAR_SUMS, _TBAR_NO_SUMS), (_TBAR_STAGE, _TBAR_BUTTERFLY),
                           ("      if (c0 + n < C) dst[n * SS] = acc[n];",
                            "      if (c0 + n < 0) dst[n * SS] = acc[n];")),
        "one sum warp": (("constexpr int SUM_CATEGORIES = 2;", "constexpr int SUM_CATEGORIES = 8;"),),
        "a sum warp a category": (("constexpr int SUM_CATEGORIES = 2;",
                                   "constexpr int SUM_CATEGORIES = 1;"),),
        **_DIVISION,
    },
}
LANES = (32, 64, 128)
# the launch parameters: down_store's patterns a block, wide_newton's
# patterns a cluster
CLUSTER_TILES = (16, 32, 64)
SIZES = {"down_store": (8, 32, 64, 128), "wide_newton": CLUSTER_TILES,
         "wide_forward": CLUSTER_TILES, "wide_store": CLUSTER_TILES,
         "wide_down_store": CLUSTER_TILES, "wide_tbar": CLUSTER_TILES, "tbar": (64,)}
UNITS = {"down_store": "patterns a block", "wide_newton": "patterns a cluster",
         "wide_forward": "patterns a cluster", "wide_store": "patterns a cluster",
         "wide_down_store": "patterns a cluster", "wide_tbar": "patterns a cluster",
         "tbar": "patterns a block"}
# the block size at which base and as built are compared bit for bit when
# not the wrapper's: the earlier wide_newton's tile, whose sums it keeps;
# the earlier row-group wide kernels' tile (their bits do not depend on the
# tile; they refuse 32 patterns at C=8, 1 024 threads)
BITS_AT = {"wide_newton": 16, "wide_forward": 16, "wide_store": 16, "wide_down_store": 16,
           "wide_tbar": 16}
# kernels at the protein bench shapes
PROTEIN = ("wide_newton", "wide_forward", "wide_store", "wide_down_store", "wide_tbar")
# the wide kernels with a codon instance (S=64), and its variants (--codon)
CODON = ("wide_forward", "wide_store", "wide_down_store", "wide_tbar")
CODON_VARIANTS = {"as built": (),
                  "rows 16 a thread": (("constexpr int CODON_RPT = 8;",
                                        "constexpr int CODON_RPT = 16;"),)}


def source_files(kernel: str):
    return (f"{kernel}.cu", *((WIDE_HEADER,) if kernel.startswith("wide_") else ()), HEADER)


def variant_sources(kernel: str, name: str, base=None, codon=False) -> Dict[str, str]:
    """{file: text} of csrc/<kernel>.cu and its headers with the edits of
    variant `name` (of CODON_VARIANTS with `codon`) applied; each edit must
    change one of them.  The variant `base` is the files as they are in the
    directory `base`."""
    if name == "base":
        return {f: (Path(base) / f).read_text() for f in source_files(kernel)}
    files = {f: (build.CSRC / f).read_text() for f in source_files(kernel)}
    for old, new in (CODON_VARIANTS if codon else KERNELS[kernel])[name]:
        hits = [f for f, text in files.items() if old in text]
        if not hits:
            raise ValueError(f"variant {name!r} of {kernel}: {old!r} is in neither file")
        for f in hits:
            files[f] = files[f].replace(old, new)
    return files


def variant_libraries(kernel: str, base=None, names=None,
                      codon=False) -> Dict[str, ctypes.CDLL]:
    """Every variant of `kernel` (or those in `names`; CODON_VARIANTS with
    `codon`) built (all at once) and loaded like the kernel, with `base`
    (module docstring) if a directory is given.  A variant's edited headers
    sit beside its source, so its #include finds those copies."""
    root = build.build_all() / ("probe_codon" if codon else "probe")
    procs = {}
    variants = CODON_VARIANTS if codon else KERNELS[kernel]
    for name in names or [*variants, *(["base"] if base else [])]:
        out = root / f"{kernel}_{name.replace(' ', '_')}"
        out.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(kernel, name, base, codon).items():
            (out / f).write_text(text)
        lib = out / f"lib{kernel}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        lib.with_name("ptxas.log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} of {kernel} failed to build:\n{log}")
        libs[name] = load_library(kernel, lib, lib.with_name(f"{kernel}.cu").read_text())
    return libs


class _EarlierEntry:
    """A library whose C entry iqt_<kernel> predates the CS-packed kernels'
    S argument: the launch's arguments with S (build.STATE_ARGUMENT) left
    out; every other symbol as the library has it."""

    def __init__(self, dll: ctypes.CDLL, kernel: str):
        self._dll, self._name = dll, f"iqt_{kernel}"
        self._at = build.STATE_ARGUMENT[self._name]

    def __getattr__(self, attr):
        if attr != self._name:
            return getattr(self._dll, attr)
        fn, at = getattr(self._dll, attr), self._at
        return lambda *args: fn(*args[:at], *args[at + 1:])


def load_library(kernel: str, path, source: str):
    """The library built from csrc/<kernel>.cu's `source` at `path`, loaded
    as build.library loads the kernel's: an earlier CS-packed kernel's,
    whose C entry takes no S (an S = 4 instance only), through
    _EarlierEntry."""
    dll = ctypes.CDLL(str(path))
    fn = getattr(dll, f"iqt_{kernel}")
    sig = list(build.SIGNATURES[f"iqt_{kernel}"])
    earlier = f"iqt_{kernel}" in build.STATE_ARGUMENT and "int C, int S," not in source
    if earlier:
        del sig[build.STATE_ARGUMENT[f"iqt_{kernel}"]]
    fn.argtypes = sig
    fn.restype = ctypes.c_int
    dll.iqt_error_string.argtypes = [ctypes.c_int]
    dll.iqt_error_string.restype = ctypes.c_char_p
    return _EarlierEntry(dll, kernel) if earlier else dll


def bench_calls(device, categories=4, protein=False, codon=False, slots=0):
    """({kernel: a call of its wrapper}, n_slots) at the bench shapes, GTR+G
    with `categories` rate categories (LG+G at the protein bench's with
    `protein`, GY+F3X4+G at the codon bench's with `codon`), on a slot pool
    of n_slots: the tree's slots, or `slots` if more."""
    from ..likelihood import (ModelArrays, SiteData, TreeArrays, branch_transition_mats,
                              ptn_invar, tip_partials)
    from ...io.alignment import Alignment
    from ...models.factory import parse_model_string
    from ...trees.tree import PhyloTree

    path = BENCH_DATA.with_name("bench_data_codon.npz" if codon else
                                "bench_data_protein.npz") if protein or codon else BENCH_DATA
    z = np.load(path, allow_pickle=True)
    aln = Alignment.from_sequences([str(n) for n in z["names"]],
                                   [str(s) for s in z["seqs"]],
                                   "CODON" if codon else "AA" if protein else "DNA")
    tree = PhyloTree.from_newick(str(z["tree"]), aln.names)
    ta = TreeArrays.from_tree(tree, device)
    steps, n_slots = device_slot_schedule(tree, ta)
    n_slots = max(n_slots, slots)
    steps = torch.as_tensor(steps, device=device)
    name = "GY+F3X4" if codon else "LG" if protein else "GTR"
    model = ModelArrays.from_model(
        *parse_model_string(f"{name}+G{categories}" if categories > 1 else name, aln), device)
    site = SiteData.from_alignment(aln, device, torch.float32)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    invar = ptn_invar(model, site).float().contiguous()
    up, usc = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    csk.fill_tip_rows_cs(up, usc, tips, model.ncat)
    wp = site.pattern_freq.contiguous()
    lnl = pruning.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
    if codon:
        return {"wide_forward": lambda: pruning.wide_site_lnl(
                    steps, n_slots, trans, tips, props, freq, invar),
                "wide_store": lambda: pruning.fused_upward_store(steps, n_slots, trans, tips),
                "wide_down_store": lambda: csk.fused_down_store(steps, n_slots, trans, up,
                                                                usc, freq),
                "wide_tbar": lambda: csk.fused_downward_tbar(
                    steps, n_slots, trans, tips, props, freq, lnl, wp, up=up, usc=usc)}, n_slots
    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    if protein:
        return {"wide_newton": lambda: csk.wide_newton_sweep(
                    steps, n_slots, mats, props, freq, wp, invar, up, usc),
                "wide_forward": lambda: pruning.wide_site_lnl(
                    steps, n_slots, trans, tips, props, freq, invar),
                "wide_store": lambda: pruning.fused_upward_store(steps, n_slots, trans, tips),
                "wide_down_store": lambda: csk.fused_down_store(steps, n_slots, trans, up,
                                                                usc, freq),
                "wide_tbar": lambda: csk.fused_downward_tbar(
                    steps, n_slots, trans, tips, props, freq, lnl, wp, up=up, usc=usc)}, n_slots
    return {
        "tbar": lambda: csk.fused_tbar_cs(steps, n_slots, trans, tips, props, freq, lnl, wp,
                                          up=up, usc=usc),
        "newton": lambda: csk.newton_sweep(steps, n_slots, mats, props, freq, wp, invar,
                                           up, usc),
        "forward": lambda: pruning.fused_site_lnl(steps, n_slots, trans, tips, props,
                                                  freq, invar),
        "store": lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips),
        "down_store": lambda: csk.fused_down_store_cs(steps, n_slots, trans, up, usc, freq),
    }, n_slots


def ptxas_lines(log: str, instance: str):
    """The register and spill lines of ptxas's report for the kernels
    whose mangled name holds `instance` (e.g. "ILi64E": S = 64)."""
    out, fn = [], ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("for")[-1].strip()
        elif instance in fn and ("registers" in line or "spill" in line):
            out.append(line.split(":", 1)[-1].strip())
    return out


def call_ms(fn, reps=10) -> float:
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# the module attribute each kernel's wrapper reads its block size from
BLOCK_SETTING = {"newton": (csk, "NEWTON_THREADS"), "down_store": (csk, "DOWN_STORE_PATTERNS"),
                 "wide_newton": (csk, "WIDE_NEWTON_TILE"), "forward": (pruning, "UPWARD_LANES"),
                 "store": (pruning, "UPWARD_LANES"), "tbar": (csk, "TBAR_PATTERNS"),
                 "wide_forward": (pruning, "WIDE_FORWARD_TILE"),
                 "wide_store": (pruning, "WIDE_STORE_TILE"),
                 "wide_down_store": (csk, "WIDE_DOWN_STORE_TILE"),
                 "wide_tbar": (csk, "WIDE_TBAR_TILE")}


def set_lanes(kernel: str, lanes: int) -> None:
    module, attr = BLOCK_SETTING[kernel]
    setattr(module, attr, lanes)


def same_bits(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(torch.equal(x, y) for x, y in zip(a, b))


def main(argv=None) -> int:
    from ... import resolve_device

    args = list(argv if argv is not None else sys.argv[1:])
    options = {"-C": "4", "--base": None, "--only": None, "--slots": "0"}
    for flag in options:
        if flag in args:
            i = args.index(flag)
            options[flag] = args[i + 1]
            del args[i:i + 2]
    codon = "--codon" in args
    if codon:
        args.remove("--codon")
    base = options["--base"]
    kernels = args or list(CODON if codon else KERNELS)
    if codon and (base or set(kernels) - set(CODON)):
        raise SystemExit(f"--codon takes the kernels {', '.join(CODON)} and no --base")
    dev = resolve_device()
    only = options["--only"].split(",") if options["--only"] else None
    libs = {kernel: variant_libraries(
        kernel, base, codon=codon,
        names=only and [*only, *(["base"] if base else [])]) for kernel in kernels}
    if codon:  # the S=64 instance's registers and spills, each variant
        root = build.build_dir() / "probe_codon"
        for kernel in kernels:
            for name in libs[kernel]:
                log = (root / f"{kernel}_{name.replace(' ', '_')}" / "ptxas.log").read_text()
                print(f"{kernel} {name}: " + "; ".join(ptxas_lines(log, "ILi64E")), flush=True)
    blocks0 = {k: getattr(*BLOCK_SETTING[k]) for k in kernels}
    for categories in (int(c) for c in options["-C"].split(",")):
        calls = {}
        slots = int(options["--slots"])
        if codon:
            c, n_slots = bench_calls(dev, categories, codon=True, slots=slots)
            calls.update(c)
        elif set(kernels) - set(PROTEIN):
            calls.update(bench_calls(dev, categories, slots=slots)[0])
        if set(kernels) & set(PROTEIN) and not codon:
            c, n_slots = bench_calls(dev, categories, protein=True, slots=slots)
            calls.update(c)
        for kernel in kernels:
            order = list(libs[kernel])
            if base:
                order = ["base", "as built", *order[1:-1], "as built", "base"]
            sizes = SIZES.get(kernel, LANES)
            unit = UNITS.get(kernel, "lanes a block")
            print(f"{torch.cuda.get_device_name(dev)}: {kernel}"
                  f"{' (codon, S=64)' if codon else ''} at C={categories}, ms a "
                  f"call at " + ", ".join(map(str, sizes)) + f" {unit}", flush=True)
            if kernel in CODON:  # the four wide walks' launches
                S = 64 if codon else 20
                for t in sizes:
                    try:
                        print(f"  as built at {t}, {n_slots} slots: "
                              f"{build.walk_launch(kernel, categories, S, n_slots, t)}",
                              flush=True)
                    except RuntimeError as e:
                        print(f"  as built at {t}: {e}", flush=True)
            built = build.library(kernel)
            outs = {}
            try:
                for name in order:
                    build._libs[kernel] = libs[kernel][name]
                    times = []
                    for t in sizes:
                        set_lanes(kernel, t)
                        try:
                            times.append(f"{call_ms(calls[kernel]):9.3f}")
                        except (RuntimeError, ValueError):  # a block size this design refuses
                            times.append(f"{'refused':>9s}")
                    set_lanes(kernel, BITS_AT.get(kernel, blocks0[kernel]))
                    if name in ("base", "as built"):
                        try:
                            outs[name] = calls[kernel]()
                        except RuntimeError:  # refused at the default block size
                            pass
                    print(f"{name:16s}" + "".join(times), flush=True)
            finally:
                build._libs[kernel] = built
                set_lanes(kernel, blocks0[kernel])
            if len(outs) == 2:
                print(f"base and as built at {BITS_AT.get(kernel, blocks0[kernel])} {unit}: "
                      f"{'the same bits' if same_bits(*outs.values()) else 'other bits'}",
                      flush=True)
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
