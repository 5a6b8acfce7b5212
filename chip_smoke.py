#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (iqtree_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from iqtree_torch/engine/kernels/csrc, one nvcc
     per source, all at once (the twelve ported TPU kernels, the wide
     walks' instances with several categories a block, and the
     stepwise-addition parsimony scorer, its 4-, 32- and 64-bit lanes);
  3. at the main path's shapes (bench_data.npz: 1000 taxa x 10k sites,
     GTR+G4) run each kernel and its plain PyTorch twin on the card,
     hold them together, time both (the six redesigned kernels -- forward,
     store, gradient, branch-Newton, outside-partial store, parsimony --
     beside their earlier designs' times; the forward kernel over 32-256
     lanes a block; the outside-partial store over 8-128 patterns a block;
     forward, store, gradient, branch-Newton and outside-partial store
     also at C = 1, 3 and 8 against their twins, and two launches of each
     bit-equal; the parsimony kernel
     alone, through its wrapper, and the host layout around it); check the
     custom-autograd gradient
     against autograd through the plain pass; check the golden lnL of the
     44-taxon example; score every NNI of the true tree on the kernels'
     passes and on the twins' passes;
  4. the fixed-topology path through the CLI entry point:
     `-s ALN -te TREE -m GTR+G` on cuda, with the launch counts of its
     four kernels read around that run;
  5. the same fit once more under torch.profiler: device time by kernel
     and the card's busy share of the fit;
  6. the default search through the CLI entry point:
     `-s ALN -m GTR+G -n 5 -ninit 8 -ntop 3 -seed 1` on cuda (the flags of
     the reference binary's recorded run), with all six kernels' launch
     counts read around it, its per-phase profile and its score checked;
  7. one NNI hill climb from the ML-distance BIONJ tree under
     torch.profiler: device time by kernel, busy share;
  8. at the protein path's shapes (bench_data_protein.npz: 300 taxa x
     2 000 aa, 1 958 patterns, LG+G4) the four wide kernels against their
     twins, timed with their tile sweep (the forward kernel, the store,
     the gradient sweep and the branch-Newton sweep over 16 / 32 / 64
     patterns a cluster, beside their earlier designs' times, two launches
     bit-equal, also at C = 1 and 8 with the outside-partial store, their
     shared memory by their formulas at S = 20 and S = 61); the
     custom-autograd gradient against autograd through the plain pass;
  9. the protein fixed-topology path through the CLI entry point:
     `-s ALN -te TREE -m LG+G` on cuda, with the wide kernels' launch
     counts read around that run;
 10. the same fit once more under torch.profiler;
 11. at the protein search's shapes the wide outside-partial store against
     its twin, timed over 16 / 32 / 64 patterns a cluster beside its
     earlier design's time, two launches bit-equal, its shared memory by
     its formula at S = 20 and S = 61, and the parsimony scorer's 32-bit
     instance against its twin on a partial protein tree (exact), each of
     50 launches timed alone (min / median / max), kernel and wrapper;
 12. the protein search with ultrafast bootstrap through the CLI entry
     point: `-s ALN -m LG+G -n 2 -ninit 4 -ntop 2 -seed 1 -bb 1000 -wbt` on
     cuda, with the launch counts of the five wide kernels and the
     parsimony scorer read around it, its score re-evaluated in float64,
     its bootstrap outputs checked; then one protein hill climb from the
     ML-distance BIONJ tree under torch.profiler;
 13. the multi-tree forward at the main path's full width: the bench tree
     and a chain of 15 more, each three random NNIs from the last, under
     GTR+G4; K=8 of them scored in one launch through fused_multi_tree_lnl,
     held against its twin on the card ([K, P], 1e-3) and against K
     forward.cu fits (0.1 a tree), timed at K = 1, 4, 8, 16 beside
     forward.cu's single tree, and at K=8 over three tiles;
 14. the forward kernel's eight ablation variants at the bench tree's shapes
     (random trans and tips from numpy seed 0), the two precision variants
     (the TPU matrix unit's 3 and 1 bfloat16 passes) among them, timed
     through the ablation entry point and held against their twins;
 15. at the codon path's shapes (bench_data_codon.npz: 80 taxa x 500
     codons, 457 patterns, GY+F3X4+G4, the 61 states padded to the S=64
     instances) the four wide kernels against their twins (forward 1e-3
     absolute, store and down-store 1e-4, tbar 1e-4 relative), two
     launches bit-equal, timed (the padding copies inside the wrappers
     timed alone too), their registers and spills (ptxas) and shared
     memory by formula; also at C = 1 and 8, and at a small shape under
     genetic codes 2 (S=60) and 6 (S=63);
 16. the codon fixed-topology path through the CLI entry point:
     `-s ALN -st CODON -te TREE -m GY+F3X4+G` on cuda, with the launch
     counts of the four wide kernels read around that run (the
     branch-Newton kernels must not launch: codon branch lengths take the
     theta path), the lnL above the reference binary's, the written tree
     and model re-evaluated in float64;
 17. the codon fit again under torch.profiler;
 18. the parsimony scorer's 64-bit instance (a codon state set in one
     64-bit lane) against its twin on the card, exactly: every insertion
     of one stepwise order on bench_data_codon.npz, the stepwise tree of
     seed 1, and the last insertion of a full tree timed (50 launches each
     alone, kernel and wrapper) there and at 1 000 taxa x 2 000 random
     sense codons (seed 181), with its registers and spills (ptxas);
 19. the codon search with ultrafast bootstrap through the CLI entry
     point: `-st CODON -m GY+F3X4+G -n 2 -ninit 4 -ntop 2 -seed 1 -bb 1000
     -wbt` on bench_data_codon.npz, with the launch counts of the four
     wide codon instances, the 64-bit parsimony scorer and every other
     kernel read around it (wide_newton and the CS-packed kernels must
     not launch), its score re-evaluated in float64, its bootstrap
     outputs checked, its peak device memory, the NNI evaluator's working
     memory at S=61 against decide_engine's model; then the search again
     under torch.profiler;
 20. at C20's 80 categories (POISSON, 20 frequency classes, Gamma(4)) on
     bench_data_protein.npz (random branch lengths around the bench
     tree's, numpy seed 20) the four wide walks' instances with several
     categories a block (10 a block on 8-block clusters) against their
     twins at the tolerances of phase 8, two launches bit-equal, timed
     beside the C=4 instances, their registers and spills (ptxas), their
     shared memory by formula; C60 (240 categories) run where its shared
     memory fits the bench tree's slots, else refused by the wrappers;
 21. the mixture fixed-topology path through the CLI entry point:
     `-s ALN -te TREE -m C20` on cuda, with every kernel's launch count
     read around it (the four wide walks launch; the branch-Newton and
     CS-packed kernels do not: past 8 categories branch lengths take the
     theta path), the written tree and model re-evaluated in float64,
     then the fit again under torch.profiler (the card's busy share);
 22. the C20 search with ultrafast bootstrap through the CLI entry point:
     `-s ALN -m C20 -n 2 -ninit 4 -ntop 2 -seed 1 -bb 1000 -wbt`, with the
     launch counts read around it, its score re-evaluated in float64, its
     per-phase profile, its bootstrap outputs checked and its peak device
     memory;
 23. at the DNA bench's shapes (bench_data.npz, GTR+I+R9, +R10 and +R16,
     weights and rates from numpy seed 23) the four wide walks' DNA
     instances (S=4, several categories a block: past 8 categories the
     CS-packed kernels do not serve) and wide_newton's multi-category
     instance (a block all categories of a tile of patterns) against
     their twins at the tolerances of phase 15 (the branch-Newton sweep
     1e-4 relative to its largest entry), two launches bit-equal, timed
     (three 10-launch means), their registers and spills (ptxas), the
     choosers' launch at C=10 on the bench tree's slots and at
     ceil(log2 N)+1; also at an +R10 rate vector from 1e-3 to 20;
 24. FreeRate fits through the CLI entry point: `-s ALN -te TREE -m
     GTR+R4` (C=4: the CS-packed kernels launch, the wide walks do not)
     and `-m GTR+I+R10` (C=10: the DNA instances of the walks and of
     wide_newton launch, the CS-packed kernels do not), each with its
     launch counts, wall time, the written tree and model re-evaluated in
     float64, and once more under torch.profiler; then the search `-m
     GTR+I+R10 -n 1 -ninit 2 -ntop 1 -seed 1` on the bench's first 100
     taxa (the outside-partial store's DNA instance serves its NNI
     evaluator), its launches, wall time and score re-evaluated;
 25. `-s ALN -m LG+R4 -n 2 -ninit 4 -ntop 2 -seed 1 -bb 1000 -wbt` on the
     protein bench (phase 12's flags): launches of the wide kernels and
     the parsimony scorer, the score re-evaluated in float64, the UFBoot
     outputs, the per-phase profile, and the search under torch.profiler;
 26. `-s ALN -te TREE -m LG4X` on the protein bench (the mixture fused with
     FreeRate, C=4): its lnL re-evaluated in float64 with the fit's class
     weights (FreeRate's) and, for information, with the mixture's defined
     ones (what ModelArrays.from_mixture takes after the fit, as the JAX
     package does), its launches, wall time and profile;
 27. at the DNA bench recoded purine/pyrimidine (A, G, R -> 0; C, T, U, Y
     -> 1; the rest unknown: 1000 taxa x 10k sites, 9 331 patterns,
     GTR2+I+G at C = 4, 1 and 8) the S=2 instances of the five CS-packed
     kernels against their twins at phase 3's tolerances, two launches
     bit-equal, the C = 4 instances timed (the kernels line's `*_s2`
     rows) with their registers and spills (ptxas);
 28. `-st BIN -te TREE -m GTR2+G` on that recoding through the CLI: the
     forward, store, gradient and branch-Newton kernels launch (S=2), no
     wide kernel and no outside store; the written tree and model
     re-evaluated in float64;
 29. `-st BIN -m GTR2+ASC+G -n 2 -ninit 4 -ntop 2 -seed 1 -bb 1000 -wbt`
     on the variable columns of its first 200 taxa: +ASC takes the theta
     path, so the outside store (S=2) launches and the branch-Newton
     kernel does not, nor does any wide kernel; the 4-bit parsimony lanes;
     the score re-evaluated in float64, the UFBoot outputs checked;
 30. morphology on the Dayhoff-6 recoding of the protein bench (AGPST,
     DENQ, HKR, ILMV, FWY, C -> 0..5: 300 taxa x 2 000, 6 states
     zero-padded to the S=20 wide kernels): the five wide kernels against
     their twins at MK+G4, timed through their wrappers (the padding
     copies included); `-st MORPH -te TREE -m MK+G`, `-te TREE -m
     ORDERED+ASC+G` on the variable columns (the theta path: the wide
     outside store, no branch-Newton kernel) and `-m MK+G` with phase
     12's flags through the CLI, each with its launches, wall time and
     float64 re-evaluation;
 31. `-te TREE -m GTR+ASC+G` on bench_data.npz's variable columns through
     the CLI: the S=4 CS-packed kernels and the outside store (the theta
     path), no branch-Newton kernel, the lnL re-evaluated in float64.
Each phase's heading prints the seconds since the script started.
Prints the kernels' JSON line (the DNA kernels' launches from the DNA
search, the wide kernels' and the 32-bit parsimony scorer's from the
protein search, the multi-tree and ablation kernels' from phases 13 and
14, which no CLI path reaches, the codon instances' and the 64-bit
parsimony scorer's from the codon search of phase 19, the C=80 instances'
from the C20 search of phase 22, the DNA instances' from the GTR+I+R10 fit
of phase 24 and the outside store's from its R10 search, the binary
instances' from the GTR2+G fit of phase 28 and the outside store's from
the GTR2+ASC+G search of phase 29), then as its last line {"ok": true,
"device": {...}}.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REF_OPTIMUM = -2656751.0  # IQ-TREE 1.4.3 binary, same -te fit (ROADMAP.md)
JAX_LNL = -2656736.32  # the JAX package's result on the same fit
REF_SEARCH_LNL = -2657075.925  # the binary's -n 5 search (bench_baseline.json)
JAX_SEARCH_LNL = -2656903.31  # the JAX package's search, float32 (BENCH_r05.json)
SEARCH_FLAGS = ["-m", "GTR+G", "-n", "5", "-ninit", "8", "-ntop", "3", "-seed", "1"]
GOLDEN_LNL = -17848.038178  # tests/test_golden.py
REF_PROTEIN_LNL = -237898.106  # the binary's -te LG+G fit (bench_baseline.json)
JAX_PROTEIN_LNL = -237897.36  # the JAX package's float32 fit on a TPU (BENCH_r05.json)
PROTEIN_SEARCH_FLAGS = ["-m", "LG+G", "-n", "2", "-ninit", "4", "-ntop", "2", "-seed",
                        "1", "-bb", "1000", "-wbt"]
JAX_PROTEIN_SEARCH_LNL = -237901.3  # the JAX package's search without -bb, float32,
#                                     on a TPU (README.md)
REF_CODON_LNL = -14816.964  # the binary's -te GY+F3X4+G fit (bench_baseline.json)
PORT_CODON_TE_LNL = -14816.79  # the port's -te GY+F3X4+G fit of the true tree (PERF.md)
CODON_SEARCH_FLAGS = ["-st", "CODON", "-m", "GY+F3X4+G", "-n", "2", "-ninit", "4", "-ntop",
                      "2", "-seed", "1", "-bb", "1000", "-wbt"]
PEAK_F32 = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s
PEAK_BF16 = 989e12  # H100 SXM bfloat16 on the tensor cores (float32 sums), FLOP/s
PEAK_BW = 3.35e12  # H100 SXM HBM3, bytes/s
# The times of the earlier designs the redesigned kernels replace (PERF.md
# section 6, the same card and timing): ms a call of fused_site_lnl,
# fused_upward_store_cs, newton_sweep, fused_down_store_cs,
# wide_newton_sweep, wide_site_lnl, fused_tbar_cs, fused_upward_store,
# fused_down_store and fused_downward_tbar, and of insertion_costs (its
# events held the wrapper's host work)
EARLIER_MS = {"forward": 3.139, "store": 3.315, "newton": 12.361, "pars_insert": 1.683,
              "pars_insert_s20": 0.556, "down_store": 14.706, "wide_newton": 7.063,
              "wide_forward": 2.102, "tbar": 13.848, "wide_store": 2.236,
              "wide_down_store": 3.961, "wide_tbar": 5.862}
# The C = 80 instances' times on their first design (one warp or one team
# a block, the categories in series; PERF.md section 6, rows 7m-10m), ms a
# call of wide_site_lnl, fused_upward_store, fused_downward_tbar and
# fused_down_store at C20 on the protein bench
EARLIER_C80_MS = {"wide_forward": 32.665, "wide_store": 35.669, "wide_tbar": 88.552,
                  "wide_down_store": 62.079}
SMEM_BLOCK = 232448  # bytes of shared memory an H100 block may have
SMEM_ROUND_TRIP = 30  # cycles from a shared-memory load to its use, about


START = time.time()


def phase(name):
    print(f"\n=== {name} === [{time.time() - START:.0f} s]", flush=True)


def cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cuda_ms_each(fn, reps):
    """Each of `reps` calls of fn() timed alone: [ms]."""
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return out


def spread(ms):
    import numpy as np

    return f"min {min(ms):.4f} / median {float(np.median(ms)):.4f} / max {max(ms):.4f} ms"


def check(ok, what):
    """Fail the run (an explicit raise: asserts vanish under -O)."""
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def beside_earlier(results, name):
    ms = results[name]["ms"]
    print(f"{name}: {ms:.3f} ms beside the earlier design's {EARLIER_MS[name]} "
          f"({EARLIER_MS[name] / ms:.2f}x)")


def store_err(up_k, usc_k, up_p, usc_p, inner):
    """An upward store against its twin on the internal rows `inner` (tip
    rows are the caller's): partials absolutely (in [0, 1]), scales
    relative to the largest."""
    return max(float((up_k[inner] - up_p[inner]).abs().max()),
               float((usc_k[inner] - usc_p[inner]).abs().max()
                     / usc_p[inner].abs().max()))


def tbar_err(got, want, R):
    """A wide gradient sweep against its twin on the edges' rows, relative to
    the twin's largest entry.  The root and dummy rows (the device numbering
    puts them last) must be the kernel's zeros; the twin's dummy row reads
    the upward store's unwritten dummy partials."""
    check(not bool(got[R - 2:].any()), "the gradient sweep's root and dummy rows are 0")
    return float((got[:R - 2] - want[:R - 2]).abs().max() / want[:R - 2].abs().max())


def outside_err(got, want, R):
    """An outside-partial store against its twin on every row but the root
    and the dummy (R - 2, R - 1; never written): O absolutely (in [0, 1]),
    osc relative to the largest."""
    (o_k, s_k), (o_p, s_p) = got, want
    rows = slice(0, R - 2)
    return max(float((o_k[rows] - o_p[rows]).abs().max()),
               float((s_k[rows] - s_p[rows]).abs().max() / s_p[rows].abs().max()))


def bit_equal(name, a, b):
    import torch

    check(all(torch.equal(x, y) for x, y in zip(a, b)), f"{name}: two launches bit-equal")
    print(f"{name}: two launches bit-equal")


def bound(bytes_, flops, bf16_flops=0):
    """(least ms on an H100 SXM for this work, what bounds it): float32
    operations at the CUDA cores' rate, products of bfloat16 operands with
    float32 sums at the tensor cores' rate."""
    tb = bytes_ / PEAK_BW * 1e3
    tf = (flops / PEAK_F32 + bf16_flops / PEAK_BF16) * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def tbar_flops(N, P, CS, CSS):
    """Operations of the gradient sweep: per step both child messages and
    both cotangent blocks, and the push P^T O into each of the N-2 internal
    non-root children (a multiply-add counts 2)."""
    return 2 * P * ((N - 1) * (4 * CSS + 6 * CS) + (N - 2) * CSS)


def newton_flops(N, P, CS, CSS):
    """Operations of the branch-Newton sweep: per step (P, P', P'') U for
    both children, and the push P^T O into each internal non-root child."""
    return 2 * P * ((N - 1) * (6 * CSS + 12 * CS) + (N - 2) * CSS)


def param_grads(fn, ta, opt, params):
    """(lnL, d lnL / d(branch lengths, each optimizer parameter)) of
    fn(tree arrays, model arrays) at `params`."""
    import torch

    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    blen = ta.blen.detach().clone().requires_grad_()
    total = fn(ta.with_blen(blen), opt.build(leaves))
    g = torch.autograd.grad(total, [blen, *leaves.values()])
    return float(total.detach()), g


def partial_tree(tree, N):
    """The layout of `tree` without its last taxon, for scoring where that
    taxon goes back: (leaf, present taxa, layout)."""
    from iqtree_torch.engine import parsimony as pars

    leaf, adj = partial_adj(tree, N)
    present = [v for v in adj if v < N]
    return leaf, present, pars._partial_layout(adj, 0, N)


def partial_adj(tree, N):
    """(leaf, adjacency of `tree` without its last taxon, the leaf)."""
    adj = {v: [] for v in range(tree.n_nodes - 1)}
    R = tree.root
    for v in range(tree.n_nodes - 1):
        p = int(tree.parent[v])
        if p == R:
            continue
        adj[v].append(p)
        adj[p].append(v)
    c = int(tree.children[R, 1] if tree.children[R, 0] == 0 else tree.children[R, 0])
    adj[0].append(c)
    adj[c].append(0)
    leaf = N - 1
    (w,) = adj.pop(leaf)
    x, y = [u for u in adj.pop(w) if u != leaf]
    adj[x] = [y if u == w else u for u in adj[x]]
    adj[y] = [x if u == w else u for u in adj[y]]
    return leaf, adj


def insert_taxon(pars, adj, first, v_old, t, nxt):
    """Attach taxon t on the edge above adjacency node v_old (new node nxt),
    as parsimony_stepwise_tree does."""
    p_old = pars._adj_parent(adj, first, v_old)
    adj[v_old].remove(p_old)
    adj[p_old].remove(v_old)
    adj[v_old].append(nxt)
    adj[p_old].append(nxt)
    adj[nxt] = [v_old, p_old, t]
    adj[t] = [nxt]


def pars_launch(pars, layout, present, words, leaf, scratch):
    """(the C entry's arguments for one insertion as insertion_costs makes
    them, walk rows): for timing the kernel without its wrapper's host
    work."""
    import torch

    rows, n_post = pars.kernel_rows(layout, present)
    N, n_words = words.shape
    miss, wts = scratch
    cost = torch.zeros(2 * N, dtype=torch.float64, device=words.device)
    return (("pars_insert", torch.as_tensor(rows, device=words.device), n_post,
             len(rows) - n_post, words, N, leaf, wts, n_words, miss, cost,
             pars.lane_bits(words, wts)), len(rows))


def pars_work(N, n_words, lanes, n_rows, word_bytes=4):
    """(bytes, operations) of one insertion: the packed tips (`word_bytes`
    a word), the weights and the walk rows read once, the costs written
    once; ~14 integer operations a word and row (SWAR Fitch and the miss
    bits), counted at the float32 rate (the card's table has no int32
    rate)."""
    return (word_bytes * N * n_words + 4 * n_words * lanes + 16 * n_rows + 16 * N,
            14 * n_rows * n_words)


def load_bench(name="bench_data.npz"):
    import numpy as np

    z = np.load(os.path.join(HERE, name), allow_pickle=True)
    return [str(n) for n in z["names"]], [str(s) for s in z["seqs"]], str(z["tree"])


def write_inputs(tmp, names, seqs, tree_nwk, search=None, model="GTR+G"):
    """The CLI arguments of the fixed-topology fit of `model` (or of the
    search with the flags `search`), its alignment and tree written to
    `tmp`: (argv, output prefix)."""
    aln_path = os.path.join(tmp, "bench.phy")
    with open(aln_path, "w") as f:
        f.write(f"{len(names)} {len(seqs[0])}\n")
        f.writelines(f"{n} {s}\n" for n, s in zip(names, seqs))
    tree_path = os.path.join(tmp, "bench.nwk")
    with open(tree_path, "w") as f:
        f.write(tree_nwk + "\n")
    prefix = os.path.join(tmp, "bench")
    common = ["-pre", prefix, "-device", "cuda", "-redo"]
    if search:
        return ["-s", aln_path, *search, *common], prefix
    return ["-s", aln_path, "-te", tree_path, "-m", model, *common], prefix


def profile_run(fn, wall, what):
    """Run fn() under torch.profiler; print the device time by kernel, the
    host ops that launched the most of it, and the card's busy share of
    the unprofiled run's wall time `wall`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        p_wall = time.time() - t0
    # device-side events (kernels, copies) hold the device time once; a host
    # op's self device time repeats that of the kernels it launched
    avgs = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    dev = [e for e in avgs if e.device_type == DeviceType.CUDA]
    host = [e for e in avgs if e.device_type != DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e6
    print(f"profiled {what}: {p_wall:.2f} s wall under the profiler; device busy "
          f"{busy:.3f} s = {busy / wall:.1%} of the unprofiled {wall:.2f} s wall "
          f"({busy / p_wall:.1%} of the profiled)")
    for title, rows in (("device time by kernel", dev),
                        ("host ops by the device time they launched", host)):
        print(f"{title}:")
        for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
            print(f"  {e.self_device_time_total / 1e3:10.1f} ms  {e.count:6d} x  "
                  f"{e.key[:90]}")


def run_cli(cli_main, args, counters):
    """One CLI run with every launch count set to 0 just before it: (wall
    seconds, launches by kernel, log lines, written tree text)."""
    import torch

    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    rc = cli_main(args)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    check(rc == 0, f"CLI exited {rc}")
    prefix = args[args.index("-pre") + 1]
    with open(prefix + ".log") as f:
        log = f.read().splitlines()
    with open(prefix + ".treefile") as f:
        nwk = f.read()
    return wall, launches, log, nwk


def logged(log, key):
    """The value after `key` on the last log line that starts with it."""
    return [l for l in log if l.startswith(key)][-1][len(key):].strip()


def reevaluate(nwk, model_str, aln, dev, grad=True):
    """The written tree and model, evaluated in float64 by the plain pass:
    (lnL, tree arrays with blen as a leaf, autograd d lnL/d blen, or None
    without `grad`: at C20's 80 categories the float64 partials alone are
    15 GB, and autograd would keep every level's)."""
    import torch
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                compute_loglik)
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree

    s64, r64 = parse_model_string(model_str, aln)
    ta = TreeArrays.from_tree(PhyloTree.from_newick(nwk, aln.names), dev)
    site = SiteData.from_alignment(aln, dev, torch.float64, asc=s64.asc)
    if not grad:
        with torch.no_grad():
            lnl, _ = compute_loglik(ta, ModelArrays.from_model(s64, r64, dev), site)
        return float(lnl), ta, None
    blen = ta.blen.clone().requires_grad_()
    lnl, _ = compute_loglik(ta.with_blen(blen), ModelArrays.from_model(s64, r64, dev), site)
    g = torch.autograd.grad(lnl, blen)[0]
    return float(lnl.detach()), ta.with_blen(blen.detach()), g


def main():
    if not (os.path.isdir(os.path.join(HERE, "iqtree_torch"))
            and os.path.exists(os.path.join(HERE, "bench_data.npz"))):
        print("chip_smoke.py must run from a checkout of the repository "
              "(iqtree_torch/ and bench_data.npz beside it)", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("CUDA is not available: this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import numpy as np

    phase("1. card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True).stdout.split()[0])
    print(f"max SM clock {sm_mhz:.0f} MHz")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")

    phase("2. build")
    from iqtree_torch.engine.kernels import build

    t0 = time.time()
    bdir = build.build_all()
    print(f"built {len(build.SOURCES)} kernels in {time.time() - t0:.1f} s -> {bdir}")
    for n in build.SOURCES:  # ptxas report of the DNA C=4 and protein S=20 instances
        fn = ""
        for line in (bdir / f"{n}.log").read_text().splitlines():
            if "Function properties for" in line:
                fn = line.split("for")[-1].strip()
            elif (("ILi4E" in fn or "ILi20E" in fn or "pars_insert" in fn
                   or "ablate_kernel" in fn) and ("registers" in line or "spill" in line)):
                # the ablation kernel's instances are its variants, 0-5
                v = f" variant {fn.split('ILi')[1][0]}" if "ablate_kernel" in fn else ""
                print(f"  {n}{v}: {line.split(':', 1)[-1].strip()}")

    phase("3. kernels against their plain twins (1000 taxa x 10k sites)")
    from iqtree_torch.engine import grad as grad_mod
    from iqtree_torch.engine.derivatives import MIN_BLEN, optimize_branch_mask
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.likelihood import (
        ModelArrays, SiteData, TreeArrays, branch_transition_mats,
        compute_loglik, ptn_invar, tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.models.optimize import ModelOptimizer
    from iqtree_torch.trees.tree import PhyloTree

    names, seqs, tree_nwk = load_bench()
    aln = Alignment.from_sequences(names, seqs, "DNA")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    subst, rate = parse_model_string("GTR+G", aln)
    opt = ModelOptimizer(subst, rate, dev)
    rng = np.random.default_rng(7)
    params = {k: v + torch.as_tensor(rng.normal(0, 0.3, v.shape), device=dev)
              for k, v in opt.init_params().items()}
    model = opt.build(params)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P = aln.n_taxa, aln.n_patterns
    C, S = rate.ncat, subst.num_states
    CS, CSS, R = C * S, C * S * S, 2 * N
    print(f"{N} taxa, {P} patterns, C={C}, S={S}, {n_slots} slots")
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    invar = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    results = {}

    def record(name, source, replaces, err, tol, ms, plain_ms, bytes_, flops,
               bf16_flops=0):
        bms, by = bound(bytes_, flops, bf16_flops)
        print(f"{name}: max_abs_err {err:.3e} (tol {tol:g}), kernel {ms:.3f} ms, "
              f"plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by})")
        check(err <= tol, f"{name}: kernel and plain twin agree ({err:.3e} vs {tol:g})")
        results[name] = dict(name=name, route="cuda", source=source,
                             replaces=replaces, launches=0, max_abs_err=err,
                             ms=ms, plain_ms=plain_ms, bound_ms=bms,
                             bound_by=by, library_ms=None)

    # forward and store: a sweep of lanes a block, then kernel vs twin
    lanes0 = pk.UPWARD_LANES
    for lanes in (32, 64, 128, 256):
        pk.UPWARD_LANES = lanes
        ms = cuda_ms(lambda: pk.fused_site_lnl(steps, n_slots, trans, tips, props,
                                               freq, invar), 5)
        st_ms = cuda_ms(lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips), 5)
        print(f"{lanes} lanes a block: forward {ms:.3f} ms, store {st_ms:.3f} ms")
    pk.UPWARD_LANES = lanes0
    k_out = pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
    bit_equal("forward", [k_out],
              [pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)])
    p_out = pk._site_lnl_plain(steps, trans, tips, props, freq, invar)
    fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P
    record("forward", "iqtree_torch/engine/kernels/csrc/forward.cu",
           "iqtree_tpu/engine/kernels/pruning.py:96",
           float((k_out - p_out).abs().max()), 1e-3,
           cuda_ms(lambda: pk.fused_site_lnl(steps, n_slots, trans, tips, props,
                                             freq, invar), 10),
           cuda_ms(lambda: pk._site_lnl_plain(steps, trans, tips, props, freq,
                                              invar), 2),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + 3 * P), fwd_flops)
    beside_earlier(results, "forward")

    inner = slice(N, 2 * N - 1)

    up_k, usc_k = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    again = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    bit_equal("store", [up_k[inner], usc_k], [again[0][inner], again[1]])
    del again
    # the lane layout keeps the thread-a-pattern step's arithmetic: the
    # ablation kernel's `full` (that step) gives the root's scale
    from iqtree_torch.engine.kernels import ablate

    root = int(steps_np[-1, 5])
    same = torch.equal(usc_k[root], ablate.forward_ablation("full", steps, n_slots,
                                                            trans, tips))
    print(f"store: the root's log-scale {'equals' if same else 'differs from'} the "
          f"thread-a-pattern step's (forward_ablate full) bit for bit")
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    err = store_err(up_k, usc_k, up_p, usc_p, inner)
    record("store", "iqtree_torch/engine/kernels/csrc/store.cu",
           "iqtree_tpu/engine/kernels/cs_kernels.py:56", err, 1e-4,
           cuda_ms(lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips), 5),
           cuda_ms(lambda: pk.upward_plain(steps, trans, tips), 2),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P),
           fwd_flops)
    beside_earlier(results, "store")
    del up_p, usc_p

    lnl = k_out.contiguous()
    wp = site.pattern_freq.contiguous()
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)
    tb_k = csk.fused_tbar_cs(steps, n_slots, trans, tips, props, freq, lnl, wp,
                             up=up_k, usc=usc_k)
    tb_p = csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k, usc_k)
    scale = float(tb_p.abs().max())
    rev_bytes = 4 * (R * (CS + 1) * P + 2 * P + R * CSS)
    record("tbar", "iqtree_torch/engine/kernels/csrc/tbar.cu",
           "iqtree_tpu/engine/kernels/cs_kernels.py:1027",
           float((tb_k - tb_p).abs().max()) / scale, 1e-4,
           cuda_ms(lambda: csk.fused_tbar_cs(steps, n_slots, trans, tips, props,
                                             freq, lnl, wp, up=up_k, usc=usc_k), 5),
           cuda_ms(lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp,
                                           up_k, usc_k), 2),
           rev_bytes, tbar_flops(N, P, CS, CSS))
    beside_earlier(results, "tbar")
    bit_equal("tbar", [tb_k], [csk.fused_tbar_cs(steps, n_slots, trans, tips, props, freq,
                                                 lnl, wp, up=up_k, usc=usc_k)])
    del tb_p, tb_k

    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    d_k = csk.newton_sweep(steps, n_slots, mats, props, freq, wp, invar, up_k, usc_k)
    d_p = csk._newton_plain(steps, mats, props, freq, wp, invar, up_k, usc_k)
    again = csk.newton_sweep(steps, n_slots, mats, props, freq, wp, invar, up_k, usc_k)
    check(all(torch.equal(a, b) for a, b in zip(d_k, again)),
          "newton: two launches bit-equal")
    print("newton: two launches bit-equal")
    err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(d_k, d_p))
    record("newton", "iqtree_torch/engine/kernels/csrc/newton.cu",
           "iqtree_tpu/engine/kernels/cs_kernels.py:280", err, 1e-4,
           cuda_ms(lambda: csk.newton_sweep(steps, n_slots, mats, props, freq, wp,
                                            invar, up_k, usc_k), 10),
           cuda_ms(lambda: csk._newton_plain(steps, mats, props, freq, wp, invar,
                                             up_k, usc_k), 2),
           rev_bytes + 4 * R * 3 * CSS, newton_flops(N, P, CS, CSS))
    beside_earlier(results, "newton")
    del d_p, again, up_k, usc_k, mats
    # the lane layouts at the other category counts: C = 1 (one lane), 3
    # (an idle lane a pattern) and 8 (eight lanes), the same tree and data
    for k in (1, 3, 8):
        s_k, r_k = parse_model_string("GTR+I" + (f"+G{k}" if k > 1 else ""), aln)
        r_k.p_invar = 0.05
        m_k = ModelArrays.from_model(s_k, r_k, dev)
        tr_k = branch_transition_mats(m_k, ta.blen).float().contiguous()
        fargs = (steps, n_slots, tr_k, tips, m_k.props.float(), m_k.state_freq.float(),
                 ptn_invar(m_k, site).float().contiguous())
        f_k = pk.fused_site_lnl(*fargs)
        bit_equal(f"forward C={k}", [f_k], [pk.fused_site_lnl(*fargs)])
        e_k = float((f_k - pk._site_lnl_plain(*fargs[:1], *fargs[2:])).abs().max())
        print(f"forward C={k}: max_abs_err {e_k:.3e} (tol 1e-3), "
              f"{cuda_ms(lambda: pk.fused_site_lnl(*fargs), 5):.3f} ms")
        check(e_k <= 1e-3, f"forward at C={k} against its twin")
        u_k, us_k = csk.fused_upward_store_cs(steps, n_slots, tr_k, tips)
        again = csk.fused_upward_store_cs(steps, n_slots, tr_k, tips)
        bit_equal(f"store C={k}", [u_k[inner], us_k], [again[0][inner], again[1]])
        del again
        e_k = store_err(u_k, us_k, *pk.upward_plain(steps, tr_k, tips), inner)
        print(f"store C={k}: error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.fused_upward_store_cs(steps, n_slots, tr_k, tips), 5):.3f} ms")
        check(e_k <= 1e-4, f"store at C={k} against its twin")
        csk.fill_tip_rows_cs(u_k, us_k, tips, k)
        mt_k = csk.stacked_deriv_mats(m_k, ta.blen).float().contiguous()
        args = (steps, n_slots, mt_k, m_k.props.float(), m_k.state_freq.float(), wp,
                ptn_invar(m_k, site).float().contiguous(), u_k, us_k)
        got, want = csk.newton_sweep(*args), csk._newton_plain(*args[:1], *args[2:])
        e_k = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
        print(f"newton C={k}: max relative error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.newton_sweep(*args), 5):.3f} ms")
        check(e_k <= 1e-4, f"newton at C={k} against its twin")
        targs = (steps, n_slots, tr_k, tips, m_k.props.float(), m_k.state_freq.float(),
                 f_k, wp)
        got = csk.fused_tbar_cs(*targs, up=u_k, usc=us_k)
        bit_equal(f"tbar C={k}", [got], [csk.fused_tbar_cs(*targs, up=u_k, usc=us_k)])
        want = csk._tbar_plain(*targs[:1], *targs[2:3], *targs[4:], u_k, us_k)
        e_k = float((got - want).abs().max() / want.abs().max())
        print(f"tbar C={k}: max relative error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.fused_tbar_cs(*targs, up=u_k, usc=us_k), 5):.3f} ms")
        check(e_k <= 1e-4, f"tbar at C={k} against its twin")
        dargs = (steps, n_slots, tr_k, u_k, us_k, m_k.state_freq.float())
        got = csk.fused_down_store_cs(*dargs)
        bit_equal(f"down_store C={k}", got, csk.fused_down_store_cs(*dargs))
        e_k = outside_err(got, csk._down_store_plain(*dargs[:1], *dargs[2:]), R)
        print(f"down_store C={k}: error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.fused_down_store_cs(*dargs), 5):.3f} ms")
        check(e_k <= 1e-4, f"down_store at C={k} against its twin")
        del u_k, us_k, mt_k, tr_k, got, want, args, f_k, fargs, dargs, targs
    up_k, usc_k = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)

    # outside-partial store: O in [0, 1] absolutely, osc relative to its
    # largest; timed over patterns a block (a warp's row store a run of
    # 32 bytes at 8, of 128 from 32 on)
    pb0 = csk.DOWN_STORE_PATTERNS
    for pb in (8, 32, 64, 128):
        csk.DOWN_STORE_PATTERNS = pb
        ms = cuda_ms(lambda: csk.fused_down_store_cs(steps, n_slots, trans, up_k, usc_k,
                                                     freq), 5)
        print(f"down_store, {pb} patterns a block: {ms:.3f} ms")
    csk.DOWN_STORE_PATTERNS = pb0
    out_k, osc_k = csk.fused_down_store_cs(steps, n_slots, trans, up_k, usc_k, freq)
    bit_equal("down_store", (out_k, osc_k),
              csk.fused_down_store_cs(steps, n_slots, trans, up_k, usc_k, freq))
    err = outside_err((out_k, osc_k),
                      csk._down_store_plain(steps, trans, up_k, usc_k, freq), R)
    record("down_store", "iqtree_torch/engine/kernels/csrc/down_store.cu",
           "iqtree_tpu/engine/kernels/cs_kernels.py:734", err, 1e-4,
           cuda_ms(lambda: csk.fused_down_store_cs(steps, n_slots, trans, up_k, usc_k,
                                                   freq), 10),
           cuda_ms(lambda: csk._down_store_plain(steps, trans, up_k, usc_k, freq), 2),
           4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
           P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
    beside_earlier(results, "down_store")
    del up_k, usc_k, out_k, osc_k

    # stepwise-addition parsimony: the last insertion of a full tree (the
    # bench tree without one taxon); integer pattern weights, exact sums.
    # Bound: pars_work
    from iqtree_torch.engine import parsimony as pars

    leaf, present, layout = partial_tree(tree, N)
    masks = torch.as_tensor(pars.pack_tip_masks(aln), device=dev)
    pfreq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64, device=dev)
    words = pars.kernel_tip_words(masks, S)
    scratch = pars.kernel_scratch(words, pfreq, S)
    cost_k = pars.insertion_costs(masks, words, pfreq, leaf, layout, present, scratch)
    cost_p = pars._edge_costs(
        pars._insertion_costs_plain(masks, pfreq, leaf, layout, present), layout)
    fin = np.isfinite(cost_p)
    check(np.array_equal(np.isfinite(cost_k), fin), "parsimony: the same edges")
    launch_args, n_rows = pars_launch(pars, layout, present, words, leaf, scratch)
    lanes = pars.word_lanes(S)
    record("pars_insert", "iqtree_torch/engine/kernels/csrc/pars_insert.cu",
           "iqtree_tpu/engine/parsimony.py:168 (plain XLA, no Pallas kernel)",
           float(np.abs(cost_k[fin] - cost_p[fin]).max()), 0.0,
           cuda_ms(lambda: build.launch(*launch_args), 20),
           cuda_ms(lambda: pars._insertion_costs_plain(masks, pfreq, leaf, layout,
                                                       present), 2),
           *pars_work(N, words.shape[1], lanes, n_rows))
    wrap_ms = cuda_ms(lambda: pars.insertion_costs(masks, words, pfreq, leaf, layout,
                                                   present, scratch), 20)
    adj = partial_adj(tree, N)[1]
    t0 = time.time()
    for _ in range(20):
        pars._partial_layout(adj, 0, N)
    layout_ms = (time.time() - t0) / 20 * 1e3
    t0 = time.time()
    for _ in range(20):
        pars.kernel_rows(layout, present)
    rows_ms = (time.time() - t0) / 20 * 1e3
    floor_ms = n_rows * SMEM_ROUND_TRIP / (sm_mhz * 1e3)
    print(f"pars_insert ({words.shape[1]} words of {lanes} patterns, {n_rows} walk "
          f"rows): kernel {results['pars_insert']['ms']:.4f} ms; through "
          f"insertion_costs (events around the wrapper, host work inside, as the "
          f"earlier design was timed) {wrap_ms:.4f} ms beside its "
          f"{EARLIER_MS['pars_insert']}; the "
          f"host layout (_partial_layout) {layout_ms:.4f} ms, the walk rows (kernel_rows) "
          f"{rows_ms:.4f} ms; chain floor {floor_ms:.4f} "
          f"ms ({n_rows} rows x {SMEM_ROUND_TRIP} cycles at {sm_mhz:.0f} MHz)")
    del masks, words, scratch, launch_args

    # every NNI of the true tree, on the kernels' passes and on the twins':
    # the two sum in other orders in float32, and the per-edge biases that
    # float32 puts into both cancel in the paired deltas, which the JAX
    # package measured within 0.2 of float64 at this size (README.md)
    from iqtree_torch.engine.banner import decide_engine
    from iqtree_torch.engine.nni import evaluate_nnis

    chunk = decide_engine(N, C, S, P, dev, torch.float32, search=True).nni_chunk
    edges = ta.h2d.cpu().numpy()[tree.internal_edges()]
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    csk.fill_tip_rows_cs(up_p, usc_p, tips, C)
    plain = (up_p, usc_p, *csk._down_store_plain(steps, trans, up_p, usc_p, freq))
    with torch.no_grad():
        def nni_eval(passes=None):
            ev = evaluate_nnis(ta, model, site, edges, steps, n_slots, paired=True,
                               edge_chunk=chunk, passes=passes)
            return (ev.lnl - ev.base_lnl[:, None]).cpu()

        d_k = nni_eval()
        torch.cuda.synchronize()
        t0 = time.time()
        d_k = nni_eval()
        eval_s = time.time() - t0
        d_p = nni_eval(plain)
    del plain, up_p, usc_p
    diff = (d_k - d_p).abs()
    err = float(diff.max())
    pos = (d_k > 1e-3) | (d_p > 1e-3)
    print(f"NNI evaluator ({len(edges)} edges x 3 swaps, {chunk} edges a chunk): "
          f"{eval_s:.3f} s; paired deltas on kernel vs plain passes differ by "
          f"{err:.3e} at most (tol 0.2), {float(diff.quantile(0.99)):.3e} at the 99th "
          f"percentile, {float(diff[pos].max()) if bool(pos.any()) else 0.0:.3e} at "
          f"most over the {int(pos.sum())} positive NNIs")
    check(err < 0.2, "paired NNI deltas on the kernels' passes vs the twins'")

    # gradient: autograd.Function vs autograd through the plain pass
    l_k, g_k = param_grads(
        lambda t, m: grad_mod.loglik(t, m, site, steps, n_slots)[0], ta, opt, params)
    l_p, g_p = param_grads(lambda t, m: compute_loglik(t, m, site)[0], ta, opt, params)
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p))
    print(f"gradient (blen + {len(params)} model params): lnL {l_k:.4f} vs plain "
          f"{l_p:.4f}, max relative error {g_err:.3e} (tol 1e-3)")
    check(abs(l_k - l_p) < 1.0 and g_err < 1e-3, "custom gradient vs plain autograd")

    # golden lnL on the 44-taxon example through the fused forward kernel
    from iqtree_torch.io.alignment import read_alignment
    from iqtree_torch.models.dna import create_dna_model
    from iqtree_torch.models.rates import RateModel

    data = os.path.join(HERE, "tests", "data")
    ex = read_alignment(os.path.join(data, "example.phy"))
    with open(os.path.join(data, "golden_tree_44.nwk")) as f:
        gtree = PhyloTree.from_newick(f.read(), ex.names)
    gsub = create_dna_model("GTR")
    gsub.group_rates = np.array([1.0, 1.5, 2.0, 0.8, 1.2, 3.0])
    gsub.state_freq = np.array([0.25, 0.26, 0.25, 0.24])
    gta = TreeArrays.from_tree(gtree, dev)
    gsteps, gslots = pk.device_slot_schedule(gtree, gta)
    g_lnl, g_pat = pk.fused_compute_loglik(
        gta, ModelArrays.from_model(gsub, RateModel.make(gamma_cats=4, alpha=0.5), dev),
        SiteData.from_alignment(ex, dev, torch.float32),
        torch.as_tensor(gsteps, device=dev), gslots)
    print(f"golden example lnL {float(g_lnl):.6f} vs {GOLDEN_LNL} (f32, tol 0.05)")
    check(abs(float(g_lnl) - GOLDEN_LNL) < 0.05, "golden lnL of the example")
    check(g_pat.shape == (ex.n_patterns,) and bool(torch.isfinite(g_pat).all()),
          "finite per-pattern lnL of the expected shape")
    del trans, tips, model, site, ta
    torch.cuda.empty_cache()

    phase("4. fixed-topology path: -te fit through the CLI on cuda")
    from iqtree_torch.cli import main as cli_main

    counters = {"forward": pk.fused_site_lnl, "store": csk.fused_upward_store_cs,
                "tbar": csk.fused_tbar_cs, "newton": csk.newton_sweep,
                "down_store": csk.fused_down_store_cs,
                "pars_insert": pars.insertion_costs}
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk)[0]
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
    fit_lnl = float(logged(log, "Optimal log-likelihood:"))
    lnl64, ta_fit, g = reevaluate(nwk, logged(log, "Best-fit model parameters:"),
                                  aln, dev)
    print(f"fitted tree and model re-evaluated in float64 (plain pass): {lnl64:.4f}")
    check(abs(lnl64 - fit_lnl) < 1.0, "float32 fit lnL vs its float64 re-evaluation")
    # stationarity in the branch lengths: free branches off the lower bound
    free = optimize_branch_mask(ta_fit)
    off = free & (ta_fit.blen > 2 * MIN_BLEN)
    at = free & ~off
    print(f"float64 d lnL/dt at the fit: max |g| {float(g[off].abs().max()):.4g} over "
          f"{int(off.sum())} free branches off the bound; {int(at.sum())} at the "
          f"{MIN_BLEN:g} bound" + (f" (largest g there {float(g[at].max()):.4g})"
                                   if bool(at.any()) else ""))
    print(f"-te fit lnL {fit_lnl:.4f}; reference binary optimum {REF_OPTIMUM}; "
          f"gap to the JAX package's {JAX_LNL}: {fit_lnl - JAX_LNL:+.4f}")
    print(f"-te fit wall time {wall:.2f} s on {card}")
    print(f"-te fit launches: {launches}")
    k_ms = sum(results[k]["ms"] * n for k, n in launches.items())
    print(f"kernel time of the fit, estimated as launches x phase-3 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {wall:.2f} s wall ("
          + ", ".join(f"{k} {results[k]['ms'] * n / 1e3:.3f} s"
                      for k, n in launches.items() if n) + ")")
    check(fit_lnl > REF_OPTIMUM, "fit ends above the reference binary's optimum")
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "finite branch lengths of the written tree")
    for k in ("forward", "store", "tbar", "newton"):
        check(launches[k] > 0, f"kernel {k} launched on the -te path")

    phase("5. the fit again under torch.profiler")
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk)[0]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "fit")

    phase("6. main path: the default search through the CLI on cuda")
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, search=SEARCH_FLAGS)[0]
        print("iqtree-torch " + " ".join(SEARCH_FLAGS))
        s_wall, launches, log, nwk = run_cli(cli_main, args, counters)
    best = float(logged(log, "BEST SCORE FOUND :"))
    model_str = logged(log, "Best-fit model parameters:")
    check(any(l.startswith("search profile") for l in log),
          "the search logged its per-phase profile")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev)
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    print(f"search: {s_wall:.2f} s wall on {card}; BEST SCORE FOUND {best:.4f}; "
          f"float64 re-evaluation of the written tree and model {lnl64:.4f}; "
          f"reference binary {REF_SEARCH_LNL} (same flags); for information, the "
          f"JAX package's float32 run on a TPU {JAX_SEARCH_LNL}")
    print(f"search launches: {launches}")
    k_ms = sum(results[k]["ms"] * n for k, n in launches.items())
    print(f"kernel time of the search, estimated as launches x phase-3 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {s_wall:.2f} s wall ("
          + ", ".join(f"{k} {results[k]['ms'] * n / 1e3:.3f} s"
                      for k, n in launches.items()) + ")")
    for line in log[[i for i, l in enumerate(log) if l.startswith("search profile")][-1]:]:
        if not line.startswith(("search profile", " ")):
            break
        print(line)
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "a written 1000-taxon tree with finite lengths")
    check(abs(lnl64 - best) < 1.0, "search lnL vs its float64 re-evaluation")
    check(best > REF_SEARCH_LNL, "search ends above the reference binary's score")
    for k, n in launches.items():
        check(n > 0, f"kernel {k} launched on the search")
        results[k]["launches"] = n

    phase("7. one NNI hill climb from the ML-distance BIONJ tree, profiled")
    from iqtree_torch.engine.distances import ml_distances
    from iqtree_torch.search.nni_search import NNIEngine
    from iqtree_torch.trees.bionj import bionj_tree

    s_fit, r_fit = parse_model_string(model_str, aln)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    model = ModelArrays.from_model(s_fit, r_fit, dev)
    with torch.no_grad():
        start = bionj_tree(ml_distances(model, site))
    engine = NNIEngine(model, site, edge_chunk=chunk)
    t0 = time.time()
    res = engine.hill_climb(start.copy())
    torch.cuda.synchronize()
    c_wall = time.time() - t0
    print(f"hill climb: {c_wall:.2f} s wall, {res.steps} steps, {res.nni_count} NNIs, "
          f"lnL {res.lnl:.4f}")
    print(engine.profile_summary())
    profile_run(lambda: engine.hill_climb(start.copy()), c_wall, "hill climb")
    del engine, model, site
    torch.cuda.empty_cache()

    protein_phases(dev, card, record, results, cli_main)
    protein_search_phases(dev, card, record, results, cli_main)
    multi_tree_phases(dev, card, record, results)
    codon_phases(dev, card, record, results, cli_main, bdir)
    codon_search_phases(dev, card, record, results, cli_main, bdir, sm_mhz)
    mixture_phases(dev, card, record, results, cli_main, bdir)
    freerate_phases(dev, card, record, results, cli_main, bdir)
    binmorph_phases(dev, card, record, results, cli_main, bdir)

    print(json.dumps({"kernels": list(results.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def protein_phases(dev, card, record, results, cli_main):
    """Phases 8-10: the wide kernels (S=20) at the protein path's shapes,
    and the protein -te fit through the CLI, plain and profiled."""
    import numpy as np
    import torch
    from iqtree_torch.engine import grad as grad_mod
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.likelihood import (
        ModelArrays, SiteData, TreeArrays, branch_transition_mats, compute_loglik,
        ptn_invar, tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.models.optimize import ModelOptimizer
    from iqtree_torch.trees.tree import PhyloTree

    phase("8. wide kernels against their plain twins (protein: 300 taxa x 2 000 aa)")
    names, seqs, tree_nwk = load_bench("bench_data_protein.npz")
    aln = Alignment.from_sequences(names, seqs, "AA")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    subst, rate = parse_model_string("LG+G", aln)
    opt = ModelOptimizer(subst, rate, dev)
    rng = np.random.default_rng(8)
    params = {k: v + torch.as_tensor(rng.normal(0, 0.3, v.shape), device=dev)
              for k, v in opt.init_params().items()}
    model = opt.build(params)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P = aln.n_taxa, aln.n_patterns
    C, S = rate.ncat, subst.num_states
    CS, CSS, R = C * S, C * S * S, 2 * N
    print(f"{N} taxa, {P} patterns, C={C}, S={S}, {n_slots} slots; alpha "
          f"{float(opt._alpha(params)):.4f} (perturbed)")
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    invar = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()

    for tile in (16, 32, 64):
        ms = cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq,
                                              invar, tile=tile), 10)
        print(f"wide forward, {tile} patterns a cluster of {C} blocks "
              f"({-(-P // tile) * C} blocks, "
              f"{pk.wide_forward_smem(S, C, tile, n_slots)} B of shared memory a block): "
              f"{ms:.3f} ms")
    for tile in (16, 32, 64):
        st_ms = cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips,
                                                      tile=tile), 10)
        print(f"wide store, {tile} patterns a cluster of {C} blocks "
              f"({-(-P // tile) * C} blocks, "
              f"{pk.wide_forward_smem(S, C, tile, n_slots)} B of shared memory a block): "
              f"{st_ms:.3f} ms")
    for name, tile in (("forward", pk.WIDE_FORWARD_TILE), ("store", pk.WIDE_STORE_TILE)):
        s61 = pk.wide_forward_smem(61, 4, tile, max(n_slots, 11))
        print(f"wide {name} shared memory by its formula at S=61, C=4, {tile} patterns "
              f"a cluster, {max(n_slots, 11)} slots (a 1000-taxon tree's): {s61} B (a "
              f"block may have {SMEM_BLOCK})")
        check(s61 <= SMEM_BLOCK, f"wide {name}'s cluster walk fits at S=61")
    k_out = pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
    bit_equal("wide_forward", [k_out],
              [pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)])
    p_out = pk._site_lnl_plain(steps, trans, tips, props, freq, invar)
    fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P
    record("wide_forward", "iqtree_torch/engine/kernels/csrc/wide_forward.cu",
           "iqtree_tpu/engine/kernels/pruning.py:34",
           float((k_out - p_out).abs().max()), 1e-3,
           cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq,
                                            invar), 20),
           cuda_ms(lambda: pk._site_lnl_plain(steps, trans, tips, props, freq, invar), 3),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + CS + 2 * P), fwd_flops)
    beside_earlier(results, "wide_forward")

    up_k, usc_k = pk.fused_upward_store(steps, n_slots, trans, tips)
    inner = slice(N, 2 * N - 1)
    up2, usc2 = pk.fused_upward_store(steps, n_slots, trans, tips)
    bit_equal("wide_store", [up_k[inner], usc_k], [up2[inner], usc2])
    del up2, usc2
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    err = store_err(up_k, usc_k, up_p, usc_p, inner)
    record("wide_store", "iqtree_torch/engine/kernels/csrc/wide_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:822", err, 1e-4,
           cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips), 20),
           cuda_ms(lambda: pk.upward_plain(steps, trans, tips), 3),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P),
           fwd_flops)
    beside_earlier(results, "wide_store")
    del up_p, usc_p

    lnl = k_out.contiguous()
    wp = site.pattern_freq.contiguous()
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)
    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    for tile in (16, 32, 64):
        tb_ms = cuda_ms(lambda: csk.fused_downward_tbar(
            steps, n_slots, trans, tips, props, freq, lnl, wp, up=up_k, usc=usc_k,
            tile=tile), 5)
        print(f"wide tbar, {tile} patterns a cluster of {C} blocks "
              f"({-(-P // tile) * C} blocks, "
              f"{csk.wide_tbar_smem(S, C, tile, n_slots)} B of shared memory a block): "
              f"{tb_ms:.3f} ms")
    tile = csk.WIDE_TBAR_TILE
    s61 = csk.wide_tbar_smem(61, 4, tile, max(n_slots, 11))
    print(f"wide tbar shared memory by its formula at S=61, C=4, {tile} patterns a "
          f"cluster, {max(n_slots, 11)} slots (a 1000-taxon tree's): {s61} B (a block "
          f"may have {SMEM_BLOCK}; formula only: no S=61 instance builds, as "
          f"group_sums needs S % 4 == 0)")
    check(s61 <= SMEM_BLOCK, "wide tbar's shared-memory formula (no S=61 instance) "
          "fits at S=61")
    for tile in (16, 32, 64):
        nt_ms = cuda_ms(lambda: csk.wide_newton_sweep(
            steps, n_slots, mats, props, freq, wp, invar, up_k, usc_k, tile=tile), 10)
        print(f"wide newton, {tile} patterns a cluster of {C} blocks "
              f"({-(-P // tile) * C} blocks, "
              f"{csk.wide_newton_smem(S, C, tile, n_slots)} B of shared memory a block): "
              f"{nt_ms:.3f} ms")
    s61 = csk.wide_newton_smem(61, 4, 8, max(n_slots, 11))
    print(f"wide newton shared memory by its formula at S=61, C=4, 8 patterns a "
          f"cluster, {max(n_slots, 11)} slots (a 1000-taxon tree's): {s61} B (a block "
          f"may have {SMEM_BLOCK})")
    check(s61 <= SMEM_BLOCK, "wide newton's staging fits at S=61")
    tb_k = csk.fused_downward_tbar(steps, n_slots, trans, tips, props, freq, lnl, wp,
                                   up=up_k, usc=usc_k)
    bit_equal("wide_tbar", [tb_k], [csk.fused_downward_tbar(
        steps, n_slots, trans, tips, props, freq, lnl, wp, up=up_k, usc=usc_k)])
    tb_p = csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k, usc_k)
    rev_bytes = 4 * (R * (CS + 1) * P + 2 * P + 2 * R * CSS)
    record("wide_tbar", "iqtree_torch/engine/kernels/csrc/wide_tbar.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1144",
           tbar_err(tb_k, tb_p, R), 1e-4,
           cuda_ms(lambda: csk.fused_downward_tbar(steps, n_slots, trans, tips, props,
                                                   freq, lnl, wp, up=up_k, usc=usc_k), 5),
           cuda_ms(lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k,
                                           usc_k), 3),
           rev_bytes, tbar_flops(N, P, CS, CSS))
    beside_earlier(results, "wide_tbar")
    del tb_p

    d_k = csk.wide_newton_sweep(steps, n_slots, mats, props, freq, wp, invar, up_k,
                                usc_k)
    bit_equal("wide_newton", d_k, csk.wide_newton_sweep(steps, n_slots, mats, props, freq,
                                                        wp, invar, up_k, usc_k))
    d_p = csk._newton_plain(steps, mats, props, freq, wp, invar, up_k, usc_k)
    err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(d_k, d_p))
    record("wide_newton", "iqtree_torch/engine/kernels/csrc/wide_newton.cu",
           "iqtree_tpu/engine/kernels/cs_kernels.py:300", err, 1e-4,
           cuda_ms(lambda: csk.wide_newton_sweep(steps, n_slots, mats, props, freq, wp,
                                                 invar, up_k, usc_k), 10),
           cuda_ms(lambda: csk._newton_plain(steps, mats, props, freq, wp, invar, up_k,
                                             usc_k), 3),
           4 * (R * (CS + 1) * P + 3 * P + 3 * R * CSS + 2 * R),
           newton_flops(N, P, CS, CSS))
    beside_earlier(results, "wide_newton")
    del d_p, up_k, usc_k, mats
    # the cluster at its smallest and largest: C = 1 (one block) and 8
    for k in (1, 8):
        s_k, r_k = parse_model_string("LG+I" + (f"+G{k}" if k > 1 else ""), aln)
        r_k.p_invar = 0.05
        m_k = ModelArrays.from_model(s_k, r_k, dev)
        tr_k = branch_transition_mats(m_k, ta.blen).float().contiguous()
        u_k, us_k = pk.fused_upward_store(steps, n_slots, tr_k, tips)
        csk.fill_tip_rows_cs(u_k, us_k, tips, k)
        mt_k = csk.stacked_deriv_mats(m_k, ta.blen).float().contiguous()
        args = (steps, n_slots, mt_k, m_k.props.float(), m_k.state_freq.float(), wp,
                ptn_invar(m_k, site).float().contiguous(), u_k, us_k)
        fargs = (steps, n_slots, tr_k, tips, m_k.props.float(), m_k.state_freq.float(),
                 ptn_invar(m_k, site).float().contiguous())
        targs = (steps, n_slots, tr_k, tips, m_k.props.float(), m_k.state_freq.float(),
                 pk.wide_site_lnl(*fargs), wp)
        t_k = csk.fused_downward_tbar(*targs, up=u_k, usc=us_k)
        bit_equal(f"wide_tbar C={k}", [t_k], [csk.fused_downward_tbar(*targs, up=u_k,
                                                                       usc=us_k)])
        t_p = csk._tbar_plain(steps, tr_k, *targs[4:], u_k, us_k)
        e_k = tbar_err(t_k, t_p, R)
        print(f"wide_tbar C={k}: max relative error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.fused_downward_tbar(*targs, up=u_k, usc=us_k), 5):.3f} ms")
        check(e_k <= 1e-4, f"wide_tbar at C={k} against its twin")
        del t_k, t_p, targs
        got = csk.wide_newton_sweep(*args)
        bit_equal(f"wide_newton C={k}", got, csk.wide_newton_sweep(*args))
        want = csk._newton_plain(*args[:1], *args[2:])
        e_k = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
        print(f"wide_newton C={k}: max relative error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.wide_newton_sweep(*args), 5):.3f} ms")
        check(e_k <= 1e-4, f"wide_newton at C={k} against its twin")
        f_k = pk.wide_site_lnl(*fargs)
        bit_equal(f"wide_forward C={k}", [f_k], [pk.wide_site_lnl(*fargs)])
        e_k = float((f_k - pk._site_lnl_plain(*fargs[:1], *fargs[2:])).abs().max())
        print(f"wide_forward C={k}: max_abs_err {e_k:.3e} (tol 1e-3), "
              f"{cuda_ms(lambda: pk.wide_site_lnl(*fargs), 5):.3f} ms")
        check(e_k <= 1e-3, f"wide_forward at C={k} against its twin")
        # the two stores: u_k came from the store, its tip rows since filled
        u2, us2 = pk.fused_upward_store(steps, n_slots, tr_k, tips)
        bit_equal(f"wide_store C={k}", [u_k[inner], us_k[inner]], [u2[inner], us2[inner]])
        e_k = store_err(u_k, us_k, *pk.upward_plain(steps, tr_k, tips), inner)
        print(f"wide_store C={k}: max error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, tr_k, tips), 5):.3f} ms")
        check(e_k <= 1e-4, f"wide_store at C={k} against its twin")
        dargs = (steps, n_slots, tr_k, u_k, us_k, m_k.state_freq.float())
        o_k = csk.fused_down_store(*dargs)
        bit_equal(f"wide_down_store C={k}", o_k, csk.fused_down_store(*dargs))
        e_k = outside_err(o_k, csk._down_store_plain(*dargs[:1], *dargs[2:]), R)
        print(f"wide_down_store C={k}: max error {e_k:.3e} (tol 1e-4), "
              f"{cuda_ms(lambda: csk.fused_down_store(*dargs), 5):.3f} ms")
        check(e_k <= 1e-4, f"wide_down_store at C={k} against its twin")
        del u_k, us_k, mt_k, tr_k, got, want, args, f_k, fargs, u2, us2, dargs, o_k

    # gradient: autograd.Function (wide store + gradient sweep) vs autograd
    # through the plain pass, in the branch lengths and alpha
    before = csk.fused_downward_tbar.launches
    l_k, g_k = param_grads(
        lambda t, m: grad_mod.loglik(t, m, site, steps, n_slots)[0], ta, opt, params)
    check(csk.fused_downward_tbar.launches == before + 1,
          "the gradient ran the wide gradient sweep")
    l_p, g_p = param_grads(lambda t, m: compute_loglik(t, m, site)[0], ta, opt, params)
    g_err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(g_k, g_p))
    print(f"gradient (blen + {len(params)} model param): lnL {l_k:.4f} vs plain "
          f"{l_p:.4f}, max relative error {g_err:.3e} (tol 1e-3)")
    check(abs(l_k - l_p) < 1.0 and g_err < 1e-3, "custom gradient vs plain autograd")
    del trans, tips, model, site, ta
    torch.cuda.empty_cache()

    phase("9. protein fixed-topology path: -te LG+G fit through the CLI on cuda")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_newton": csk.wide_newton_sweep, "forward": pk.fused_site_lnl,
                "store": csk.fused_upward_store_cs, "tbar": csk.fused_tbar_cs,
                "newton": csk.newton_sweep}
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="LG+G")[0]
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
    fit_lnl = float(logged(log, "Optimal log-likelihood:"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev)
    print(f"fitted model {model_str[:12]}...{model_str[-20:]}")
    print(f"fitted tree and model re-evaluated in float64 (plain pass): {lnl64:.4f}")
    print(f"-te LG+G fit lnL {fit_lnl:.4f}; reference binary {REF_PROTEIN_LNL}; "
          f"for information, the JAX package's float32 run on a TPU "
          f"{JAX_PROTEIN_LNL} (gap {fit_lnl - JAX_PROTEIN_LNL:+.4f})")
    print(f"-te LG+G fit wall time {wall:.2f} s on {card}")
    print(f"-te LG+G fit launches: {launches}")
    k_ms = sum(results[k]["ms"] * n for k, n in launches.items())
    print(f"kernel time of the fit, estimated as launches x phase-8/3 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {wall:.2f} s wall")
    check(abs(lnl64 - fit_lnl) < 1.0, "float32 fit lnL vs its float64 re-evaluation")
    check(fit_lnl > REF_PROTEIN_LNL, "fit ends above the reference binary's optimum")
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "finite branch lengths of the written tree")
    for k in ("wide_forward", "wide_store", "wide_tbar", "wide_newton"):
        check(launches[k] > 0, f"kernel {k} launched on the protein -te path")
    for k in ("forward", "store", "tbar", "newton"):
        check(launches[k] == 0, f"the CS-packed kernel {k} stays off the S=20 path")

    phase("10. the protein fit again under torch.profiler")
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="LG+G")[0]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "protein fit")


def protein_search_phases(dev, card, record, results, cli_main):
    """Phases 11-12: the wide outside-partial store and the 32-bit parsimony
    scorer at the protein search's shapes, then the protein search with
    ultrafast bootstrap through the CLI and one profiled protein climb."""
    import numpy as np
    import torch
    from iqtree_torch.engine import parsimony as pars
    from iqtree_torch.engine.banner import decide_engine
    from iqtree_torch.engine.distances import ml_distances
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.models.optimize import ModelOptimizer
    from iqtree_torch.search.nni_search import NNIEngine
    from iqtree_torch.trees.bionj import bionj_tree
    from iqtree_torch.trees.tree import PhyloTree

    phase("11. wide outside-partial store and 32-bit parsimony against their twins "
          "(protein: 300 taxa x 2 000 aa)")
    names, seqs, tree_nwk = load_bench("bench_data_protein.npz")
    aln = Alignment.from_sequences(names, seqs, "AA")
    true_tree = PhyloTree.from_newick(tree_nwk, aln.names)
    subst, rate = parse_model_string("LG+G", aln)
    opt = ModelOptimizer(subst, rate, dev)
    rng = np.random.default_rng(11)
    params = {k: v + torch.as_tensor(rng.normal(0, 0.3, v.shape), device=dev)
              for k, v in opt.init_params().items()}
    model = opt.build(params)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(true_tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(true_tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P = aln.n_taxa, aln.n_patterns
    C, S = rate.ncat, subst.num_states
    CS, CSS, R = C * S, C * S * S, 2 * N
    print(f"{N} taxa, {P} patterns, C={C}, S={S}, {n_slots} slots")
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    freq = model.state_freq.float()
    up_k, usc_k = pk.fused_upward_store(steps, n_slots, trans, tips)
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)

    # O in [0, 1] absolutely, osc relative to its largest; the root and the
    # dummy rows are never written.  Bound: up, usc read and out, osc
    # written once, the matrices read once; both child messages a step and
    # the push P^T O into each internal non-root child
    for tile in (16, 32, 64):
        ms = cuda_ms(lambda: csk.fused_down_store(steps, n_slots, trans, up_k, usc_k,
                                                  freq, tile=tile), 10)
        print(f"wide down-store, {tile} patterns a cluster of {C} blocks "
              f"({-(-P // tile) * C} blocks, "
              f"{csk.wide_down_store_smem(S, C, tile, n_slots)} B of shared memory a "
              f"block): {ms:.3f} ms")
    tile = csk.WIDE_DOWN_STORE_TILE
    s61 = csk.wide_down_store_smem(61, 4, tile, max(n_slots, 11))
    print(f"wide down-store shared memory by its formula at S=61, C=4, {tile} patterns "
          f"a cluster, {max(n_slots, 11)} slots (a 1000-taxon tree's): {s61} B (a block "
          f"may have {SMEM_BLOCK})")
    check(s61 <= SMEM_BLOCK, "wide down-store's reverse walk fits at S=61")
    out_k, osc_k = csk.fused_down_store(steps, n_slots, trans, up_k, usc_k, freq)
    bit_equal("wide_down_store", (out_k, osc_k),
              csk.fused_down_store(steps, n_slots, trans, up_k, usc_k, freq))
    out_p, osc_p = csk._down_store_plain(steps, trans, up_k, usc_k, freq)
    err = outside_err((out_k, osc_k), (out_p, osc_p), R)
    check(not bool(out_k[R - 2:].any()) and not bool(osc_k[R - 2:].any()),
          "root and dummy rows of the outside store are 0")
    record("wide_down_store", "iqtree_torch/engine/kernels/csrc/wide_down_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1437", err, 1e-4,
           cuda_ms(lambda: csk.fused_down_store(steps, n_slots, trans, up_k, usc_k,
                                                freq), 20),
           cuda_ms(lambda: csk._down_store_plain(steps, trans, up_k, usc_k, freq), 3),
           4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
           P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
    beside_earlier(results, "wide_down_store")
    del out_k, osc_k, out_p, osc_p, up_k, usc_k, trans, tips

    # the last insertion of a full protein tree with 32-bit state sets
    leaf, present, layout = partial_tree(true_tree, N)
    masks = torch.as_tensor(pars.pack_tip_masks(aln), device=dev)
    words = pars.kernel_tip_words(masks, S)
    check(words.dtype == torch.int32, "20 states take the 32-bit instance")
    pfreq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64, device=dev)
    scratch = pars.kernel_scratch(words, pfreq, S)
    cost_k = pars.insertion_costs(masks, words, pfreq, leaf, layout, present, scratch)
    cost_p = pars._edge_costs(
        pars._insertion_costs_plain(masks, pfreq, leaf, layout, present), layout)
    fin = np.isfinite(cost_p)
    check(np.array_equal(np.isfinite(cost_k), fin), "32-bit parsimony: the same edges")
    # each of 50 launches timed alone, the kernel and its wrapper (whose
    # events hold the wrapper's host work, as the earlier design's times did)
    launch_args, n_rows = pars_launch(pars, layout, present, words, leaf, scratch)
    each = cuda_ms_each(lambda: build.launch(*launch_args), 50)
    wrap = cuda_ms_each(lambda: pars.insertion_costs(masks, words, pfreq, leaf, layout,
                                                     present, scratch), 50)
    record("pars_insert_s20", "iqtree_torch/engine/kernels/csrc/pars_insert.cu",
           "iqtree_tpu/engine/parsimony.py:168 (plain XLA, no Pallas kernel)",
           float(np.abs(cost_k[fin] - cost_p[fin]).max()), 0.0, float(np.mean(each)),
           cuda_ms(lambda: pars._insertion_costs_plain(masks, pfreq, leaf, layout,
                                                       present), 3),
           *pars_work(N, words.shape[1], pars.word_lanes(S), n_rows))
    print(f"pars_insert_s20 ({words.shape[1]} words, {n_rows} walk rows), 50 launches "
          f"each: kernel {spread(each)}; through insertion_costs {spread(wrap)} (the "
          f"earlier design: {EARLIER_MS['pars_insert_s20']} and 0.673 in two runs)")
    del masks, words, scratch, model, site, ta, launch_args
    torch.cuda.empty_cache()

    phase("12. the protein search with ultrafast bootstrap through the CLI on cuda")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_newton": csk.wide_newton_sweep,
                "wide_down_store": csk.fused_down_store,
                "pars_insert_s20": pars.insertion_costs,
                "forward": pk.fused_site_lnl, "store": csk.fused_upward_store_cs,
                "tbar": csk.fused_tbar_cs, "newton": csk.newton_sweep,
                "down_store": csk.fused_down_store_cs}
    with tempfile.TemporaryDirectory() as tmp:
        args, prefix = write_inputs(tmp, names, seqs, tree_nwk,
                                    search=PROTEIN_SEARCH_FLAGS)
        print("iqtree-torch " + " ".join(PROTEIN_SEARCH_FLAGS))
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        with open(prefix + ".ufboot") as f:
            boot = f.read().splitlines()
        sizes = {ext: os.path.getsize(prefix + ext) for ext in (".contree", ".splits.nex")}
        with open(prefix + ".contree") as f:
            contree = PhyloTree.from_newick(f.read(), aln.names)
    best = float(logged(log, "BEST SCORE FOUND :"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev)
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    rf = out_tree.robinson_foulds(true_tree)
    supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    print(f"protein search: {wall:.2f} s wall on {card}; BEST SCORE FOUND {best:.4f}; "
          f"float64 re-evaluation of the written tree and model {lnl64:.4f}; "
          f"for information, the JAX package's float32 search without -bb on a TPU "
          f"{JAX_PROTEIN_SEARCH_LNL} (gap {best - JAX_PROTEIN_SEARCH_LNL:+.4f}) and the "
          f"-te fit of the true tree {REF_PROTEIN_LNL} (binary)")
    print(f"RF distance of the best tree to the true tree: {rf} (of {2 * (N - 3)}); "
          f"consensus to the true tree: {contree.robinson_foulds(true_tree)}")
    print(f"UFBoot: {len(boot)} sample trees, {len(supports)} supports on the "
          f"treefile (min {min(supports)}, median {int(np.median(supports))}); "
          f"files {sizes}; summaries and outputs "
          f"{logged(log, 'UFBoot summaries and outputs:')}")
    for line in log[[i for i, l in enumerate(log) if l.startswith("search profile")][-1]:]:
        if not line.startswith(("search profile", " ")):
            break
        print(line)
    print(f"protein search launches: {launches}")
    k_ms = sum(results[k]["ms"] * n for k, n in launches.items() if k in results)
    print(f"kernel time of the protein search, estimated as launches x phase-8/11 "
          f"kernel ms: {k_ms / 1e3:.3f} s of {wall:.2f} s wall")
    check(abs(lnl64 - best) < 1.0, "protein search lnL vs its float64 re-evaluation")
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "a written 300-taxon tree with finite lengths")
    check(len(boot) == 1000 and all(l.strip().endswith(";") for l in boot),
          "every one of the 1000 UFBoot samples holds a tree")
    check(len(supports) == N - 3 and all(0 <= x <= 100 for x in supports),
          "the treefile carries N-3 supports in 0-100")
    check(all(v > 0 for v in sizes.values()), ".contree and .splits.nex written")
    for k in ("wide_forward", "wide_store", "wide_tbar", "wide_newton",
              "wide_down_store", "pars_insert_s20"):
        check(launches[k] > 0, f"kernel {k} launched on the protein search")
        results[k]["launches"] = launches[k]
    for k in ("forward", "store", "tbar", "newton", "down_store"):
        check(launches[k] == 0, f"the CS-packed kernel {k} stays off the S=20 path")

    # one protein hill climb from the ML-distance BIONJ tree, profiled
    s_fit, r_fit = parse_model_string(model_str, aln)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    model = ModelArrays.from_model(s_fit, r_fit, dev)
    with torch.no_grad():
        start = bionj_tree(ml_distances(model, site))
    chunk = decide_engine(N, C, S, P, dev, torch.float32, search=True).nni_chunk
    engine = NNIEngine(model, site, edge_chunk=chunk)
    t0 = time.time()
    res = engine.hill_climb(start.copy())
    torch.cuda.synchronize()
    c_wall = time.time() - t0
    print(f"protein hill climb ({chunk} edges a chunk): {c_wall:.2f} s wall, "
          f"{res.steps} steps, {res.nni_count} NNIs, lnL {res.lnl:.4f}")
    print(engine.profile_summary())
    profile_run(lambda: engine.hill_climb(start.copy()), c_wall, "protein hill climb")
    del engine, model, site
    torch.cuda.empty_cache()


def multi_tree_phases(dev, card, record, results):
    """Phases 13-14: the multi-tree forward at the main path's full width
    against its twin and against forward.cu, timed at K = 1, 4, 8, 16; then
    the forward kernel's ablation variants against their twins, timed."""
    import numpy as np
    import torch
    from iqtree_torch.engine.kernels import ablate
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, ptn_invar,
                                                tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.dna import create_dna_model
    from iqtree_torch.models.rates import RateModel
    from iqtree_torch.trees.tree import PhyloTree

    phase("13. the multi-tree forward at full width (1000 taxa x 10k sites, K trees)")
    names, seqs, tree_nwk = load_bench()
    aln = Alignment.from_sequences(names, seqs, "DNA")
    # the true tree and a chain of trees, each three random NNIs from the last
    trees = [PhyloTree.from_newick(tree_nwk, aln.names)]
    rng = np.random.default_rng(0)
    for _ in range(15):
        t = trees[-1].copy()
        for _ in range(3):
            e = t.internal_edges()
            t.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
        trees.append(t)
    model = ModelArrays.from_model(create_dna_model("GTR"),
                                   RateModel.make(gamma_cats=4, alpha=0.6), dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    pairs = [(t, TreeArrays.from_tree(t, dev)) for t in trees]
    N, P, C, S = aln.n_taxa, aln.n_patterns, model.ncat, model.num_states
    CS, CSS, R, K = C * S, C * S * S, 2 * N, 8
    on = lambda a: torch.as_tensor(a, device=dev)

    # the path: K trees scored through the entry point, one launch
    pk.fused_site_lnl_cs_stream.launches = 0
    totals = pk.fused_multi_tree_lnl(pairs[:K], model, site).cpu().numpy()
    torch.cuda.synchronize()
    launches = pk.fused_site_lnl_cs_stream.launches
    check(launches == 1, "the multi-tree evaluation launched the kernel once")
    scheds = [pk.device_slot_schedule(t, ta) for t, ta in pairs]
    singles = [pk.fused_compute_loglik(ta, model, site, on(s), ns)
               for (_, ta), (s, ns) in zip(pairs, scheds)]
    single_tot = np.array([float(s[0]) for s in singles])
    diff = float(np.abs(totals - single_tot[:K]).max())
    print(f"K={K} lnL (multi-tree kernel): {np.array2string(totals, precision=4)}")
    print(f"largest difference to {K} forward.cu fits: {diff:.4e} (tol 0.1); spread "
          f"of the K lnL {np.ptp(single_tot[:K]):.2f}")
    check(diff < 0.1, "multi-tree totals vs forward.cu per tree")
    check(np.ptp(single_tot[:K]) > 1.0, "the K topologies differ in lnL")
    check(bool(np.isfinite(totals).all()) and totals.shape == (K,),
          "finite lnL of the K trees")

    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    rootw = (props[:, None] * freq).reshape(-1).contiguous()

    def batch(k):
        """The kernel's arguments for the first k trees."""
        sk, sg, ns, roots = pk.multi_tree_schedule(pairs[:k])
        trans = torch.cat([branch_transition_mats(model, ta.blen)
                           for _, ta in pairs[:k]]).float().contiguous()
        return dict(steps=on(sk), n_slots=ns, trans=trans, roots=on(roots),
                    gather_steps=on(sg), tree_slots=pk.pool_slots(sk, k))

    def stream(b, tile=None):
        return pk.fused_site_lnl_cs_stream(
            b["steps"], b["n_slots"], b["trans"], tips, props, freq, inv,
            roots=b["roots"], gather_steps=b["gather_steps"], tile=tile,
            tree_slots=b["tree_slots"])

    def plain(b):
        k = b["roots"].shape[0]
        return pk._stream_plain(b["steps"], b["gather_steps"], b["trans"], tips, rootw,
                                inv.expand(k, P), b["roots"])

    def work(k):
        """(bytes, operations) of k trees: tips, trans, schedules and roots
        read once, invariant classes read and outputs written once."""
        return (4 * (N * S * P + k * R * CSS + 12 * k * (N - 1) + k + CS + 2 * k * P),
                k * ((N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P))

    b8 = batch(K)
    print(f"{K} trees: {b8['steps'].shape[0]} rows, {b8['n_slots']} slots in all, "
          f"{b8['tree_slots']} a tree (the block's pool)")
    k_out = stream(b8)
    p_out = plain(b8)
    check(k_out.shape == (K, P) and bool(torch.isfinite(k_out).all()),
          "finite [K, P] site lnL")
    record("stream_forward", "iqtree_torch/engine/kernels/csrc/stream_forward.cu",
           "iqtree_tpu/engine/kernels/pruning.py:246",
           float((k_out - p_out).abs().max()), 1e-3, cuda_ms(lambda: stream(b8), 5),
           cuda_ms(lambda: plain(b8), 2), *work(K))
    results["stream_forward"]["launches"] = launches
    del p_out

    s0 = on(scheds[0][0])
    trans0 = branch_transition_mats(model, pairs[0][1].blen).float().contiguous()
    fwd_ms = cuda_ms(lambda: pk.fused_site_lnl(s0, scheds[0][1], trans0, tips, props,
                                               freq, inv), 10)
    print(f"forward.cu, one tree: {fwd_ms:.3f} ms")
    for k in (1, 4, 8, 16):
        b = b8 if k == K else batch(k)
        out = stream(b)
        err = max(float((out[j] - singles[j][1]).abs().max()) for j in range(k))
        check(err < 1e-3, f"K={k}: the multi-tree kernel vs forward.cu per tree")
        ms = cuda_ms(lambda: stream(b), 5)
        bms, by = bound(*work(k))
        print(f"K={k:2d}: {ms:.3f} ms a launch, {ms / k:.3f} ms a tree ({fwd_ms / (ms / k):.2f}x "
              f"forward.cu's {fwd_ms:.3f}); bound {bms:.4f} ms ({by}); largest site lnL "
              f"difference to forward.cu {err:.2e}")
    for tile in (32, 64, 128):
        print(f"K={K} tile {tile}: {cuda_ms(lambda: stream(b8, tile), 5):.3f} ms")
    del b8, k_out, singles, site, pairs
    torch.cuda.empty_cache()

    phase("14. the forward kernel's ablation variants (bench tree, random trans and tips)")
    steps, n_slots, trans, tips = ablate.bench_inputs(dev)
    n_steps, (N, S, P) = steps.shape[0], tips.shape
    # each variant's timed launches counted alone (the comparisons below
    # launch again and are not counted)
    times, launched = {}, {}
    for v in ablate.VARIANTS:
        ablate.forward_ablation.launches = 0
        times.update(ablate.time_variants(steps, n_slots, trans, tips, variants=(v,)))
        launched[v] = ablate.forward_ablation.launches
        check(launched[v] == 11, f"ablation variant {v} launched 11 times")
    # Tolerances.  The exact variants: log-scales of ~1e3, relative to the
    # largest 1e-5, as the store's scales.  The precision variants: their
    # twins sum the exact bfloat16 products in the kernel's order, so they
    # give the kernel's bits up to the last digits of a log; each must lie
    # within a tenth of its measured distance from the kernel's `full`, so
    # a kernel that skipped its passes (and computed `full`) fails.
    k_full = ablate.forward_ablation("full", steps, n_slots, trans, tips)
    tols, errs = {v: 1e-5 for v in ablate.VARIANTS}, {}
    for v in ablate.VARIANTS:
        k_out = ablate.forward_ablation(v, steps, n_slots, trans, tips)
        p_out = ablate.ablation_plain(v, steps, trans, tips)
        d = (k_out - p_out).abs()
        errs[v] = float(d.max())
        if v in ablate.PASSES:
            gap = (p_out - k_full).abs()
            tols[v] = float(gap.max()) / 10
            check(tols[v] > 0, f"{v}: the passes move the twin away from full")
            how = "absolute"
            print(f"{v}: twin's distance from the kernel's full: max {float(gap.max()):.4e}, "
                  f"mean {float(gap.mean()):.4e}; the kernel's: max "
                  f"{float((k_out - k_full).abs().max()):.4e}; kernel vs twin: "
                  f"{int((d > 0).sum())} of {P} patterns differ, mean {float(d.mean()):.3e}")
        else:
            errs[v] /= max(1.0, float(p_out.abs().max()))
            how = "relative to the largest |scale|"
        print(f"{v:10s} {times[v]:.3f} ms a launch, {times[v] * 1e3 / n_steps:.3f} us a "
              f"step, {1 - times[v] / times['full']:+.1%} against full; error {errs[v]:.2e} "
              f"{how} (tol {tols[v]:.3g})")
        check(errs[v] <= tols[v], f"ablation variant {v} vs its twin")
    # The work of full.  A precision variant's passes multiply bfloat16
    # operands with float32 sums (the tensor cores' rate); it splits each
    # child's x once a pattern and step (two roundings and a subtraction a
    # value) and each edge matrix once.
    fwd_bytes = 4 * (N * S * P + (R - 1) * CSS + 6 * (N - 1) + P)
    fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS)
    exact = [v for v in ablate.VARIANTS if v not in ablate.PASSES]
    record("forward_ablate", "iqtree_torch/engine/kernels/csrc/forward_ablate.cu",
           "scripts/kernel_ablate.py:42", max(errs[v] for v in exact), 1e-5,
           times["full"],
           cuda_ms(lambda: ablate.ablation_plain("full", steps, trans, tips), 2),
           fwd_bytes, fwd_flops)
    results["forward_ablate"]["launches"] = sum(launched[v] for v in exact)
    for v, line in (("highprec3", 153), ("defprec", 154)):
        passes = ablate.PASSES[v]
        record(f"forward_ablate_{v}", "iqtree_torch/engine/kernels/csrc/forward_ablate.cu",
               f"scripts/kernel_ablate.py:{line}", errs[v], tols[v], times[v],
               cuda_ms(lambda: ablate.ablation_plain(v, steps, trans, tips), 2),
               fwd_bytes, (N - 1) * P * (3 * CS + 2 * 3 * CS) + 3 * (R - 1) * CSS,
               (N - 1) * P * 4 * CSS * passes)
        results[f"forward_ablate_{v}"]["launches"] = launched[v]
    del steps, trans, tips
    torch.cuda.empty_cache()



def codon_phases(dev, card, record, results, cli_main, bdir):
    """Phases 15-17: the S=64 instances of the four wide kernels at the
    codon path's shapes, and the codon -te fit through the CLI, plain and
    profiled."""
    import numpy as np
    import torch
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.kernels.probe import ptxas_lines
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, ptn_invar,
                                                tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.codon import NT_ORDER, sense_codons
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.models.optimize import ModelOptimizer
    from iqtree_torch.trees.tree import PhyloTree, random_tree

    phase("15. the wide kernels' codon instances (S=64) against their plain twins "
          "(codon: 80 taxa x 500 codons)")
    names, seqs, tree_nwk = load_bench("bench_data_codon.npz")
    aln = Alignment.from_sequences(names, seqs, "CODON")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    subst, rate = parse_model_string("GY+F3X4+G", aln)
    opt = ModelOptimizer(subst, rate, dev)
    rng = np.random.default_rng(15)
    params = {k: v + torch.as_tensor(rng.normal(0, 0.3, v.shape), device=dev)
              for k, v in opt.init_params().items()}
    model = opt.build(params)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P = aln.n_taxa, aln.n_patterns
    C, S = rate.ncat, subst.num_states
    SK = build.instance_states(S)
    CS, CSS, R = C * S, C * S * S, 2 * N
    print(f"{N} taxa, {P} patterns, C={C}, S={S} (the S={SK} instance), {n_slots} slots; "
          f"kappa {float(torch.exp(params['log_kappa'])):.4f}, omega "
          f"{float(torch.exp(params['log_omega'])):.4f} (perturbed)")
    check(SK == 64, "the codon space runs the S=64 instance")
    for n in ("wide_forward", "wide_store", "wide_down_store", "wide_tbar"):
        regs = ptxas_lines((bdir / f"{n}.log").read_text(), "ILi64E")
        print(f"  {n} S=64 instance (ptxas): {'; '.join(regs)}")
        check(bool(regs), f"ptxas reports the S=64 instance of {n}")
    print(f"shared memory a block by the formulas at S=64, C={C}, {n_slots} slots: "
          f"wide_forward / wide_store {pk.wide_forward_smem(SK, C, 16, n_slots)} B, "
          f"wide_down_store {csk.wide_down_store_smem(SK, C, 16, n_slots)} B, wide_tbar "
          f"{csk.wide_tbar_smem(SK, C, 16, n_slots)} B ({csk.wide_tbar_threads(SK, 16)} "
          f"threads) at 16 patterns a cluster (a block may have {SMEM_BLOCK})")
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    invar = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    pad_ms = cuda_ms(lambda: (pk.pad_states(trans, SK, 2, 3), pk.pad_states(tips, SK, 1)), 10)
    print(f"the wrappers' padding of trans and tips to S={SK} alone: {pad_ms:.3f} ms a call")
    for tile in (16, 32):
        ms = cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq,
                                              invar, tile=tile), 10)
        st_ms = cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips,
                                                      tile=tile), 10)
        print(f"codon wide forward / store at {tile} patterns a cluster of {C} blocks: "
              f"{ms:.3f} / {st_ms:.3f} ms")

    # the work counted at the codon space's own S (61): the padding is the
    # kernels' overhead, not the function's
    fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P
    k_out = pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
    bit_equal("wide_forward S=64", [k_out],
              [pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, invar)])
    p_out = pk._site_lnl_plain(steps, trans, tips, props, freq, invar)
    record("wide_forward_codon", "iqtree_torch/engine/kernels/csrc/wide_forward.cu",
           "iqtree_tpu/engine/kernels/pruning.py:34",
           float((k_out - p_out).abs().max()), 1e-3,
           cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq,
                                            invar), 20),
           cuda_ms(lambda: pk._site_lnl_plain(steps, trans, tips, props, freq, invar), 3),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + CS + 2 * P), fwd_flops)
    up_k, usc_k = pk.fused_upward_store(steps, n_slots, trans, tips)
    inner = slice(N, 2 * N - 1)
    up2, usc2 = pk.fused_upward_store(steps, n_slots, trans, tips)
    bit_equal("wide_store S=64", [up_k[inner], usc_k], [up2[inner], usc2])
    del up2, usc2
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    record("wide_store_codon", "iqtree_torch/engine/kernels/csrc/wide_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:822",
           store_err(up_k, usc_k, up_p, usc_p, inner), 1e-4,
           cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips), 20),
           cuda_ms(lambda: pk.upward_plain(steps, trans, tips), 3),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P), fwd_flops)
    del up_p, usc_p
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)
    out_k, osc_k = csk.fused_down_store(steps, n_slots, trans, up_k, usc_k, freq)
    bit_equal("wide_down_store S=64", (out_k, osc_k),
              csk.fused_down_store(steps, n_slots, trans, up_k, usc_k, freq))
    check(not bool(out_k[R - 2:].any()) and not bool(osc_k[R - 2:].any()),
          "root and dummy rows of the codon outside store are 0")
    record("wide_down_store_codon", "iqtree_torch/engine/kernels/csrc/wide_down_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1437",
           outside_err((out_k, osc_k),
                       csk._down_store_plain(steps, trans, up_k, usc_k, freq), R), 1e-4,
           cuda_ms(lambda: csk.fused_down_store(steps, n_slots, trans, up_k, usc_k,
                                                freq), 20),
           cuda_ms(lambda: csk._down_store_plain(steps, trans, up_k, usc_k, freq), 3),
           4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
           P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
    del out_k, osc_k
    lnl = k_out.contiguous()
    wp = site.pattern_freq.contiguous()
    tb_k = csk.fused_downward_tbar(steps, n_slots, trans, tips, props, freq, lnl, wp,
                                   up=up_k, usc=usc_k)
    bit_equal("wide_tbar S=64", [tb_k], [csk.fused_downward_tbar(
        steps, n_slots, trans, tips, props, freq, lnl, wp, up=up_k, usc=usc_k)])
    record("wide_tbar_codon", "iqtree_torch/engine/kernels/csrc/wide_tbar.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1144",
           tbar_err(tb_k, csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k, usc_k),
                    R), 1e-4,
           cuda_ms(lambda: csk.fused_downward_tbar(steps, n_slots, trans, tips, props,
                                                   freq, lnl, wp, up=up_k, usc=usc_k), 10),
           cuda_ms(lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k,
                                           usc_k), 3),
           4 * (R * (CS + 1) * P + 2 * P + 2 * R * CSS), tbar_flops(N, P, CS, CSS))
    del tb_k, up_k, usc_k

    def four(steps, n_slots, trans, tips, m, site, what):
        """The four codon instances against their twins on one case, each
        two launches bit-equal; prints errors and ms."""
        props, freq = m.props.float(), m.state_freq.float()
        inv = ptn_invar(m, site).float().contiguous()
        n = tips.shape[0]
        inner, Rk = slice(n, 2 * n - 1), 2 * n
        f = pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, inv)
        bit_equal(f"wide_forward {what}", [f],
                  [pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, inv)])
        e_f = float((f - pk._site_lnl_plain(steps, trans, tips, props, freq, inv)).abs().max())
        u, us = pk.fused_upward_store(steps, n_slots, trans, tips)
        u2, us2 = pk.fused_upward_store(steps, n_slots, trans, tips)
        bit_equal(f"wide_store {what}", [u[inner], us[inner]], [u2[inner], us2[inner]])
        e_s = store_err(u, us, *pk.upward_plain(steps, trans, tips), inner)
        csk.fill_tip_rows_cs(u, us, tips, trans.shape[1])
        o = csk.fused_down_store(steps, n_slots, trans, u, us, freq)
        bit_equal(f"wide_down_store {what}", o,
                  csk.fused_down_store(steps, n_slots, trans, u, us, freq))
        e_d = outside_err(o, csk._down_store_plain(steps, trans, u, us, freq), Rk)
        w = site.pattern_freq.contiguous()
        t = csk.fused_downward_tbar(steps, n_slots, trans, tips, props, freq, f, w, up=u,
                                    usc=us)
        bit_equal(f"wide_tbar {what}", [t], [csk.fused_downward_tbar(
            steps, n_slots, trans, tips, props, freq, f, w, up=u, usc=us)])
        e_t = tbar_err(t, csk._tbar_plain(steps, trans, props, freq, f, w, u, us), Rk)
        ms = [cuda_ms(fn, 5) for fn in (
            lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, inv),
            lambda: pk.fused_upward_store(steps, n_slots, trans, tips),
            lambda: csk.fused_down_store(steps, n_slots, trans, u, us, freq),
            lambda: csk.fused_downward_tbar(steps, n_slots, trans, tips, props, freq, f,
                                            w, up=u, usc=us))]
        print(f"{what}: errors forward {e_f:.3e} (tol 1e-3), store {e_s:.3e}, down-store "
              f"{e_d:.3e} (tol 1e-4), tbar {e_t:.3e} (tol 1e-4 relative); ms forward "
              f"{ms[0]:.3f}, store {ms[1]:.3f}, down-store {ms[2]:.3f}, tbar {ms[3]:.3f}")
        check(e_f <= 1e-3 and e_s <= 1e-4 and e_d <= 1e-4 and e_t <= 1e-4,
              f"the codon instances against their twins ({what})")

    for k in (1, 8):
        s_k, r_k = parse_model_string("GY+F3X4+I" + (f"+G{k}" if k > 1 else ""), aln)
        r_k.p_invar = 0.05
        m_k = ModelArrays.from_model(s_k, r_k, dev)
        tr_k = branch_transition_mats(m_k, ta.blen).float().contiguous()
        four(steps, n_slots, tr_k, tips, m_k, site, f"C={k} (bench shapes)")
        del tr_k
    # the other genetic codes' spaces through the same instance, at a small shape
    for code in (2, 6):
        crng = np.random.default_rng(150 + code)
        sc = sense_codons(code)
        words = [NT_ORDER[c // 16] + NT_ORDER[(c // 4) % 4] + NT_ORDER[c % 4] for c in sc]
        cseqs = ["".join(words[crng.integers(len(words))] for _ in range(151))
                 for _ in range(30)]
        a_c = Alignment.from_sequences([f"t{i}" for i in range(30)], cseqs, "CODON", code)
        s_c, r_c = parse_model_string("GY+F3X4+G", a_c)
        m_c = ModelArrays.from_model(s_c, r_c, dev)
        t_c = random_tree(30, crng)
        ta_c = TreeArrays.from_tree(t_c, dev)
        st_c, ns_c = pk.device_slot_schedule(t_c, ta_c)
        site_c = SiteData.from_alignment(a_c, dev, torch.float32)
        four(torch.as_tensor(st_c, device=dev), ns_c,
             branch_transition_mats(m_c, ta_c.blen).float().contiguous(),
             tip_partials(site_c).contiguous(), m_c, site_c,
             f"genetic code {code} (S={a_c.num_states}, 30 taxa x 151 codons, C=4)")
    del trans, tips, model, site, ta
    torch.cuda.empty_cache()

    phase("16. codon fixed-topology path: -st CODON -te GY+F3X4+G fit through the CLI "
          "on cuda")
    codon_kernels = ("wide_forward", "wide_store", "wide_tbar", "wide_down_store")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_down_store": csk.fused_down_store,
                "wide_newton": csk.wide_newton_sweep, "forward": pk.fused_site_lnl,
                "store": csk.fused_upward_store_cs, "tbar": csk.fused_tbar_cs,
                "newton": csk.newton_sweep, "down_store": csk.fused_down_store_cs}
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="GY+F3X4+G")[0]
        args = ["-st", "CODON", *args]
        print("iqtree-torch " + " ".join(["-st", "CODON", "-te", "TREE", "-m",
                                          "GY+F3X4+G"]))
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
    for line in log:
        if line.startswith(("Likelihood engine", "Branch optimization", "Memory")):
            print(line)
    fit_lnl = float(logged(log, "Optimal log-likelihood:"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev)
    print(f"fitted model {model_str[:40]}...{model_str[-20:]}")
    print(f"fitted tree and model re-evaluated in float64 (plain pass): {lnl64:.4f}")
    print(f"-st CODON -te GY+F3X4+G fit lnL {fit_lnl:.4f}; reference binary "
          f"{REF_CODON_LNL} (gap {fit_lnl - REF_CODON_LNL:+.4f})")
    print(f"-te GY+F3X4+G fit wall time {wall:.2f} s on {card}")
    print(f"-te GY+F3X4+G fit launches: {launches}")
    k_ms = sum(results[f"{k}_codon"]["ms"] * launches[k] for k in codon_kernels)
    print(f"kernel time of the codon fit, estimated as launches x phase-15 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {wall:.2f} s wall")
    check(abs(lnl64 - fit_lnl) < 1.0, "codon fit lnL vs its float64 re-evaluation")
    check(fit_lnl > REF_CODON_LNL, "codon fit ends above the reference binary's optimum")
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "finite branch lengths of the written codon tree")
    for k in codon_kernels:
        check(launches[k] > 0, f"kernel {k} launched at S=64 on the codon -te path")
        results[f"{k}_codon"]["launches"] = launches[k]
    for k in ("wide_newton", "forward", "store", "tbar", "newton", "down_store"):
        check(launches[k] == 0, f"kernel {k} stays off the codon path (theta path, S=64)")

    phase("17. the codon fit again under torch.profiler")
    with tempfile.TemporaryDirectory() as tmp:
        args = ["-st", "CODON",
                *write_inputs(tmp, names, seqs, tree_nwk, model="GY+F3X4+G")[0]]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "codon fit")


def codon_search_phases(dev, card, record, results, cli_main, bdir, sm_mhz):
    """Phases 18-19: the parsimony kernel's 64-bit instance against its
    twin at the codon shapes, and the codon search with ultrafast
    bootstrap through the CLI, plain and profiled."""
    import numpy as np
    import torch
    from iqtree_torch.engine import parsimony as pars
    from iqtree_torch.engine.banner import NNI_LIVE_TENSORS, decide_engine
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.kernels.probe import ptxas_lines
    from iqtree_torch.engine.likelihood import ModelArrays, SiteData, TreeArrays
    from iqtree_torch.engine.nni import evaluate_nnis, nni_passes
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.codon import NT_ORDER, sense_codons
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree, random_tree

    phase("18. the parsimony kernel's 64-bit instance against its twin (codon: 80 "
          "taxa x 457 patterns; 1 000 taxa x 2 000 codons)")
    regs = ptxas_lines((bdir / "pars_insert.log").read_text(), "ILi64E")
    print(f"  pars_insert 64-bit instance (ptxas; walk, then sums): {'; '.join(regs)}")
    check(bool(regs), "ptxas reports the 64-bit parsimony instance")
    names, seqs, tree_nwk = load_bench("bench_data_codon.npz")
    aln = Alignment.from_sequences(names, seqs, "CODON")
    true_tree = PhyloTree.from_newick(tree_nwk, aln.names)
    N, P, S = aln.n_taxa, aln.n_patterns, aln.num_states
    masks = torch.as_tensor(pars.pack_tip_masks(aln), device=dev)
    pfreq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64, device=dev)
    words = pars.kernel_tip_words(masks, S)
    scratch = pars.kernel_scratch(words, pfreq, S)
    check(words.dtype == torch.int64 and pars.lane_bits(words, scratch[1]) == 64,
          "61 states take the 64-bit instance")
    # every insertion of one stepwise order, the kernel's costs against the
    # twin's (on the card), exactly
    order = [int(t) for t in np.random.default_rng(18).permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    for nxt, t in enumerate(order[3:], N + 1):
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        got = pars.insertion_costs(masks, words, pfreq, t, layout, present, scratch)
        want = pars._edge_costs(
            pars._insertion_costs_plain(masks, pfreq, t, layout, present), layout)
        check(np.array_equal(got, want),
              f"64-bit parsimony: the twin's costs at insertion {nxt - N}")
        insert_taxon(pars, adj, order[0], layout[0][int(np.argmin(want))], t, nxt)
    t_k = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1), dev)
    t_p = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1), torch.device("cpu"))
    check(np.array_equal(t_k.children, t_p.children) and np.array_equal(t_k.blen, t_p.blen),
          "the card's stepwise tree is the twin's")
    print(f"pars_insert_s61: all {N - 3} insertions of a stepwise order give the twin's "
          f"costs exactly; the stepwise tree of seed 1 equals the twin's")

    def timed(aln_x, tree_x, what):
        """The last insertion of a full tree: kernel against twin (exact),
        50 launches each timed alone, kernel and wrapper; (err, kernel ms,
        plain ms, work, n_rows)."""
        Nx = aln_x.n_taxa
        m = torch.as_tensor(pars.pack_tip_masks(aln_x), device=dev)
        f = torch.as_tensor(aln_x.pattern_freq, dtype=torch.float64, device=dev)
        w = pars.kernel_tip_words(m, aln_x.num_states)
        sc = pars.kernel_scratch(w, f, aln_x.num_states)
        leaf, present, layout = partial_tree(tree_x, Nx)
        cost_k = pars.insertion_costs(m, w, f, leaf, layout, present, sc)
        cost_p = pars._edge_costs(pars._insertion_costs_plain(m, f, leaf, layout, present),
                                  layout)
        fin = np.isfinite(cost_p)
        check(np.array_equal(np.isfinite(cost_k), fin), f"{what}: the same edges")
        err = float(np.abs(cost_k[fin] - cost_p[fin]).max())
        check(err == 0.0, f"{what}: the twin's costs exactly")
        launch_args, n_rows = pars_launch(pars, layout, present, w, leaf, sc)
        each = cuda_ms_each(lambda: build.launch(*launch_args), 50)
        wrap = cuda_ms_each(lambda: pars.insertion_costs(m, w, f, leaf, layout, present,
                                                         sc), 50)
        plain = cuda_ms(lambda: pars._insertion_costs_plain(m, f, leaf, layout, present), 3)
        work = pars_work(Nx, w.shape[1], 1, n_rows, word_bytes=8)
        bms, by = bound(*work)
        floor_ms = n_rows * SMEM_ROUND_TRIP / (sm_mhz * 1e3)
        print(f"{what} ({Nx} taxa, {w.shape[1]} 64-bit words, {n_rows} walk rows): exact; "
              f"kernel {spread(each)}; through insertion_costs {spread(wrap)}; plain twin "
              f"{plain:.3f} ms; bound {bms:.4f} ms ({by}), chain floor {floor_ms:.4f} ms "
              f"({n_rows} rows x {SMEM_ROUND_TRIP} cycles at {sm_mhz:.0f} MHz)")
        return err, float(np.mean(each)), plain, work, n_rows

    err, ms, plain, work, _ = timed(aln, true_tree, "pars_insert_s61 at the codon bench")
    record("pars_insert_s61", "iqtree_torch/engine/kernels/csrc/pars_insert.cu",
           "iqtree_tpu/engine/parsimony.py:168 (plain XLA, no Pallas kernel)", err, 0.0,
           ms, plain, *work)
    # a deep codon shape: 1 000 taxa x 2 000 random sense codons (seed 181),
    # a walk as long as the DNA bench's
    crng = np.random.default_rng(181)
    cw = np.array([NT_ORDER[c // 16] + NT_ORDER[(c // 4) % 4] + NT_ORDER[c % 4]
                   for c in sense_codons(1)])
    deep = Alignment.from_sequences(
        [f"t{i}" for i in range(1000)],
        ["".join(cw[crng.integers(len(cw), size=2000)]) for _ in range(1000)], "CODON")
    timed(deep, random_tree(1000, crng), "pars_insert_s61 at 1000 x 2000 codons")
    del masks, words, scratch, deep
    torch.cuda.empty_cache()

    phase("19. the codon search with ultrafast bootstrap through the CLI on cuda")
    codon_kernels = ("wide_forward", "wide_store", "wide_tbar", "wide_down_store")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_down_store": csk.fused_down_store,
                "pars_insert_s61": pars.insertion_costs,
                "wide_newton": csk.wide_newton_sweep, "forward": pk.fused_site_lnl,
                "store": csk.fused_upward_store_cs, "tbar": csk.fused_tbar_cs,
                "newton": csk.newton_sweep, "down_store": csk.fused_down_store_cs}
    with tempfile.TemporaryDirectory() as tmp:
        args, prefix = write_inputs(tmp, names, seqs, tree_nwk, search=CODON_SEARCH_FLAGS)
        print("iqtree-torch " + " ".join(CODON_SEARCH_FLAGS))
        torch.cuda.reset_peak_memory_stats()
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        peak = torch.cuda.max_memory_allocated()
        with open(prefix + ".ufboot") as f:
            boot = f.read().splitlines()
        sizes = {ext: os.path.getsize(prefix + ext) for ext in (".contree", ".splits.nex")}
        with open(prefix + ".contree") as f:
            contree = PhyloTree.from_newick(f.read(), aln.names)
    for line in log:
        if line.startswith(("Likelihood engine", "Branch optimization", "Tree search",
                            "Parsimony start trees", "Memory")):
            print(line)
    best = float(logged(log, "BEST SCORE FOUND :"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev)
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    print(f"codon search: {wall:.2f} s wall on {card}; BEST SCORE FOUND {best:.4f}; "
          f"float64 re-evaluation of the written tree and model {lnl64:.4f}; the port's "
          f"-te fit of the true tree {PORT_CODON_TE_LNL} (gap {best - PORT_CODON_TE_LNL:+.4f}),"
          f" the binary's {REF_CODON_LNL}")
    print(f"RF distance of the best tree to the true tree: "
          f"{out_tree.robinson_foulds(true_tree)} (of {2 * (N - 3)}); consensus to the "
          f"true tree: {contree.robinson_foulds(true_tree)}")
    print(f"UFBoot: {len(boot)} sample trees, {len(supports)} supports on the treefile "
          f"(min {min(supports)}, median {int(np.median(supports))}); files {sizes}; "
          f"summaries and outputs {logged(log, 'UFBoot summaries and outputs:')}")
    for line in log[[i for i, l in enumerate(log) if l.startswith("search profile")][-1]:]:
        if not line.startswith(("search profile", " ")):
            break
        print(line)
    print(f"codon search launches: {launches}")
    k_ms = (sum(results[f"{k}_codon"]["ms"] * launches[k] for k in codon_kernels)
            + results["pars_insert_s61"]["ms"] * launches["pars_insert_s61"])
    print(f"kernel time of the codon search, estimated as launches x phase-15/18 kernel "
          f"ms: {k_ms / 1e3:.3f} s of {wall:.2f} s wall; peak device memory "
          f"{peak / 2**20:.0f} MB (torch.cuda.max_memory_allocated)")
    check(abs(lnl64 - best) < 1.0, "codon search lnL vs its float64 re-evaluation")
    check(best >= PORT_CODON_TE_LNL - 1.0,
          "codon search at or above the port's -te fit of the true tree less 1")
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "a written 80-taxon tree with finite lengths")
    check(len(boot) == 1000 and all(l.strip().endswith(";") for l in boot),
          "every one of the 1000 UFBoot samples holds a tree")
    check(len(supports) == N - 3 and all(0 <= x <= 100 for x in supports),
          "the treefile carries N-3 supports in 0-100")
    check(all(v > 0 for v in sizes.values()), ".contree and .splits.nex written")
    for k in codon_kernels:
        check(launches[k] > 0, f"kernel {k} launched at S=64 on the codon search")
        results[f"{k}_codon"]["launches"] = launches[k]
    check(launches["pars_insert_s61"] > 0, "the 64-bit parsimony instance launched")
    results["pars_insert_s61"]["launches"] = launches["pars_insert_s61"]
    for k in ("wide_newton", "forward", "store", "tbar", "newton", "down_store"):
        check(launches[k] == 0, f"kernel {k} stays off the codon search (theta path, S=64)")

    # the NNI evaluator's working memory at S=61 against decide_engine's
    # model of it: the bytes above the two passes over the chunk's
    # candidates, in [C, S, P] float32 tensors a candidate
    s_fit, r_fit = parse_model_string(model_str, aln)
    model = ModelArrays.from_model(s_fit, r_fit, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(out_tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(out_tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    C = r_fit.ncat
    chunk = decide_engine(N, C, S, P, dev, torch.float32, search=True).nni_chunk
    edges = ta.h2d.cpu().numpy()[out_tree.internal_edges()]
    with torch.no_grad():
        passes = nni_passes(ta, model, site, steps, n_slots)
        evaluate_nnis(ta, model, site, edges, steps, n_slots, edge_chunk=chunk,
                      paired=True, passes=passes)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        evaluate_nnis(ta, model, site, edges, steps, n_slots, edge_chunk=chunk,
                      paired=True, passes=passes)
        torch.cuda.synchronize()
        extra = torch.cuda.max_memory_allocated() - base
    cands = 3 * min(chunk, len(edges))
    live = extra / (cands * C * S * P * 4)
    print(f"NNI evaluator at S=61 ({chunk} edges a chunk, {len(edges)} edges): "
          f"{extra / 2**20:.1f} MB above the passes for {cands} candidates = {live:.2f} "
          f"[C,S,P] float32 tensors a candidate (decide_engine counts "
          f"{NNI_LIVE_TENSORS})")
    check(live <= NNI_LIVE_TENSORS, "the NNI evaluator within decide_engine's memory model")
    del passes, model, site, ta
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, search=CODON_SEARCH_FLAGS)[0]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "codon search")


def mixture_phases(dev, card, record, results, cli_main, bdir):
    """Phases 20-22: the four wide walks with several categories a block at
    C20's 80 categories on the protein bench, and the C20 fit and search
    through the CLI."""
    import numpy as np
    import torch
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.kernels.probe import ptxas_lines
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, ptn_invar,
                                                tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.models.mixture import category_count
    from iqtree_torch.trees.tree import PhyloTree

    phase("20. the wide walks at C20's 80 categories, several a block, against their "
          "plain twins (protein: 300 taxa x 2 000 aa)")
    walks = ("wide_forward", "wide_store", "wide_tbar", "wide_down_store")
    for n in walks:
        regs = ptxas_lines((bdir / f"{n}.log").read_text(), "ILi20ELi5ELb1E")
        print(f"  {n} S=20 instance with several categories a block (ptxas): "
              f"{'; '.join(regs)}")
        check(bool(regs), f"ptxas reports the multi-category instance of {n}")
    for n in walks:  # the one-category instances keep their bounds
        print(f"  {n} S=20 instance at one category a block (ptxas): "
              f"{'; '.join(ptxas_lines((bdir / f'{n}.log').read_text(), 'ILi20ELi5ELb0E'))}")
    names, seqs, tree_nwk = load_bench("bench_data_protein.npz")
    aln = Alignment.from_sequences(names, seqs, "AA")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    subst, rate = parse_model_string("C20", aln)
    C, S = category_count(subst, rate), subst.num_states
    model = ModelArrays.from_model(subst, rate, dev)
    check(C == 80 == model.ncat, "C20 is 20 classes x 4 rate categories")
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    rng = np.random.default_rng(20)  # random branch lengths around the bench tree's
    blen = ta.blen * torch.as_tensor(rng.uniform(0.5, 1.5, ta.blen.shape), device=dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P = aln.n_taxa, aln.n_patterns
    CS, CSS, R = C * S, C * S * S, 2 * N
    K, cb = build.wide_layout(C)
    warps = pk.wide_forward_warps(S, C, 16, n_slots)
    teams = {"wide_forward": warps, "wide_store": warps,
             "wide_down_store": csk.wide_reverse_teams(S, C, 16, n_slots),
             "wide_tbar": csk.wide_reverse_teams(S, C, 16, n_slots, sums=True)}
    print(f"{N} taxa, {P} patterns, C={C} ({cb} categories a block on {K}-block "
          f"clusters), S={S}, {n_slots} slots; shared memory a block by the formulas at "
          f"16 patterns a cluster: wide_forward / wide_store "
          f"{pk.wide_forward_smem(S, C, 16, n_slots, warps=warps)} B ({warps} category "
          f"warps; {pk.wide_forward_smem(S, C, 16, n_slots)} B at one), wide_down_store "
          f"{csk.wide_down_store_smem(S, C, 16, n_slots, warps=teams['wide_down_store'])} B "
          f"({teams['wide_down_store']} category teams; "
          f"{csk.wide_down_store_smem(S, C, 16, n_slots)} B at one), wide_tbar "
          f"{csk.wide_tbar_smem(S, C, 16, n_slots, warps=teams['wide_tbar'])} B "
          f"({teams['wide_tbar']} teams; {csk.wide_tbar_smem(S, C, 16, n_slots)} B at one) "
          f"(a block may have {SMEM_BLOCK})")
    for n in walks:
        lay = build.walk_launch(n, C, S, n_slots, 16)
        w, upward = teams[n], n in walks[:2]
        units = -(-cb // lay["warps"])
        print(f"{n} C={C}: its C entry's launch: {lay['warps']} category "
              f"{'warps' if upward else 'teams'} a block ({units} units a "
              f"{'step' if upward else 'phase'}), {lay['threads']} threads, "
              f"{lay['smem']} B of shared memory a block, at most {lay['clusters']} "
              f"clusters of {K} blocks at once ({-(-((P + 15) // 16) // max(lay['clusters'], 1))}"
              f" waves of {(P + 15) // 16} clusters)")
        smem = (pk.wide_forward_smem(S, C, 16, n_slots, warps=w) if upward else
                csk.wide_tbar_smem(S, C, 16, n_slots, warps=w) if n == "wide_tbar" else
                csk.wide_down_store_smem(S, C, 16, n_slots, warps=w))
        check(lay["warps"] == w and lay["clusters"] > 0 and lay["smem"] == smem,
              f"{n}'s launch takes the chooser's {w} {'warps' if upward else 'teams'} and "
              f"places its clusters")
    trans = branch_transition_mats(model, blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    invar = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P

    def c80_ms(name, fn):  # three 10-launch means, and their mean
        ms = [cuda_ms(fn, 10) for _ in range(3)]
        print(f"{name} C=80: three 10-launch means {', '.join(f'{m:.3f}' for m in ms)} ms")
        return sum(ms) / len(ms)
    # the forward kernel: lnL per pattern
    k_out = pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
    bit_equal("wide_forward C=80", [k_out],
              [pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, invar)])
    record("wide_forward_c80", "iqtree_torch/engine/kernels/csrc/wide_forward.cu",
           "iqtree_tpu/engine/kernels/pruning.py:34",
           float((k_out - pk._site_lnl_plain(steps, trans, tips, props, freq,
                                             invar)).abs().max()), 1e-3,
           cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq,
                                            invar), 5),
           cuda_ms(lambda: pk._site_lnl_plain(steps, trans, tips, props, freq, invar), 2),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + CS + 2 * P), fwd_flops)
    # the upward store
    up_k, usc_k = pk.fused_upward_store(steps, n_slots, trans, tips)
    inner = slice(N, 2 * N - 1)
    up2, usc2 = pk.fused_upward_store(steps, n_slots, trans, tips)
    bit_equal("wide_store C=80", [up_k[inner], usc_k], [up2[inner], usc2])
    del up2, usc2
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    err = store_err(up_k, usc_k, up_p, usc_p, inner)
    del up_p, usc_p
    torch.cuda.empty_cache()
    record("wide_store_c80", "iqtree_torch/engine/kernels/csrc/wide_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:822", err, 1e-4,
           cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips), 5),
           cuda_ms(lambda: pk.upward_plain(steps, trans, tips), 2),
           4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P), fwd_flops)
    # the gradient sweep
    csk.fill_tip_rows_cs(up_k, usc_k, tips, C)
    lnl, wp = k_out.contiguous(), site.pattern_freq.contiguous()
    targs = (steps, n_slots, trans, tips, props, freq, lnl, wp)
    tb_k = csk.fused_downward_tbar(*targs, up=up_k, usc=usc_k)
    bit_equal("wide_tbar C=80", [tb_k], [csk.fused_downward_tbar(*targs, up=up_k,
                                                                 usc=usc_k)])
    tb_p = csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k, usc_k)
    err = tbar_err(tb_k, tb_p, R)
    del tb_k, tb_p
    torch.cuda.empty_cache()
    record("wide_tbar_c80", "iqtree_torch/engine/kernels/csrc/wide_tbar.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1144", err, 1e-4,
           c80_ms("wide_tbar", lambda: csk.fused_downward_tbar(*targs, up=up_k, usc=usc_k)),
           cuda_ms(lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k,
                                           usc_k), 2),
           4 * (R * (CS + 1) * P + 2 * P + 2 * R * CSS), tbar_flops(N, P, CS, CSS))
    # the outside-partial store
    dargs = (steps, n_slots, trans, up_k, usc_k, freq)
    o_k = csk.fused_down_store(*dargs)
    bit_equal("wide_down_store C=80", o_k, csk.fused_down_store(*dargs))
    check(not bool(o_k[0][R - 2:].any()) and not bool(o_k[1][R - 2:].any()),
          "root and dummy rows of the outside store are 0 at C=80")
    err = outside_err(o_k, csk._down_store_plain(*dargs[:1], *dargs[2:]), R)
    del o_k
    torch.cuda.empty_cache()
    record("wide_down_store_c80", "iqtree_torch/engine/kernels/csrc/wide_down_store.cu",
           "iqtree_tpu/engine/kernels/pruning.py:1437", err, 1e-4,
           c80_ms("wide_down_store", lambda: csk.fused_down_store(*dargs)),
           cuda_ms(lambda: csk._down_store_plain(*dargs[:1], *dargs[2:]), 2),
           4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
           P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
    for k in walks:
        r_ = results[f"{k}_c80"]
        ms0 = EARLIER_C80_MS[k]
        print(f"{k} C=80: {r_['ms']:.3f} ms beside {results[k]['ms']:.3f} ms at LG+G4's "
              f"C=4 ({r_['ms'] / results[k]['ms']:.1f}x for 20x the categories), "
              f"{r_['bound_ms'] / r_['ms']:.1%} of its bound; the earlier design (one "
              f"{'warp' if k in walks[:2] else 'team'} a block, on an NVIDIA H100 80GB HBM3 "
              f"at 700 W) {ms0} ms ({ms0 / r_['ms']:.2f}x)")
    del up_k, usc_k, dargs, targs
    # C60: 240 categories, 30 a block, where the formulas fit this tree's slots
    need = build.wide_walk_smem(240, S, n_slots)
    s60, r60 = parse_model_string("C60", aln)
    m60 = ModelArrays.from_model(s60, r60, dev)
    tr60 = branch_transition_mats(m60, blen).float().contiguous()
    if need > SMEM_BLOCK:
        try:
            pk.wide_site_lnl(steps, n_slots, tr60, tips, m60.props.float(),
                             m60.state_freq.float(), ptn_invar(m60, site).float())
            refused = False
        except NotImplementedError as e:
            refused = True
            print(f"C60 (240 categories, {build.wide_layout(240)[1]} a block) at {n_slots} "
                  f"slots: {need} B of shared memory a block, over {SMEM_BLOCK}: refused "
                  f"({str(e)[:80]}...)")
        check(refused, "C60 refused where its shared memory does not fit")
    else:
        f60 = pk.wide_site_lnl(steps, n_slots, tr60, tips, m60.props.float(),
                               m60.state_freq.float(), ptn_invar(m60, site).float())
        e60 = float((f60 - pk._site_lnl_plain(steps, tr60, tips, m60.props.float(),
                                              m60.state_freq.float(),
                                              ptn_invar(m60, site).float())).abs().max())
        print(f"wide_forward C=240: max_abs_err {e60:.3e} (tol 1e-3)")
        check(e60 <= 1e-3, "wide_forward at C=240 against its twin")
    del m60, tr60, trans, tips, model, site, ta
    torch.cuda.empty_cache()

    phase("21. mixture fixed-topology path: -te C20 fit through the CLI on cuda")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_down_store": csk.fused_down_store,
                "wide_newton": csk.wide_newton_sweep, "forward": pk.fused_site_lnl,
                "store": csk.fused_upward_store_cs, "tbar": csk.fused_tbar_cs,
                "newton": csk.newton_sweep, "down_store": csk.fused_down_store_cs}
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="C20")[0]
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
    for line in log:
        if line.startswith(("Likelihood engine", "Branch optimization", "Memory")):
            print(line)
    fit_lnl = float(logged(log, "Optimal log-likelihood:"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev, grad=False)
    print(f"fitted model {model_str[:40]}...{model_str[-24:]}")
    print(f"-te C20 fit lnL {fit_lnl:.4f}; the written tree and model re-evaluated in "
          f"float64 (plain pass) {lnl64:.4f}; for information, LG+G4's fit of the same "
          f"tree by the binary {REF_PROTEIN_LNL}")
    print(f"-te C20 fit wall time {wall:.2f} s on {card}")
    print(f"-te C20 fit launches: {launches}")
    k_ms = sum(results[f"{k}_c80"]["ms"] * launches[k] for k in walks)
    print(f"kernel time of the C20 fit, estimated as launches x phase-20 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {wall:.2f} s wall")
    check(abs(lnl64 - fit_lnl) < 1.0, "C20 fit lnL vs its float64 re-evaluation")
    check("theta path" in " ".join(log), "C20's branch lengths take the theta path")
    for k in walks:
        check(launches[k] > 0, f"kernel {k} launched at C=80 on the C20 fit")
    for k in ("wide_newton", "forward", "store", "tbar", "newton", "down_store"):
        check(launches[k] == 0, f"kernel {k} stays off the C20 fit")
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="C20")[0]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "C20 fit")

    phase("22. the C20 search with ultrafast bootstrap through the CLI on cuda")
    flags = ["-m", "C20", "-n", "2", "-ninit", "4", "-ntop", "2", "-seed", "1", "-bb",
             "1000", "-wbt"]
    with tempfile.TemporaryDirectory() as tmp:
        args, prefix = write_inputs(tmp, names, seqs, tree_nwk, search=flags)
        print("iqtree-torch " + " ".join(flags))
        torch.cuda.reset_peak_memory_stats()
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        peak = torch.cuda.max_memory_allocated()
        with open(prefix + ".ufboot") as f:
            boot = f.read().splitlines()
        sizes = {ext: os.path.getsize(prefix + ext) for ext in (".contree", ".splits.nex")}
    for line in log:
        if line.startswith(("Likelihood engine", "Branch optimization", "Tree search",
                            "Parsimony start trees", "Memory")):
            print(line)
    best = float(logged(log, "BEST SCORE FOUND :"))
    model_str = logged(log, "Best-fit model parameters:")
    lnl64, _, _ = reevaluate(nwk, model_str, aln, dev, grad=False)
    out_tree = PhyloTree.from_newick(nwk, aln.names)
    supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    print(f"C20 search: {wall:.2f} s wall on {card}; BEST SCORE FOUND {best:.4f}; float64 "
          f"re-evaluation of the written tree and model {lnl64:.4f}; the -te C20 fit of "
          f"the bench tree {fit_lnl:.4f}")
    print(f"RF distance of the best tree to the bench tree: {out_tree.robinson_foulds(tree)}"
          f" (of {2 * (N - 3)})")
    print(f"UFBoot: {len(boot)} sample trees, {len(supports)} supports on the treefile "
          f"(min {min(supports)}, median {int(np.median(supports))}); files {sizes}; "
          f"summaries and outputs {logged(log, 'UFBoot summaries and outputs:')}")
    for line in log[[i for i, l in enumerate(log) if l.startswith("search profile")][-1]:]:
        if not line.startswith(("search profile", " ")):
            break
        print(line)
    print(f"C20 search launches: {launches}")
    k_ms = sum(results[f"{k}_c80"]["ms"] * launches[k] for k in walks)
    print(f"kernel time of the C20 search, estimated as launches x phase-20 kernel ms: "
          f"{k_ms / 1e3:.3f} s of {wall:.2f} s wall; peak device memory "
          f"{peak / 2**20:.0f} MB (torch.cuda.max_memory_allocated)")
    check(abs(lnl64 - best) < 1.0, "C20 search lnL vs its float64 re-evaluation")
    check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
          "a written 300-taxon tree with finite lengths")
    check(len(boot) == 1000 and all(l.strip().endswith(";") for l in boot),
          "every one of the 1000 UFBoot samples holds a tree")
    check(len(supports) == N - 3 and all(0 <= x <= 100 for x in supports),
          "the treefile carries N-3 supports in 0-100")
    check(all(v > 0 for v in sizes.values()), ".contree and .splits.nex written")
    for k in walks:
        check(launches[k] > 0, f"kernel {k} launched at C=80 on the C20 search")
        results[f"{k}_c80"]["launches"] = launches[k]
    for k in ("wide_newton", "forward", "store", "tbar", "newton", "down_store"):
        check(launches[k] == 0, f"kernel {k} stays off the C20 search")


def freerate_phases(dev, card, record, results, cli_main, bdir):
    """Phase 23: the wide walks' DNA instances past 8 categories (S = 4) on
    the DNA bench; then phases 24-26 (freerate_cli_phases)."""
    import numpy as np
    import torch
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.kernels.probe import ptxas_lines
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, ptn_invar,
                                                tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree

    phase("23. the wide walks' and wide_newton's DNA instances past 8 categories (S=4) "
          "against their plain twins (1000 taxa x 10k sites, GTR+I+R9/R10/R16)")
    walks = ("wide_forward", "wide_store", "wide_tbar", "wide_down_store")
    for n in walks:
        regs = ptxas_lines((bdir / f"{n}.log").read_text(), "ILi4ELi1ELb1E")
        print(f"  {n} S=4 instance, several categories a block (ptxas): {'; '.join(regs)}")
        check(bool(regs), f"ptxas reports the DNA instance of {n}")
        check(not ptxas_lines((bdir / f"{n}.log").read_text(), "ILi4ELi1ELb0E"),
              f"{n} has no one-category DNA instance (the CS-packed kernels serve C <= 8)")
    regs = ptxas_lines((bdir / "wide_newton.log").read_text(), "wide_newton_multi_kernel")
    print(f"  wide_newton S=4 instance, all categories a block (ptxas): {'; '.join(regs)}")
    check(bool(regs), "ptxas reports the DNA instance of wide_newton")
    names, seqs, tree_nwk = load_bench()
    aln = Alignment.from_sequences(names, seqs, "DNA")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P, S, R = aln.n_taxa, aln.n_patterns, 4, 2 * aln.n_taxa
    tips = tip_partials(site).contiguous()
    inner = slice(N, R - 1)
    print(f"{N} taxa, {P} patterns, {n_slots} slots (at most {build.max_slots(N)} for "
          f"{N} taxa)")
    for slots in sorted({n_slots, build.max_slots(N)}):  # what the choosers pick at C=10
        K, cb = build.wide_layout(10)
        for n in walks:
            lay = build.walk_launch(n, 10, S, slots, 16)
            upward = n in walks[:2]
            w = (pk.wide_forward_warps(S, 10, 16, slots) if upward else
                 csk.wide_reverse_teams(S, 10, 16, slots, sums=n == "wide_tbar"))
            smem = (pk.wide_forward_smem(S, 10, 16, slots, warps=w) if upward else
                    csk.wide_tbar_smem(S, 10, 16, slots, warps=w) if n == "wide_tbar" else
                    csk.wide_down_store_smem(S, 10, 16, slots, warps=w))
            print(f"  C=10 at {slots} slots, {n}: {lay['warps']} category "
                  f"{'warps' if upward else 'teams'} ({cb} categories a block on {K}-block "
                  f"clusters, {-(-cb // lay['warps'])} units a "
                  f"{'step' if upward else 'phase'}), {lay['threads']} threads, "
                  f"{lay['smem']} B of shared memory a block (of {SMEM_BLOCK}), at most "
                  f"{lay['clusters']} clusters at once ({-(-P // 16)} clusters)")
            check(lay["warps"] == w and lay["smem"] == smem <= SMEM_BLOCK
                  and lay["clusters"] > 0, f"{n}'s launch at C=10 is its chooser's")
    rng = np.random.default_rng(23)

    def s4_case(C, rates=None):
        """GTR+I+R{C} with exchangeabilities, weights and rates from the seed
        (or `rates`), and its edge matrices at the bench tree's lengths."""
        subst, rate = parse_model_string(f"GTR+I+R{C}", aln)
        subst.set_rate_param_vector(rng.uniform(0.5, 3.0, 5))
        rate.p_invar = 0.1
        rate.free_rates = (np.sort(rng.gamma(0.7, 1.0 / 0.7, C)) if rates is None
                           else np.asarray(rates, float))
        rate.free_props = rng.dirichlet(np.ones(C))
        model = ModelArrays.from_model(subst, rate, dev)
        if rates is not None:  # the rates as given, not renormalized to mean 1
            model.rates = torch.as_tensor(rate.free_rates, device=dev)
        return (model, branch_transition_mats(model, ta.blen).float().contiguous(),
                ptn_invar(model, site).float().contiguous())

    def means(name, fn):  # three 10-launch means, and their mean
        ms = [cuda_ms(fn, 10) for _ in range(3)]
        print(f"  {name}: three 10-launch means {', '.join(f'{m:.3f}' for m in ms)} ms")
        return sum(ms) / len(ms)

    cases = [(9, None), (10, None), (16, None), (10, np.geomspace(1e-3, 20.0, 10))]
    for C, rates in cases:
        extreme = rates is not None
        tag = f"C={C}" + (" (rates 1e-3 .. 20)" if extreme else "")
        model, trans, invar = s4_case(C, rates)
        print(f"{tag}: rates {np.array2string(model.rates.cpu().numpy(), precision=4)}")
        props, freq = model.props.float(), model.state_freq.float()
        CS, CSS = C * S, C * S * S
        check(not build.packed(C, S), f"{tag} is past the CS-packed kernels")
        rec = C == 10 and not extreme  # +R10: the kernels line's S=4 rows
        fwd_flops = (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P
        # the forward kernel, through the engine's wrapper
        before = pk.wide_site_lnl.launches
        k_out = pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)
        check(pk.wide_site_lnl.launches == before + 1, f"{tag}: forward runs the wide walk")
        bit_equal(f"wide_forward S=4 {tag}", [k_out],
                  [pk.fused_site_lnl(steps, n_slots, trans, tips, props, freq, invar)])
        err = float((k_out - pk._site_lnl_plain(steps, trans, tips, props, freq,
                                                invar)).abs().max())
        print(f"wide_forward S=4 {tag}: max_abs_err {err:.3e} (tol 1e-3)")
        check(err <= 1e-3, f"wide_forward S=4 {tag} against its twin")
        if rec:
            record("wide_forward_s4", "iqtree_torch/engine/kernels/csrc/wide_forward.cu",
                   "iqtree_tpu/engine/kernels/pruning.py:34", err, 1e-3,
                   means("wide_forward S=4 C=10", lambda: pk.fused_site_lnl(
                       steps, n_slots, trans, tips, props, freq, invar)),
                   cuda_ms(lambda: pk._site_lnl_plain(steps, trans, tips, props, freq,
                                                      invar), 2),
                   4 * (N * S * P + R * CSS + 6 * (N - 1) + CS + 2 * P), fwd_flops)
        # the upward store
        up_k, usc_k = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
        up2, usc2 = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
        bit_equal(f"wide_store S=4 {tag}", [up_k[inner], usc_k[inner]],
                  [up2[inner], usc2[inner]])
        del up2, usc2
        up_p, usc_p = pk.upward_plain(steps, trans, tips)
        err = store_err(up_k, usc_k, up_p, usc_p, inner)
        del up_p, usc_p
        print(f"wide_store S=4 {tag}: max_abs_err {err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"wide_store S=4 {tag} against its twin")
        if rec:
            record("wide_store_s4", "iqtree_torch/engine/kernels/csrc/wide_store.cu",
                   "iqtree_tpu/engine/kernels/pruning.py:822", err, 1e-4,
                   means("wide_store S=4 C=10", lambda: csk.fused_upward_store_cs(
                       steps, n_slots, trans, tips)),
                   cuda_ms(lambda: pk.upward_plain(steps, trans, tips), 2),
                   4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P),
                   fwd_flops)
        # the gradient sweep
        csk.fill_tip_rows_cs(up_k, usc_k, tips, C)
        lnl, wp = k_out.contiguous(), site.pattern_freq.contiguous()
        targs = (steps, n_slots, trans, tips, props, freq, lnl, wp)
        tb_k = csk.fused_tbar_cs(*targs, up=up_k, usc=usc_k)
        bit_equal(f"wide_tbar S=4 {tag}", [tb_k], [csk.fused_tbar_cs(*targs, up=up_k,
                                                                     usc=usc_k)])
        err = tbar_err(tb_k, csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k,
                                             usc_k), R)
        del tb_k
        print(f"wide_tbar S=4 {tag}: max rel err {err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"wide_tbar S=4 {tag} against its twin")
        if rec:
            record("wide_tbar_s4", "iqtree_torch/engine/kernels/csrc/wide_tbar.cu",
                   "iqtree_tpu/engine/kernels/pruning.py:1144", err, 1e-4,
                   means("wide_tbar S=4 C=10", lambda: csk.fused_tbar_cs(
                       *targs, up=up_k, usc=usc_k)),
                   cuda_ms(lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp, up_k,
                                                   usc_k), 2),
                   4 * (R * (CS + 1) * P + 2 * P + 2 * R * CSS), tbar_flops(N, P, CS, CSS))
        # the outside-partial store
        dargs = (steps, n_slots, trans, up_k, usc_k, freq)
        o_k = csk.fused_down_store_cs(*dargs)
        bit_equal(f"wide_down_store S=4 {tag}", o_k, csk.fused_down_store_cs(*dargs))
        check(not bool(o_k[0][R - 2:].any()) and not bool(o_k[1][R - 2:].any()),
              f"root and dummy rows of the outside store are 0 at {tag}")
        err = outside_err(o_k, csk._down_store_plain(*dargs[:1], *dargs[2:]), R)
        del o_k
        print(f"wide_down_store S=4 {tag}: max_abs_err {err:.3e} (tol 1e-4)")
        check(err <= 1e-4, f"wide_down_store S=4 {tag} against its twin")
        if rec:
            record("wide_down_store_s4",
                   "iqtree_torch/engine/kernels/csrc/wide_down_store.cu",
                   "iqtree_tpu/engine/kernels/pruning.py:1437", err, 1e-4,
                   means("wide_down_store S=4 C=10",
                         lambda: csk.fused_down_store_cs(*dargs)),
                   cuda_ms(lambda: csk._down_store_plain(*dargs[:1], *dargs[2:]), 2),
                   4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
                   P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
        # the branch-Newton sweep: wide_newton's multi-category instance
        mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
        nargs = (steps, n_slots, mats, props, freq, wp, invar, up_k, usc_k)
        before = (csk.newton_sweep.launches, csk.wide_newton_sweep.launches)
        d_k = csk.newton_sweep(*nargs)
        check((csk.newton_sweep.launches, csk.wide_newton_sweep.launches)
              == (before[0], before[1] + 1), f"{tag}: the branch-Newton sweep runs "
              "wide_newton's DNA instance, not the CS-packed newton.cu")
        bit_equal(f"wide_newton S=4 {tag}", d_k, csk.newton_sweep(*nargs))
        check(not bool(d_k[0][[ta.root, ta.dummy]].any()),
              f"root and dummy rows of the branch derivatives are 0 at {tag}")
        d_p = csk._newton_plain(*nargs[:1], *nargs[2:])
        err = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(d_k, d_p))
        del d_k, d_p
        print(f"wide_newton S=4 {tag}: max rel err {err:.3e} (tol 1e-4), "
              f"{csk.WIDE_NEWTON_MULTI_TILE} patterns a block")
        check(err <= 1e-4, f"wide_newton S=4 {tag} against its twin")
        if rec:
            record("wide_newton_s4", "iqtree_torch/engine/kernels/csrc/wide_newton.cu",
                   "iqtree_tpu/engine/kernels/cs_kernels.py:300", err, 1e-4,
                   means("wide_newton S=4 C=10", lambda: csk.newton_sweep(*nargs)),
                   cuda_ms(lambda: csk._newton_plain(*nargs[:1], *nargs[2:]), 2),
                   4 * (R * (CS + 1) * P + 3 * P + 3 * R * CSS + 2 * R),
                   newton_flops(N, P, CS, CSS))
            print("  C=10 wide_newton at 8 / 16 / 32 patterns a block ("
                  f"{csk.WIDE_NEWTON_MULTI_TILE} is the wrapper's): " + ", ".join(
                      f"{cuda_ms(lambda: csk.wide_newton_sweep(*nargs, tile=t), 10):.3f} ms"
                      for t in (8, 16, 32)))
        elif not extreme:
            means(f"wide_newton S=4 {tag}", lambda: csk.newton_sweep(*nargs))
        del mats, nargs
        if rec:  # for information: more patterns a cluster, fewer waves
            for t in (32, 64):
                got = [pk.wide_site_lnl(steps, n_slots, trans, tips, props, freq, invar,
                                        tile=t),
                       pk.fused_upward_store(steps, n_slots, trans, tips, tile=t)[0][inner],
                       csk.fused_downward_tbar(*targs, up=up_k, usc=usc_k, tile=t),
                       csk.fused_down_store(*dargs, tile=t)[0]]
                want = [k_out, csk.fused_upward_store_cs(steps, n_slots, trans,
                                                         tips)[0][inner],
                        csk.fused_tbar_cs(*targs, up=up_k, usc=usc_k),
                        csk.fused_down_store_cs(*dargs)[0]]
                same = [torch.equal(g, w) for g, w in zip(got, want)]
                del got, want
                ms = [cuda_ms(lambda: pk.wide_site_lnl(steps, n_slots, trans, tips, props,
                                                       freq, invar, tile=t), 10),
                      cuda_ms(lambda: pk.fused_upward_store(steps, n_slots, trans, tips,
                                                            tile=t), 10),
                      cuda_ms(lambda: csk.fused_downward_tbar(*targs, up=up_k, usc=usc_k,
                                                              tile=t), 10),
                      cuda_ms(lambda: csk.fused_down_store(*dargs, tile=t), 10)]
                print(f"  C=10 at {t} patterns a cluster (16 is the wrappers'): "
                      + ", ".join(f"{n} {m:.3f} ms (16's bits: {b})"
                                  for n, m, b in zip(walks, ms, same)))
        elif not extreme:
            for n, fn in (("wide_forward", lambda: pk.fused_site_lnl(
                              steps, n_slots, trans, tips, props, freq, invar)),
                          ("wide_store", lambda: csk.fused_upward_store_cs(
                              steps, n_slots, trans, tips)),
                          ("wide_tbar", lambda: csk.fused_tbar_cs(*targs, up=up_k,
                                                                  usc=usc_k)),
                          ("wide_down_store", lambda: csk.fused_down_store_cs(*dargs))):
                means(f"{n} S=4 {tag}", fn)
        del up_k, usc_k, dargs, targs, model, trans, invar
        torch.cuda.empty_cache()
    for k in walks + ("wide_newton",):
        r_ = results[f"{k}_s4"]
        print(f"{k} S=4 C=10: {r_['ms']:.3f} ms, {r_['bound_ms'] / r_['ms']:.1%} of its "
              f"bound ({r_['bound_by']}); the CS-packed kernel at C=4 "
              f"{results[k[5:]]['ms']:.3f} ms")
    del site, ta, tips
    torch.cuda.empty_cache()
    freerate_cli_phases(dev, card, results, cli_main)


def freerate_cli_phases(dev, card, results, cli_main):
    """Phases 24-26: FreeRate through the CLI -- the GTR+R4 and GTR+I+R10
    fits on the DNA bench, the LG+R4 search with its bootstrap and the LG4X
    fit on the protein bench."""
    import numpy as np
    import torch
    from iqtree_torch.engine import parsimony as pars
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                compute_loglik)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree

    walks = ("wide_forward", "wide_store", "wide_tbar", "wide_down_store")
    names, seqs, tree_nwk = load_bench()
    aln = Alignment.from_sequences(names, seqs, "DNA")

    phase("24. FreeRate fits through the CLI on cuda: -te GTR+R4 and -te GTR+I+R10 "
          "(1000 taxa x 10k sites)")
    counters = {"wide_forward": pk.wide_site_lnl, "wide_store": pk.fused_upward_store,
                "wide_tbar": csk.fused_downward_tbar,
                "wide_down_store": csk.fused_down_store,
                "wide_newton": csk.wide_newton_sweep, "forward": pk.fused_site_lnl,
                "store": csk.fused_upward_store_cs, "tbar": csk.fused_tbar_cs,
                "newton": csk.newton_sweep, "down_store": csk.fused_down_store_cs}
    packed = ("forward", "store", "tbar", "newton", "down_store")
    for model_name in ("GTR+R4", "GTR+I+R10"):
        with tempfile.TemporaryDirectory() as tmp:
            args = write_inputs(tmp, names, seqs, tree_nwk, model=model_name)[0]
            wall, launches, log, nwk = run_cli(cli_main, args, counters)
            for line in log:
                if line.startswith(("Likelihood engine", "Branch optimization", "Memory")):
                    print(line)
            fit_lnl = float(logged(log, "Optimal log-likelihood:"))
            model_str = logged(log, "Best-fit model parameters:")
            lnl64, _, _ = reevaluate(nwk, model_str, aln, dev, grad=False)
            print(f"fitted model {model_str}")
            print(f"-te {model_name} fit lnL {fit_lnl:.4f}; the written tree and model "
                  f"re-evaluated in float64 (plain pass) {lnl64:.4f}; for information, "
                  f"the binary's GTR+G4 fit of the same tree {REF_OPTIMUM}")
            print(f"-te {model_name} fit wall time {wall:.2f} s on {card}")
            print(f"-te {model_name} fit launches: {launches}")
            check(abs(lnl64 - fit_lnl) < 1.0, f"{model_name} fit lnL vs its float64 "
                  "re-evaluation")
            if model_name == "GTR+R4":  # C = 4: the CS-packed kernels (a -te fit
                # runs no outside store)
                for k in packed[:4]:
                    check(launches[k] > 0, f"kernel {k} launched on the GTR+R4 fit")
                for k in walks + ("wide_newton",):
                    check(launches[k] == 0, f"kernel {k} stays off the GTR+R4 fit")
            else:  # C = 10: the DNA instances of the wide walks and of wide_newton
                check("Branch optimization: branch-Newton sweep kernel" in "\n".join(log),
                      "R10's branch lengths take the branch-Newton sweep kernel")
                for k in walks[:3] + ("wide_newton",):
                    check(launches[k] > 0, f"kernel {k} launched on the GTR+I+R10 fit")
                    results[f"{k}_s4"]["launches"] = launches[k]
                for k in packed + ("wide_down_store",):  # a -te fit: no outside store
                    check(launches[k] == 0, f"kernel {k} stays off the GTR+I+R10 fit")
                k_ms = sum(results[f"{k}_s4"]["ms"] * launches[k]
                           for k in walks[:3] + ("wide_newton",))
                print(f"kernel time of the R10 fit, estimated as launches x phase-23 "
                      f"kernel ms: {k_ms / 1e3:.3f} s of {wall:.2f} s wall")
            args = write_inputs(tmp, names, seqs, tree_nwk, model=model_name)[0]
            profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                        f"{model_name} fit")
    # a search at C = 10: the NNI evaluator runs the outside store's DNA instance
    n_cut = 100
    cut = Alignment.from_sequences(names[:n_cut], seqs[:n_cut], "DNA")
    flags = ["-m", "GTR+I+R10", "-n", "1", "-ninit", "2", "-ntop", "1", "-seed", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names[:n_cut], seqs[:n_cut], tree_nwk, search=flags)[0]
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        best = float(logged(log, "BEST SCORE FOUND :"))
        lnl64, _, _ = reevaluate(nwk, logged(log, "Best-fit model parameters:"), cut, dev,
                                 grad=False)
        print(f"iqtree-torch {' '.join(flags)} on the first {n_cut} taxa "
              f"({cut.n_patterns} patterns): {wall:.2f} s wall on {card}; BEST SCORE FOUND "
              f"{best:.4f}; float64 re-evaluation of the written tree and model "
              f"{lnl64:.4f}")
        print(f"GTR+I+R10 search launches: {launches}")
        check(abs(lnl64 - best) < 1.0, "GTR+I+R10 search lnL vs its float64 re-evaluation")
        for k in walks + ("wide_newton",):
            check(launches[k] > 0, f"kernel {k} launched on the GTR+I+R10 search")
        for k in packed:
            check(launches[k] == 0, f"the CS-packed kernel {k} stays off the R10 search")
        results["wide_down_store_s4"]["launches"] = launches["wide_down_store"]
    del aln, cut

    phase("25. the LG+R4 search with ultrafast bootstrap through the CLI on cuda")
    names, seqs, tree_nwk = load_bench("bench_data_protein.npz")
    aln = Alignment.from_sequences(names, seqs, "AA")
    N = aln.n_taxa
    counters["pars_insert_s20"] = pars.insertion_costs
    flags = ["-m", "LG+R4", "-n", "2", "-ninit", "4", "-ntop", "2", "-seed", "1", "-bb",
             "1000", "-wbt"]
    with tempfile.TemporaryDirectory() as tmp:
        args, prefix = write_inputs(tmp, names, seqs, tree_nwk, search=flags)
        print("iqtree-torch " + " ".join(flags))
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        with open(prefix + ".ufboot") as f:
            boot = f.read().splitlines()
        sizes = {ext: os.path.getsize(prefix + ext) for ext in (".contree", ".splits.nex")}
        best = float(logged(log, "BEST SCORE FOUND :"))
        model_str = logged(log, "Best-fit model parameters:")
        lnl64, _, _ = reevaluate(nwk, model_str, aln, dev, grad=False)
        out_tree = PhyloTree.from_newick(nwk, aln.names)
        supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
        print(f"fitted model ...{model_str[-90:]}")
        print(f"LG+R4 search: {wall:.2f} s wall on {card}; BEST SCORE FOUND {best:.4f}; "
              f"float64 re-evaluation of the written tree and model {lnl64:.4f}; for "
              f"information, the binary's -te LG+G4 fit of the true tree {REF_PROTEIN_LNL}")
        print(f"UFBoot: {len(boot)} sample trees, {len(supports)} supports on the treefile "
              f"(min {min(supports)}, median {int(np.median(supports))}); files {sizes}; "
              f"summaries and outputs {logged(log, 'UFBoot summaries and outputs:')}")
        for line in log[[i for i, l in enumerate(log)
                         if l.startswith("search profile")][-1]:]:
            if not line.startswith(("search profile", " ")):
                break
            print(line)
        print(f"LG+R4 search launches: {launches}")
        check(abs(lnl64 - best) < 1.0, "LG+R4 search lnL vs its float64 re-evaluation")
        check(bool(np.all(np.isfinite(out_tree.blen))) and out_tree.n_taxa == N,
              "a written 300-taxon tree with finite lengths")
        check(len(boot) == 1000 and all(l.strip().endswith(";") for l in boot),
              "every one of the 1000 UFBoot samples holds a tree")
        check(len(supports) == N - 3 and all(0 <= x <= 100 for x in supports),
              "the treefile carries N-3 supports in 0-100")
        check(all(v > 0 for v in sizes.values()), ".contree and .splits.nex written")
        for k in ("wide_forward", "wide_store", "wide_tbar", "wide_newton",
                  "wide_down_store", "pars_insert_s20"):
            check(launches[k] > 0, f"kernel {k} launched on the LG+R4 search")
        for k in packed:
            check(launches[k] == 0, f"the CS-packed kernel {k} stays off the S=20 path")
        args, prefix = write_inputs(tmp, names, seqs, tree_nwk, search=flags)
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "LG+R4 search")

    phase("26. the fused FreeRate mixture: -te LG4X through the CLI on cuda")
    with tempfile.TemporaryDirectory() as tmp:
        args = write_inputs(tmp, names, seqs, tree_nwk, model="LG4X")[0]
        wall, launches, log, nwk = run_cli(cli_main, args, counters)
        fit_lnl = float(logged(log, "Optimal log-likelihood:"))
        model_str = logged(log, "Best-fit model parameters:")
        print(f"fitted model {model_str[:60]}...{model_str[-80:]}")
        # the fit's classes weigh by the FreeRate weights; the written string's
        # evaluation (ModelArrays.from_mixture) by the mixture's defined ones,
        # as in the JAX package (ROADMAP Queue 3)
        s64, r64 = parse_model_string(model_str, aln)
        fit_model = ModelArrays.from_model(s64, r64, dev)
        fit_model.props = torch.as_tensor(r64.category_rates()[1], device=dev)
        ta64 = TreeArrays.from_tree(PhyloTree.from_newick(nwk, aln.names), dev)
        site64 = SiteData.from_alignment(aln, dev, torch.float64)
        with torch.no_grad():
            lnl64 = float(compute_loglik(ta64, fit_model, site64)[0])
        defined, _, _ = reevaluate(nwk, model_str, aln, dev, grad=False)
        print(f"-te LG4X fit lnL {fit_lnl:.4f}; the written tree and model re-evaluated "
              f"in float64 (plain pass) with the fit's class weights (FreeRate's "
              f"{np.array2string(r64.category_rates()[1], precision=4)}) {lnl64:.4f}, "
              f"with the mixture's defined weights (ModelArrays.from_mixture) "
              f"{defined:.4f}; for information, the binary's LG+G4 fit {REF_PROTEIN_LNL}")
        print(f"-te LG4X fit wall time {wall:.2f} s on {card}")
        print(f"-te LG4X fit launches: {launches}")
        check(abs(lnl64 - fit_lnl) < 1.0, "LG4X fit lnL vs its float64 re-evaluation")
        for k in ("wide_forward", "wide_store", "wide_tbar", "wide_newton"):
            check(launches[k] > 0, f"kernel {k} launched on the LG4X fit")
        for k in packed:
            check(launches[k] == 0, f"the CS-packed kernel {k} stays off the LG4X fit")
        args = write_inputs(tmp, names, seqs, tree_nwk, model="LG4X")[0]
        profile_run(lambda: check(cli_main(args) == 0, "profiled CLI run"), wall,
                    "LG4X fit")


def recode(seqs, groups):
    """seqs with the characters of groups[i] written as state i (a digit) and
    every other character (gaps, ambiguity codes) as '?'."""
    table = {chr(c): "?" for c in range(32, 127)}
    for i, g in enumerate(groups):
        table.update({c: str(i) for c in g + g.lower()})
    tr = str.maketrans(table)
    return [s.translate(tr) for s in seqs]


def variable_columns(seqs):
    """seqs cut to their columns with two or more states ('?' none): an
    alignment without constant sites, as +ASC takes it."""
    import numpy as np

    a = np.frombuffer("".join(seqs).encode(), dtype=np.uint8).reshape(len(seqs), -1)
    known = a != ord("?")
    keep = np.where(known, a, 0).max(0) > np.where(known, a, 255).min(0)
    return [row.tobytes().decode() for row in a[:, keep]]


def round_off_shifts(nwk, model_str, aln, dev, lnl64):
    """The written tree and model's lnL (the plain pass) minus `lnl64`, its
    float64 lnL, at alpha x (1 - 1e-9) and x (1 + 1e-9) in float64 and at
    alpha in float32: how far round-off moves its evaluation."""
    import torch
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                compute_loglik)
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree

    s64, r64 = parse_model_string(model_str, aln)
    ta = TreeArrays.from_tree(PhyloTree.from_newick(nwk, aln.names), dev)
    alpha = r64.alpha
    out = []
    for scale, dt in ((1 - 1e-9, torch.float64), (1 + 1e-9, torch.float64),
                      (1.0, torch.float32)):
        r64.alpha = alpha * scale
        with torch.no_grad():
            lnl, _ = compute_loglik(ta, ModelArrays.from_model(s64, r64, dev),
                                    SiteData.from_alignment(aln, dev, dt, asc=s64.asc))
        out.append(float(lnl) - lnl64)
    return out


def binmorph_phases(dev, card, record, results, cli_main, bdir):
    """Phases 27-31: the CS-packed kernels' binary instances (S = 2) against
    their twins on the purine/pyrimidine recoding of the DNA bench; binary
    fits and searches through the CLI (GTR2+G, GTR2+ASC+G); morphology on
    the Dayhoff-6 recoding of the protein bench (MK+G, ORDERED+ASC+G, a
    search), padded to the S = 20 wide kernels; and +ASC on DNA."""
    import numpy as np
    import torch
    from iqtree_torch.engine import parsimony as pars
    from iqtree_torch.engine.kernels import build
    from iqtree_torch.engine.kernels import cs_kernels as csk
    from iqtree_torch.engine.kernels import pruning as pk
    from iqtree_torch.engine.kernels.probe import ptxas_lines
    from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                                branch_transition_mats, ptn_invar,
                                                tip_partials)
    from iqtree_torch.io.alignment import Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import PhyloTree

    packed = ("forward", "store", "tbar", "newton", "down_store")
    wide = ("wide_forward", "wide_store", "wide_tbar", "wide_newton", "wide_down_store")
    replaces = {"forward": "iqtree_tpu/engine/kernels/pruning.py:96",
                "store": "iqtree_tpu/engine/kernels/cs_kernels.py:56",
                "tbar": "iqtree_tpu/engine/kernels/cs_kernels.py:1027",
                "newton": "iqtree_tpu/engine/kernels/cs_kernels.py:280",
                "down_store": "iqtree_tpu/engine/kernels/cs_kernels.py:734"}
    counters = {"forward": pk.fused_site_lnl, "store": csk.fused_upward_store_cs,
                "tbar": csk.fused_tbar_cs, "newton": csk.newton_sweep,
                "down_store": csk.fused_down_store_cs, "wide_forward": pk.wide_site_lnl,
                "wide_store": pk.fused_upward_store, "wide_tbar": csk.fused_downward_tbar,
                "wide_newton": csk.wide_newton_sweep, "wide_down_store": csk.fused_down_store,
                "pars_insert": pars.insertion_costs}

    phase("27. the CS-packed kernels' binary instances (S=2) against their plain twins "
          "(bench_data.npz recoded purine/pyrimidine: 1000 taxa x 10k sites, GTR2+I+G)")
    for n in packed:
        regs = ptxas_lines((bdir / f"{n}.log").read_text(), "ILi4ELi2EEv")
        print(f"  {n} S=2 C=4 instance (ptxas): {'; '.join(regs)}")
        check(bool(regs), f"ptxas reports the S=2 instance of {n}")
    names, seqs, tree_nwk = load_bench()
    ry = recode(seqs, ("AGR", "CTUY"))
    aln = Alignment.from_sequences(names, ry, "BIN")
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    N, P, S, R = aln.n_taxa, aln.n_patterns, 2, 2 * aln.n_taxa
    tips = tip_partials(site).contiguous()
    wp = site.pattern_freq.contiguous()
    inner = slice(N, R - 1)
    print(f"{N} taxa, {P} patterns ({aln.n_sites} sites), {n_slots} slots")
    for C in (4, 1, 8):
        subst, rate = parse_model_string("GTR2+I" + (f"+G{C}" if C > 1 else ""), aln)
        rate.p_invar, rate.alpha = 0.05, 0.5
        model = ModelArrays.from_model(subst, rate, dev)
        trans = branch_transition_mats(model, ta.blen).float().contiguous()
        props, freq = model.props.float(), model.state_freq.float()
        invar = ptn_invar(model, site).float().contiguous()
        CS, CSS = C * S, C * S * S
        check(build.packed(C, S) and build.instance_states(S, C) == 2,
              f"C={C}: binary runs the S=2 CS-packed instances")
        timed = C == 4  # the kernels line's rows

        def keep(name, err, tol, fn, plain, bytes_, flops):
            print(f"{name} S=2 C={C}: error {err:.3e} (tol {tol:g})")
            if timed:
                record(f"{name}_s2", f"iqtree_torch/engine/kernels/csrc/{name}.cu",
                       replaces[name], err, tol, cuda_ms(fn, 10), cuda_ms(plain, 2),
                       bytes_, flops)
            check(err <= tol, f"{name} S=2 C={C} against its twin")

        fargs = (steps, n_slots, trans, tips, props, freq, invar)
        before = (pk.fused_site_lnl.launches, pk.wide_site_lnl.launches)
        lnl = pk.fused_site_lnl(*fargs)
        bit_equal(f"forward S=2 C={C}", [lnl], [pk.fused_site_lnl(*fargs)])
        check((pk.fused_site_lnl.launches, pk.wide_site_lnl.launches) ==
              (before[0] + 2, before[1]), "forward S=2 runs csrc/forward.cu")
        keep("forward", float((lnl - pk._site_lnl_plain(*fargs[:1], *fargs[2:])).abs().max()),
             1e-3, lambda: pk.fused_site_lnl(*fargs),
             lambda: pk._site_lnl_plain(*fargs[:1], *fargs[2:]),
             4 * (N * S * P + R * CSS + 6 * (N - 1) + 3 * P),
             (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P)
        up, usc = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
        again = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
        bit_equal(f"store S=2 C={C}", [up[inner], usc[inner]], [again[0][inner], again[1][inner]])
        del again
        keep("store", store_err(up, usc, *pk.upward_plain(steps, trans, tips), inner), 1e-4,
             lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips),
             lambda: pk.upward_plain(steps, trans, tips),
             4 * (N * S * P + R * CSS + 6 * (N - 1) + (N - 1) * (CS + 1) * P),
             (N - 1) * P * (4 * CSS + 3 * CS) + 2 * CS * P)
        csk.fill_tip_rows_cs(up, usc, tips, C)
        rev_bytes = 4 * (R * (CS + 1) * P + 2 * P + R * CSS)
        targs = (steps, n_slots, trans, tips, props, freq, lnl, wp)
        tb = csk.fused_tbar_cs(*targs, up=up, usc=usc)
        bit_equal(f"tbar S=2 C={C}", [tb], [csk.fused_tbar_cs(*targs, up=up, usc=usc)])
        want = csk._tbar_plain(steps, trans, props, freq, lnl, wp, up, usc)
        keep("tbar", float((tb - want).abs().max() / want.abs().max()), 1e-4,
             lambda: csk.fused_tbar_cs(*targs, up=up, usc=usc),
             lambda: csk._tbar_plain(steps, trans, props, freq, lnl, wp, up, usc),
             rev_bytes, tbar_flops(N, P, CS, CSS))
        del tb, want
        mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
        nargs = (steps, n_slots, mats, props, freq, wp, invar, up, usc)
        got = csk.newton_sweep(*nargs)
        bit_equal(f"newton S=2 C={C}", got, csk.newton_sweep(*nargs))
        want = csk._newton_plain(*nargs[:1], *nargs[2:])
        keep("newton", max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want)),
             1e-4, lambda: csk.newton_sweep(*nargs),
             lambda: csk._newton_plain(*nargs[:1], *nargs[2:]),
             rev_bytes + 4 * R * 3 * CSS, newton_flops(N, P, CS, CSS))
        dargs = (steps, n_slots, trans, up, usc, freq)
        got = csk.fused_down_store_cs(*dargs)
        bit_equal(f"down_store S=2 C={C}", got, csk.fused_down_store_cs(*dargs))
        keep("down_store", outside_err(got, csk._down_store_plain(*dargs[:1], *dargs[2:]), R),
             1e-4, lambda: csk.fused_down_store_cs(*dargs),
             lambda: csk._down_store_plain(*dargs[:1], *dargs[2:]),
             4 * (2 * R * (CS + 1) * P + R * CSS + 6 * (N - 1) + CS),
             P * (2 * (N - 1) * (2 * CSS + 3 * CS) + (N - 2) * 2 * CSS))
        del up, usc, got, want, mats, trans
    del site, tips, wp, ta
    torch.cuda.empty_cache()

    def cli_fit(tag, names_, seqs_, tree_, model=None, search=None, st=None, check_on=(),
                check_off=(), aln_=None, tol=1.0, round_off=False):
        """One CLI run (-te fit of `model`, or the search with `search`):
        prints its wall time and float64 re-evaluation (on `aln_`, the
        alignment of names_ and seqs_, or one made from them), which must
        be within `tol`; the kernels of check_on must launch, those of
        check_off must not.  With `round_off` also the written result's
        lnL at alpha moved by 1e-9 of itself and in float32 (the plain
        pass), beside its float64 lnL.  Returns its launches by kernel."""
        with tempfile.TemporaryDirectory() as tmp:
            args, prefix = write_inputs(tmp, names_, seqs_, tree_, search=search,
                                        model=model or "GTR+G")
            if st:
                args = ["-st", st, *args]
            wall, launches, log, nwk = run_cli(cli_main, args, counters)
            for line in log:
                if line.startswith(("Alignment:", "Likelihood engine", "Branch optimization")):
                    print(line)
            lnl = float(logged(log, "Optimal log-likelihood:" if model else
                               "BEST SCORE FOUND :"))
            model_str = logged(log, "Best-fit model parameters:")
            a64 = aln_ or Alignment.from_sequences(names_, seqs_, st)
            lnl64, _, _ = reevaluate(nwk, model_str, a64, dev, grad=False)
            print(f"{tag}: lnL {lnl:.4f}; the written tree and model re-evaluated in "
                  f"float64 (plain pass) {lnl64:.4f}; {wall:.2f} s wall on {card}")
            print(f"fitted model {model_str}")
            print(f"{tag} launches: {launches}")
            if round_off:
                print(f"{tag}: the written result's lnL minus its float64 lnL at alpha x "
                      "(1 - 1e-9), x (1 + 1e-9), and in float32: "
                      + ", ".join(f"{d:+.4f}" for d in round_off_shifts(
                          nwk, model_str, a64, dev, lnl64)))
            check(abs(lnl64 - lnl) < tol, f"{tag}: lnL vs its float64 re-evaluation")
            for k in check_on:
                check(launches[k] > 0, f"kernel {k} launched on {tag}")
            for k in check_off:
                check(launches[k] == 0, f"kernel {k} stays off {tag}")
            if search and "-bb" in search:
                with open(prefix + ".ufboot") as f:
                    boot = f.read().splitlines()
                supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
                print(f"UFBoot: {len(boot)} sample trees, {len(supports)} supports on the "
                      f"treefile (min {min(supports)}, median {int(np.median(supports))})")
                check(len(boot) == int(search[search.index("-bb") + 1]),
                      f"{tag}: every UFBoot sample holds a tree")
                check(len(supports) == len(names_) - 3, f"{tag}: N-3 supports")
            return launches

    phase("28. binary fixed-topology path: -st BIN -te TREE -m GTR2+G through the CLI "
          "(1000 taxa x 10k sites)")
    launches = cli_fit("-st BIN -te GTR2+G", names, ry, tree_nwk, model="GTR2+G",
                       st="BIN", check_on=packed[:4], check_off=wide + ("down_store",),
                       aln_=aln)
    for k in packed[:4]:
        results[f"{k}_s2"]["launches"] = launches[k]

    phase("29. binary search with +ASC and ultrafast bootstrap through the CLI: -st BIN "
          "-m GTR2+ASC+G -bb 1000 (the variable columns)")
    n_cut = 200
    var = variable_columns(ry[:n_cut])
    flags = ["-m", "GTR2+ASC+G", "-n", "2", "-ninit", "4", "-ntop", "2", "-seed", "1", "-bb",
             "1000", "-wbt"]
    print(f"iqtree-torch -st BIN {' '.join(flags)} on the first {n_cut} taxa, "
          f"{len(var[0])} variable columns of {len(ry[0])}")
    launches = cli_fit("the GTR2+ASC+G search", names[:n_cut], var, tree_nwk,
                       search=flags, st="BIN",
                       check_on=("forward", "store", "tbar", "down_store", "pars_insert"),
                       check_off=wide + ("newton",))
    results["down_store_s2"]["launches"] = launches["down_store"]
    del ry, var, aln

    phase("30. morphology (Dayhoff-6 recoding of bench_data_protein.npz, 6 states "
          "padded to the S=20 wide kernels): -te MK+G, -te ORDERED+ASC+G and an MK+G "
          "search with ultrafast bootstrap through the CLI")
    names, seqs, tree_nwk = load_bench("bench_data_protein.npz")
    d6 = recode(seqs, ("AGPST", "DENQ", "HKR", "ILMV", "FWY", "C"))
    aln = Alignment.from_sequences(names, d6, "MORPH")
    check(aln.num_states == 6 and build.instance_states(6, 4) == 20,
          "the Dayhoff-6 recoding has 6 states, padded to the S=20 instances")
    # the padded wide kernels at the fit's shapes, against their twins, timed
    tree = PhyloTree.from_newick(tree_nwk, aln.names)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    ta = TreeArrays.from_tree(tree, dev)
    steps_np, n_slots = pk.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps_np, device=dev)
    subst, rate = parse_model_string("MK+G", aln)
    rate.alpha = 0.5
    model = ModelArrays.from_model(subst, rate, dev)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    invar = ptn_invar(model, site).float().contiguous()
    wp = site.pattern_freq.contiguous()
    N, R = aln.n_taxa, 2 * aln.n_taxa
    inner = slice(N, R - 1)
    print(f"{N} taxa, {aln.n_patterns} patterns, MK+G4 (S=6 padded to 20)")
    fargs = (steps, n_slots, trans, tips, props, freq, invar)
    lnl = pk.fused_site_lnl(*fargs)
    up, usc = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    up_p, usc_p = pk.upward_plain(steps, trans, tips)
    csk.fill_tip_rows_cs(up, usc, tips, 4)
    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    nargs = (steps, n_slots, mats, props, freq, wp, invar, up, usc)
    targs = (steps, n_slots, trans, tips, props, freq, lnl, wp)
    dargs = (steps, n_slots, trans, up, usc, freq)
    tb, tb_p = csk.fused_tbar_cs(*targs, up=up, usc=usc), csk._tbar_plain(
        steps, trans, props, freq, lnl, wp, up, usc)
    errs = {"wide_forward": (float((lnl - pk._site_lnl_plain(*fargs[:1], *fargs[2:])).abs()
                                   .max()), 1e-3, lambda: pk.fused_site_lnl(*fargs)),
            "wide_store": (store_err(up, usc, up_p, usc_p, inner), 1e-4,
                           lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips)),
            "wide_tbar": (tbar_err(tb, tb_p, R), 1e-4,
                          lambda: csk.fused_tbar_cs(*targs, up=up, usc=usc)),
            "wide_newton": (max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(
                csk.newton_sweep(*nargs), csk._newton_plain(*nargs[:1], *nargs[2:]))), 1e-4,
                lambda: csk.newton_sweep(*nargs)),
            "wide_down_store": (outside_err(csk.fused_down_store_cs(*dargs),
                                            csk._down_store_plain(*dargs[:1], *dargs[2:]), R),
                                1e-4, lambda: csk.fused_down_store_cs(*dargs))}
    for k, (err, tol, fn) in errs.items():
        print(f"{k} at S=6 (padded 20), C=4: error {err:.3e} (tol {tol:g}), "
              f"{cuda_ms(fn, 10):.3f} ms a call of its wrapper (the padding copies included)")
        check(err <= tol, f"{k} at S=6 against its twin")
    del up, usc, up_p, usc_p, mats, tb, tb_p, trans, tips, site, ta
    torch.cuda.empty_cache()
    cli_fit("-st MORPH -te MK+G", names, d6, tree_nwk, model="MK+G", st="MORPH",
            check_on=wide[:4], check_off=packed + ("wide_down_store",), aln_=aln)
    var = variable_columns(d6)
    print(f"ORDERED+ASC+G on the {len(var[0])} variable columns of {len(d6[0])}")
    # ORDERED's P(t) reaches a state k steps away as O(t^k), which the
    # eigendecomposition gives at round-off (~1e-16) on short branches, in
    # both packages; on this misspecified recoding many patterns need such
    # changes, so the lnL at the written parameters moves by tenths under
    # a 1e-9 change of alpha and by more between float32 and float64
    # (printed with the run: round_off): its re-evaluation is held within
    # 5.0
    cli_fit("-st MORPH -te ORDERED+ASC+G", names, var, tree_nwk, model="ORDERED+ASC+G",
            st="MORPH", check_on=wide[:3] + ("wide_down_store",),
            check_off=packed + ("wide_newton",), tol=5.0, round_off=True)
    flags = ["-m", "MK+G", "-n", "2", "-ninit", "4", "-ntop", "2", "-seed", "1", "-bb",
             "1000", "-wbt"]
    cli_fit("the MK+G search", names, d6, tree_nwk, search=flags, st="MORPH",
            check_on=wide + ("pars_insert",), check_off=packed, aln_=aln)
    del d6, var

    phase("31. +ASC on DNA: -te GTR+ASC+G through the CLI (the variable columns of "
          "bench_data.npz)")
    names, seqs, tree_nwk = load_bench()
    var = variable_columns(recode(seqs, ("A", "C", "G", "TU")))
    var = [s.translate(str.maketrans("0123", "ACGT")) for s in var]
    print(f"{len(var[0])} variable columns of {len(seqs[0])}")
    cli_fit("-te GTR+ASC+G", names, var, tree_nwk, model="GTR+ASC+G", st="DNA",
            check_on=("forward", "store", "tbar", "down_store"),
            check_off=wide + ("newton",))


if __name__ == "__main__":
    sys.exit(main())
