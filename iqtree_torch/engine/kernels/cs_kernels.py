"""Upward-store, gradient and branch-Newton sweeps (CS-packed layouts).

Companions of the forward kernel (pruning.py); the (category x state)
axes are flattened into one packed row axis CS = C*S for the stored
partials up [2N, CS, P].  The CS-packed kernels serve S <= 4 up to 8
categories (instances at S=2 and S=4; S=3 zero-padded to 4 and sliced
back, as build.instance_states says):

* `fused_upward_store_cs` -- the forward sweep, storing every internal
  node's normalized partial and log-scale (csrc/store.cu); the residuals
  every reverse sweep reads.
* `fused_tbar_cs` -- reverse sweep accumulating the cotangent of every
  edge's transition matrices for the custom-autograd gradient
  (csrc/tbar.cu).
* `newton_sweep` -- reverse sweep giving d lnL/dt and d2 lnL/dt2 for
  every branch at once (csrc/newton.cu); `fused_newton_derivs` runs the
  store and this sweep from a model and branch lengths.
* `fused_down_store_cs` -- reverse sweep storing every node's outside
  partial and log-scale (csrc/down_store.cu); `fused_nni_passes_cs` runs
  the store and this sweep for the NNI evaluator (engine/nni.py).

The same sweeps at the wide shapes (the general [C,S,S] layout: protein
S=20 and morphology with 5 to 20 states zero-padded to it, the codon
spaces and 21 to 32 morphological states zero-padded to the kernels' S=64
instance, S <= 4 past 8 categories on the S=4 instance, each sliced
back), on the same plain twins; the wrappers above
pass those shapes on to them, as pruning.fused_site_lnl does, so a caller
makes one call at any shape:

* `pruning.fused_upward_store` -- the upward store (csrc/wide_store.cu);
* `fused_downward_tbar` -- the gradient sweep (csrc/wide_tbar.cu);
* `wide_newton_sweep` -- the branch-Newton sweep (csrc/wide_newton.cu;
  S=20 up to 8 categories, and DNA past them up to C*S = 128: codon branch
  lengths and the shapes past those take the theta path of
  engine/derivatives.py, as the JAX package's do);
* `fused_down_store` -- the outside-partial store (csrc/wide_down_store.cu),
  so `fused_nni_passes_cs` serves the NNI evaluator at both shapes.

Each wrapper launches its kernel for CUDA tensors and runs its plain twin
for CPU tensors.  The reverse sweeps read child partials from `up` with
the tip rows filled (fill_tip_rows_cs).
"""

from __future__ import annotations

import torch

from . import build
from . import pruning
from .pruning import (fused_upward_store, pad_partials, pad_states, schedule_tree,
                      unpad_partials, upward_plain)
from ..likelihood import SCALE_TINY, branch_transition_mats, downward_pass


def fused_upward_store_cs(steps, n_slots, trans, tips):
    """(up [2N, CS, P], usc [2N, P]) -- every internal node's normalized
    partial and log-scale.  Tip rows are left for fill_tip_rows_cs.  The
    shapes build.packed does not give it run
    pruning.fused_upward_store.  csrc/store.cu runs
    pruning.UPWARD_LANES lanes a block."""
    if not trans.is_cuda:
        return upward_plain(steps, trans, tips)
    n_rows, C, S = trans.shape[:3]
    if not build.packed(C, S):
        return fused_upward_store(steps, n_slots, trans, tips)
    P, SK = tips.shape[2], build.instance_states(S, C)
    if SK != S:
        trans, tips = pad_states(trans, SK, 2, 3), pad_states(tips, SK, 1)
    build.check_inputs(C, SK, steps, trans, tips)
    up = torch.empty(n_rows, C * SK, P, dtype=torch.float32, device=trans.device)
    usc = torch.zeros(n_rows, P, dtype=torch.float32, device=trans.device)
    build.launch("store", steps, steps.shape[0], trans, tips, P, up, usc, C, SK,
                 n_slots, pruning.UPWARD_LANES)
    fused_upward_store_cs.launches += 1
    return (unpad_partials(up, C, S) if SK != S else up), usc


fused_upward_store_cs.launches = 0


def fill_tip_rows_cs(up, usc, tips, C):
    """Fill the tip rows of `up` with C-tiled tip partials and zero their
    scales (in place), so reverse-sweep child reads are uniform."""
    N = tips.shape[0]
    up[:N] = tips.repeat(1, C, 1)
    usc[:N] = 0.0
    return up, usc


def _tbar_plain(steps, trans, props, state_freq, lnl, wp, up, usc):
    n_rows, C, S = trans.shape[:3]
    levels, children = schedule_tree(steps, n_rows)
    up4 = up.reshape(n_rows, C, S, -1)
    out, osc = downward_pass(levels, children, trans, up4, usc,
                             props[:, None] * state_freq)
    fac = torch.exp(torch.clamp(osc + usc - lnl, max=80.0)) * wp
    return torch.einsum("ncsp,nctp,np->ncst", out, up4, fac)


def fused_tbar_cs(steps, n_slots, trans, tips, props, state_freq, lnl_raw, w_p,
                  up=None, usc=None):
    """[2N, C, S, S] transition-matrix cotangents:
        tbar[e,c,s,t] = sum_p O_e[c,s,p] U_e[c,t,p] exp(osc+usc-lnl_p) w_p
    with the class weights folded into the root seed.  `up`/`usc` may be
    passed from a prior upward store (tip rows are filled here).  The wide
    shapes build.packed does not give it run fused_downward_tbar."""
    n_rows, C, S = trans.shape[:3]
    if not build.packed(C, S):
        return fused_downward_tbar(steps, n_slots, trans, tips, props, state_freq,
                                   lnl_raw, w_p, up, usc)
    if up is None:
        up, usc = fused_upward_store_cs(steps, n_slots, trans, tips)
    fill_tip_rows_cs(up, usc, tips, C)
    if not trans.is_cuda:
        return _tbar_plain(steps, trans, props, state_freq, lnl_raw, w_p, up, usc)
    P, SK = tips.shape[2], build.instance_states(S, C)
    rootd = (props[:, None] * state_freq).float()
    if SK != S:
        trans, up = pad_states(trans, SK, 2, 3), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, rootd, lnl_raw, w_p, up, usc)
    n_blocks = -(-P // TBAR_PATTERNS)
    part = torch.zeros(n_blocks, n_rows, C, SK, SK, dtype=torch.float32,
                       device=trans.device)
    tbar = torch.empty(n_rows, C, SK, SK, dtype=torch.float32, device=trans.device)
    build.launch("tbar", steps, steps.shape[0], trans, rootd, lnl_raw, w_p, up,
                 usc, P, n_rows, part, tbar, C, SK, n_slots, TBAR_PATTERNS)
    fused_tbar_cs.launches += 1
    return tbar[:, :, :S, :S].contiguous() if SK != S else tbar


fused_tbar_cs.launches = 0
# Patterns a block of csrc/tbar.cu (C x 64 lanes, one a pattern and rate
# category, and a warp for the sums): the thread-a-pattern design's block,
# whose sum order (64 patterns a part row, in order) it keeps; the kernel
# takes no other.
TBAR_PATTERNS = 64
# The ring depth of csrc/tbar.cu and its rows' padding (words).
TBAR_STAGES, TBAR_PAD = 2, 4


def packed_block_words(S: int) -> int:
    """Words of one category's [S,S] block staged in shared memory by the
    CS-packed kernels (SSP of csrc/cs_common.cuh): 20 at S=4 (4 words of
    padding put the rows a warp's categories read at once in distinct
    banks), 4 at S=2 (a block is one float4; consecutive categories' blocks
    already are)."""
    return 4 if S == 2 else S * S + 4


def tbar_smem(C: int, n_slots: int, stages: int = TBAR_STAGES, S: int = 4) -> int:
    """Bytes of shared memory a block of csrc/tbar.cu takes (the formula of
    its header): the walk warps' edge blocks (packed_block_words) and the
    lanes' ring, the O * fac stage, the pool [slot][S+1][lanes] and the
    max buffers, at C x TBAR_PATTERNS walk lanes."""
    pb = TBAR_PATTERNS
    lanes = C * pb
    return 4 * (lanes // 32 * stages * 2 * packed_block_words(S)
                + stages * (2 * S + 2) * (lanes + TBAR_PAD)
                + C * 2 * S * (pb + TBAR_PAD)
                + (n_slots * (S + 1) + 4) * lanes)

# Share of the card's free memory the wide gradient sweep's part rows may
# take; past it the sweep runs in chunks of clusters.
PART_MEMORY_SHARE = 0.25
# Patterns a cluster of csrc/wide_tbar.cu (C blocks, one a rate category,
# of tile x 4 walk threads and a sum warp for each 16 patterns): 16 gives
# 123 clusters of 4 three-warp blocks at 1 958 patterns, C=4, as
# WIDE_DOWN_STORE_TILE.
WIDE_TBAR_TILE = 16
# Patterns of a part row of csrc/wide_tbar.cu: the earlier row-group
# design's block, whose sum order (16 patterns a row, in order) it keeps at
# any tile.
WIDE_TBAR_SUM_PATTERNS = 16
# Entries a side of a sum lane's block of a child's [S,S] in
# csrc/wide_tbar.cu (SumShape): 5 x 5 at S=20, through a stage; 8 x 8 at
# the codon instance S=64, stored straight (rows of whole float4s); one
# entry at the DNA instance S=4 (32 lanes, one warp, through a stage).
WIDE_TBAR_LANE_BLOCK = {4: 1, 20: 5, 64: 8}
# Largest block of csrc/wide_tbar.cu (TBAR_THREADS_MAX): 256 walk threads
# and 4 sum warps.
WIDE_TBAR_THREADS_MAX = 384
# Largest block of csrc/wide_tbar.cu past 8 categories
# (TBAR_MULTI_THREADS_MAX): five category teams of 64 walk threads and a sum
# warp at 16 patterns a cluster.
WIDE_TBAR_MULTI_THREADS_MAX = 480


def wide_tbar_smem(S: int, C: int, tile: int, n_slots: int, warps: int = 1) -> int:
    """Bytes of shared memory a block of csrc/wide_tbar.cu takes on `warps`
    category teams (the formula of its header, wide_tbar_smem): the reverse
    walk's (wide_down_store_smem), its ring a stage deeper past one team
    (the sums lag a unit behind the walk), each child's fac for the tile's
    patterns and, where the sum lanes' rows are not whole float4 runs (S=20;
    any S without an instance), a stage of both children's [S,S] blocks for
    each 16 patterns of each team."""
    staged = WIDE_TBAR_LANE_BLOCK.get(S, 1) % 4 != 0
    stage = warps * tile // WIDE_TBAR_SUM_PATTERNS * 2 * S * S if staged else 0
    return (wide_down_store_smem(S, C, tile, n_slots, stages=3 if warps > 1 else 2,
                                 warps=warps) + 4 * (2 * tile + stage))


def wide_tbar_threads(S: int, tile: int, warps: int = 1) -> int:
    """Threads a block of csrc/wide_tbar.cu: for each of `warps` category
    teams tile x S / RPT walk threads and the sum warps, 2 (S / SB)^2 / 32
    for each 16 patterns."""
    nb = S // WIDE_TBAR_LANE_BLOCK[S]
    return warps * (tile * S // pruning.WIDE_RPT[S]
                    + tile // WIDE_TBAR_SUM_PATTERNS * 2 * nb * nb)


def wide_reverse_teams(S: int, C: int, tile: int, n_slots: int, sums: bool = False) -> int:
    """Category teams a block of csrc/wide_down_store.cu (csrc/wide_tbar.cu
    with `sums`): 1 at one category a block; past 8 categories
    build.least_units over teams of tile x S / RPT walk threads (with the
    sum warps: wide_tbar_threads), build.REVERSE_MULTI_THREADS_MAX
    (WIDE_TBAR_MULTI_THREADS_MAX) threads a block and wide_down_store_smem
    (wide_tbar_smem), least (2 U + 2) / b."""
    cb = build.wide_layout(C)[1]
    if cb == 1:
        return 1
    if sums:
        return build.least_units(cb, 1, wide_tbar_threads(S, tile), WIDE_TBAR_MULTI_THREADS_MAX,
                                 lambda w: wide_tbar_smem(S, C, tile, n_slots, warps=w))
    return build.least_units(cb, 1, tile * S // pruning.WIDE_RPT[S],
                             build.REVERSE_MULTI_THREADS_MAX,
                             lambda w: wide_down_store_smem(S, C, tile, n_slots, warps=w))


def fused_downward_tbar(steps, n_slots, trans, tips, props, state_freq, lnl_raw,
                        w_p, up=None, usc=None, tile=None, part_blocks=None):
    """fused_tbar_cs at the wide shapes (S=20; S=4 past 8 categories; any
    other state count through the instance build.instance_states names,
    padded in and sliced out): [2N, C, S, S] cotangents
    through csrc/wide_tbar.cu for CUDA tensors, the plain twin _tbar_plain
    for CPU tensors.  A cluster of C blocks (one a rate category) holds
    `tile` patterns (default WIDE_TBAR_TILE, a multiple of 16) and writes a
    part row [2N, C, S, S] for each 16 of them.  The rows are sized to
    PART_MEMORY_SHARE of the free memory unless `part_blocks` (rows) is
    given; with fewer than the sweep's rows the kernel runs in chunks of
    clusters and adds the chunks in row order.  `tile` and `part_blocks`
    are for measuring and testing the kernel."""
    n_rows, C, S = trans.shape[:3]
    if up is None:
        up, usc = fused_upward_store(steps, n_slots, trans, tips)
    fill_tip_rows_cs(up, usc, tips, C)
    if not trans.is_cuda:
        return _tbar_plain(steps, trans, props, state_freq, lnl_raw, w_p, up, usc)
    P = tips.shape[2]
    T = tile or WIDE_TBAR_TILE
    if T <= 0 or T % WIDE_TBAR_SUM_PATTERNS:
        raise ValueError(f"wide_tbar: {T} patterns a cluster is not a multiple of "
                         f"{WIDE_TBAR_SUM_PATTERNS}")
    groups = T // WIDE_TBAR_SUM_PATTERNS  # part rows a cluster
    SK = build.instance_states(S, C)
    rootd = (props[:, None] * state_freq).float()
    if SK != S:
        trans, up = pad_states(trans, SK, 2, 3), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, rootd, lnl_raw, w_p, up, usc,
                       n_slots=n_slots, walk=True)
    if wide_tbar_threads(SK, T) > WIDE_TBAR_THREADS_MAX:
        raise ValueError(f"wide_tbar: {T} patterns a cluster need "
                         f"{wide_tbar_threads(SK, T)} threads a block at S={SK}, over "
                         f"{WIDE_TBAR_THREADS_MAX}")
    if part_blocks is None:
        per_row = n_rows * C * SK * SK * 4
        free = torch.cuda.mem_get_info(trans.device)[0]
        part_blocks = int(free * PART_MEMORY_SHARE) // per_row
    # a chunk is whole clusters' rows
    part_blocks = max(groups, min(-(-P // T) * groups, part_blocks) // groups * groups)
    part = torch.empty(part_blocks, n_rows, C, SK, SK, dtype=torch.float32,
                       device=trans.device)
    part[:, n_rows - 2:].zero_()  # the root and dummy rows are never written
    tbar = torch.empty(n_rows, C, SK, SK, dtype=torch.float32, device=trans.device)
    build.launch("wide_tbar", steps, steps.shape[0], trans, rootd, lnl_raw, w_p, up,
                 usc, P, n_rows, part, part_blocks, tbar, C, SK, n_slots, T)
    fused_downward_tbar.launches += 1
    return tbar[:, :, :S, :S].contiguous() if SK != S else tbar


fused_downward_tbar.launches = 0


def _down_store_plain(steps, trans, up, usc, state_freq):
    """Plain twin of the outside-partial store: the level-batched
    downward pass over the tree the schedule walks."""
    n_rows, C, S = trans.shape[:3]
    levels, children = schedule_tree(steps, n_rows)
    out, osc = downward_pass(levels, children, trans, up.reshape(n_rows, C, S, -1),
                             usc, state_freq)
    return out.reshape(n_rows, C * S, -1), osc


def _zeroed_outside(n_rows, CS, P, device):
    """Empty out [2N, CS, P] / osc [2N, P] with the root and dummy rows
    (the device numbering puts the root last, then the dummy) zeroed:
    the reverse sweeps never write them."""
    out = torch.empty(n_rows, CS, P, dtype=torch.float32, device=device)
    osc = torch.empty(n_rows, P, dtype=torch.float32, device=device)
    out[n_rows - 2:].zero_()
    osc[n_rows - 2:].zero_()
    return out, osc


def fused_down_store_cs(steps, n_slots, trans, up, usc, state_freq):
    """(out [2N, CS, P], osc [2N, P]): every non-root node's normalized
    outside partial (at the parent end of its edge) and log-scale, from
    the upward store's up/usc with the tip rows filled.  The root seed is
    the bare state_freq [C, S]; the root and dummy rows are 0.  The
    shapes build.packed does not give it run fused_down_store."""
    if not trans.is_cuda:
        return _down_store_plain(steps, trans, up, usc, state_freq)
    n_rows, C, S = trans.shape[:3]
    if not build.packed(C, S):
        return fused_down_store(steps, n_slots, trans, up, usc, state_freq)
    P, SK = up.shape[2], build.instance_states(S, C)
    rootd = state_freq.float()
    if SK != S:
        trans, up = pad_states(trans, SK, 2, 3), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, rootd, up, usc)
    out, osc = _zeroed_outside(n_rows, C * SK, P, trans.device)
    build.launch("down_store", steps, steps.shape[0], trans, rootd, up, usc, P,
                 out, osc, C, SK, n_slots, DOWN_STORE_PATTERNS)
    fused_down_store_cs.launches += 1
    return (unpad_partials(out, C, S) if SK != S else out), osc


fused_down_store_cs.launches = 0
# Patterns a block of csrc/down_store.cu (a lane a pattern and rate
# category, a category's lanes over the block's patterns: from 32 on a
# warp's row store is one 128-byte line; 64 measured fastest at C=4).
DOWN_STORE_PATTERNS = 64


# Patterns a cluster of csrc/wide_down_store.cu (C blocks, one a rate
# category, of tile x 4 threads): 16 gives 123 clusters of 4 two-warp
# blocks at 1 958 patterns, C=4 (measured fastest at C = 3 and 8, within 2%
# of 32 at C = 1 and 4; PERF.md).
WIDE_DOWN_STORE_TILE = 16


def wide_down_store_smem(S: int, C: int, tile: int, n_slots: int, stages: int = 2,
                         warps: int = 1) -> int:
    """Bytes of shared memory a block of csrc/wide_down_store.cu takes on
    `warps` category teams (the formula of its header, ReverseSmem): a ring
    of `stages` stages of W categories' [S,S] blocks of both children and
    their rows and scales, the slot pool of the block's CB categories, O's
    stage of both children's CB S rows and the max buffers of the K blocks
    (build.wide_layout; double-buffered by step parity)."""
    K, cb = build.wide_layout(C)
    return 4 * (stages * warps * (2 * S * S + 2 * (S + 1) * tile)
                + n_slots * (cb * S + 1) * tile + 2 * cb * S * tile + 4 * K * tile)


def fused_down_store(steps, n_slots, trans, up, usc, state_freq, tile=None):
    """fused_down_store_cs at the wide shapes (S=20; S=4 past 8 categories;
    any other state count through the instance build.instance_states
    names, padded in and sliced out): csrc/wide_down_store.cu
    for CUDA tensors, the plain twin _down_store_plain for CPU tensors.  A
    cluster of C blocks (one a rate category) holds `tile` patterns
    (default WIDE_DOWN_STORE_TILE; for measuring the kernel)."""
    if not trans.is_cuda:
        return _down_store_plain(steps, trans, up, usc, state_freq)
    n_rows, C, S = trans.shape[:3]
    P, SK = up.shape[2], build.instance_states(S, C)
    rootd = state_freq.float()
    if SK != S:
        trans, up = pad_states(trans, SK, 2, 3), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, rootd, up, usc, n_slots=n_slots,
                       walk=True)
    out, osc = _zeroed_outside(n_rows, C * SK, P, trans.device)
    build.launch("wide_down_store", steps, steps.shape[0], trans, rootd, up, usc, P,
                 out, osc, C, SK, n_slots, tile or WIDE_DOWN_STORE_TILE)
    fused_down_store.launches += 1
    return (unpad_partials(out, C, S) if SK != S else out), osc


fused_down_store.launches = 0


def fused_nni_passes_cs(steps, n_slots, trans, tips, state_freq):
    """(up, usc, out, osc): the two global passes of the NNI evaluator --
    the upward store (tip rows filled) and the outside-partial store -- at
    the CS-packed (S <= 4) and the wide shapes alike.  Unlike the TPU's
    general passes nothing is padded: no state axis to 8 rows, no pattern
    axis to 128 lanes."""
    up, usc = fused_upward_store_cs(steps, n_slots, trans, tips)
    fill_tip_rows_cs(up, usc, tips, trans.shape[1])
    out, osc = fused_down_store_cs(steps, n_slots, trans, up, usc, state_freq)
    return up, usc, out, osc


def stacked_deriv_mats(model, blen: torch.Tensor) -> torch.Tensor:
    """[2N, 3, C, S, S]: per edge (P(t), dP/dt, d2P/dt2) from the
    eigensystem, P^(k) = V (Lambda r_c)^k e^{Lambda r_c t} V^-1."""
    lam_r = model.eigenvalues * model.rates[:, None]  # [C, S]
    e = torch.exp(lam_r[None] * blen[:, None, None])  # [E, C, S]
    mats = [torch.einsum("csj,ecj,cjt->ecst", model.eigvec, e * lam_r[None] ** k,
                         model.inv_eigvec) for k in range(3)]
    return torch.stack(mats, dim=1)


def _newton_plain(steps, mats, props, state_freq, wp, invar, up, usc):
    n_rows, _, C, S = mats.shape[:4]
    levels, children = schedule_tree(steps, n_rows)
    up4 = up.reshape(n_rows, C, S, -1)
    out, osc = downward_pass(levels, children, mats[:, 0], up4, usc,
                             props[:, None] * state_freq)
    f0, f1, f2 = ((out * (mats[:, k] @ up4)).sum((1, 2)) for k in range(3))
    inv_t = torch.where(invar > 0,
                        invar * torch.exp(torch.clamp(-(osc + usc), max=80.0)),
                        torch.zeros_like(osc))
    den = torch.clamp(f0, min=SCALE_TINY) + inv_t
    r1, r2 = f1 / den, f2 / den
    return (wp * r1).sum(-1), (wp * (r2 - r1 * r1)).sum(-1)


def newton_sweep(steps, n_slots, mats, props, state_freq, wp, invar, up, usc):
    """(d1 [2N], d2 [2N]) from the stored partials (tip rows filled) and the
    stacked derivative matrices mats [2N, 3, C, S, S].  The wide shapes
    (S=5 to 20, and S <= 4 past 8 categories) run wide_newton_sweep."""
    if not mats.is_cuda:
        return _newton_plain(steps, mats, props, state_freq, wp, invar, up, usc)
    n_rows, _, C, S = mats.shape[:4]
    if not build.packed(C, S):
        return wide_newton_sweep(steps, n_slots, mats, props, state_freq, wp, invar,
                                 up, usc)
    P, SK = up.shape[2], build.instance_states(S, C)
    rootd = (props[:, None] * state_freq).float()
    if SK != S:
        mats, up = pad_states(mats, SK, 3, 4), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, mats, rootd, wp, invar, up, usc)
    # per-warp sums [warps, 2N, 2]: ~20 MB at 1000 taxa x 9 962 patterns, C=4
    per_block = NEWTON_THREADS // category_lanes(C)
    n_warps = -(-P // per_block) * (NEWTON_THREADS // 32)
    part = torch.zeros(n_warps, n_rows, 2, dtype=torch.float32, device=mats.device)
    d12 = torch.empty(n_rows, 2, dtype=torch.float32, device=mats.device)
    build.launch("newton", steps, steps.shape[0], mats, rootd, wp, invar, up, usc,
                 P, n_rows, part, d12, C, SK, n_slots, NEWTON_THREADS)
    newton_sweep.launches += 1
    return d12[:, 0], d12[:, 1]


newton_sweep.launches = 0
# Lanes a block of csrc/newton.cu, one a (pattern, rate category): small
# blocks spread the ~9 warps an SM evenly (PERF.md).
NEWTON_THREADS = 64


def category_lanes(C: int) -> int:
    """Lanes a pattern in the lane layout of csrc/cs_common.cuh: the
    category count rounded up to a power of two."""
    return 1 << (C - 1).bit_length()


# Patterns a cluster of csrc/wide_newton.cu (C blocks, one a rate category):
# 32 gives 62 clusters of 4 blocks of 64 threads at 1 958 patterns, C=4
# (measured fastest at C=4 and C=8).
WIDE_NEWTON_TILE = 32
# Patterns a block of its multi-category instance (DNA past 8 categories, a
# thread a category and pattern): 16 ran 7.705 ms at C = 10 on the DNA bench,
# 8 7.790 and 32 8.197 (PERF.md); at C = 32, 512 threads.
WIDE_NEWTON_MULTI_TILE = 16
# Its largest block (MULTI_NEWTON_THREADS_MAX of the source).
WIDE_NEWTON_MULTI_THREADS_MAX = 512
# Patterns whose edge terms csrc/wide_newton.cu adds in order into one row
# of its sums (the earlier design's tile, whose bits it keeps).
WIDE_NEWTON_SUM_PATTERNS = 16


def wide_newton_part_rows(P: int, tile: int) -> int:
    """Rows of csrc/wide_newton.cu's edge sums [rows, 2N, 2]: a row a group
    of 16 patterns (of `tile` itself below 16) of each cluster's tile."""
    group = min(tile, WIDE_NEWTON_SUM_PATTERNS)
    if tile <= 0 or tile % group:
        raise ValueError(f"wide_newton: {tile} patterns a cluster is neither a multiple "
                         f"of {WIDE_NEWTON_SUM_PATTERNS} nor below it")
    return -(-P // tile) * (tile // group)


def wide_newton_smem(S: int, C: int, tile: int, n_slots: int, groups: int = 4,
                     stages: int = 2) -> int:
    """Bytes of shared memory a block of csrc/wide_newton.cu takes (the
    formula of its header) with `groups` row groups a category: the
    matrices' ring, the children's rows, the slot pool, the O stage, the
    exchange buffers and the edge terms.  A block holds one rate
    category, so only the max buffers grow with C."""
    return 4 * (stages * 6 * S * S + stages * 2 * (S + 1) * tile
                + n_slots * (S + 1) * tile + 2 * S * tile
                + (2 * C + 6 * groups + 4) * tile)


def wide_newton_sweep(steps, n_slots, mats, props, state_freq, wp, invar, up, usc,
                      tile=None):
    """newton_sweep at the wide shapes: csrc/wide_newton.cu for CUDA tensors,
    the plain twin _newton_plain for CPU tensors.  At S=20 (5 to 20 states
    zero-padded to it) a cluster of C blocks (one a rate category) holds
    `tile` patterns (default WIDE_NEWTON_TILE); S <= 4 past 8 categories
    runs the multi-category instance, a block all C categories of `tile`
    patterns (default WIDE_NEWTON_MULTI_TILE).  `tile` is for measuring
    the kernel."""
    if not mats.is_cuda:
        return _newton_plain(steps, mats, props, state_freq, wp, invar, up, usc)
    n_rows, _, C, S = mats.shape[:4]
    P, SK = up.shape[2], build.instance_states(S, C)
    rootd = (props[:, None] * state_freq).float()
    if SK != S:
        mats, up = pad_states(mats, SK, 3, 4), pad_partials(up, C, SK)
        rootd = pad_states(rootd, SK, 1)
    rootd = rootd.reshape(-1).contiguous()
    S = SK
    if S in build.MULTI_NEWTON_STATES:
        if not build.wide_newton_multi(C, S):
            raise NotImplementedError(
                f"wide_newton: the S={S} instance serves {build.MAX_CATEGORIES} < C <= "
                f"{build.MULTI_NEWTON_ROWS // S} categories (the CS-packed newton "
                f"kernel below, the theta path above), got C={C}")
        T = tile or WIDE_NEWTON_MULTI_TILE
        build.check_inputs(C, S, steps, mats, rootd, wp, invar, up, usc,
                           states=build.MULTI_NEWTON_STATES, multi=True)
    else:
        T = tile or WIDE_NEWTON_TILE
        build.check_inputs(C, S, steps, mats, rootd, wp, invar, up, usc,
                           states=build.WIDE_NEWTON_STATES)
    part = torch.zeros(wide_newton_part_rows(P, T), n_rows, 2, dtype=torch.float32,
                       device=mats.device)
    d12 = torch.empty(n_rows, 2, dtype=torch.float32, device=mats.device)
    build.launch("wide_newton", steps, steps.shape[0], mats, rootd, wp, invar, up, usc,
                 P, n_rows, part, d12, C, S, n_slots, T)
    wide_newton_sweep.launches += 1
    return d12[:, 0], d12[:, 1]


wide_newton_sweep.launches = 0


def fused_newton_derivs(steps, n_slots, model, blen, tips, pattern_freq, invar):
    """(d1 [2N], d2 [2N]): d lnL/dt and d2 lnL/dt2 of every edge (entry v =
    the edge above v; root and dummy rows are 0) from one upward store and
    one reverse sweep -- the CS-packed kernels at S <= 4 up to 8
    categories, the wide store and sweep at 5 to 20 states and at S <= 4
    past 8.  The denominator
    includes the invariant class."""
    dt = tips.dtype
    trans = branch_transition_mats(model, blen).to(dt).contiguous()
    up, usc = fused_upward_store_cs(steps, n_slots, trans, tips)
    fill_tip_rows_cs(up, usc, tips, trans.shape[1])
    mats = stacked_deriv_mats(model, blen).to(dt).contiguous()
    return newton_sweep(steps, n_slots, mats, model.props.to(dt),
                        model.state_freq.to(dt), pattern_freq, invar, up, usc)
