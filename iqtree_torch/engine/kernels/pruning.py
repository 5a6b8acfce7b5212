"""Fused forward likelihood: whole-tree site log-likelihoods in one kernel.

`fused_site_lnl` launches a hand-written CUDA kernel for a CUDA tensor --
csrc/forward.cu at the CS-packed shapes (S=2 binary, S=4 DNA, S=3 padded
to 4; C <= 8), csrc/wide_forward.cu (`wide_site_lnl`) at the wide shapes
(protein S=20, morphology with 5 to 20 states padded to it; codons and 21
to 32 morphological states padded to the S=64 instance; S <= 4 past 8
categories on the S=4 instance), every padding by `pad_states` as
build.instance_states says -- and runs its plain twin
for a CPU tensor.  `fused_upward_store` is the wide upward store
(csrc/wide_store.cu): the same sweep on the same clusters, storing every
internal partial for the reverse sweeps.  The kernels evaluate the entire
post-order for a block of patterns with the live partials in a
shared-memory slot pool (forward.cu with a lane a pattern and rate
category, csrc/cs_common.cuh; wide_forward.cu with a cluster of blocks,
one a rate category, csrc/wide_common.cuh):

  * topology arrives as a Sethi-Ullman slot schedule (schedule.py), so at
    most ceil(log2 N)+1 partials are live per pattern;
  * per step: both children through their edge matrices, elementwise
    product, per-pattern max renormalization with a log-scale;
  * the root mixes with props * pi and adds the invariant-site class.

The plain twin computes the same function one wave of independent
schedule steps at a time (engine/likelihood.py upward_pass).  Unlike the
TPU kernel it contracts each category's [S,S] block directly: the
block-diagonal [2CS, 2CS] pair matrices existed to feed the 128x128 MXU.

`fused_multi_tree_lnl` scores K topologies that share one alignment in one
launch of csrc/stream_forward.cu (`fused_site_lnl_cs_stream`), on the
schedule `multi_tree_schedule` interleaves from theirs.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from . import build
from .schedule import slot_schedule
from ..likelihood import (
    SCALE_TINY,
    asc_correction,
    branch_transition_mats,
    finish_site_lnl,
    ptn_invar,
    tip_partials,
    upward_pass,
)

# Lanes a block of the upward kernels on the lane layout (forward.cu,
# store.cu; one lane a pattern and rate category, C rounded up to a power
# of two lanes a pattern): 64 gives 623 blocks for 10k patterns at C=4,
# ~9.4 warps an SM spread evenly, as newton.cu's NEWTON_THREADS.
UPWARD_LANES = 64
# Patterns per block of the kernels that give a thread a pattern
# (stream_forward.cu, forward_ablate.cu): 64 keeps the slot
# pool of a 1000-taxon tree (11 slots) under the 48 KB default shared
# memory and gives ~160 blocks for 10k patterns on the 132 SMs.
DEFAULT_TILE = 64
# Patterns a cluster of csrc/wide_forward.cu (C blocks, one a rate
# category, of tile / 2 x 4 threads): 16 gives 123 clusters of 4 one-warp
# blocks at 1 958 patterns, C=4 (measured fastest at C = 1, 3, 4 and 8,
# PERF.md).
WIDE_FORWARD_TILE = 16
# Patterns a cluster of csrc/wide_store.cu (the same clusters and walk):
# 16, measured fastest at C = 3, 4 and 8 (PERF.md).
WIDE_STORE_TILE = 16
# The cluster walk's ring depth (CLUSTER_STAGES of csrc/wide_common.cuh).
CLUSTER_STAGES = 2
# The states of csrc/stream_forward.cu's instance (the thread-a-pattern
# layout of cs_common.cuh, DNA only).
STREAM_STATES = 4
# State rows a thread of each wide instance (RPT; csrc/wide_common.cuh
# IQT_DISPATCH_WIDE_S, CODON_RPT at S=64, DNA_RPT at S=4).
WIDE_RPT = {4: 1, 20: 5, 64: 8}


def pad_states(x: torch.Tensor, S_pad: int, *axes: int) -> torch.Tensor:
    """x with each state axis in `axes` zero-padded at its end to S_pad
    entries, contiguous: a state space's way into a wider kernel instance
    (build.instance_states).  A padded row or column of a transition matrix, a tip row or
    a root weight is 0, so every padded partial row stays 0 and the real
    rows, maxima and scales are the unpadded arithmetic's."""
    pad = [0] * (2 * x.dim())
    for a in axes:
        pad[2 * (x.dim() - 1 - a % x.dim()) + 1] = S_pad - x.shape[a]
    return torch.nn.functional.pad(x, pad).contiguous()


def pad_partials(up: torch.Tensor, C: int, S_pad: int) -> torch.Tensor:
    """Stored partials [2N, C*S, P] with each category's S rows zero-padded
    to S_pad: [2N, C*S_pad, P]."""
    n, CS, P = up.shape
    return pad_states(up.reshape(n, C, CS // C, P), S_pad, 2).reshape(n, C * S_pad, P)


def unpad_partials(up: torch.Tensor, C: int, S: int) -> torch.Tensor:
    """[2N, C*S_pad, P] -> the first S rows of each category, [2N, C*S, P]."""
    n, CSp, P = up.shape
    return up.reshape(n, C, CSp // C, P)[:, :, :S].reshape(n, C * S, P)


def device_slot_schedule(tree_host, tree_arrays) -> Tuple[np.ndarray, int]:
    """Slot schedule with node ids translated to the device numbering used
    by TreeArrays / branch_transition_mats: (steps [N-1, 6] int32, n_slots)."""
    steps, n_slots = slot_schedule(tree_host)
    h2d = tree_arrays.h2d.cpu().numpy()
    steps = steps.copy()
    for col in (0, 1, 5):
        steps[:, col] = h2d[steps[:, col]]
    return steps, n_slots


def schedule_waves(steps: np.ndarray) -> List[np.ndarray]:
    """Schedule rows grouped into waves of mutually independent steps:
    a step's wave is one above the later of its children's."""
    depth = {}
    wave = np.empty(steps.shape[0], dtype=np.int64)
    for i, (l, r, _, _, _, node) in enumerate(steps.tolist()):
        wave[i] = 1 + max(depth.get(l, 0), depth.get(r, 0))
        depth[node] = wave[i]
    return [np.flatnonzero(wave == w) for w in range(1, int(wave.max()) + 1)]


def schedule_tree(steps: torch.Tensor, n_rows: int):
    """(levels, children) of the tree a schedule walks, in the form the
    plain passes of engine/likelihood.py take: node ids per wave, and
    children [n_rows, 2] (dummy rows point at the last row)."""
    s = steps.cpu().numpy()
    children = np.full((n_rows, 2), n_rows - 1, dtype=np.int64)
    children[s[:, 5]] = s[:, :2]
    dev = steps.device
    levels = [torch.as_tensor(s[w, 5].astype(np.int64), device=dev)
              for w in schedule_waves(s)]
    return levels, torch.as_tensor(children, device=dev)


def upward_plain(steps: torch.Tensor, trans: torch.Tensor, tips: torch.Tensor):
    """Plain twin of the upward sweep: (up [2N, CS, P], usc [2N, P]) for
    every node a step produces, one wave of independent steps at a time.
    Tip rows hold the C-tiled tip partials."""
    n_rows, C, S = trans.shape[:3]
    levels, children = schedule_tree(steps, n_rows)
    up, usc = upward_pass(levels, children, trans, tips)
    return up.reshape(n_rows, C * S, -1), usc


def _site_lnl_plain(steps, trans, tips, props, state_freq, invar):
    up, usc = upward_plain(steps, trans, tips)
    root = int(steps[-1, 5])
    rootw = (props[:, None] * state_freq).reshape(1, -1).to(up.dtype)
    mix = (rootw @ up[root])[0]
    lnl = torch.log(torch.clamp(mix, min=SCALE_TINY)) + usc[root]
    return torch.where(
        invar > 0,
        torch.logaddexp(lnl, torch.log(torch.clamp(invar, min=SCALE_TINY))),
        lnl)


def fused_site_lnl(steps, n_slots, trans, tips, props, state_freq, invar,
                   tile=None) -> torch.Tensor:
    """Per-pattern log-likelihood [P] of the tree a slot schedule walks.

    steps [N-1, 6] int32, trans [2N, C, S, S], tips [N, S, P],
    props [C], state_freq [C, S], invar [P] (the invariant-class
    likelihood).  CUDA tensors launch csrc/forward.cu at S <= 4 up to 8
    categories (S=2 and S=4 instances, S=3 padded) and csrc/wide_forward.cu
    (wide_site_lnl) at every other shape; CPU tensors run the plain twin.
    `tile` (patterns a cluster) is for measuring the wide kernel;
    forward.cu runs UPWARD_LANES lanes a block."""
    if not trans.is_cuda:
        return _site_lnl_plain(steps, trans, tips, props, state_freq, invar)
    C, S = trans.shape[1], trans.shape[2]
    if not build.packed(C, S):
        return wide_site_lnl(steps, n_slots, trans, tips, props, state_freq, invar,
                             tile)
    P, SK = tips.shape[2], build.instance_states(S, C)
    rootw = (props[:, None] * state_freq).float()
    if SK != S:
        trans, tips = pad_states(trans, SK, 2, 3), pad_states(tips, SK, 1)
        rootw = pad_states(rootw, SK, 1)
    rootw = rootw.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, tips, rootw, invar)
    out = torch.empty(P, dtype=torch.float32, device=trans.device)
    build.launch("forward", steps, steps.shape[0], trans, tips, P, rootw,
                 invar, out, C, SK, n_slots, UPWARD_LANES)
    fused_site_lnl.launches += 1
    return out


fused_site_lnl.launches = 0


def wide_forward_smem(S: int, C: int, tile: int, n_slots: int,
                      stages: int = CLUSTER_STAGES, warps: int = 1) -> int:
    """Bytes of shared memory a block of csrc/wide_forward.cu or
    csrc/wide_store.cu takes on `warps` category warps (the upward walk's
    ClusterSmem, csrc/wide_common.cuh): a ring stage of W categories' [S,S]
    blocks of both children, a tip area of both children's rows a stage,
    the slot pool of the block's CB categories ([slot][CB S + 1][tile]) and
    the max buffers of the K blocks' W warps (build.wide_layout)."""
    K, cb = build.wide_layout(C)
    return 4 * (stages * (warps * 2 * S * S + 2 * S * tile)
                + n_slots * (cb * S + 1) * tile + 2 * K * warps * tile)


def wide_forward_warps(S: int, C: int, tile: int, n_slots: int) -> int:
    """Category warps a block of csrc/wide_forward.cu and csrc/wide_store.cu:
    1 at one category a block; past 8 categories build.least_units over
    warps of tile / 2 x S / RPT threads, build.MULTI_THREADS_MAX threads a
    block and wide_forward_smem, least (U + 2) / b."""
    cb = build.wide_layout(C)[1]
    if cb == 1:
        return 1
    return build.least_units(cb, 2, tile // 2 * (S // WIDE_RPT[S]), build.MULTI_THREADS_MAX,
                             lambda w: wide_forward_smem(S, C, tile, n_slots, warps=w))


def wide_site_lnl(steps, n_slots, trans, tips, props, state_freq, invar,
                  tile=None) -> torch.Tensor:
    """fused_site_lnl at the wide shapes (S=20; S=4 past 8 categories; any
    other state count through the instance build.instance_states names, its
    inputs zero-padded): csrc/wide_forward.cu for CUDA tensors, the plain
    twin for CPU tensors.  A cluster of C blocks (one a
    rate category) holds `tile` patterns (default WIDE_FORWARD_TILE; for
    measuring the kernel)."""
    if not trans.is_cuda:
        return _site_lnl_plain(steps, trans, tips, props, state_freq, invar)
    C, S = trans.shape[1], trans.shape[2]
    P, SK = tips.shape[2], build.instance_states(S, C)
    rootw = (props[:, None] * state_freq).float()
    if SK != S:
        trans, tips = pad_states(trans, SK, 2, 3), pad_states(tips, SK, 1)
        rootw = pad_states(rootw, SK, 1)
    rootw = rootw.reshape(-1).contiguous()
    build.check_inputs(C, SK, steps, trans, tips, rootw, invar, n_slots=n_slots,
                       walk=True)
    out = torch.empty(P, dtype=torch.float32, device=trans.device)
    build.launch("wide_forward", steps, steps.shape[0], trans, tips, P, rootw,
                 invar, out, C, SK, n_slots, tile or WIDE_FORWARD_TILE)
    wide_site_lnl.launches += 1
    return out


wide_site_lnl.launches = 0


def fused_upward_store(steps, n_slots, trans, tips, tile=None):
    """(up [2N, CS, P], usc [2N, P]) at the wide shapes (S=20; S=4 past 8
    categories; any other state count through the instance
    build.instance_states names, padded in and sliced out): every
    internal node's normalized partial and log-scale, through
    csrc/wide_store.cu for CUDA tensors and the plain twin upward_plain
    for CPU tensors.  Tip rows are left for fill_tip_rows_cs.  A cluster
    of C blocks (one a rate category) holds `tile` patterns (default
    WIDE_STORE_TILE; for measuring the kernel); its shared memory is
    wide_forward_smem's."""
    if not trans.is_cuda:
        return upward_plain(steps, trans, tips)
    n_rows, C, S = trans.shape[:3]
    P, SK = tips.shape[2], build.instance_states(S, C)
    if SK != S:
        trans, tips = pad_states(trans, SK, 2, 3), pad_states(tips, SK, 1)
    build.check_inputs(C, SK, steps, trans, tips, n_slots=n_slots, walk=True)
    up = torch.empty(n_rows, C * SK, P, dtype=torch.float32, device=trans.device)
    usc = torch.zeros(n_rows, P, dtype=torch.float32, device=trans.device)
    build.launch("wide_store", steps, steps.shape[0], trans, tips, P, up, usc, C, SK,
                 n_slots, tile or WIDE_STORE_TILE)
    fused_upward_store.launches += 1
    return (unpad_partials(up, C, S) if SK != S else up), usc


fused_upward_store.launches = 0


def fused_compute_loglik(tree, model, site, steps, n_slots):
    """(f64 lnL, site_lnl) through the fused forward kernel; drop-in for
    compute_loglik when a slot schedule is available."""
    dt = site.code_masks.dtype
    trans = branch_transition_mats(model, tree.blen).to(dt).contiguous()
    site_lnl = fused_site_lnl(steps, n_slots, trans, tip_partials(site).contiguous(),
                              model.props, model.state_freq,
                              ptn_invar(model, site).to(dt).contiguous())
    return finish_site_lnl(site, site_lnl)


def multi_tree_schedule(trees_and_arrays):
    """One schedule for K topologies that share an alignment:
    (steps_kernel, steps_gather, n_slots, roots).

    trees_and_arrays: [(tree_host, tree_arrays)] of one taxon count.  Row j
    of tree k's slot schedule sits at row j*K+k; each tree's slots are
    offset into one global slot space, plus one trash slot (n_slots = the
    sum + 1).  steps_kernel carries raw tip ids for tip children (the tips
    are shared), steps_gather every node id offset by k*2N, the tree's rows
    in the concatenated trans; roots [K] are the trees' root slots.  The
    JAX package's multi_tree_schedule at pack=1 returns the same arrays
    (its pack-4 grouping fed the TPU's matrix unit)."""
    scheds = [device_slot_schedule(tree, ta) for tree, ta in trees_and_arrays]
    if len({s.shape[0] for s, _ in scheds}) != 1:
        raise ValueError("a multi-tree schedule needs trees of one taxon count")
    K = len(scheds)
    soff = np.cumsum([0] + [ns for _, ns in scheds])
    g = np.stack([s for s, _ in scheds]).astype(np.int64)  # [K, rows, 6]
    node_off = 2 * trees_and_arrays[0][0].n_taxa * np.arange(K)[:, None]
    slot_off = soff[:-1, None]
    for col in (0, 1, 5):
        g[:, :, col] += node_off
    for col in (2, 3):
        g[:, :, col] = np.where(g[:, :, col] >= 0, g[:, :, col] + slot_off, -1)
    g[:, :, 4] += slot_off
    kern = g.copy()
    for col in (0, 1):
        kern[:, :, col] = np.where(g[:, :, col + 2] < 0, g[:, :, col] - node_off,
                                   g[:, :, col])
    rows = lambda a: a.transpose(1, 0, 2).reshape(-1, 6).astype(np.int32)
    return rows(kern), rows(g), int(soff[-1]) + 1, g[:, -1, 4].astype(np.int32)


def pool_slots(steps, K: int) -> int:
    """The most slots one tree of a K-tree schedule uses: the shared-memory
    pool of the multi-tree kernel, whose block walks one tree."""
    out = np.asarray(steps)[:, 4].reshape(-1, K)
    return int((out.max(0) - out[0]).max()) + 1


def _stream_plain(steps, gather, trans, tips, rootw, invar, roots):
    """Plain twin of the multi-tree kernel: [K, P].  Tree k's rows (k::K),
    its node ids taken back by k*2N, run through the plain upward pass on
    its block of trans; its root is the node of its last row that writes
    roots[k]."""
    K = roots.shape[0]
    R = trans.shape[0] // K
    out = []
    for k in range(K):
        g = gather[k::K].clone()
        for col in (0, 1, 5):
            g[:, col] -= k * R
        up, usc = upward_plain(g, trans[k * R:(k + 1) * R], tips)
        root = int(g[(steps[k::K, 4] == roots[k]).nonzero()[-1, 0], 5])
        lnl = torch.log(torch.clamp(rootw @ up[root], min=SCALE_TINY)) + usc[root]
        out.append(torch.where(
            invar[k] > 0,
            torch.logaddexp(lnl, torch.log(torch.clamp(invar[k], min=SCALE_TINY))),
            lnl))
    return torch.stack(out)


def fused_site_lnl_cs_stream(steps, n_slots, trans, tips, props, state_freq,
                             ptn_invar, roots=None, gather_steps=None, tile=None,
                             tree_slots=None) -> torch.Tensor:
    """Per-pattern log-likelihood: [P] for one tree (roots=None: the last
    row's output slot), [K, P] for the K trees of a multi_tree_schedule
    (roots [K] their root slots, gather_steps its trans-row schedule).

    steps [R, 6] int32, trans [K*2N, C, S, S] (the K trees' arrays
    concatenated), tips [N, S, P], props [C], state_freq [C, S], ptn_invar
    [P] or [K, P].  DNA's CS-packed shapes only (S=4, C<=8; ValueError
    otherwise).  CUDA tensors launch csrc/stream_forward.cu, CPU tensors
    run the plain twin.  `tree_slots` is pool_slots(steps, K), the
    kernel's shared-memory pool, as n_slots is for one tree: a caller that
    built the schedule on the host passes it, otherwise it is read from
    the device.  `tile` (patterns per block) is for measuring the kernel."""
    C, S = trans.shape[1], trans.shape[2]
    if S != STREAM_STATES or not 1 <= C <= build.MAX_CATEGORIES:
        raise ValueError(f"the multi-tree kernel serves DNA's CS-packed shapes (S="
                         f"{STREAM_STATES}, C <= {build.MAX_CATEGORIES}), got "
                         f"C={C}, S={S}")
    single = roots is None
    if single:
        roots = steps[-1:, 4]
    K, P = roots.shape[0], tips.shape[2]
    if gather_steps is None:
        if K > 1:
            raise ValueError("a multi-tree schedule needs its gather_steps")
        gather_steps = steps
    invar = ptn_invar.expand(K, P).contiguous()
    rootw = (props[:, None] * state_freq).reshape(-1).to(trans.dtype).contiguous()
    if not trans.is_cuda:
        out = _stream_plain(steps, gather_steps, trans, tips, rootw, invar, roots)
        return out[0] if single else out
    if tree_slots is None:
        tree_slots = n_slots if single else pool_slots(steps.cpu(), K)
    build.check_inputs(C, S, steps, trans, tips, rootw, invar)
    build.check_inputs(C, S, gather_steps)
    roots = roots.to(torch.int32).contiguous()
    out = torch.empty(K, P, dtype=torch.float32, device=trans.device)
    build.launch("stream_forward", steps, gather_steps, steps.shape[0] // K, K, roots,
                 trans, tips, P, rootw, invar, out, C, tree_slots,
                 tile or DEFAULT_TILE)
    fused_site_lnl_cs_stream.launches += 1
    return out[0] if single else out


fused_site_lnl_cs_stream.launches = 0


def fused_multi_tree_lnl(trees_and_arrays, model, site, tile=None) -> torch.Tensor:
    """[K] float64 total log-likelihoods of K topologies that share the
    model and the alignment, through one launch of the multi-tree kernel
    (the plain twin for CPU tensors)."""
    if model.num_states != STREAM_STATES:
        raise ValueError(f"multi-tree evaluation needs DNA's CS-packed shape (S="
                         f"{STREAM_STATES}), got S={model.num_states}")
    sk, sg, n_slots, roots = multi_tree_schedule(trees_and_arrays)
    dt, dev = site.code_masks.dtype, site.code_masks.device
    trans = torch.cat([branch_transition_mats(model, ta.blen)
                       for _, ta in trees_and_arrays]).to(dt).contiguous()
    site_lnl = fused_site_lnl_cs_stream(
        torch.as_tensor(sk, device=dev), n_slots, trans,
        tip_partials(site).contiguous(), model.props, model.state_freq,
        ptn_invar(model, site).to(dt), roots=torch.as_tensor(roots, device=dev),
        gather_steps=torch.as_tensor(sg, device=dev), tile=tile,
        tree_slots=pool_slots(sk, len(roots)))
    corr = torch.stack([asc_correction(site, lnl) for lnl in site_lnl])
    return (site.pattern_freq.double() * (site_lnl - corr[:, None]).double()).sum(1)
