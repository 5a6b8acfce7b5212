"""Batched branch-length Newton on every branch at once.

One upward store and one reverse sweep (the branch-Newton kernel,
kernels/cs_kernels.py fused_newton_derivs: the CS-packed kernels for DNA,
the wide ones for protein, the plain twins on the CPU) give d lnL/dt and
d2 lnL/dt2 for all 2N-3 branches; Newton then moves every branch simultaneously
(Jacobi-style sweeps rather than one branch at a time).  Plain Jacobi
steps oscillate, because neighbouring branches overshoot jointly, so each
sweep backtracks on the joint step until the lnL does not drop.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .kernels.cs_kernels import fused_newton_derivs
from .kernels.pruning import fused_compute_loglik
from .likelihood import ModelArrays, SiteData, TreeArrays, ptn_invar, tip_partials

MIN_BLEN = 1e-6
MAX_BLEN = 100.0


def blen_bounds() -> Tuple[float, float]:
    """(min, max) branch-length bounds."""
    return MIN_BLEN, MAX_BLEN


def optimize_branch_mask(tree: TreeArrays) -> torch.Tensor:
    """[2N] bool: which entries of blen are free parameters.  Excludes the
    virtual root, its non-tip-0 child (that half-edge is pinned to 0; tip 0
    carries the pendant edge) and the dummy row."""
    root = tree.root
    c0, c1 = (int(c) for c in tree.children[root])
    pinned = c1 if c0 == 0 else c0
    mask = torch.ones(tree.n_nodes + 1, dtype=torch.bool, device=tree.blen.device)
    mask[[root, pinned, tree.dummy]] = False
    return mask


def newton_target(d1, d2, blen, min_blen=None, max_blen=None) -> torch.Tensor:
    """Safeguarded per-branch Newton target: t - f'/f'' where the
    curvature is negative, else a doubling/halving move along the
    gradient, clipped to the bounds."""
    b0, b1 = blen_bounds()
    min_blen = b0 if min_blen is None else min_blen
    max_blen = b1 if max_blen is None else max_blen
    newton = blen - d1 / torch.clamp(d2, max=-1e-12)
    fallback = torch.where(d1 > 0, blen * 2.0, blen * 0.5)
    target = torch.where(d2 < -1e-12, newton, fallback)
    return torch.clamp(target, min_blen, max_blen)


def optimize_all_branches(
    tree: TreeArrays,
    model: ModelArrays,
    site: SiteData,
    steps: torch.Tensor,
    n_slots: int,
    n_sweeps: int = 100,
    tol: float = 1e-5,
    max_backtracks: int = 8,
) -> Tuple[TreeArrays, float]:
    """Newton sweeps on all branches until a sweep gains less than `tol`
    lnL: each sweep takes the full joint Newton step and halves it (at
    most `max_backtracks` times) while the lnL is below the last one;
    a sweep whose smallest step still loses stays put and ends the loop.
    Returns (tree with the new blen, lnL)."""
    if bool((site.asc_mask != 0).any()):
        raise NotImplementedError(
            "branch Newton with +ASC is not ported yet (the ascertainment-bias slice)")
    mask = optimize_branch_mask(tree)
    dt = site.code_masks.dtype
    tips = tip_partials(site).contiguous()
    pfreq = site.pattern_freq.contiguous()
    with torch.no_grad():
        invar = ptn_invar(model, site).to(dt).contiguous()

        def true_lnl(b):
            return float(fused_compute_loglik(tree.with_blen(b), model, site,
                                              steps, n_slots)[0])

        blen = tree.blen
        last = true_lnl(blen)
        for _ in range(n_sweeps):
            d1, d2 = fused_newton_derivs(steps, n_slots, model, blen, tips,
                                         pfreq, invar)
            target = newton_target(d1.to(blen.dtype), d2.to(blen.dtype), blen)
            direction = torch.where(mask, target - blen, torch.zeros_like(blen))
            step = 1.0
            new = true_lnl(blen + direction)
            k = 0
            while k < max_backtracks and new < last:
                step *= 0.5
                new = true_lnl(blen + step * direction)
                k += 1
            if not new >= last:  # the smallest step lost (or NaN): stay put
                break
            blen = blen + step * direction
            improved, last = new - last, new
            if improved <= tol:
                break
    return tree.with_blen(blen), last
