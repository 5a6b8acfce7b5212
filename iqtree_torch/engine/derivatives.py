"""Batched branch-length Newton on every branch at once.

d lnL/dt and d2 lnL/dt2 for all 2N-3 branches come from one of two paths
(`branch_derivs`):

* the branch-Newton sweep: one upward store and one reverse sweep
  (kernels/cs_kernels.py fused_newton_derivs: the CS-packed kernels for
  DNA, the wide ones for protein, the plain twins on the CPU);
* the theta path, where no branch-Newton kernel serves the shape (the
  codon spaces, protein past 8 categories and DNA past 32, as in the JAX
  package) and under +ASC, whose per-branch terms the sweep does not
  carry (as in the JAX package): the upward store and the outside-partial store
  (fused_nni_passes_cs, the wide kernels), then every branch's theta
  buffer theta[v,c,j,p] = (V^T O_v)_j (V^-1 U_v)_j and its derivatives
  f_k = sum_cj w_c (lam_j r_c)^k e^{lam_j r_c t} theta in plain PyTorch
  (`thetas`, `theta_derivs`, shared with the NNI evaluator's local
  Newton, engine/nni.py), a chunk of branches at a time
  (theta_chunk_edges).

Newton then moves every branch simultaneously (Jacobi-style sweeps rather
than one branch at a time).  Plain Jacobi steps oscillate, because
neighbouring branches overshoot jointly, so each sweep backtracks on the
joint step until the lnL does not drop.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .kernels import build
from .kernels.cs_kernels import fused_newton_derivs, fused_nni_passes_cs
from .kernels.pruning import fused_compute_loglik
from .likelihood import (SCALE_TINY, ModelArrays, SiteData, TreeArrays,
                         branch_transition_mats, ptn_invar, tip_partials)

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


class LocalModel(NamedTuple):
    """The model in the working type, laid out for the theta algebra."""
    eigvec: torch.Tensor  # [C, S, S]
    inv_eigvec: torch.Tensor  # [C, S, S]
    lam: torch.Tensor  # [C, S]
    rates: torch.Tensor  # [C]
    lam_r: torch.Tensor  # [CS] eigenvalue x category rate
    props_cs: torch.Tensor  # [CS]
    pfreq: torch.Tensor  # [P]
    invar: torch.Tensor  # [P]
    asc: Optional[torch.Tensor] = None  # [P] the +ASC patterns (None: no +ASC)


def has_asc(site: SiteData) -> bool:
    """Whether the site data carry +ASC's unobservable constant patterns."""
    return bool((site.asc_mask != 0).any())


def local_model(model: ModelArrays, site: SiteData, dt) -> LocalModel:
    C, S = model.ncat, model.num_states
    to = lambda x: x.detach().to(dt)
    lam, rates = to(model.eigenvalues), to(model.rates)
    return LocalModel(
        eigvec=to(model.eigvec), inv_eigvec=to(model.inv_eigvec), lam=lam,
        rates=rates, lam_r=(lam * rates[:, None]).reshape(C * S),
        props_cs=to(model.props)[:, None].expand(C, S).reshape(C * S),
        pfreq=site.pattern_freq.to(dt), invar=to(ptn_invar(model, site)),
        asc=site.asc_mask.to(dt) if has_asc(site) else None)


class Thetas(NamedTuple):
    theta: torch.Tensor  # [K, CS, P]
    scale: torch.Tensor  # [K, P] inside + outside log-scale
    invar: torch.Tensor  # [K, P] the invariant class in the scaled frame


def thetas(m: LocalModel, inside, in_scale, outside, out_scale) -> Thetas:
    """Theta buffers of K branches from their inside and outside partials
    [K, C, S, P] and log-scales [K, P]: theta[k,c,j,p] = (V^T O)_j (V^-1 U)_j
    (the JAX package's compute_thetas)."""
    K, C, S, P = inside.shape
    scale = in_scale + out_scale
    invar = torch.where(m.invar > 0,
                        m.invar * torch.exp(torch.clamp(-scale, max=80.0)),
                        torch.zeros_like(scale))
    vt_o = m.eigvec.transpose(-1, -2)[None] @ outside  # [K, C, j, P]
    vi_u = m.inv_eigvec[None] @ inside
    return Thetas((vt_o * vi_u).reshape(K, C * S, P), scale, invar)


def theta_derivs(m: LocalModel, th: Thetas, t: torch.Tensor):
    """(d1 [K], d2 [K], denom [K, P]) at branch lengths t [K]: d lnL/dt and
    d2 lnL/dt2 of each branch and its scaled site likelihoods, from
    f_k = sum_cj w_c (lam_j r_c)^k e^{lam_j r_c t} theta (the JAX package's
    branch_lnl_derivs).  Under +ASC the total also holds -n log(1 - q),
    q = sum of the unobservable patterns' likelihoods: with q' = sum L r1
    and q'' = sum L r2 over them, d1 gains n q' / (1 - q) and d2
    n (q'' / (1 - q) + (q' / (1 - q))^2), 1 - q clamped at 1e-10."""
    e = m.props_cs[None] * torch.exp(m.lam_r[None] * t[:, None])  # [K, CS]
    w = torch.stack([e, e * m.lam_r, e * m.lam_r * m.lam_r], dim=1)
    f = torch.bmm(w, th.theta)  # [K, 3, P]
    denom = torch.clamp(f[:, 0], min=SCALE_TINY) + th.invar
    r1, r2 = f[:, 1] / denom, f[:, 2] / denom
    d1, d2 = (m.pfreq * r1).sum(-1), (m.pfreq * (r2 - r1 * r1)).sum(-1)
    if m.asc is not None:
        L = m.asc * torch.exp(torch.clamp(th.scale + torch.log(denom), max=0.0))
        one_m_q = torch.clamp(1.0 - L.sum(-1), min=1e-10)
        n = m.pfreq.sum()
        q1, q2 = (L * r1).sum(-1) / one_m_q, (L * r2).sum(-1) / one_m_q
        d1, d2 = d1 + n * q1, d2 + n * (q2 + q1 * q1)
    return d1, d2, denom


def asc_corrections(m: LocalModel, site_lnl: torch.Tensor) -> torch.Tensor:
    """[K] log(1 - q) of K candidates' uncorrected site lnl [K, P]
    (likelihood.asc_correction a row each); 0 without +ASC."""
    if m.asc is None:
        return torch.zeros_like(site_lnl[:, 0])
    q = (m.asc * torch.exp(torch.clamp(site_lnl, max=0.0))).sum(-1)
    return torch.log1p(-torch.clamp(q, max=1.0 - 1e-10))


def newton_serves(C: int, S: int, asc: bool = False) -> bool:
    """Whether a branch-Newton sweep kernel serves C categories x S states
    (DNA and binary up to 32 categories, 3 to 20 states up to 8); the codon
    spaces, the shapes past those and +ASC (`asc`) take the theta path."""
    SK = build.instance_states(S, C)
    return not asc and (build.packed(C, S) or build.wide_newton_multi(C, SK)
                        or (SK in build.WIDE_NEWTON_STATES and C <= build.MAX_CATEGORIES))


# Bytes the theta path's per-branch buffers may take at once: the theta
# buffers [K, C*S, P] and the two transforms they are made of
# (THETA_LIVE tensors of that size).  At C20 (C*S = 1 600) and 1 958
# patterns in float32 a branch takes 38 MB, so a chunk holds 28 branches.
THETA_BUDGET = 1 << 30
THETA_LIVE = 3


def theta_chunk_edges(n_edges: int, CS: int, n_patterns: int, item: int) -> int:
    """Branches whose theta buffers the theta path builds at once: as many
    as fit THETA_BUDGET, at least one."""
    per_edge = THETA_LIVE * CS * n_patterns * item
    return max(1, min(n_edges, THETA_BUDGET // per_edge))


def branch_derivs(steps, n_slots: int, model: ModelArrays, site: SiteData,
                  blen: torch.Tensor, tips, invar):
    """(d1 [2N], d2 [2N]) of every edge (entry v = the edge above v; the
    root and dummy rows carry no edge): the branch-Newton sweep where a
    kernel serves the shape, else (and under +ASC) the theta path on the
    upward store and the outside-partial store."""
    if newton_serves(model.ncat, model.num_states, has_asc(site)):
        return fused_newton_derivs(steps, n_slots, model, blen, tips,
                                   site.pattern_freq.contiguous(), invar)
    dt = tips.dtype
    trans = branch_transition_mats(model, blen).to(dt).contiguous()
    up, usc, out, osc = fused_nni_passes_cs(steps, n_slots, trans, tips,
                                            model.state_freq.to(dt))
    n, P = up.shape[0], up.shape[2]
    shape = (n, model.ncat, model.num_states, P)
    inside, outside = up.reshape(shape), out.reshape(shape)
    m = local_model(model, site, dt)
    t = blen.to(dt)
    # each branch's buffers and sums are its own: a chunk of branches gives
    # the values all of them at once would
    k = theta_chunk_edges(n, model.ncat * model.num_states, P, up.element_size())
    d1, d2 = [], []
    for a in range(0, n, k):
        e = slice(a, a + k)
        r = theta_derivs(m, thetas(m, inside[e], usc[e], outside[e], osc[e]), t[e])
        d1.append(r[0])
        d2.append(r[1])
    return torch.cat(d1), torch.cat(d2)


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
    mask = optimize_branch_mask(tree)
    dt = site.code_masks.dtype
    tips = tip_partials(site).contiguous()
    with torch.no_grad():
        invar = ptn_invar(model, site).to(dt).contiguous()

        def true_lnl(b):
            return float(fused_compute_loglik(tree.with_blen(b), model, site,
                                              steps, n_slots)[0])

        blen = tree.blen
        last = true_lnl(blen)
        for _ in range(n_sweeps):
            d1, d2 = branch_derivs(steps, n_slots, model, site, blen, tips, invar)
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
