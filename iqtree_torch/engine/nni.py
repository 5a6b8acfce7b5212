"""Batched NNI evaluation: every given internal edge, both swaps, at once.

One upward store and one outside-partial store (kernels/cs_kernels.py
fused_nni_passes_cs) give the four subtree messages around every internal
edge; each NNI candidate is then a local computation -- messages fixed,
the 5 local branch lengths re-optimized by Newton on their theta
buffers -- batched over the candidates of a chunk of edges.

Around internal edge (v, u = parent(v)) the four subtrees are
  a = children[v,0],  b = children[v,1]   (below v)
  c = sibling of v                        (below u)
  up = everything above u                 (outside message O[u])
swap 0 exchanges a <-> c, swap 1 exchanges b <-> c, as
PhyloTree.apply_nni(v, swap) does on the host.  With `paired` the edge's
identity configuration is scored as a third swap by the same machinery:
in float32 the shared messages carry per-edge lnL biases far larger than
a marginal NNI's gain, and they cancel in lnl - base_lnl.

Reversible models only; the local work runs in the partials' type, the
totals in float64.  Under +ASC the local Newton and the scores carry the
correction's terms (derivatives.theta_derivs, asc_corrections).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .derivatives import (LocalModel, asc_corrections, local_model, newton_target,
                          theta_derivs, thetas)
from .kernels.cs_kernels import fused_nni_passes_cs
from .likelihood import (
    SCALE_TINY,
    ModelArrays,
    SiteData,
    TreeArrays,
    branch_transition_mats,
    tip_partials,
)


class NNIEval(NamedTuple):
    lnl: torch.Tensor  # [E, 2] candidate log-likelihoods (float64)
    center_blen: torch.Tensor  # [E, 2] optimized central branch length
    cur_lnl: torch.Tensor  # scalar: the current tree's lnL, same machinery
    base_lnl: Optional[torch.Tensor] = None  # [E] identity configuration (paired)


def _pmat(m: LocalModel, t: torch.Tensor) -> torch.Tensor:
    """P(t_k r_c) [K, C, S, S] for branch lengths t [K]."""
    expo = torch.exp(m.lam[None] * (t[:, None] * m.rates[None])[:, :, None])
    return (m.eigvec[None] * expo[:, :, None, :]) @ m.inv_eigvec[None]


def _apply(p, x):
    """[K,C,S,S] x [K,C,S,P] -> [K,C,S,P]"""
    return p @ x


def _apply_t(p, x):
    return p.transpose(-1, -2) @ x


def _rescale(x, scale):
    mx = torch.clamp(x.amax(dim=(1, 2)), min=SCALE_TINY)
    return x / mx[:, None, None, :], scale + torch.log(mx)


def _theta_lnl_newton(m: LocalModel, inside, in_scale, outside, out_scale, t0,
                      newton_iters: int):
    """1-D Newton on each candidate's branch from its theta buffer (with
    +ASC's terms); returns (t* [K], lnl(t*) [K] float64, +ASC-corrected)."""
    th = thetas(m, inside, in_scale, outside, out_scale)
    t = t0
    for _ in range(newton_iters):
        d1, d2, _ = theta_derivs(m, th, t)
        t = newton_target(d1, d2, t)
    _, _, denom = theta_derivs(m, th, t)
    site_lnl = th.scale + torch.log(denom)
    site_lnl = site_lnl - asc_corrections(m, site_lnl)[:, None]
    return t, (m.pfreq.double() * site_lnl.double()).sum(-1)


def _candidates(tree: TreeArrays, edges: np.ndarray, n_sw: int):
    """Node ids of each candidate, [E, n_sw] each: (p, q) go below the
    central edge, r beside it under u; plus u and v [E, n_sw]."""
    children = tree.children.cpu().numpy()
    parent = tree.parent.cpu().numpy()
    v = np.asarray(edges, dtype=np.int64)
    u = parent[v]
    a, b = children[v, 0], children[v, 1]
    c = np.where(children[u, 0] == v, children[u, 1], children[u, 0])
    # swap 0: inside (c, b), out a; swap 1: inside (a, c), out b;
    # swap 2 (paired baseline): inside (a, b), out c
    p = np.stack([c, a, a], 1)[:, :n_sw]
    q = np.stack([b, c, b], 1)[:, :n_sw]
    r = np.stack([a, b, c], 1)[:, :n_sw]
    rep = lambda x: np.repeat(x[:, None], n_sw, 1)
    return p, q, r, rep(u), rep(v)


def nni_passes(tree: TreeArrays, model: ModelArrays, site: SiteData, steps,
               n_slots: int):
    """(up, usc, out, osc) for the evaluator through the two store kernels
    (their plain twins for CPU tensors)."""
    dt = site.code_masks.dtype
    trans = branch_transition_mats(model, tree.blen).to(dt).contiguous()
    return fused_nni_passes_cs(steps, n_slots, trans, tip_partials(site),
                               model.state_freq.to(dt))


def evaluate_nnis(
    tree: TreeArrays,
    model: ModelArrays,
    site: SiteData,
    edges: np.ndarray,  # [E] device ids v whose parent edge is internal
    steps: torch.Tensor,
    n_slots: int,
    edge_chunk: int = 0,
    paired: bool = False,
    passes=None,
) -> NNIEval:
    """Score both NNIs of every given edge, re-optimizing the 5 local
    branch lengths once (as the reference's getBestNNIForBran does), then
    the central one twice more.  `edge_chunk` bounds how many edges'
    candidates are live at once (0: all).  `passes` = (up, usc, out, osc)
    replaces the two global passes (the comparison of the kernels with
    their plain twins)."""
    if passes is None:
        passes = nni_passes(tree, model, site, steps, n_slots)
    up, usc, out, osc = passes
    C, S = model.ncat, model.num_states
    n_rows, P = up.shape[0], up.shape[-1]
    dt = up.dtype
    up = up.reshape(n_rows, C, S, P)
    out = out.reshape(n_rows, C, S, P)
    m = local_model(model, site, dt)
    blen = tree.blen.detach().to(dt)
    dev = up.device

    v0 = int(edges[0])
    _, cur_lnl = _theta_lnl_newton(m, up[v0:v0 + 1], usc[v0:v0 + 1],
                                   out[v0:v0 + 1], osc[v0:v0 + 1],
                                   blen[v0:v0 + 1], 0)

    n_sw = 3 if paired else 2
    cand = [torch.as_tensor(x.reshape(-1), device=dev)
            for x in _candidates(tree, edges, n_sw)]
    E = len(edges)
    B = edge_chunk if 0 < edge_chunk < E else E
    lnls, centers = [], []
    for lo in range(0, E, B):
        k = slice(lo * n_sw, min(E, lo + B) * n_sw)
        ip, iq, ir, iu, iv = (x[k] for x in cand)
        U_p, U_q, U_r, O_u = up[ip], up[iq], up[ir], out[iu]
        sU_p, sU_q, sU_r, sO_u = usc[ip], usc[iq], usc[ir], osc[iu]
        t_p, t_q, t_r, t_u, t_c = blen[ip], blen[iq], blen[ir], blen[iu], blen[iv]

        def messages(t_p, t_q, t_r, t_u):
            M_p = _apply(_pmat(m, t_p), U_p)
            M_q = _apply(_pmat(m, t_q), U_q)
            M_r = _apply(_pmat(m, t_r), U_r)
            M_up = _apply_t(_pmat(m, t_u), O_u)
            return M_p, M_q, M_r, M_up

        # one round over the central and the 4 outer branches
        M_p, M_q, M_r, M_up = messages(t_p, t_q, t_r, t_u)
        inside, s_in = _rescale(M_p * M_q, sU_p + sU_q)
        outside, s_out = _rescale(M_r * M_up, sU_r + sO_u)
        t_c, _ = _theta_lnl_newton(m, inside, s_in, outside, s_out, t_c, 2)
        down = _apply_t(_pmat(m, t_c), outside)  # at v, from outside
        o_p, so_p = _rescale(M_q * down, sU_q + s_out)
        t_p, _ = _theta_lnl_newton(m, U_p, sU_p, o_p, so_p, t_p, 2)
        o_q, so_q = _rescale(M_p * down, sU_p + s_out)
        t_q, _ = _theta_lnl_newton(m, U_q, sU_q, o_q, so_q, t_q, 2)
        del down, o_p, o_q
        up2 = _apply(_pmat(m, t_c), inside)  # message v -> u
        o_r, so_r = _rescale(M_up * up2, sO_u + s_in)
        t_r, _ = _theta_lnl_newton(m, U_r, sU_r, o_r, so_r, t_r, 2)
        u_in, su_in = _rescale(M_r * up2, sU_r + s_in)
        t_u, _ = _theta_lnl_newton(m, u_in, su_in, O_u, sO_u, t_u, 2)
        del up2, o_r, u_in, M_p, M_q, M_r, M_up, inside, outside
        # the final score at the center
        M_p, M_q, M_r, M_up = messages(t_p, t_q, t_r, t_u)
        inside, s_in = _rescale(M_p * M_q, sU_p + sU_q)
        outside, s_out = _rescale(M_r * M_up, sU_r + sO_u)
        del M_p, M_q, M_r, M_up
        t_c, lnl = _theta_lnl_newton(m, inside, s_in, outside, s_out, t_c, 2)
        lnls.append(lnl)
        centers.append(t_c)
    lnl = torch.cat(lnls).reshape(E, n_sw)
    center = torch.cat(centers).reshape(E, n_sw)
    return NNIEval(lnl=lnl[:, :2], center_blen=center[:, :2], cur_lnl=cur_lnl[0],
                   base_lnl=lnl[:, 2] if paired else None)
