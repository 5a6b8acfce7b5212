"""Pairwise maximum-likelihood distances, batched over all taxon pairs.

The pair count matrices of all pairs are one matrix product over the
patterns; the per-pair Newton iterations run as batched tensor code, a
chunk of pairs at a time.  For a reversible model with rate categories
the pairwise log-likelihood of count matrix n is
    l(t) = sum_st n_st log( sum_c w_c pi_s P_c(t)[s,t] ).
Everything runs in float64 on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .derivatives import MAX_BLEN, MIN_BLEN
from .likelihood import ModelArrays, SiteData

# pairs per Newton chunk: bounds the [chunk, S*S] temporaries
PAIR_CHUNK = 1 << 18


def pair_count_matrices(site: SiteData) -> torch.Tensor:
    """[T, T, S, S] pattern-weighted co-occurrence counts of every taxon
    pair.  An ambiguous code contributes fractionally (mask / mask.sum);
    gaps and unknowns spread uniformly."""
    masks = site.code_masks.double()[site.tip_codes]  # [T, P, S]
    onehot = masks / torch.clamp(masks.sum(-1, keepdim=True), min=1e-30)
    T, P, S = onehot.shape
    x = onehot.permute(0, 2, 1).reshape(T * S, P)
    y = (onehot * site.pattern_freq.double()[None, :, None]).permute(0, 2, 1)
    counts = x @ y.reshape(T * S, P).T  # [(a,s), (b,t)]
    return counts.reshape(T, S, T, S).permute(0, 2, 1, 3)


def ml_distances(model: ModelArrays, site: SiteData,
                 newton_iters: int = 12) -> np.ndarray:
    """[T, T] ML distance matrix (diagonal 0) as float64 numpy."""
    counts = pair_count_matrices(site)
    T, S = counts.shape[0], counts.shape[2]
    f64 = lambda a: a.detach().double()
    lam, v, vinv = f64(model.eigenvalues), f64(model.eigvec), f64(model.inv_eigvec)
    rates, props, pi = f64(model.rates), f64(model.props), f64(model.state_freq)
    C = rates.shape[0]
    lamr = (lam * rates[:, None]).reshape(C * S)  # [(c,j)]
    # joint[s,t] = sum_{c,j} w_c pi_c[s] V_c[s,j] e^{lam_cj r_c t} V^-1_c[j,t]
    # = expo[(c,j)] @ B[(c,j), (s,t)]
    wpi = props[:, None] * pi  # [C, S]
    B = torch.einsum("cij,ci,cjk->cjik", v, wpi, vinv).reshape(C * S, S * S)

    flat = counts.reshape(T * T, S * S)
    out = torch.empty(T * T, dtype=torch.float64, device=flat.device)
    b = (S - 1.0) / S
    for lo in range(0, T * T, PAIR_CHUNK):
        n = flat[lo:lo + PAIR_CHUNK]
        total = torch.clamp(n.sum(-1), min=1e-30)
        diag = n[:, :: S + 1].sum(-1)
        arg = torch.clamp(1.0 - (1.0 - diag / total) / b, min=0.05)
        t = torch.clamp(-b * torch.log(arg), MIN_BLEN, MAX_BLEN)
        for _ in range(newton_iters):
            expo = torch.exp(t[:, None] * lamr[None, :])  # [k, (c,j)]
            joint = torch.clamp(expo @ B, min=1e-300)
            r1 = ((expo * lamr) @ B) / joint
            r2 = ((expo * lamr * lamr) @ B) / joint
            d1 = (n * r1).sum(-1)
            d2 = (n * (r2 - r1 * r1)).sum(-1)
            t_new = torch.where(d2 < -1e-12, t - d1 / torch.clamp(d2, max=-1e-12),
                                torch.where(d1 > 0, t * 2.0, t * 0.5))
            t = torch.clamp(t_new, MIN_BLEN, MAX_BLEN)
        out[lo:lo + PAIR_CHUNK] = t
    d = out.reshape(T, T)
    d = 0.5 * (d + d.T)
    d = d - torch.diag(torch.diag(d))
    return d.cpu().numpy()
