"""Pairwise maximum-likelihood distances, batched over all taxon pairs.

The pair count matrices of a chunk of taxon rows (every pair (a, b) with
a in the chunk) are one matrix product over the patterns, and the
per-pair Newton iterations run on them as batched tensor code; a chunk's
[pairs, S*S] and [pairs, C*S] temporaries are sized to a byte budget, so
S=61 codon spaces and the C=80 categories of a C20 mixture take as little
memory as DNA does.  For a reversible model with rate
categories the pairwise log-likelihood of count matrix n is
    l(t) = sum_st n_st log( sum_c w_c pi_s P_c(t)[s,t] ).
Everything runs in float64 on the caller's device.
"""

from __future__ import annotations

import numpy as np
import torch

from .derivatives import MAX_BLEN, MIN_BLEN
from .likelihood import ModelArrays, SiteData

# bytes the Newton loop's float64 temporaries may take at once: the
# chunk's counts and about five products and ratios live together, each
# [pairs, S*S] (the counts, the joint) or [pairs, C*S] (expo, expo * lamr,
# expo * lamr^2), so a pair takes PAIR_LIVE rows of the wider of the two
PAIR_BUDGET = 2 << 30
PAIR_LIVE = 6


def pair_chunk_rows(T: int, S: int, C: int = 1) -> int:
    """Taxon rows a chunk: the pairs of `rows` rows (rows x T) whose float64
    temporaries, max(S*S, C*S) columns, fit PAIR_BUDGET bytes, at least one
    row.  At S=61 that is ~12 000 pairs a chunk (12 rows at 1 000 taxa); at
    S=4 every pair of 1 000 taxa in one; at C20's C*S = 1 600 columns, four
    times S*S, ~28 000 pairs."""
    pairs = max(1, PAIR_BUDGET // (PAIR_LIVE * max(S * S, C * S) * 8))
    return max(1, min(T, pairs // T))


def _profiles(site: SiteData):
    """(x [T, S, P] state profiles of the tips, y [T*S, P] the same weighted
    by the pattern counts).  An ambiguous code contributes fractionally
    (mask / mask.sum); gaps and unknowns spread uniformly."""
    masks = site.code_masks.double()[site.tip_codes]  # [T, P, S]
    onehot = masks / torch.clamp(masks.sum(-1, keepdim=True), min=1e-30)
    T, P, S = onehot.shape
    y = (onehot * site.pattern_freq.double()[None, :, None]).permute(0, 2, 1)
    return onehot.permute(0, 2, 1), y.reshape(T * S, P)


def _counts(x, y, rows: slice) -> torch.Tensor:
    """[A, T, S, S] pattern-weighted co-occurrence counts of the taxon
    pairs (a, b), a in `rows`."""
    T, S, P = x.shape
    counts = x[rows].reshape(-1, P) @ y.T  # [(a,s), (b,t)]
    return counts.reshape(-1, S, T, S).permute(0, 2, 1, 3)


def ml_distances(model: ModelArrays, site: SiteData,
                 newton_iters: int = 12) -> np.ndarray:
    """[T, T] ML distance matrix (diagonal 0) as float64 numpy.  The pairs
    run a chunk of taxon rows at a time (pair_chunk_rows): the counts and
    the Newton temporaries of one chunk are live at once, never all
    [T, T, S, S] counts."""
    T, S = site.tip_codes.shape[0], site.code_masks.shape[1]
    f64 = lambda a: a.detach().double()
    lam, v, vinv = f64(model.eigenvalues), f64(model.eigvec), f64(model.inv_eigvec)
    rates, props, pi = f64(model.rates), f64(model.props), f64(model.state_freq)
    C = rates.shape[0]
    lamr = (lam * rates[:, None]).reshape(C * S)  # [(c,j)]
    # joint[s,t] = sum_{c,j} w_c pi_c[s] V_c[s,j] e^{lam_cj r_c t} V^-1_c[j,t]
    # = expo[(c,j)] @ B[(c,j), (s,t)]
    wpi = props[:, None] * pi  # [C, S]
    B = torch.einsum("cij,ci,cjk->cjik", v, wpi, vinv).reshape(C * S, S * S)

    out = torch.empty(T * T, dtype=torch.float64, device=B.device)
    b = (S - 1.0) / S
    x, y = _profiles(site)
    rows = pair_chunk_rows(T, S, C)
    for a0 in range(0, T, rows):
        n = _counts(x, y, slice(a0, a0 + rows)).reshape(-1, S * S)
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
        out[a0 * T:a0 * T + t.shape[0]] = t
    d = out.reshape(T, T)
    d = 0.5 * (d + d.T)
    d = d - torch.diag(torch.diag(d))
    return d.cpu().numpy()
