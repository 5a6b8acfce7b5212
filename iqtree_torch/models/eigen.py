"""Rate-matrix construction and eigendecomposition (torch, differentiable).

For reversible models the symmetrization trick gives a symmetric problem:

    B = diag(sqrt(pi)) * Q * diag(sqrt(pi))^-1   is symmetric,
    eigh(B) = (lam, U)  =>  Q = V diag(lam) V^-1 with
    V = diag(pi)^-1/2 U,  V^-1 = U^T diag(pi)^1/2.
"""

from __future__ import annotations

import torch


def build_rate_matrix(sym_rates: torch.Tensor, freq: torch.Tensor) -> torch.Tensor:
    """Reversible Q from exchangeabilities [S,S] (diagonal ignored) and
    frequencies [S], normalized to mean substitution rate 1."""
    q = sym_rates * freq[None, :]
    q = q - torch.diag(torch.diagonal(q))
    q = q - torch.diag(q.sum(dim=1))
    return q / -torch.sum(freq * torch.diagonal(q))


class SafeEigh(torch.autograd.Function):
    """eigh with degenerate-safe derivatives.

    torch.linalg.eigh's backward divides by eigenvalue gaps and gives NaN
    at exact degeneracies -- e.g. equal GTR rates (a triple eigenvalue),
    which is the starting point of every GTR fit.  Downstream only
    V diag(f(lam)) V^-1 is used, which is invariant under rotations
    inside an eigenspace, so zeroing the degenerate cross-terms gives the
    correct gradient.

    The forward runs LAPACK on the host, as the reference pass (numpy)
    does, whatever the device: the problem is S x S, and on the card
    cuSOLVER's eigenvectors put P(t)'s small entries (a change across
    several states on a short branch, which ORDERED's banded Q makes
    O(t^k)) at another round-off level, which a fit then exploits: the
    ORDERED+ASC+G fit of the Dayhoff-6 protein bench (chip_smoke.py phase
    30) ended 8.9 lnL above its written result's float64 evaluation
    through numpy's eigenvectors, 1.6 with the host's."""

    @staticmethod
    def forward(ctx, b):
        lam, u = (x.to(b.device) for x in torch.linalg.eigh(b.cpu()))
        ctx.save_for_backward(lam, u)
        return lam, u

    @staticmethod
    def backward(ctx, g_lam, g_u):
        lam, u = ctx.saved_tensors
        diff = lam[None, :] - lam[:, None]  # diff[i,j] = lam_j - lam_i
        scale = torch.clamp(lam.abs().max(), min=1e-30)
        # dtype-aware cutoff: numerically degenerate eigenvalues differ by
        # O(eps * scale), and 1/diff would inject O(1/eps) garbage
        tol = 30.0 * torch.finfo(lam.dtype).eps ** 0.75 * scale
        degenerate = diff.abs() < tol
        f = torch.where(degenerate, torch.zeros_like(diff),
                        1.0 / torch.where(degenerate, torch.ones_like(diff), diff))
        # adjoint of (dlam = diag(U^T dB U), dU = U (F * (U^T dB U)))
        inner = torch.zeros_like(u) if g_u is None else f * (u.T @ g_u)
        if g_lam is not None:
            inner = inner + torch.diag(g_lam)
        gb = u @ inner @ u.T
        return 0.5 * (gb + gb.T)


def eigen_reversible(sym_rates: torch.Tensor, freq: torch.Tensor):
    """(eigenvalues [S], V [S,S], V^-1 [S,S]) of the normalized reversible
    Q, with Q = V diag(lam) V^-1 and P(t) = V diag(exp(lam t)) V^-1."""
    q = build_rate_matrix(sym_rates, freq)
    sqrt_pi = torch.sqrt(freq)
    b = q * (sqrt_pi[:, None] / sqrt_pi[None, :])
    lam, u = SafeEigh.apply(0.5 * (b + b.T))
    return lam, u / sqrt_pi[:, None], u.T * sqrt_pi[None, :]


def transition_matrices(eigenvalues, eigvec, inv_eigvec, t):
    """P_c(t_c) = V_c exp(diag(lam_c * t_c)) V_c^-1 for every category.

    eigenvalues [C,S], eigvec/inv_eigvec [C,S,S], t [..., C] (branch length
    times category rate).  Returns [..., C, S, S].

    Floored at 0 with a straight-through gradient: tiny entries computed
    by cancellation of O(1) eigen-terms can round negative, and one
    negative entry poisons a pattern's likelihood; P(t) of an irreducible
    Q is strictly positive, so the floor never masks a real value.  The
    identity pullback keeps the smooth derivative at zero-length branches,
    where P(0)'s off-diagonals are round-off but dP/dt = Q is O(1)."""
    expo = torch.exp(eigenvalues * t[..., None])  # [..., C, S]
    p = torch.einsum("cij,...cj,cjk->...cik", eigvec, expo, inv_eigvec)
    return p + (torch.clamp(p, min=0.0) - p).detach()
