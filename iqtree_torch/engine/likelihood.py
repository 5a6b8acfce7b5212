"""Felsenstein pruning on array-encoded trees (plain PyTorch).

The tree topology is data: internal nodes carry a level-contiguous device
numbering (trees/tree.py device_numbering), and the plain pruning pass
runs one batched step per level -- every node of a level at once, each a
[C,S,S] x [C,S,P] product over its two children.  This is the reference
engine the kernels (engine/kernels/) are held against; the fitting paths
run the kernels instead when a slot schedule is given.

Numerical scaling: every internal node renormalizes by its per-pattern
max and accumulates a log-scale, so
  lnl[p] = logaddexp(scale_root[p] + log(site_mix[p]), log(ptn_invar[p])).

Layouts:
  tip codes          long [N_taxa, P]
  partials           [2N, C, S, P]  (device numbering; row 2N-1 is a dummy)
  log-scales         [2N, P]
  transition mats    [2N, C, S, S]
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..models.eigen import transition_matrices

# Floor for per-pattern renormalization factors: prevents division by zero
# on impossible states; any real pattern likelihood is far above this.
SCALE_TINY = 1e-30


def node_levels(children: np.ndarray, n_taxa: int) -> List[np.ndarray]:
    """Internal device ids grouped by height above the tips (bottom-up).
    Children always sit on lower levels, so one level's nodes are
    independent given the levels below."""
    n_nodes = children.shape[0] - 1  # without the dummy row
    depth = np.zeros(n_nodes, dtype=np.int64)
    for v in range(n_taxa, n_nodes):  # level-contiguous: children first
        depth[v] = 1 + max(depth[children[v, 0]], depth[children[v, 1]])
    ids = np.arange(n_taxa, n_nodes)
    return [ids[depth[ids] == d] for d in range(1, int(depth.max()) + 1)]


@dataclass
class TreeArrays:
    """Device view of one topology and its branch lengths.

    Tips keep host ids 0..N-1, internal nodes are N..2N-2 in level order
    (device root 2N-2), plus one dummy row 2N-1 with blen 0.  d2h/h2d
    translate to the host PhyloTree numbering."""

    children: torch.Tensor  # [2N, 2] long; dummy row = (dummy, dummy)
    parent: torch.Tensor  # [2N] long; parent[root] = parent[dummy] = dummy
    blen: torch.Tensor  # [2N] float, blen[dummy] = 0
    d2h: torch.Tensor  # [2N-1] device -> host node id
    h2d: torch.Tensor  # [2N-1] host -> device node id
    levels: List[torch.Tensor]  # internal ids per level, bottom-up

    @property
    def n_nodes(self) -> int:
        return self.children.shape[0] - 1

    @property
    def n_taxa(self) -> int:
        return (self.n_nodes + 1) // 2

    @property
    def dummy(self) -> int:
        return self.n_nodes

    @property
    def root(self) -> int:
        return self.n_nodes - 1

    @classmethod
    def from_arrays(cls, children, parent, blen, d2h, h2d, device,
                    dtype=torch.float64) -> "TreeArrays":
        """From device-numbered numpy arrays (the layout both packages use)."""
        children = np.asarray(children, dtype=np.int64)
        n_taxa = children.shape[0] // 2
        as_long = lambda a: torch.tensor(np.asarray(a, dtype=np.int64),
                                         device=device)
        return cls(
            children=as_long(children),
            parent=as_long(parent),
            blen=torch.tensor(np.asarray(blen, dtype=np.float64),
                              dtype=dtype, device=device),
            d2h=as_long(d2h),
            h2d=as_long(h2d),
            levels=[as_long(ids) for ids in node_levels(children, n_taxa)],
        )

    @classmethod
    def from_tree(cls, tree, device, dtype=torch.float64) -> "TreeArrays":
        n = tree.n_nodes
        dummy = n
        d2h, h2d, _ = tree.device_numbering()
        children = np.full((n + 1, 2), dummy, dtype=np.int64)
        parent = np.full(n + 1, dummy, dtype=np.int64)
        blen = np.zeros(n + 1, dtype=np.float64)
        blen[:n] = tree.blen[d2h]
        hp = tree.parent[d2h]  # host parents in device order
        has_p = hp >= 0
        parent[:n][has_p] = h2d[hp[has_p]]
        internal = d2h >= tree.n_taxa
        children[:n][internal] = h2d[tree.children[d2h[internal]]]
        return cls.from_arrays(children, parent, blen, d2h, h2d, device, dtype)

    def with_blen(self, blen: torch.Tensor) -> "TreeArrays":
        return replace(self, blen=blen)

    def host_blen(self) -> np.ndarray:
        """Branch lengths mapped back to the host PhyloTree numbering."""
        dev = self.blen.detach().double().cpu().numpy()[:-1]
        out = np.empty_like(dev)
        out[self.d2h.cpu().numpy()] = dev
        return out


@dataclass
class ModelArrays:
    """Device view of (substitution model x rate heterogeneity).  The
    eigen-data carries a leading category axis C with C identical copies,
    so one engine serves +G, +I and plain models alike."""

    eigenvalues: torch.Tensor  # [C, S]
    eigvec: torch.Tensor  # [C, S, S]
    inv_eigvec: torch.Tensor  # [C, S, S]
    state_freq: torch.Tensor  # [C, S]
    rates: torch.Tensor  # [C]
    props: torch.Tensor  # [C]
    p_invar: torch.Tensor  # scalar

    @property
    def num_states(self) -> int:
        return self.eigenvalues.shape[-1]

    @property
    def ncat(self) -> int:
        return self.rates.shape[0]

    @property
    def mean_freq(self) -> torch.Tensor:
        """[S] class-weighted stationary frequencies."""
        w = self.props / torch.clamp(self.props.sum(), min=1e-12)
        return torch.einsum("c,cs->s", w, self.state_freq)

    @classmethod
    def from_model(cls, subst, rate, device, dtype=torch.float64) -> "ModelArrays":
        from ..models.mixture import MixtureModel

        if isinstance(subst, MixtureModel):
            return cls.from_mixture(subst, rate, device, dtype)
        lam, v, vinv = subst.eigen()
        r, w = rate.category_rates()
        C, S = r.shape[0], lam.shape[0]
        t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                   dtype=dtype, device=device)
        return cls(
            eigenvalues=t(lam).expand(C, S),
            eigvec=t(v).expand(C, S, S),
            inv_eigvec=t(vinv).expand(C, S, S),
            state_freq=t(subst.state_freq).expand(C, S),
            rates=t(r),
            props=t(w),
            p_invar=t(rate.p_invar),
        )


    @classmethod
    def from_mixture(cls, mix, rate, device, dtype=torch.float64) -> "ModelArrays":
        """The fused (mixture x rate) category axis.  With
        mix.fused_with_rate (LG4M-style `*G4`) class m pairs with rate class
        m (C = M); otherwise C = M x R, mixture class first (m-major), each
        category carrying its class's eigensystem and frequencies, rates
        r (x) comp_rate and proportions w (x) w_r."""
        lam_m, v_m, vinv_m, freq_m = mix.eigen_all()  # [M,S], [M,S,S], ...
        r, w = rate.category_rates()
        M, R = lam_m.shape[0], r.shape[0]
        comp_rate = np.asarray(mix.comp_rates, dtype=np.float64)
        if mix.fused_with_rate:
            if M != R:
                raise ValueError(f"fused mixture has {M} classes but rate model has {R}")
            # the mixture weights scaled by the total non-invariant mass
            rates = np.asarray(r) * comp_rate
            props = np.asarray(mix.weights) * np.asarray(w).sum()
            eigenvalues, eigvec, inv_eigvec, state_freq = lam_m, v_m, vinv_m, freq_m
        else:
            rates = (np.asarray(r)[None, :] * comp_rate[:, None]).reshape(-1)
            props = (np.asarray(mix.weights)[:, None] * np.asarray(w)[None, :]).reshape(-1)
            eigenvalues, eigvec, inv_eigvec, state_freq = (
                np.repeat(a, R, axis=0) for a in (lam_m, v_m, vinv_m, freq_m))
        t = lambda a: torch.tensor(np.asarray(a, dtype=np.float64), dtype=dtype,
                                   device=device)
        return cls(eigenvalues=t(eigenvalues), eigvec=t(eigvec), inv_eigvec=t(inv_eigvec),
                   state_freq=t(state_freq), rates=t(rates), props=t(props),
                   p_invar=t(rate.p_invar))


@dataclass
class SiteData:
    """Device view of the pattern-compressed alignment.

    Ascertainment-bias correction (+ASC, Lewis 2001): the S unobservable
    constant patterns are appended with zero pattern_freq and asc_mask=1;
    every reduction then conditions on variability via
    lnl_p := lnl_p - log(1 - sum_asc exp(lnl))."""

    tip_codes: torch.Tensor  # [N_taxa, P] long
    code_masks: torch.Tensor  # [n_codes, S]
    pattern_freq: torch.Tensor  # [P]
    const_state: torch.Tensor  # [P] long: -1 | state | S (all-unknown)
    asc_mask: torch.Tensor  # [P] 1.0 on appended unobserved-constant patterns
    # tip_partials' result, built at first use: the tips never change
    # during a fit or a search, and the gather costs as much as a kernel
    _tips: Optional[torch.Tensor] = field(default=None, init=False, repr=False,
                                          compare=False)

    @classmethod
    def from_arrays(cls, tip_codes, code_masks, pattern_freq, const_state,
                    asc_mask, device, dtype) -> "SiteData":
        f = lambda a: torch.tensor(np.asarray(a, dtype=np.float64),
                                   dtype=dtype, device=device)
        i = lambda a: torch.tensor(np.asarray(a, dtype=np.int64), device=device)
        return cls(i(tip_codes), f(code_masks), f(pattern_freq),
                   i(const_state), f(asc_mask))

    @classmethod
    def from_alignment(cls, aln, device, dtype, asc: bool = False) -> "SiteData":
        tip_codes = np.asarray(aln.patterns)
        pattern_freq = np.asarray(aln.pattern_freq, dtype=np.float64)
        const_state = np.asarray(aln.const_state)
        asc_mask = np.zeros(tip_codes.shape[1])
        if asc:
            S, N = aln.num_states, tip_codes.shape[0]
            tip_codes = np.concatenate(
                [tip_codes, np.tile(np.arange(S), (N, 1))], axis=1)
            pattern_freq = np.concatenate([pattern_freq, np.zeros(S)])
            const_state = np.concatenate([const_state, np.arange(S)])
            asc_mask = np.concatenate([asc_mask, np.ones(S)])
        return cls.from_arrays(tip_codes, aln.states.code_masks, pattern_freq,
                               const_state, asc_mask, device, dtype)


def branch_transition_mats(model: ModelArrays, blen: torch.Tensor) -> torch.Tensor:
    """P(blen[v] * rate[c]) for every node and category: [2N, C, S, S]."""
    t = blen[:, None] * model.rates[None, :]
    return transition_matrices(model.eigenvalues, model.eigvec,
                               model.inv_eigvec, t)


def tip_partials(site: SiteData) -> torch.Tensor:
    """[N_taxa, S, P] state-indicator partials from integer codes
    (contiguous; gathered once per SiteData)."""
    if site._tips is None:
        site._tips = site.code_masks[site.tip_codes].transpose(1, 2).contiguous()
    return site._tips


def ptn_invar(model: ModelArrays, site: SiteData) -> torch.Tensor:
    """[P] invariant-class likelihood: p_inv * (pi[const] for a constant
    pattern, 1 for an all-unknown one, 0 otherwise)."""
    S = model.num_states
    mean_freq = model.mean_freq
    pi_ext = torch.cat([mean_freq, torch.ones_like(mean_freq[:1])])
    const = site.const_state
    w = torch.where(const >= 0, pi_ext[torch.clamp(const, 0, S)],
                    torch.zeros((), dtype=pi_ext.dtype, device=pi_ext.device))
    return model.p_invar * w


def upward_pass(levels, children, trans, tips):
    """Level-batched post-order: (partials U [2N, C, S, P], log-scales
    [2N, P]).  Tip rows hold the C-tiled tip partials with scale 0;
    U[v] is the scaled conditional likelihood of the subtree below v."""
    n_rows, C = trans.shape[0], trans.shape[1]
    N, S, P = tips.shape
    up = tips.new_zeros(n_rows, C, S, P)
    up[:N] = tips[:, None]
    usc = tips.new_zeros(n_rows, P)
    for ids in levels:
        l, r = children[ids, 0], children[ids, 1]
        y = (trans[l] @ up[l]) * (trans[r] @ up[r])
        mx = torch.clamp(y.amax(dim=(1, 2)), min=SCALE_TINY)
        # in place: the gathers above save only their indices for autograd
        up.index_copy_(0, ids, y / mx[:, None, None, :])
        usc.index_copy_(0, ids, usc[l] + usc[r] + torch.log(mx))
    return up, usc


def downward_pass(levels, children, trans, up, usc, root_seed):
    """Reverse level sweep: (outside partials O [2N, C, S, P], log-scales
    [2N, P]).  O[v] is the outside partial at the PARENT end of the edge
    above v, renormalized per pattern; the root row stays zero.
    root_seed [C, S] is the outside vector at the root (the state
    frequencies, with the class weights folded in where a caller wants
    them)."""
    C, S, P = up.shape[1], up.shape[2], up.shape[3]
    root = levels[-1]
    d = torch.zeros_like(up)
    d[root] = root_seed[:, :, None].expand(C, S, P).to(up.dtype)
    dsc = torch.zeros_like(usc)
    out = torch.zeros_like(up)
    osc = torch.zeros_like(usc)
    for ids in reversed(levels):
        l, r = children[ids, 0], children[ids, 1]
        ml, mr = trans[l] @ up[l], trans[r] @ up[r]
        for c, m_sib, s_sib in ((l, mr, usc[r]), (r, ml, usc[l])):
            y = d[ids] * m_sib
            mx = torch.clamp(y.amax(dim=(1, 2)), min=SCALE_TINY)
            o = y / mx[:, None, None, :]
            s = dsc[ids] + s_sib + torch.log(mx)
            out[c] = o
            osc[c] = s
            d[c] = trans[c].transpose(-1, -2) @ o
            dsc[c] = s
    return out, osc


def asc_correction(site: SiteData, site_lnl: torch.Tensor) -> torch.Tensor:
    """log(1 - q), q = summed (uncorrected) likelihood of the unobserved
    constant patterns; identically 0 without +ASC."""
    q = torch.sum(site.asc_mask * torch.exp(torch.clamp(site_lnl, max=0.0)))
    return torch.log1p(-torch.clamp(q, max=1.0 - 1e-10))


def finish_site_lnl(site: SiteData, site_lnl: torch.Tensor):
    """(f64 total, per-pattern lnl) from raw per-pattern lnl: the +ASC
    shift, then the pattern-weighted total accumulated in float64 (at
    |lnL| ~ 1e6 the float32 resolution is coarser than every convergence
    tolerance)."""
    site_lnl = site_lnl - asc_correction(site, site_lnl)
    total = torch.sum(site.pattern_freq.double() * site_lnl.double())
    return total, site_lnl


def root_loglik(model: ModelArrays, site: SiteData, root_partial: torch.Tensor,
                root_scale: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(f64 total lnL, per-pattern lnl [P]) from the root partial [C, S, P].
    The invariable-site class is added in log space."""
    dt = root_partial.dtype
    mix = torch.einsum("c,cs,csp->p", model.props.to(dt),
                       model.state_freq.to(dt), root_partial)
    lnl = root_scale + torch.log(torch.clamp(mix, min=SCALE_TINY))
    inv = ptn_invar(model, site).to(dt)
    lnl = torch.where(
        inv > 0, torch.logaddexp(lnl, torch.log(torch.clamp(inv, min=SCALE_TINY))),
        lnl)
    return finish_site_lnl(site, lnl)


def compute_loglik(tree: TreeArrays, model: ModelArrays,
                   site: SiteData) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tree log-likelihood through the plain level-batched pass.
    Returns (lnL, pattern_lnl); differentiable by plain autograd."""
    dt = site.code_masks.dtype
    trans = branch_transition_mats(model, tree.blen).to(dt)
    up, usc = upward_pass(tree.levels, tree.children, trans, tip_partials(site))
    return root_loglik(model, site, up[tree.root], usc[tree.root])
