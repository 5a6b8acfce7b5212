"""Model-parameter packing and the joint model + branch-length fit.

All free model parameters are mapped to one unconstrained dict of float64
tensors and optimized by L-BFGS with exact gradients (through the
sweep-based likelihood gradient, the degenerate-safe eigendecomposition
and the differentiable Gamma quadrature); branch lengths move by the
batched Newton sweeps in between.

Unconstrained parameterization:
  mixture weights    w = softmax(x) (a mixture's free class weights)
  exchangeabilities  r_g = exp(x)
  codon kappa, omega kappa = exp(x), omega = exp(y)
  frequencies        pi = softmax(x) floored at MIN_FREQ (+FO only)
  gamma shape        alpha = MIN + (MAX-MIN) * sigmoid(x)
  p_invar            p = sigmoid(x) * max_pinv
  free rates (+R)    r = exp(x), w = softmax(y) * (1 - p), renormalized so
                     that sum w r = 1
  +K rates           r = K * softmax([0, x]) (sum r = K), weight 1.0 each

The optimizer's +GM rates are the mean quadrature, as the JAX package's
optimizer builds them; RateModel.category_rates (the evaluation after the
fit) gives the median one.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from ..engine.derivatives import optimize_all_branches
from ..engine.grad import loglik
from ..engine.likelihood import ModelArrays, SiteData, TreeArrays
from ..utils.gamma_torch import discrete_gamma_rates
from ..utils.lbfgs import lbfgs_minimize, zero_lbfgs_state
from .codon import CodonModel
from .eigen import eigen_reversible
from .mixture import MixtureModel
from .rates import MAX_GAMMA_SHAPE, MIN_GAMMA_SHAPE, RateModel
from .subst import FREQ_ESTIMATE, ReversibleModel, pair_index

MIN_FREQ = 1e-4
# One model chunk (L-BFGS iterations) alternates with one branch chunk
# (Newton sweeps); the L-BFGS curvature is carried across model chunks.
M_CHUNK = 15
B_CHUNK = 25


@dataclass
class ModelOptimizer:
    """Builds ModelArrays from an unconstrained parameter dict on `device`."""

    subst: ReversibleModel
    rate: RateModel
    device: torch.device

    def __post_init__(self):
        s, r = self.subst, self.rate
        self.opt_alpha = r.has_gamma and not r.fix_alpha
        self.opt_pinv = r.has_invar and not r.fix_p_invar
        self.opt_free = r.is_free_rate
        self.opt_kat = r.is_kategory
        self.max_pinv = 0.999
        self.is_mixture = isinstance(s, MixtureModel)
        if self.is_mixture:
            # fixed component matrices and frequencies: eigendecomposed once;
            # the weights (unless pinned) and the rate model are free
            self.opt_freq = self.opt_rates = self.is_codon = False
            self.opt_kappa = self.opt_omega = False
            self.opt_weights = not s.fix_weights and s.n_mix > 1
            eig = s.eigen_all()
            if s.fused_with_rate:
                if s.n_mix != r.ncat:
                    raise ValueError(f"fused mixture has {s.n_mix} classes, rate model "
                                     f"{r.ncat}")
            else:
                eig = tuple(np.repeat(a, r.ncat, axis=0) for a in eig)
            self._mix_eigen = tuple(self._t(a) for a in eig)
            return
        self.opt_weights = False
        self.opt_freq = s.freq_type == FREQ_ESTIMATE
        self.opt_rates = s.n_rate_params > 0
        self.is_codon = isinstance(s, CodonModel)
        self.opt_kappa = self.is_codon and not s.fix_kappa
        self.opt_omega = self.is_codon and not s.fix_omega
        if self.is_codon:
            # the fixed single-step structure; MG's factors are fixed by
            # the frequencies, which the fit does not move (+F3X4/+F1X4)
            self._ts = self._t(s.ts)
            self._nonsyn = self._t(s.nonsyn)
            fac = s.mg_factor() if s.mg and s.nt_freq is not None else 1.0
            self._base = self._t(np.where(s.step, 1.0, 0.0) * fac)
        if s.rate_groups is not None:
            pairs = torch.tensor(pair_index(s.num_states), device=self.device)
            self._pairs = (pairs[:, 0], pairs[:, 1])
            self._groups = torch.tensor(s.rate_groups, dtype=torch.long,
                                        device=self.device)

    def _t(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, dtype=np.float64), device=self.device)

    def init_params(self) -> Dict[str, torch.Tensor]:
        p: Dict[str, torch.Tensor] = {}
        if self.opt_weights:
            p["mix_logits"] = self._t(np.log(np.maximum(self.subst.weights, 1e-6)))
        if self.opt_kappa:
            p["log_kappa"] = self._t(np.log(self.subst.kappa))
        if self.opt_omega:
            p["log_omega"] = self._t(np.log(self.subst.omega))
        if self.opt_rates:
            p["log_rates"] = self._t(np.log(np.maximum(self.subst.group_rates[1:], 1e-4)))
        if self.opt_freq:
            p["freq_logits"] = self._t(np.log(np.maximum(self.subst.state_freq, MIN_FREQ)))
        if self.opt_alpha:
            # soft bounds keep a live gradient at the rails
            a0 = np.clip((self.rate.alpha - MIN_GAMMA_SHAPE)
                         / (MAX_GAMMA_SHAPE - MIN_GAMMA_SHAPE), 1e-6, 1 - 1e-6)
            p["alpha_logit"] = self._t(np.log(a0 / (1 - a0)))
        if self.opt_pinv:
            # start mid-range: a logit at the saturated rail never moves
            pv = self.rate.p_invar if self.rate.p_invar > 0 else 0.5 * self.max_pinv
            p0 = np.clip(pv / self.max_pinv, 1e-4, 1 - 1e-4)
            p["logit_pinv"] = self._t(np.log(p0 / (1 - p0)))
        if self.opt_free:
            p["log_free_rates"] = self._t(np.log(np.maximum(self.rate.free_rates, 1e-6)))
            p["free_logits"] = self._t(np.log(np.maximum(self.rate.free_props, 1e-6)))
        if self.opt_kat and self.rate.ncat > 1:
            # K - 1 logits against the first rate's: sum(rates) == K smoothly
            logit = np.log(np.maximum(np.asarray(self.rate.free_rates), 1e-6))
            p["kat_logits"] = self._t(logit[1:] - logit[0])
        return p

    def _freq(self, params) -> torch.Tensor:
        if not self.opt_freq:
            return self._t(self.subst.state_freq)
        f = torch.clamp(torch.softmax(params["freq_logits"], 0), min=MIN_FREQ)
        return f / f.sum()

    def _alpha(self, params) -> torch.Tensor:
        if not self.opt_alpha:
            return self._t(self.rate.alpha)
        return MIN_GAMMA_SHAPE + (MAX_GAMMA_SHAPE - MIN_GAMMA_SHAPE) * \
            torch.sigmoid(params["alpha_logit"])

    def _pinv(self, params) -> torch.Tensor:
        if not self.opt_pinv:
            return self._t(self.rate.p_invar)
        return torch.sigmoid(params["logit_pinv"]) * self.max_pinv

    def _exchange_matrix(self, params) -> torch.Tensor:
        """[S, S] symmetric exchangeabilities: fixed (an empirical matrix,
        or rates pinned in the model string), from the free rates, or a
        codon model's from kappa and omega over its fixed masks."""
        if self.is_codon:
            s = self.subst
            lk = params["log_kappa"] if self.opt_kappa else self._t(np.log(s.kappa))
            lo = params["log_omega"] if self.opt_omega else self._t(np.log(s.omega))
            return self._base * torch.exp(lk * self._ts + lo * self._nonsyn)
        if not self.opt_rates:
            return self._t(self.subst.sym_rates())
        S = self.subst.num_states
        group_rates = torch.cat([self._t([1.0]), torch.exp(params["log_rates"])])
        sym = torch.zeros(S, S, dtype=torch.float64, device=self.device)
        sym = sym.index_put(self._pairs, group_rates[self._groups])
        return sym + sym.T

    def _rate_part(self, params):
        """(rates [R], props [R], p_invar) of the rate model."""
        pinv = self._pinv(params)
        C = self.rate.ncat
        ones = torch.ones(C, dtype=torch.float64, device=self.device)
        if self.opt_free:
            r = torch.exp(params["log_free_rates"])
            w = torch.softmax(params["free_logits"], 0) * (1.0 - pinv)
            return r / torch.clamp((r * w).sum(), min=1e-8), w, pinv
        if self.opt_kat:
            # weight 1.0 a category (the reference's RateKategory)
            if C == 1:
                return ones, ones, pinv
            logits = torch.cat([self._t([0.0]), params["kat_logits"]])
            return torch.softmax(logits, 0) * C, ones, pinv
        if self.rate.has_gamma:
            rates = discrete_gamma_rates(self._alpha(params), C, pinv)
        else:
            rates = torch.ones(1, dtype=torch.float64, device=self.device)
        return rates, ones * (1.0 - pinv) / C, pinv

    def _build_mixture(self, params) -> ModelArrays:
        """The fused (mixture x rate) ModelArrays (likelihood.py
        from_mixture): the components' eigensystems fixed, the weights and
        the rate model's parameters free."""
        mix = self.subst
        lam, v, vinv, freq = self._mix_eigen
        rates_r, props_r, pinv = self._rate_part(params)
        w = (torch.softmax(params["mix_logits"], 0) if self.opt_weights
             else self._t(mix.weights))
        comp_rate = self._t(mix.comp_rates)
        if mix.fused_with_rate:
            # LG4X (*R): the FreeRate weights are the class weights
            rates = rates_r * comp_rate
            props = props_r if self.opt_free else w * props_r.sum()
        else:
            rates = (comp_rate[:, None] * rates_r[None, :]).reshape(-1)
            props = (w[:, None] * props_r[None, :]).reshape(-1)
        return ModelArrays(eigenvalues=lam, eigvec=v, inv_eigvec=vinv, state_freq=freq,
                           rates=rates, props=props, p_invar=pinv)

    def build(self, params: Dict[str, torch.Tensor]) -> ModelArrays:
        if self.is_mixture:
            return self._build_mixture(params)
        S = self.subst.num_states
        sym = self._exchange_matrix(params)
        freq = self._freq(params)
        lam, v, vinv = eigen_reversible(sym, freq)
        rates, props, pinv = self._rate_part(params)
        C = self.rate.ncat
        return ModelArrays(
            eigenvalues=lam.expand(C, S),
            eigvec=v.expand(C, S, S),
            inv_eigvec=vinv.expand(C, S, S),
            state_freq=freq.expand(C, S),
            rates=rates,
            props=props,
            p_invar=pinv,
        )

    def unpack(self, params: Dict[str, torch.Tensor]):
        """Write the fitted values back into the host model objects."""
        s, r = self.subst, self.rate
        with torch.no_grad():
            if self.opt_weights:
                w = torch.softmax(params["mix_logits"], 0).cpu().numpy()
                s.weights = w / w.sum()
            if self.opt_kappa:
                s.kappa = float(torch.exp(params["log_kappa"]))
            if self.opt_omega:
                s.omega = float(torch.exp(params["log_omega"]))
            if self.is_codon:
                s.refresh_exchange()
            if self.opt_rates:
                s.set_rate_param_vector(np.exp(params["log_rates"].cpu().numpy()))
            if self.opt_freq:
                s.state_freq = self._freq(params).cpu().numpy()
            if self.opt_alpha:
                r.alpha = float(self._alpha(params))
            if self.opt_pinv:
                r.p_invar = float(self._pinv(params))
            if self.opt_free:
                r.free_rates = torch.exp(params["log_free_rates"]).cpu().numpy()
                r.free_props = torch.softmax(params["free_logits"], 0).cpu().numpy()
            if self.opt_kat and r.ncat > 1:
                logits = torch.cat([self._t([0.0]), params["kat_logits"]])
                r.free_rates = (torch.softmax(logits, 0) * r.ncat).cpu().numpy()
        return s, r


def fit_model_step(
    opt: ModelOptimizer,
    tree: TreeArrays,
    site: SiteData,
    params: Dict[str, torch.Tensor],
    steps: torch.Tensor,
    n_slots: int,
    max_iters: int = 60,
    lbfgs_state=None,
):
    """One L-BFGS solve of all model parameters with branch lengths fixed.
    Value evaluations run the forward kernel; gradients the fused sweeps.
    Returns (params, lnL, lbfgs_state)."""
    def lnl(p):
        return loglik(tree, opt.build(p), site, steps, n_slots)[0]

    if not params:
        with torch.no_grad():
            return params, float(lnl(params)), lbfgs_state
    # scale the objective to O(1) per site: raw |lnL| grows with the
    # alignment, and gradients of that size break the unit trial step
    scale = float(site.pattern_freq.sum())
    # two consecutive sub-0.005-lnL steps mean convergence
    p, val, st = lbfgs_minimize(lambda x: -lnl(x) / scale, params,
                                max_iters=max_iters, init_state=lbfgs_state,
                                ftol=0.005 / scale, max_backtracks=8)
    return p, -val * scale, st


def optimize_model_and_branches(
    opt: ModelOptimizer,
    tree: TreeArrays,
    site: SiteData,
    steps: torch.Tensor,
    n_slots: int,
    params: Optional[Dict[str, torch.Tensor]] = None,
    rounds: int = 10,
    tol: float = 0.01,
    branch_sweeps: int = 100,
    model_iters: int = 60,
    log=None,
):
    """Alternate ONE model chunk and ONE branch chunk until a round gains
    less than `tol` lnL.  Fine-grained alternation lets branch lengths
    adapt between model updates: model L-BFGS run to convergence on far-off
    start branch lengths dives into a degenerate basin (alpha to the rail,
    tree length exploding).  Returns (tree, params, lnL)."""
    if params is None:
        params = opt.init_params()
    total_chunks = rounds * max(1, -(-model_iters // M_CHUNK),
                                -(-branch_sweeps // B_CHUNK))
    lnl_prev = -np.inf
    lnl = -np.inf
    lst = zero_lbfgs_state(params) if params else None
    for it in range(total_chunks):
        params, mlnl, lst = fit_model_step(opt, tree, site, params, steps,
                                           n_slots, M_CHUNK, lbfgs_state=lst)
        with torch.no_grad():
            tree, lnl = optimize_all_branches(tree, opt.build(params), site,
                                              steps, n_slots, n_sweeps=B_CHUNK)
        if log is not None:
            log(f"  round {it + 1}: model lnL {mlnl:.4f}, branches lnL {lnl:.4f}")
        if lnl - lnl_prev < tol and it > 0:
            break
        lnl_prev = lnl
    return tree, params, lnl
