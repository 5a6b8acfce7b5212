"""Among-site rate heterogeneity (+G, +GM, +I, +I+G, +R, +R+I, +K): the
category (rate, proportion) arrays the engine consumes.

Conventions:
  * site likelihood = sum_c prop[c] * L_c(ptn) + ptn_invar[ptn]
  * +G:    rates = discrete-gamma quadrature, prop = 1/K each (+GM: median
           quadrature)
  * +I:    one category, rate 1, prop = (1 - p_inv)
  * +I+G:  rates = gamma rates / (1 - p_inv), prop = (1 - p_inv)/K
  * +R k:  free (rate, weight) pairs with sum w = 1 and sum w*r = 1
  * +R+I:  free rates with invariable class; weights scaled by (1 - p_inv)
           and rates renormalized so that sum w*r = 1 over all sites
  * +K k:  free rates with mean 1 and weight 1.0 each (the reference's
           RateKategory), so the lnL carries +n_sites * log K against a
           1/K-weighted mix
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from ..utils.gamma import discrete_gamma_rates

MIN_GAMMA_SHAPE = 0.02
MAX_GAMMA_SHAPE = 100.0


@dataclass
class RateModel:
    kind: str = ""  # "" (uniform) | "G" | "I" | "I+G" | "R" | "R+I" | "K"
    ncat: int = 1
    alpha: float = 1.0  # gamma shape
    p_invar: float = 0.0
    gamma_median: bool = False
    # the FreeRate (+R) and +K parameters
    free_rates: Optional[np.ndarray] = None  # [K]
    free_props: Optional[np.ndarray] = None  # [K]
    fix_alpha: bool = False
    fix_p_invar: bool = False

    @property
    def has_gamma(self) -> bool:
        return "G" in self.kind

    @property
    def has_invar(self) -> bool:
        return "I" in self.kind

    @property
    def is_free_rate(self) -> bool:
        return "R" in self.kind

    @property
    def is_kategory(self) -> bool:
        """+K: free rates with equal weights and mean pinned to 1."""
        return "K" in self.kind

    @property
    def df(self) -> int:
        """Free parameters of the rate model."""
        n = 0
        if self.has_gamma and not self.fix_alpha:
            n += 1
        if self.has_invar and not self.fix_p_invar:
            n += 1
        if self.is_free_rate:
            n += 2 * self.ncat - 2
        if self.is_kategory:
            n += self.ncat - 1
        return n

    def name_suffix(self) -> str:
        s = ""
        if self.has_invar:
            s += "+I"
        if self.has_gamma:
            s += f"+G{self.ncat}"
        if self.is_free_rate:
            s += f"+R{self.ncat}"
        if self.is_kategory:
            s += f"+K{self.ncat}"
        return s

    def category_rates(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rates [C], props [C]); props sum to 1 - p_invar (+K: to K)."""
        if self.is_kategory:
            r = np.asarray(self.free_rates, dtype=np.float64)
            return r / r.mean(), np.ones(self.ncat)
        if self.is_free_rate:
            r = np.asarray(self.free_rates, dtype=np.float64)
            w = np.asarray(self.free_props, dtype=np.float64)
            w = w / w.sum() * (1.0 - self.p_invar)
            return r / (r * w).sum(), w
        if self.has_gamma:
            rates = discrete_gamma_rates(self.alpha, self.ncat, self.p_invar,
                                         self.gamma_median)
            return rates, np.full(self.ncat, (1.0 - self.p_invar) / self.ncat)
        return np.array([1.0]), np.array([1.0 - self.p_invar])

    @classmethod
    def make(cls, gamma_cats: int = 0, invar: bool = False, free_cats: int = 0,
             alpha: float = 1.0, p_invar: float = 0.0, gamma_median: bool = False,
             fix_alpha: bool = False, fix_p_invar: bool = False,
             kat_cats: int = 0) -> "RateModel":
        if kat_cats:
            # +K and +R start from the mean Gamma(1) ladder, equal weights
            k = kat_cats
            return cls(kind="K", ncat=k,
                       free_rates=discrete_gamma_rates(1.0, k) if k > 1 else np.ones(1),
                       free_props=np.full(k, 1.0 / k))
        if free_cats:
            k = free_cats
            return cls(kind="R+I" if invar else "R", ncat=k, p_invar=p_invar,
                       alpha=alpha, free_rates=discrete_gamma_rates(1.0, k),
                       free_props=np.full(k, 1.0 / k), fix_alpha=fix_alpha,
                       fix_p_invar=fix_p_invar)
        kind = ("I+" if invar else "") + ("G" if gamma_cats else "")
        return cls(kind=kind.rstrip("+"), ncat=gamma_cats or 1, alpha=alpha,
                   p_invar=p_invar, gamma_median=gamma_median and bool(gamma_cats),
                   fix_alpha=fix_alpha, fix_p_invar=fix_p_invar)
