"""Among-site rate heterogeneity (+G, +I, +I+G): the category (rate,
proportion) arrays the engine consumes.

Conventions:
  * site likelihood = sum_c prop[c] * L_c(ptn) + ptn_invar[ptn]
  * +G:    rates = discrete-gamma quadrature, prop = 1/K each
  * +I:    one category, rate 1, prop = (1 - p_inv)
  * +I+G:  rates = gamma rates / (1 - p_inv), prop = (1 - p_inv)/K

FreeRate (+R) and +K come with the FreeRate slice of the port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from ..utils.gamma import discrete_gamma_rates

MIN_GAMMA_SHAPE = 0.02
MAX_GAMMA_SHAPE = 100.0


@dataclass
class RateModel:
    kind: str = ""  # "" (uniform) | "G" | "I" | "I+G"
    ncat: int = 1
    alpha: float = 1.0  # gamma shape
    p_invar: float = 0.0
    fix_alpha: bool = False
    fix_p_invar: bool = False

    @property
    def has_gamma(self) -> bool:
        return "G" in self.kind

    @property
    def has_invar(self) -> bool:
        return "I" in self.kind

    def category_rates(self) -> Tuple[np.ndarray, np.ndarray]:
        """(rates [C], props [C]); props sum to 1 - p_invar."""
        if self.has_gamma:
            rates = discrete_gamma_rates(self.alpha, self.ncat, self.p_invar)
            return rates, np.full(self.ncat, (1.0 - self.p_invar) / self.ncat)
        return np.array([1.0]), np.array([1.0 - self.p_invar])

    @classmethod
    def make(cls, gamma_cats: int = 0, invar: bool = False, alpha: float = 1.0,
             p_invar: float = 0.0, fix_alpha: bool = False,
             fix_p_invar: bool = False) -> "RateModel":
        kind = ("I+" if invar else "") + ("G" if gamma_cats else "")
        return cls(kind=kind.rstrip("+"), ncat=gamma_cats or 1, alpha=alpha,
                   p_invar=p_invar, fix_alpha=fix_alpha,
                   fix_p_invar=fix_p_invar)
