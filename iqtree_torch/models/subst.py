"""Reversible substitution models (host-side parameter containers).

A reversible model is defined by:
  * either `rate_groups`: for each unordered state pair (i<j, row-major
    order: (0,1),(0,2)... so DNA order is AC,AG,AT,CG,CT,GT), an integer
    group id.  All pairs in a group share one exchangeability; group 0 is
    pinned to 1.0 (IQ-TREE's rate-code strings like "010010" for HKY);
  * or a fixed `exchange` matrix [S, S] (the empirical protein models, and
    the banded matrix of the ORDERED morphology model);
  * state frequencies with a frequency policy (equal/empirical/estimated/
    user).

The device engine consumes them through `ModelArrays` (engine/likelihood.py),
rebuilt by differentiable torch code in models/eigen.py during the fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

FREQ_EQUAL = "equal"
FREQ_EMPIRICAL = "empirical"  # +F counted from data
FREQ_ESTIMATE = "estimate"  # +FO ML-optimized
FREQ_USER = "user"  # +F{...} / +FU


def pair_index(num_states: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(num_states) for j in range(i + 1, num_states)]


@dataclass
class ReversibleModel:
    name: str
    num_states: int
    rate_groups: Optional[np.ndarray] = None  # [n_pairs] int
    group_rates: Optional[np.ndarray] = None  # [n_groups] float, [0]==1.0
    exchange: Optional[np.ndarray] = None  # [S, S] symmetric, fixed
    freq_type: str = FREQ_EQUAL
    state_freq: Optional[np.ndarray] = None  # [S]
    fixed_rates: bool = False  # rates pinned (model string or empirical matrix)
    asc: bool = False  # +ASC: Lewis's ascertainment-bias correction

    def __post_init__(self):
        S = self.num_states
        if self.state_freq is None:
            self.state_freq = np.full(S, 1.0 / S)
        if self.rate_groups is not None:
            self.rate_groups = np.asarray(self.rate_groups, dtype=np.int32)
            if self.group_rates is None:
                self.group_rates = np.ones(int(self.rate_groups.max()) + 1)

    @property
    def n_rate_params(self) -> int:
        if self.fixed_rates or self.rate_groups is None:
            return 0
        return int(self.rate_groups.max())

    def set_rate_param_vector(self, v: np.ndarray) -> None:
        self.group_rates = np.concatenate([[1.0], np.asarray(v, dtype=np.float64)])

    def sym_rates(self) -> np.ndarray:
        """The symmetric exchangeability matrix R [S, S] (diagonal 0)."""
        S = self.num_states
        if self.exchange is not None:
            r = np.array(self.exchange, dtype=np.float64)
            np.fill_diagonal(r, 0.0)
            return r
        r = np.zeros((S, S))
        for (i, j), g in zip(pair_index(S), self.rate_groups):
            r[i, j] = r[j, i] = self.group_rates[g]
        return r

    def rate_matrix(self) -> np.ndarray:
        """Normalized Q (mean rate 1) as float64 NumPy."""
        r = self.sym_rates()
        pi = self.state_freq
        q = r * pi[None, :]
        np.fill_diagonal(q, 0.0)
        np.fill_diagonal(q, -q.sum(axis=1))
        return q / -np.sum(pi * np.diag(q))

    def eigen(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(eigenvalues, V, V^-1) of normalized Q via symmetrization
        (float64, NumPy)."""
        q = self.rate_matrix()
        sq = np.sqrt(self.state_freq)
        b = q * (sq[:, None] / sq[None, :])
        lam, u = np.linalg.eigh(0.5 * (b + b.T))
        return lam, u / sq[:, None], u.T * sq[None, :]
