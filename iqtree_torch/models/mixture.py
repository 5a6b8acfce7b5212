"""Mixture substitution models.

A mixture is M fixed (matrix, frequency) components with weights and
per-component rate multipliers.  The engine fuses the mixture axis with
the rate-heterogeneity axis into ONE category axis C
(engine/likelihood.py ModelArrays.from_mixture), so mixtures run through
the same kernels as rate categories: C = M x R categories, listed mixture
class first, each with its own eigensystem and frequencies.

Supported forms (built-in definitions in models/data/builtin_mixmodels.nex):
  MIX{m1:rate1:w1,m2,...}      matrix mixtures (EX2, EHO, EX_EHO, ...)
  BASE+FMIX{f1:r:w,...}        frequency mixtures over one matrix
                               (CF4, CAT C10..C60; `empirical` = counted)
  MIX{...}*G4                  rate-fused mixtures (LG4M: class m pairs
                               with Gamma rate class m)
  MIX{...}*R4                  fused with FreeRate (LG4X: the FreeRate
                               weights are the class weights in the fit)
Weights given in the definition are fixed (unless -mwopt); omitted weights
start equal and are ML-optimized (softmax logits in models/optimize.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .subst import FREQ_USER, ReversibleModel

# the -mwopt switch (set by the CLI before models are built): mixture
# weights are free parameters even where the model string pins them
FORCE_OPT_WEIGHTS = False


@dataclass
class MixtureModel:
    name: str
    components: List[ReversibleModel]  # each with a fixed matrix and frequencies
    weights: np.ndarray  # [M]
    comp_rates: np.ndarray  # [M] per-component rate multipliers
    fix_weights: bool = False
    fused_with_rate: bool = False  # LG4M-style `*G4`
    # the classes as the model string names them (MIX{...} components, or
    # +FMIX{...} frequency vectors over `base`): model_string's
    class_tokens: Optional[List[str]] = None
    base: Optional[str] = None  # a frequency mixture's matrix
    asc: bool = False  # +ASC: Lewis's ascertainment-bias correction

    @property
    def n_mix(self) -> int:
        return len(self.components)

    @property
    def num_states(self) -> int:
        return self.components[0].num_states

    @property
    def state_freq(self) -> np.ndarray:
        """The weight-averaged frequencies (the report's)."""
        f = np.stack([c.state_freq for c in self.components])
        return (self.weights[:, None] * f).sum(0) / self.weights.sum()

    def eigen_all(self) -> Tuple[np.ndarray, ...]:
        """The components' eigensystems stacked: (lam [M,S], V [M,S,S],
        V^-1 [M,S,S], freq [M,S])."""
        eig = [c.eigen() for c in self.components]
        return (np.stack([e[0] for e in eig]), np.stack([e[1] for e in eig]),
                np.stack([e[2] for e in eig]),
                np.stack([np.asarray(c.state_freq) for c in self.components]))

    def model_string(self, rate_suffix: str, fused_rate: str = "G") -> str:
        """The mixture as a model string with its rates and weights pinned,
        which parse_model_string reads back: MIX{a:r:w,...}[*G4 | *R4] (the
        fused rate model `fused_rate`) or BASE+FMIX{f:r:w,...}, then
        `rate_suffix` (+I{..}+G4{..}, +R4{..})."""
        toks = self.class_tokens or [c.name for c in self.components]
        body = ",".join(f"{t}:{r:.10g}:{w:.10g}"
                        for t, r, w in zip(toks, self.comp_rates, self.weights))
        if self.base is not None:
            return f"{self.base}+FMIX{{{body}}}{rate_suffix}"
        star = f"*{fused_rate}{self.n_mix}" if self.fused_with_rate else ""
        return f"MIX{{{body}}}{star}{rate_suffix}"


def category_count(subst, rate) -> int:
    """The engine's categories C: the rate categories, times the classes of
    a mixture that is not fused with its rates."""
    if isinstance(subst, MixtureModel) and not subst.fused_with_rate:
        return subst.n_mix * rate.ncat
    return rate.ncat


def _parse_component_list(body: str) -> List[Tuple[str, float, Optional[float]]]:
    """'A:1.2:0.3,B,C:2' -> [(name, rate, weight | None), ...]: IQ-TREE's
    NAME:RATE:WEIGHT component syntax."""
    out = []
    for tok in body.split(","):
        parts = tok.split(":")
        rate = float(parts[1]) if len(parts) > 1 and parts[1] else 1.0
        weight = float(parts[2]) if len(parts) > 2 and parts[2] else None
        out.append((parts[0], rate, weight))
    return out


def build_mixture(base_token: str, fmix_body: Optional[str], aln,
                  defs: Dict[str, object], resolve_base):
    """(MixtureModel, the fused rate token after `*` or None) from a
    `MIX{...}[*G4]` base token, or from a plain base with a `+FMIX{...}`
    suffix body.  `resolve_base(name)` gives a plain component's
    ReversibleModel (an empirical matrix, or a matrix of `defs`, the parsed
    built-in definitions)."""
    from ..io.modelsblock import FreqDef

    tok, star = base_token, None
    if "*" in tok:
        tok, star = tok.split("*", 1)
    comps: List[ReversibleModel] = []
    rates, weights, tokens = [], [], []
    if fmix_body is not None:  # a frequency mixture: one matrix, a frequency a class
        base = resolve_base(tok)
        for name, rate, weight in _parse_component_list(fmix_body):
            tokens.append(name)
            if name.lower() == "empirical":
                freq = aln.state_frequencies()
            else:
                d = defs.get(name.upper())
                if not isinstance(d, FreqDef):
                    raise ValueError(f"unknown frequency vector {name!r}")
                freq = d.freqs
            comps.append(ReversibleModel(
                name=f"{base.name}+{name}", num_states=base.num_states,
                rate_groups=base.rate_groups, group_rates=base.group_rates,
                exchange=base.exchange, freq_type=FREQ_USER,
                state_freq=np.asarray(freq, float), fixed_rates=True))
            rates.append(rate)
            weights.append(weight)
        mixname = f"{base.name}+FMIX"
    else:
        if not (tok.upper().startswith("MIX{") and tok.endswith("}")):
            raise ValueError(f"not a mixture token: {base_token!r}")
        for name, rate, weight in _parse_component_list(tok[4:-1]):
            tokens.append(name)
            comps.append(resolve_base(name))
            rates.append(rate)
            weights.append(weight)
        mixname = "MIX"
    M = len(comps)
    given = [w for w in weights if w is not None]
    if given and len(given) != M:
        raise ValueError("mixture weights must be given for all or none")
    if given:
        w = np.asarray(given, float)
        w = w / w.sum()
        fix_weights = not FORCE_OPT_WEIGHTS  # -mwopt frees given weights too
    else:
        w = np.full(M, 1.0 / M)
        fix_weights = False
    return MixtureModel(name=mixname, components=comps, weights=w,
                        comp_rates=np.asarray(rates, float), fix_weights=fix_weights,
                        fused_with_rate=star is not None, class_tokens=tokens,
                        base=tok if fmix_body is not None else None), star
