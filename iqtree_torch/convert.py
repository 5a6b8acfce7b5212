"""Carry the JAX package's objects across to the port's tensors.

Every function takes plain numpy arrays (or objects whose fields are
array-likes, such as the JAX package's TreeArrays / ModelArrays /
SiteData named tuples after `np.asarray`), so this module imports
nothing of the JAX package and both sides can be fed the same numbers.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from .engine.likelihood import ModelArrays, SiteData, TreeArrays
from .models.codon import CodonModel
from .models.mixture import MixtureModel
from .models.subst import ReversibleModel
from .trees.tree import PhyloTree


def _np(x) -> np.ndarray:
    return np.asarray(x)


def phylo_tree(src) -> PhyloTree:
    """The port's host tree from an object with n_taxa, children [2N-1, 2],
    parent [2N-1] and blen [2N-1] (the host encoding both packages share)."""
    return PhyloTree(int(src.n_taxa), _np(src.parent).astype(np.int32).copy(),
                     _np(src.children).astype(np.int32).copy(),
                     _np(src.blen).astype(np.float64).copy())


def tree_arrays(src, device, dtype=torch.float64) -> TreeArrays:
    """From an object with children [2N,2], parent [2N], blen [2N], d2h,
    h2d fields in the device numbering both packages share."""
    return TreeArrays.from_arrays(_np(src.children), _np(src.parent),
                                  _np(src.blen), _np(src.d2h), _np(src.h2d),
                                  device, dtype)


def model_arrays(src, device, dtype=torch.float64) -> ModelArrays:
    """From an object with eigenvalues, eigvec, inv_eigvec, state_freq,
    rates, props and p_invar fields, at any state count (binary S=2, DNA
    S=4, protein S=20, morphology, codons; reversible models only)."""
    if getattr(src, "qmat", None) is not None:
        raise NotImplementedError("non-reversible models are not ported yet")
    t = lambda a: torch.tensor(_np(a).astype(np.float64), dtype=dtype,
                               device=device)
    return ModelArrays(t(src.eigenvalues), t(src.eigvec), t(src.inv_eigvec),
                       t(src.state_freq), t(src.rates), t(src.props),
                       t(src.p_invar))


def codon_model(src) -> CodonModel:
    """The port's CodonModel from an object with the fields of one (name,
    num_states, freq_type, state_freq, code_id, kappa, omega, mg, nt_freq,
    fix_kappa, fix_omega, asc): its exchangeabilities follow from them."""
    nt = getattr(src, "nt_freq", None)
    return CodonModel(str(src.name), int(src.num_states), freq_type=str(src.freq_type),
                      state_freq=_np(src.state_freq).astype(np.float64).copy(),
                      code_id=int(src.code_id), kappa=float(src.kappa),
                      omega=float(src.omega), mg=bool(src.mg),
                      nt_freq=None if nt is None else _np(nt).astype(np.float64).copy(),
                      fix_kappa=bool(src.fix_kappa), fix_omega=bool(src.fix_omega),
                      asc=bool(getattr(src, "asc", False)))


def reversible_model(src) -> ReversibleModel:
    """The port's ReversibleModel from an object with the fields of one
    (name, num_states, rate_groups, group_rates, exchange, freq_type,
    state_freq, fixed_rates, asc)."""
    copy = lambda a, t: None if a is None else _np(a).astype(t).copy()
    return ReversibleModel(str(src.name), int(src.num_states),
                           rate_groups=copy(src.rate_groups, np.int32),
                           group_rates=copy(src.group_rates, np.float64),
                           exchange=copy(src.exchange, np.float64),
                           freq_type=str(src.freq_type),
                           state_freq=copy(src.state_freq, np.float64),
                           fixed_rates=bool(src.fixed_rates),
                           asc=bool(getattr(src, "asc", False)))


def mixture_model(src) -> MixtureModel:
    """The port's MixtureModel from an object with the fields of one (name,
    components, weights, comp_rates, fix_weights, fused_with_rate, asc): each
    component's matrix and frequencies, the weights and the rates."""
    return MixtureModel(str(src.name), [reversible_model(c) for c in src.components],
                        _np(src.weights).astype(np.float64).copy(),
                        _np(src.comp_rates).astype(np.float64).copy(),
                        fix_weights=bool(src.fix_weights),
                        fused_with_rate=bool(src.fused_with_rate),
                        asc=bool(getattr(src, "asc", False)))


def site_data(src, device, dtype=torch.float64) -> SiteData:
    """From an object with tip_codes, code_masks, pattern_freq,
    const_state and asc_mask fields."""
    return SiteData.from_arrays(_np(src.tip_codes), _np(src.code_masks),
                                _np(src.pattern_freq), _np(src.const_state),
                                _np(src.asc_mask), device, dtype)


def params(src: Dict[str, object], device) -> Dict[str, torch.Tensor]:
    """ModelOptimizer parameters (unconstrained, float64)."""
    return {k: torch.tensor(_np(v).astype(np.float64), device=device)
            for k, v in src.items()}


def schedule(steps, device) -> torch.Tensor:
    """A device-numbered slot schedule [N-1, 6] as the kernels take it."""
    return torch.tensor(_np(steps).astype(np.int32), device=device)
