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
    rates, props and p_invar fields, at any state count (DNA S=4, protein
    S=20; reversible models only)."""
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
    fix_kappa, fix_omega): its exchangeabilities follow from them."""
    nt = getattr(src, "nt_freq", None)
    return CodonModel(str(src.name), int(src.num_states), freq_type=str(src.freq_type),
                      state_freq=_np(src.state_freq).astype(np.float64).copy(),
                      code_id=int(src.code_id), kappa=float(src.kappa),
                      omega=float(src.omega), mg=bool(src.mg),
                      nt_freq=None if nt is None else _np(nt).astype(np.float64).copy(),
                      fix_kappa=bool(src.fix_kappa), fix_omega=bool(src.fix_omega))


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
