"""Model-string parsing for the DNA, protein, codon, binary and morphology
models the port serves.

Parses IQ-TREE-style model strings like "GTR+G4+I", "HKY+F{.3,.2,.2,.3}",
"GTR{1.5,2,0.8,1.2,3}+G{0.5}", "LG+F+I+G", "C20", "EX2+G", "LG4M" or
"MIX{WAG,LG}+G", "HKY+I+R3" or "LG4X" into a (ReversibleModel |
MixtureModel, RateModel) pair.
The protein names are the empirical matrices of models/protein.py, with
their published frequencies unless a +F suffix says otherwise.  The codon
names (models/codon.py) are GY (the default, counted codon frequencies),
MG (F3X4 product frequencies) and the empirical KOSI07/ECM, ECMREST and
SCHN05, with their own frequencies.  Binary data take JC2 (equal
frequencies, the default) and GTR2 (counted frequencies); morphology MK
(equal rates and frequencies, the default) and ORDERED (changes between
neighbouring states only, equal frequencies).  Mixture names (EX2, EX3, EHO, UL2,
UL3, EX_EHO, LG4M, CF4, C10..C60) resolve from the built-in NEXUS
definitions (io/modelsblock.py) into a MixtureModel (models/mixture.py).

Supported suffixes:
  +F    empirical (counted) frequencies
  +FO   ML-optimized frequencies
  +FQ   equal frequencies
  +F{a,b,...} user frequencies
  +F1X4, +F3X4  codon frequencies from the pooled / per-position
                nucleotide frequencies
  +I[{p}]       invariable sites
  +G[n][{a}]    discrete Gamma (default n=4); +GM[n][{a}] with median rates
  +R[n][{w1,r1,...}]  FreeRate (default n=4), with or without +I
  +K[n]         free rates of equal weight (RateKategory; no +G, +R or +I)
  +FMIX{f1:r:w,...}  frequency-mixture classes (CF4/C10..C60 style)
  MIX{...}*Rn   a mixture fused with FreeRate, its weights the FreeRate
                weights (LG4X)
  +ASC          Lewis's ascertainment-bias correction (no +I, and an
                alignment without constant sites)
Model parameters may be pinned inline: GTR{1.5,2.0,...}, GY{kappa,omega}.  Other families
and suffixes raise NotImplementedError naming the slice that ports them.
"""

from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np

from ..io.alignment import (SEQ_BINARY, SEQ_CODON, SEQ_DNA, SEQ_MORPH, SEQ_PROTEIN,
                            Alignment)
from ..io.modelsblock import ExprDef, MatrixDef, builtin_mixture_defs
from .codon import (EMPIRICAL_CODON, CodonModel, empirical_codon_model,
                    product_codon_freqs)
from .dna import create_dna_model
from .mixture import build_mixture
from .protein import create_protein_model
from .rates import RateModel
from .subst import (FREQ_EMPIRICAL, FREQ_EQUAL, FREQ_ESTIMATE, FREQ_USER,
                    ReversibleModel)


class ModelParseError(ValueError):
    pass


def _split_suffixes(s: str):
    """'GTR{1,2}+F+G4{0.5}' -> ('GTR{1,2}', ['F', 'G4{0.5}'])"""
    parts = []
    depth = 0
    cur = []
    for ch in s:
        if ch == "{":
            depth += 1
        elif ch == "}":
            depth -= 1
        if ch == "+" and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    parts.append("".join(cur))
    return parts[0], parts[1:]


def _parse_braces(tok: str) -> Tuple[str, Optional[list]]:
    m = re.match(r"([^{]*)(?:\{([^}]*)\})?$", tok)
    if not m:
        raise ModelParseError(f"bad model token {tok!r}")
    vals = None
    if m.group(2) is not None:
        vals = [float(x) for x in m.group(2).split(",") if x.strip()]
    return m.group(1), vals


def _not_ported(what: str, slice_name: str):
    raise NotImplementedError(f"{what} is not ported yet ({slice_name})")


DEFAULT_MODELS = {SEQ_DNA: "HKY+G", SEQ_PROTEIN: "LG+G", SEQ_CODON: "GY+G",
                  SEQ_BINARY: "JC2+G", SEQ_MORPH: "MK+G"}


def default_model(aln: Alignment) -> str:
    """The model when -m is omitted: HKY+G for DNA, LG+G for protein, GY+G
    for codons, JC2+G for binary and MK+G for morphological data."""
    return DEFAULT_MODELS[aln.states.seq_type]


def _binmorph_model(name: str, aln: Alignment) -> ReversibleModel:
    """JC2 and GTR2 (binary), MK and ORDERED (morphology, the alignment's
    state count)."""
    upper = name.upper()
    ns = aln.num_states
    if aln.states.seq_type == SEQ_BINARY:
        if upper in ("JC2", ""):
            return ReversibleModel("JC2", 2, rate_groups=np.array([0]),
                                   freq_type=FREQ_EQUAL)
        if upper == "GTR2":
            return ReversibleModel("GTR2", 2, rate_groups=np.array([0]),
                                   freq_type=FREQ_ESTIMATE)
        raise ModelParseError(f"unknown binary model {name!r}")
    if upper in ("MK", ""):
        return ReversibleModel("MK", ns, rate_groups=np.zeros(ns * (ns - 1) // 2, int),
                               freq_type=FREQ_EQUAL)
    if upper == "ORDERED":  # a change moves to a neighbouring state only
        band = np.zeros((ns, ns))
        i = np.arange(ns - 1)
        band[i, i + 1] = band[i + 1, i] = 1.0
        return ReversibleModel("ORDERED", ns, exchange=band, freq_type=FREQ_EQUAL,
                               fixed_rates=True)
    raise ModelParseError(f"unknown morphology model {name!r}")


def _resolve_base(name: str, aln: Alignment, defs) -> ReversibleModel:
    """A plain (non-mixture) model: a matrix of the built-in definitions, or
    the alignment's family's model of that name with its pinned parameters."""
    bname, bparams = _parse_braces(name)
    upper = bname.upper()
    if upper == "UNREST":
        _not_ported("UNREST", "the non-reversible slice")
    d = defs.get(upper)
    if isinstance(d, MatrixDef):
        if d.exchange.shape[0] != aln.num_states:
            raise ModelParseError(f"model {bname} has {d.exchange.shape[0]} states, "
                                  f"alignment has {aln.num_states}")
        freq = d.freqs if d.freqs is not None else aln.state_frequencies()
        return ReversibleModel(name=d.name, num_states=d.exchange.shape[0],
                               exchange=d.exchange, freq_type=FREQ_USER,
                               state_freq=np.asarray(freq, float), fixed_rates=True)
    if aln.states.seq_type == SEQ_PROTEIN:
        subst = create_protein_model(bname)
        if bparams is not None:
            raise ModelParseError(f"{bname} takes no rate parameters")
    elif aln.states.seq_type == SEQ_CODON:
        subst = _codon_model(bname, aln)
        if bparams is not None:  # GY{kappa,omega}: both pinned
            if not isinstance(subst, CodonModel):
                raise ModelParseError(f"{bname} takes no parameters")
            if len(bparams) != 2:
                raise ModelParseError(f"{bname} takes two parameters, {{kappa,omega}}")
            subst.kappa, subst.omega = bparams
            subst.fix_kappa = subst.fix_omega = True
    else:
        subst = (create_dna_model(bname) if aln.states.seq_type == SEQ_DNA
                 else _binmorph_model(bname, aln))
        if bparams is not None:
            if subst.rate_groups is None:
                raise ModelParseError(f"{bname} takes no rate parameters")
            ngroups = int(subst.rate_groups.max()) + 1
            if len(bparams) != ngroups - 1:
                raise ModelParseError(
                    f"{bname} expects {ngroups - 1} rate parameters, got "
                    f"{len(bparams)}")
            subst.set_rate_param_vector(np.asarray(bparams))
            subst.fixed_rates = True
    return subst


def parse_model_string(model_str: str, aln: Alignment):
    """Returns (ReversibleModel | MixtureModel, RateModel)."""
    defs = builtin_mixture_defs()
    base_tok, suffixes = _split_suffixes(model_str.strip())
    # a built-in mixture name stands for its expression (C20, EX2, LG4M, ...)
    d = defs.get(base_tok.split("*")[0].split("{")[0].upper())
    if isinstance(d, ExprDef):
        inner_base, inner_suffixes = _split_suffixes(d.expr)
        base_tok, suffixes = inner_base, inner_suffixes + suffixes
    fmix_body = None
    rest = []
    for tok in suffixes:
        if tok.upper().startswith("FMIX{") and tok.endswith("}"):
            fmix_body = tok[5:-1]
        else:
            rest.append(tok)
    suffixes = rest
    mix_star = None
    is_mix = base_tok.upper().startswith("MIX") or fmix_body is not None
    if is_mix:
        if aln.states.seq_type == SEQ_CODON:
            _not_ported("mixture models", "the codon mixture slice")
        subst, mix_star = build_mixture(base_tok, fmix_body, aln, defs,
                                        lambda n: _resolve_base(n, aln, defs))
    elif "*" in base_tok:
        raise ModelParseError(f"bad model token {base_tok!r}")
    else:
        subst = _resolve_base(base_tok, aln, defs)

    gamma_cats = free_cats = kat_cats = 0
    invar = gamma_median = False
    alpha, p_invar = 1.0, 0.0
    fix_alpha = fix_pinv = False
    free_init = None
    freq_set = False
    for tok in suffixes:
        name, vals = _parse_braces(tok)
        up = name.upper()
        if up in ("F", "FO", "FE", "FQ", "FU") and is_mix:
            raise ModelParseError("frequency suffixes don't apply to mixture models")
        if up in ("F", "FO", "FE", "FQ", "FU"):
            if up == "F" and vals:
                f = np.asarray(vals)
                if len(f) != subst.num_states:
                    raise ModelParseError(
                        f"+F expects {subst.num_states} frequencies")
                subst.state_freq = f / f.sum()
                subst.freq_type = FREQ_USER
            elif up == "F":
                subst.freq_type = FREQ_EMPIRICAL
            elif up in ("FO", "FE"):
                subst.freq_type = FREQ_ESTIMATE
            elif up == "FQ":
                subst.freq_type = FREQ_EQUAL
                subst.state_freq = np.full(subst.num_states,
                                           1.0 / subst.num_states)
            else:
                subst.freq_type = FREQ_USER
            freq_set = True
        elif up in ("F1X4", "F3X4"):
            if aln.states.seq_type != SEQ_CODON:
                raise ModelParseError(f"+{up} needs codon data")
            nt = aln.codon_nt_frequencies(by_position=up == "F3X4")
            subst.nt_freq = nt
            subst.state_freq = product_codon_freqs(nt, aln.states.genetic_code)
            subst.freq_type = FREQ_USER
            freq_set = True
        elif up == "I":
            invar = True
            if vals:
                p_invar, fix_pinv = vals[0], True
        elif up.startswith("GM") and (len(up) == 2 or up[2:].isdigit()):
            gamma_median = True
            gamma_cats = int(up[2:]) if len(up) > 2 else (gamma_cats or 4)
            if vals:
                alpha, fix_alpha = vals[0], True
        elif up.startswith("G") and (len(up) == 1 or up[1:].isdigit()):
            gamma_cats = int(up[1:]) if len(up) > 1 else 4
            if vals:
                alpha, fix_alpha = vals[0], True
        elif up.startswith("R") and (len(up) == 1 or up[1:].isdigit()):
            free_cats = int(up[1:]) if len(up) > 1 else 4
            if vals:
                free_init = np.asarray(vals)
        elif up.startswith("K") and (len(up) == 1 or up[1:].isdigit()):
            kat_cats = int(up[1:]) if len(up) > 1 else 4
        elif up == "ASC":
            subst.asc = True
        else:
            raise ModelParseError(f"unknown model suffix +{name}")

    # the correction conditions on variable sites: no invariable class, and
    # no constant site in the data
    if subst.asc:
        if invar:
            raise ModelParseError("+ASC is incompatible with +I")
        if aln.frac_const_sites() > 0:
            raise ModelParseError("+ASC requires an alignment without constant sites")
    if is_mix and subst.fused_with_rate:
        # `MIX{..}*G4` pairs class m with Gamma rate class m (LG4M); `MIX{..}*R4`
        # with FreeRate class m, whose free weights are the class weights (LG4X)
        if mix_star.upper().startswith("R"):
            free_cats, gamma_cats = subst.n_mix, 0
            subst.fix_weights = True  # tied to the FreeRate weights
        else:
            if gamma_cats and gamma_cats != subst.n_mix:
                raise ModelParseError(f"fused mixture {subst.name} needs G{subst.n_mix}")
            gamma_cats = gamma_cats or subst.n_mix
    if kat_cats and (gamma_cats or free_cats or invar):
        raise ModelParseError("+K cannot combine with +G/+R/+I")
    # a model's FREQ_ESTIMATE default means empirical counts unless +FO
    if not is_mix and not freq_set and subst.freq_type == FREQ_ESTIMATE:
        subst.freq_type = FREQ_EMPIRICAL
    if not is_mix and subst.freq_type in (FREQ_EMPIRICAL, FREQ_ESTIMATE):
        subst.state_freq = aln.state_frequencies()
    if isinstance(subst, CodonModel):  # MG's factors follow the frequencies
        subst.refresh_exchange()
    rate = RateModel.make(gamma_cats=gamma_cats, invar=invar, free_cats=free_cats,
                          kat_cats=kat_cats, alpha=alpha, p_invar=p_invar,
                          gamma_median=gamma_median, fix_alpha=fix_alpha,
                          fix_p_invar=fix_pinv)
    if free_init is not None:  # +Rk{w1,r1,...}: the start weights and rates
        if len(free_init) != 2 * free_cats:
            raise ModelParseError(f"+R{free_cats} expects {2 * free_cats} values "
                                  "(w1,r1,...)")
        rate.free_props = free_init[0::2].copy()
        rate.free_rates = free_init[1::2].copy()
    return subst, rate


def _codon_model(name: str, aln: Alignment):
    """GY (counted codon frequencies), MG (F3X4 products) or an empirical
    codon matrix, under the alignment's genetic code."""
    upper = name.upper()
    code = aln.states.genetic_code
    if upper in EMPIRICAL_CODON:
        return empirical_codon_model(upper, code)
    ns = aln.num_states
    if upper in ("GY", "GY94", ""):
        m = CodonModel("GY", ns, code_id=code, freq_type=FREQ_EMPIRICAL)
    elif upper in ("MG", "MG94"):
        m = CodonModel("MG", ns, code_id=code, mg=True, freq_type=FREQ_USER)
    else:
        raise ModelParseError(f"unknown codon model {name!r}")
    m.nt_freq = aln.codon_nt_frequencies(by_position=True)
    if m.mg:
        m.state_freq = product_codon_freqs(m.nt_freq, code)
    return m
