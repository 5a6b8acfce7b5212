"""The .iqtree analysis report for DNA, protein, codon, binary and
morphology models and the mixtures: alignment summary, the substitution model (a mixture's classes
with their rates and weights), rate heterogeneity (Gamma, invariable
sites, FreeRate, with each category's rate and proportion), the
maximum-likelihood tree and run information, in the reference report's
sections."""

from __future__ import annotations

import time
from typing import List

import numpy as np

from .. import __version__
from ..io.alignment import AA_ORDER, SEQ_BINARY, SEQ_CODON, SEQ_DNA, SEQ_MORPH, SEQ_PROTEIN
from ..models.codon import codon_strings
from ..models.mixture import MixtureModel
from ..models.subst import (FREQ_EMPIRICAL, FREQ_EQUAL, FREQ_ESTIMATE,
                            FREQ_USER, pair_index)

STATE_NAMES = {SEQ_DNA: "ACGT", SEQ_PROTEIN: AA_ORDER}
SITE_KIND = {SEQ_DNA: "nucleotide", SEQ_PROTEIN: "amino-acid", SEQ_CODON: "codon",
             SEQ_BINARY: "binary", SEQ_MORPH: "morphological"}
FREQ_DESC = {
    FREQ_EMPIRICAL: "empirical counts from alignment",
    FREQ_EQUAL: "equal frequencies",
    FREQ_ESTIMATE: "estimated with maximum likelihood",
    FREQ_USER: "user-defined",
}


def write_report(path: str, aln, subst, rate, tree, lnl: float, command: str,
                 wall_time: float, iterations: int = 0) -> None:
    L: List[str] = [
        f"IQ-TREE-torch {__version__} -- maximum-likelihood phylogenetic "
        "inference on PyTorch and CUDA",
        "",
        f"Command: {command}",
        f"Date: {time.strftime('%a %b %d %H:%M:%S %Y')}",
        "",
        "SEQUENCE ALIGNMENT",
        "------------------",
        f"Input data: {aln.n_taxa} sequences with {aln.n_sites} "
        f"{SITE_KIND[aln.states.seq_type]} sites",
        f"Number of distinct site patterns: {aln.n_patterns}",
        f"Number of constant sites: "
        f"{int(round(aln.frac_const_sites() * aln.n_sites))} "
        f"(= {aln.frac_const_sites() * 100:.4g}% of all sites)",
        f"Number of parsimony informative sites: {aln.num_informative_sites()}",
        "",
        "SUBSTITUTION PROCESS",
        "--------------------",
        f"Model of substitution: {subst.name}{rate.name_suffix()}"
        + ("+ASC" if subst.asc else ""),
        "",
    ]
    codon = aln.states.seq_type == SEQ_CODON
    # binary and morphological states by their numbers, as the JAX report
    names = codon_strings(aln.states.genetic_code) if codon else \
        STATE_NAMES.get(aln.states.seq_type, [str(i) for i in range(aln.num_states)])
    if isinstance(subst, MixtureModel):
        L += ["Mixture model of substitution (class, rate, weight):", ""]
        L += [f"  {c.name:<16} {rr:.4f}  {ww:.4f}"
              for c, rr, ww in zip(subst.components, subst.comp_rates, subst.weights)]
        L += ["", "State frequencies (class-weighted means):", ""]
        L += [f"  pi({n}) = {f:.4g}" for n, f in zip(names, subst.state_freq)]
    else:
        L += _substitution_lines(subst, names, codon)
    L += ["", "RATE HETEROGENEITY", "------------------"]
    if rate.has_gamma:
        L.append(f"Model of rate heterogeneity: "
                 f"{'Invar+' if rate.has_invar else ''}Gamma with {rate.ncat} categories")
        L.append(f"Gamma shape alpha: {rate.alpha:.4g}")
    elif rate.is_free_rate:
        L.append(f"Model of rate heterogeneity: FreeRate with {rate.ncat} categories")
    elif rate.has_invar:
        L.append("Model of rate heterogeneity: Invariable sites")
    else:
        L.append("Model of rate heterogeneity: Uniform")
    if rate.has_invar:
        L.append(f"Proportion of invariable sites: {rate.p_invar:.4g}")
    rates, props = rate.category_rates()
    if len(rates) > 1 or rate.has_invar:
        L += ["", " Category  Relative_rate  Proportion"]
        if rate.has_invar:
            L.append(f"  0         0              {rate.p_invar:.4g}")
        L += [f"  {i}         {r_:.4g}         {w_:.4g}"
              for i, (r_, w_) in enumerate(zip(rates, props), 1)]
    total_len = float(np.sum(tree.blen)) - float(tree.blen[tree.root])
    L += ["", "MAXIMUM LIKELIHOOD TREE", "-----------------------", "",
          f"Log-likelihood of the tree: {lnl:.4f}",
          f"Total tree length (sum of branch lengths): {total_len:.4f}", "",
          "Tree in newick format:", "", tree.to_newick(aln.names), "",
          "ANALYSIS INFO", "-------------",
          f"Search iterations: {iterations}",
          f"Wall-clock time used: {wall_time:.3f} sec", ""]
    with open(path, "w") as f:
        f.write("\n".join(L))


def _substitution_lines(subst, names, codon: bool) -> List[str]:
    """A single model's parameters: kappa and omega (codon), the
    exchangeabilities (DNA), the frequencies and Q (not for codons)."""
    S = subst.num_states
    L: List[str] = []
    if getattr(subst, "kappa", None) is not None:  # a parametric codon model
        L += [f"Transition/transversion ratio kappa: {subst.kappa:.4f}",
              f"Nonsynonymous/synonymous ratio omega: {subst.omega:.4f}", ""]
    if subst.rate_groups is not None and S == 4:  # group-coded (DNA) exchangeabilities
        r = subst.sym_rates()
        L += ["Rate parameter R:", ""]
        L += [f"  {names[i]}-{names[j]}: {r[i, j]:.4f}" for i, j in pair_index(S)]
        L.append("")
    L += [f"State frequencies: ({FREQ_DESC.get(subst.freq_type, subst.freq_type)})", ""]
    L += [f"  pi({n}) = {f:.4g}" for n, f in zip(names, subst.state_freq)]
    if not codon:  # a codon Q (61 x 61) is too wide to print
        L += ["", "Rate matrix Q:", ""]
        q = subst.rate_matrix()
        L += [f"  {names[i]}  " + "  ".join(f"{q[i, j]:8.4f}" for j in range(S))
              for i in range(S)]
    return L
