"""Command-line entry: the default tree search, with the ultrafast
bootstrap under -bb, or the fixed-topology (-te) model and branch fit;
DNA, protein, codons (-st CODON[n]), binary and morphological data
(-st BIN, -st MORPH: JC2, GTR2, MK, ORDERED), the mixture models (-m C10..
C60, EX2+G, LG4M, LG4X, MIX{...}, BASE+FMIX{...}; -mwopt frees their
pinned class weights), the rate models +G, +GM, +I, +R, +K (-a, -i
and -gmedian write into the model string) and +ASC.

    python -m iqtree_torch -s ALN [-st DNA|AA|BIN|MORPH|CODON[n]] [-m MODEL] [-mwopt]
                           [-a ALPHA] [-i PINV] [-gmedian]
                           [-t TREE | -starttree BIONJ|PARS]
                           [-n N] [-nstop N] [-ninit N] [-ntop N] [-pers X]
                           [-maxtime MIN] [-keep-ident] [-pre P] [-seed N]
                           [-bb B [-beps X] [-bcor X] [-nstep N] [-wbt | -wbtl]]
                           [-redo] [-device cuda|cpu]
    python -m iqtree_torch -s ALN [-st DNA|AA|BIN|MORPH|CODON[n]] -te TREE -m MODEL [-blfix] ...

With -te, -bb is accepted and ignored: the fit writes no supports (as the
JAX CLI does).  Writes PREFIX.treefile (the best tree, with UFBoot supports under -bb),
PREFIX.iqtree (the report) and PREFIX.log (the screen log, with
`BEST SCORE FOUND :`); under -bb also PREFIX.splits.nex, PREFIX.contree
and, with -wbt/-wbtl, PREFIX.ufboot.
"""

from __future__ import annotations

import os
import re
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import __version__, resolve_device, work_dtype
from .config import parse_args


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_args(argv)
    prefix = cfg.out_prefix
    if not cfg.redo and os.path.exists(prefix + ".treefile"):
        print(f"ERROR: {prefix}.treefile exists; use -redo to overwrite",
              file=sys.stderr)
        return 2
    log_lines: List[str] = []

    def log(msg: str = ""):
        log_lines.append(str(msg))
        print(msg, flush=True)

    t0 = time.time()
    from .models import mixture

    mixture.FORCE_OPT_WEIGHTS = cfg.optimize_mixmodel_weight
    device = resolve_device(cfg.device)
    command = f"iqtree-torch {' '.join(argv)}"
    log(f"IQ-TREE-torch {__version__} starting: {command}")
    log(f"Device: {device}" + (f" ({torch.cuda.get_device_name(device)})"
                               if device.type == "cuda" else ""))
    from .io.alignment import read_alignment
    from .io.report import write_report
    from .models.factory import default_model

    aln = read_alignment(cfg.aln_file, cfg.seq_type, cfg.genetic_code)
    log(f"Alignment: {aln.n_taxa} sequences, {aln.n_sites} sites, "
        f"{aln.n_patterns} patterns ({aln.states.seq_type})")
    model_str = cfg.model or default_model(aln)
    ident_pairs = []
    ufboot = None
    if cfg.fixed_tree:
        tree, lnl, subst, rate = run_fixed_topology(cfg, aln, model_str, device, log)
        iterations = 0
    else:
        # identical sequences are set aside for the search and grafted back
        # onto the written tree, except under -bb: supports must cover all
        # taxa (as the JAX CLI does)
        if not cfg.keep_identical and not cfg.ufboot:
            keep, ident_pairs = aln.identical_groups()
            if ident_pairs:
                log(f"NOTE: {len(ident_pairs)} identical sequences will be "
                    "ignored during the analysis and re-inserted at the end")
                for r, t in ident_pairs:
                    log(f"NOTE: {r} (identical to {t}) is ignored")
                aln = aln.subset_taxa(keep)
        tree, lnl, subst, rate, iterations, ufboot = run_tree_search(
            cfg, aln, model_str, device, log)
    log(f"Best-fit model parameters: {model_name(subst, rate)}")
    support = None
    if ufboot is not None:
        support = ufboot.supports_for(tree)
        write_ufboot_outputs(cfg, prefix, aln, ufboot, log)
    nwk = tree.to_newick(aln.names, support=support)
    if ident_pairs:
        nwk = graft_identical(nwk, ident_pairs)
    with open(prefix + ".treefile", "w") as f:
        f.write(nwk + "\n")
    write_report(prefix + ".iqtree", aln, subst, rate, tree, lnl, command,
                 time.time() - t0, iterations=iterations)
    log(f"BEST SCORE FOUND : {lnl:.4f}")
    log(f"Total wall-clock time used: {time.time() - t0:.3f} sec")
    log("")
    log(f"  IQ-TREE report:                {prefix}.iqtree")
    log(f"  Maximum-likelihood tree:       {prefix}.treefile")
    log(f"  Screen log file:               {prefix}.log")
    with open(prefix + ".log", "w") as f:
        f.write("\n".join(log_lines) + "\n")
    return 0


def write_ufboot_outputs(cfg, prefix: str, aln, ufboot, log) -> None:
    """PREFIX.splits.nex, PREFIX.contree (the consensus with its supports)
    and, under -wbt/-wbtl, PREFIX.ufboot."""
    t0 = time.time()
    if cfg.write_boot_trees:
        ufboot.write_ufboot(prefix + ".ufboot", aln.names,
                            with_lengths=cfg.write_boot_tree_blens)
        log(f"  UFBoot trees:                  {prefix}.ufboot")
    ufboot.write_splits_nex(prefix + ".splits.nex", aln.names)
    contree = ufboot.consensus()
    with open(prefix + ".contree", "w") as f:
        f.write(contree.to_newick(aln.names, support=ufboot.supports_for(contree),
                                  with_lengths=False) + "\n")
    log(f"  Split support values:          {prefix}.splits.nex")
    log(f"  Consensus tree:                {prefix}.contree")
    log(f"UFBoot summaries and outputs: {time.time() - t0:.2f} s")


def model_name(subst, rate) -> str:
    """The fitted model as a model string with every parameter pinned (a
    mixture: its classes' rates and weights; FreeRate: +Rk{w1,r1,...}, its
    weights and rates, which parse back as the start; +K: no values, as
    the model string takes none)."""
    from .models.mixture import MixtureModel

    suffix = f"+I{{{rate.p_invar:.6f}}}" if rate.has_invar else ""
    if rate.has_gamma:
        suffix += f"+G{'M' if rate.gamma_median else ''}{rate.ncat}{{{rate.alpha:.6f}}}"
    if rate.is_free_rate:  # the weights and rates, which parse back as the start
        r, w = rate.category_rates()
        suffix += f"+R{rate.ncat}{{" + ",".join(f"{a:.6g},{b:.6g}" for a, b in zip(w, r)) + "}"
    if rate.is_kategory:  # +K takes no values
        suffix += f"+K{rate.ncat}"
    if subst.asc:
        suffix += "+ASC"
    if isinstance(subst, MixtureModel):
        return subst.model_string(suffix, "R" if rate.is_free_rate else "G")
    name = subst.name
    if getattr(subst, "kappa", None) is not None:  # codon: {kappa,omega}
        name += f"{{{subst.kappa:.6f},{subst.omega:.6f}}}"
    if subst.rate_groups is not None and len(subst.group_rates) > 1:
        name += "{" + ",".join(f"{r:.6f}" for r in subst.group_rates[1:]) + "}"
    return name + "+F{" + ",".join(f"{x:.6f}" for x in subst.state_freq) + "}" + suffix


def graft_identical(nwk: str, pairs) -> str:
    """Re-insert removed duplicate taxa next to their twins: the twin leaf
    "T:len" becomes "(T:0,R:0):len"."""
    for removed, twin in pairs:
        m = re.search(r"([(,])" + re.escape(twin) + r":([0-9eE.+-]+)", nwk)
        if m:
            nwk = (nwk[: m.start()] + m.group(1) + "(" + twin + ":0,"
                   + removed + ":0):" + m.group(2) + nwk[m.end():])
            continue
        # the twin was grafted already: attach to its zero-length edge
        m = re.search(r"([(,])" + re.escape(twin) + r":0", nwk)
        if m:
            nwk = (nwk[: m.start()] + m.group(1) + "(" + twin + ":0,"
                   + removed + ":0):0" + nwk[m.end():])
    return nwk


def run_tree_search(cfg, aln, model_str: str, device: torch.device, log):
    """The default search.  Returns (tree, lnL, subst, rate, iterations,
    the UFBoot samples or None)."""
    from .search.driver import SearchParams, run_search

    start = None
    if cfg.start_tree:
        with open(cfg.start_tree) as f:
            start = f.read()
    res = run_search(aln, SearchParams(
        device=device, model=model_str, seed=cfg.seed,
        n_init_trees=cfg.n_init_trees, n_top_init=cfg.n_top_init, pers=cfg.pers,
        unsuccess_iteration=cfg.unsuccess_iteration,
        fixed_iterations=cfg.n_iterations, max_seconds=cfg.max_seconds,
        start_tree=start, start_tree_mode=cfg.start_tree_mode, ufboot=cfg.ufboot,
        ufboot_epsilon=cfg.ufboot_epsilon, min_correlation=cfg.min_correlation,
        step_iterations=cfg.step_iterations, log=log))
    return (res.best_tree, res.best_lnl, res.subst, res.rate, res.iterations,
            res.ufboot)


def run_fixed_topology(cfg, aln, model_str: str, device: torch.device, log):
    """-te: fixed topology; fit the model (and the branch lengths unless
    -blfix).  Returns (tree, lnL, subst, rate)."""
    from .engine.banner import decide_engine, engine_banner
    from .engine.kernels.pruning import device_slot_schedule
    from .engine.likelihood import SiteData, TreeArrays
    from .models.factory import parse_model_string
    from .models.mixture import category_count
    from .models.optimize import (ModelOptimizer, fit_model_step,
                                  optimize_model_and_branches)
    from .trees.tree import PhyloTree

    rng = np.random.default_rng(cfg.seed)
    with open(cfg.fixed_tree) as f:
        tree = PhyloTree.from_newick(f.read(), aln.names, rng=rng)
    subst, rate = parse_model_string(model_str, aln)
    dt = work_dtype(device)
    site = SiteData.from_alignment(aln, device, dt, asc=subst.asc)
    ta = TreeArrays.from_tree(tree, device)
    C = category_count(subst, rate)
    P = site.tip_codes.shape[1]  # +ASC's unobservable patterns included
    dec = decide_engine(aln.n_taxa, C, subst.num_states, P, device, dt, has_asc=subst.asc)
    for line in engine_banner(dec, aln.n_taxa, C, subst.num_states, P,
                              has_asc=subst.asc).splitlines():
        log(line)
    steps, n_slots = device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=device)
    opt = ModelOptimizer(subst, rate, device)
    if cfg.fix_branch_lengths:
        params, lnl, _ = fit_model_step(opt, ta, site, opt.init_params(), steps,
                                        n_slots, max_iters=100)
    else:
        ta, params, lnl = optimize_model_and_branches(
            opt, ta, site, steps, n_slots, tol=0.001, log=log)
        tree.blen = ta.host_blen()
    log(f"Optimal log-likelihood: {lnl:.4f}")
    subst, rate = opt.unpack(params)
    return tree, lnl, subst, rate
