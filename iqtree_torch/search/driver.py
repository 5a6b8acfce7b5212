"""The stochastic tree search (the reference's default run):

  1. start tree: BIONJ on pairwise ML distances (or a stepwise-addition
     parsimony tree, or the user's tree)
  2. model parameters and branch lengths fitted on it; ML distances
     recomputed with the fitted model, the better BIONJ tree kept
  3. initial candidate set: the climbed start tree plus random-NNI and
     parsimony variants, the best NNI-climbed
  4. stochastic loop: perturb a random top candidate with random NNIs,
     NNI hill-climb, update the candidate set, re-fit the model on every
     improvement; stop by the stop rule
  5. a final model fit on the best tree

With -bb B every tree a hill climb visits is RELL-rescored against B
bootstrap samples (search/ufboot.py); the loop then runs at least -nstep
iterations and, without -n, until the samples' split frequencies
correlate at -bcor between two checks -nstep iterations apart (at most
MAX_BOOT_ITERATIONS).

Host randomness comes from one numpy Generator(seed), drawn in a fixed
order, so a float64 run on the CPU follows the JAX package's trajectory.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np
import torch

from .. import work_dtype
from ..engine.banner import decide_engine, engine_banner
from ..engine.distances import ml_distances
from ..engine.likelihood import SiteData, TreeArrays
from ..engine.parsimony import parsimony_stepwise_tree
from ..io.alignment import Alignment
from ..models.factory import parse_model_string
from ..models.mixture import category_count
from ..models.optimize import ModelOptimizer, optimize_model_and_branches
from ..trees.bionj import bionj_tree
from ..trees.tree import PhyloTree
from .candidate_set import CandidateSet
from .nni_search import NNIEngine
from .stoprule import StopRule
from .ufboot import RELL_EPSILON, UFBoot

MAX_BOOT_ITERATIONS = 1000  # the -bb search's iteration cap without -n


@dataclass
class SearchParams:
    device: torch.device
    model: str = "HKY+G"
    seed: int = 1
    n_init_trees: int = 20
    n_top_init: int = 5
    pers: float = 0.5  # perturbation strength: NNIs = pers * (n_taxa - 3)
    unsuccess_iteration: int = 100
    fixed_iterations: Optional[int] = None
    max_seconds: Optional[float] = None
    start_tree: Optional[str] = None  # newick (-t)
    start_tree_mode: str = "BIONJ"  # -starttree BIONJ|PARS
    ufboot: int = 0  # -bb: bootstrap samples (0: none)
    ufboot_epsilon: float = RELL_EPSILON  # -beps
    min_correlation: float = 0.99  # -bcor
    step_iterations: int = 100  # -nstep
    log: Callable[[str], None] = print


@dataclass
class SearchResult:
    best_tree: PhyloTree
    best_lnl: float
    subst: object
    rate: object
    iterations: int
    engine: NNIEngine
    ufboot: Optional[UFBoot] = None


def random_nni_perturb(tree: PhyloTree, n_moves: int, rng: np.random.Generator):
    """n_moves random NNIs: a random internal edge, a random side."""
    for _ in range(n_moves):
        edges = tree.internal_edges()
        if len(edges) == 0:
            return
        v = int(edges[rng.integers(len(edges))])
        tree.apply_nni(v, int(rng.integers(2)))


def run_search(aln: Alignment, params: SearchParams) -> SearchResult:
    t_start = time.time()
    rng = np.random.default_rng(params.seed)
    log = params.log
    device = params.device
    dt = work_dtype(device)

    subst, rate = parse_model_string(params.model, aln)
    opt = ModelOptimizer(subst, rate, device)
    site = SiteData.from_alignment(aln, device, dt, asc=subst.asc)
    mparams = opt.init_params()
    C = category_count(subst, rate)
    P = site.tip_codes.shape[1]  # +ASC's unobservable patterns included
    dec = decide_engine(aln.n_taxa, C, subst.num_states, P, device, dt,
                        search=True, has_asc=subst.asc)
    for line in engine_banner(dec, aln.n_taxa, C, subst.num_states, P,
                              search=True, has_asc=subst.asc).splitlines():
        log(line)
    engine = NNIEngine(opt.build(mparams), site, edge_chunk=dec.nni_chunk)
    phase = engine.phase

    def distances(model):
        with phase("distances"), torch.no_grad():
            return ml_distances(model, site)

    def bionj(dist):
        with phase("bionj"):
            return bionj_tree(dist)

    def parsimony_tree():
        with phase("parsimony"):
            return parsimony_stepwise_tree(aln, rng, device)

    # ---- start tree ----------------------------------------------------
    pars_start = params.start_tree_mode.upper().startswith("PARS")
    if params.start_tree:
        tree = PhyloTree.from_newick(params.start_tree, aln.names, rng=rng)
        log("Using user start tree")
    elif pars_start:
        log("Computing parsimony stepwise-addition start tree...")
        tree = parsimony_tree()
    else:
        log("Computing ML pairwise distances + BIONJ start tree...")
        tree = bionj(distances(engine.model))

    def fit_model(tree_obj, rounds, tol):
        """Model + branch fit on tree_obj; (TreeArrays, params, lnL)."""
        ta = TreeArrays.from_tree(tree_obj, device)
        steps, n_slots = engine.schedule(tree_obj, ta)
        with phase("fit_model"):
            return optimize_model_and_branches(opt, ta, site, steps, n_slots,
                                               params=mparams, rounds=rounds,
                                               tol=tol)

    log("Optimizing model parameters on the start tree...")
    ta, mparams, lnl = fit_model(tree, rounds=10, tol=0.1)
    tree.blen = ta.host_blen()
    log(f"Start tree lnL: {lnl:.4f}")
    engine.model = opt.build(mparams)

    # ---- ML-distance BIONJ refresh: distances under the fitted model
    # beat those under the default one by thousands of lnL at 1000 taxa
    if params.start_tree is None and not pars_start:
        log("Recomputing ML distances with the optimized model...")
        tree2 = bionj(distances(engine.model))
        tree, lnl_a = engine.optimize_branches(tree, 30, tol=0.05)
        tree2, lnl_b = engine.optimize_branches(tree2, 30, tol=0.05)
        if lnl_b > lnl_a:
            tree = tree2
            log(f"ML-distance BIONJ tree is better ({lnl_b:.4f} vs {lnl_a:.4f})")

    # ---- ultrafast bootstrap: the samples drawn here, from the search's rng
    ufboot = on_tree = None
    if params.ufboot > 0:
        ufboot = UFBoot(aln, params.ufboot, rng, device, epsilon=params.ufboot_epsilon)
        log(f"Ultrafast bootstrap: {params.ufboot} replicates (RELL on the device)")

        def on_tree(t, _lnl):
            with phase("ufboot"):
                ufboot.save_tree(t, engine.site_lnl(t))

    n_perturb = max(1, int(params.pers * (aln.n_taxa - 3)))
    cand = CandidateSet()

    def reopt_model(tree_obj, lnl_now, tol):
        """Re-fit the model on an improved tree; returns the refreshed lnL
        and updates the engine's model."""
        nonlocal mparams
        ta2, mparams, lnl2 = fit_model(tree_obj, rounds=4, tol=tol)
        engine.model = opt.build(mparams)
        if float(lnl2) > lnl_now:
            tree_obj.blen = ta2.host_blen()
            return float(lnl2)
        return lnl_now

    # ---- initial candidate set ------------------------------------------
    res = engine.hill_climb(tree, on_tree=on_tree)
    lnl0 = reopt_model(res.tree, res.lnl, tol=0.1)
    cand.update(res.tree, lnl0)
    best_lnl = lnl0
    best_tree = res.tree.canonical()
    log(f"BIONJ + NNI tree lnL: {best_lnl:.4f} [{time.time() - t_start:.0f}s]")

    init_variants: List[PhyloTree] = []
    for i in range(params.n_init_trees - 1):
        if i % 2 == 0:
            t = best_tree.copy()
            random_nni_perturb(t, n_perturb, rng)
        else:
            t = parsimony_tree()
        init_variants.append(t)

    def init_budget_left() -> bool:
        # -maxtime bounds the initial phase too: 60% of the budget at most
        return (params.max_seconds is None
                or time.time() - t_start < 0.6 * params.max_seconds)

    scored = []
    for t in init_variants:
        if not init_budget_left():
            log(f"init-variant scoring stopped at {len(scored)}/"
                f"{len(init_variants)} (time budget)")
            break
        t, l = engine.optimize_branches(t, 8, tol=0.1)
        scored.append((l, t))
    scored.sort(key=lambda e: -e[0])
    for i, (l, t) in enumerate(scored[: params.n_top_init]):
        if i > 0 and not init_budget_left():
            log("init-variant climbing stopped (time budget)")
            break
        r = engine.hill_climb(t, on_tree=on_tree)
        cand.update(r.tree, r.lnl)
        if r.lnl > best_lnl:
            best_lnl, best_tree = r.lnl, r.tree.canonical()
    log(f"Initial candidate set done, best lnL: {best_lnl:.4f} "
        f"[{time.time() - t_start:.0f}s]")

    # ---- stochastic loop ----------------------------------------------
    stop = StopRule(unsuccess_iteration=params.unsuccess_iteration,
                    min_iterations=params.step_iterations if ufboot else 0,
                    fixed_iterations=params.fixed_iterations,
                    max_seconds=params.max_seconds)
    boot_converged = ufboot is None

    def keep_searching() -> bool:
        nonlocal boot_converged
        if ufboot is not None and params.fixed_iterations is None:
            it = stop.cur_iteration
            if it >= MAX_BOOT_ITERATIONS:
                return False
            if it > 0 and it % params.step_iterations == 0:
                corr = ufboot.check_convergence()
                boot_converged = corr >= params.min_correlation
                log(f"UFBoot split correlation at iteration {it}: {corr:.4f}")
            if not boot_converged:
                return True
        return not stop.should_stop()

    while keep_searching():
        t = cand.random_candidate(rng)
        random_nni_perturb(t, n_perturb, rng)
        r = engine.hill_climb(t, on_tree=on_tree)
        improved = r.lnl > best_lnl + 1e-6
        r_lnl = reopt_model(r.tree, r.lnl, tol=0.01) if improved else r.lnl
        cand.update(r.tree, r_lnl)
        if improved:
            best_lnl, best_tree = r_lnl, r.tree.canonical()
            log(f"BETTER TREE FOUND at iteration {stop.cur_iteration + 1}: "
                f"{best_lnl:.4f}")
        stop.iteration_done(improved)
        if stop.cur_iteration % 10 == 0:
            log(f"Iteration {stop.cur_iteration} / LogL: {r.lnl:.3f} / "
                f"best: {best_lnl:.3f} / {time.time() - t_start:.1f}s")

    # ---- final model fit on the best tree --------------------------------
    log("Final model parameter optimization...")
    ta, mparams, best_lnl = fit_model(best_tree, rounds=15, tol=0.001)
    best_tree.blen = ta.host_blen()
    engine.model = opt.build(mparams)
    subst, rate = opt.unpack(mparams)
    log(f"BEST SCORE FOUND: {best_lnl:.4f}")
    for line in engine.profile_summary().splitlines():
        log(line)
    return SearchResult(best_tree=best_tree, best_lnl=best_lnl, subst=subst,
                        rate=rate, iterations=stop.cur_iteration, engine=engine,
                        ufboot=ufboot)
