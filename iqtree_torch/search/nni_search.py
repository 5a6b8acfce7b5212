"""NNI hill climbing: a host loop over the batched NNI evaluator.

  repeat (<= n_taxa steps):
    evaluate every internal branch's two NNIs at once (engine/nni.py)
    positive = candidates beating the current score by LOGL_EPSILON
    apply the non-conflicting subset, best first (no shared endpoints)
    re-optimize all branch lengths (2 sweeps)
    if the joint result is worse than the best single NNI's estimate:
      roll back and apply only the best one
    stop when a step gains < 0.1 or no NNI is positive
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..engine.derivatives import optimize_all_branches
from ..engine.kernels.pruning import device_slot_schedule, fused_compute_loglik
from ..engine.likelihood import ModelArrays, SiteData, TreeArrays
from ..engine.nni import evaluate_nnis
from ..trees.tree import PhyloTree

LOGL_EPSILON = 0.001
SCHEDULE_MEMO = 512  # topologies whose slot schedules are kept


@dataclass
class NNISearchResult:
    tree: PhyloTree
    lnl: float
    nni_count: int
    steps: int


class NNIEngine:
    """Branch optimization and NNI evaluation for one (model, alignment).

    Every global pass runs on the kernels (their plain twins on the CPU).
    `prof` holds cumulative wall seconds and counts per phase
    (`<name>_s`, `<name>_n`); each phase ends in a host read of its
    result, so its time includes the device work it waited for."""

    def __init__(self, model: ModelArrays, site: SiteData, edge_chunk: int = 0):
        self.model = model
        self.site = site
        self.device = site.code_masks.device
        self.edge_chunk = edge_chunk
        # pair each swap with its edge's identity configuration in float32
        # (the shared per-edge bias cancels); float64 needs no pairing
        self.paired = site.code_masks.dtype == torch.float32
        self.prof = Counter()
        self.climbs = 0
        # schedule memo keyed by topology: a climb step builds the same
        # topology's schedule several times (evaluation, branch sweeps,
        # rollback) and the stochastic loop revisits candidates
        self._sched_cache: dict = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        yield
        self.prof[f"{name}_s"] += time.perf_counter() - t0
        self.prof[f"{name}_n"] += 1

    def arrays(self, tree: PhyloTree) -> TreeArrays:
        return TreeArrays.from_tree(tree, self.device)

    def schedule(self, tree: PhyloTree, ta: TreeArrays):
        """(steps on the device, n_slots) of this topology, memoized."""
        key = tree.children.tobytes()
        hit = self._sched_cache.get(key)
        if hit is not None:
            return hit
        with self.phase("schedule"):
            steps, n_slots = device_slot_schedule(tree, ta)
            out = (torch.as_tensor(steps, device=self.device), n_slots)
        if len(self._sched_cache) >= SCHEDULE_MEMO:
            self._sched_cache.clear()
        self._sched_cache[key] = out
        return out

    def site_lnl(self, tree: PhyloTree) -> torch.Tensor:
        """Per-pattern lnL [P] of `tree` by the forward kernel, on the device."""
        ta = self.arrays(tree)
        steps, n_slots = self.schedule(tree, ta)
        with torch.no_grad():
            return fused_compute_loglik(ta, self.model, self.site, steps, n_slots)[1]

    def pattern_lnl(self, tree: PhyloTree) -> np.ndarray:
        return self.site_lnl(tree).cpu().numpy()

    def optimize_branches(self, tree: PhyloTree, n_sweeps: int = 100,
                          tol: float = 1e-5) -> Tuple[PhyloTree, float]:
        """Newton sweeps on all branches until one gains less than `tol`;
        writes the lengths into `tree`.  Returns (tree, lnL)."""
        ta = self.arrays(tree)
        steps, n_slots = self.schedule(tree, ta)
        with self.phase(f"brlen{n_sweeps}"):
            ta, lnl = optimize_all_branches(ta, self.model, self.site, steps,
                                            n_slots, n_sweeps=n_sweeps, tol=tol)
            tree.blen = ta.host_blen()
        return tree, float(lnl)

    def _evaluate(self, tree: PhyloTree, ta: TreeArrays, edges_dev: np.ndarray):
        """(lnl [E,2], center [E,2], base [E] or None) as numpy."""
        steps, n_slots = self.schedule(tree, ta)
        with self.phase("nni_eval"), torch.no_grad():
            ev = evaluate_nnis(ta, self.model, self.site, edges_dev, steps,
                               n_slots, edge_chunk=self.edge_chunk,
                               paired=self.paired)
            host = lambda x: None if x is None else x.cpu().numpy()
            return host(ev.lnl), host(ev.center_blen), host(ev.base_lnl)

    def profile_summary(self) -> str:
        tot = sum(v for k, v in self.prof.items() if k.endswith("_s"))
        lines = [f"search profile (wall seconds by phase, {tot:.1f} s attributed; "
                 f"{self.climbs} hill climbs):"]
        for k in sorted(self.prof):
            if k.endswith("_s"):
                n = self.prof.get(k[:-2] + "_n", 0)
                lines.append(f"  {k[:-2]:>12s}: {self.prof[k]:8.2f}s  x{n}"
                             f"  ({self.prof[k] / max(n, 1) * 1000:7.1f} ms/call)")
        return "\n".join(lines)

    def hill_climb(self, tree: PhyloTree, max_steps: Optional[int] = None,
                   on_tree: Optional[Callable[[PhyloTree, float], None]] = None
                   ) -> NNISearchResult:
        """on_tree(tree, lnl) is called with the tree at the start of every
        step (the ultrafast bootstrap's hook)."""
        self.climbs += 1
        max_steps = max_steps or tree.n_taxa
        # a few sweeps settle the (perturbed) lengths and give `cur`
        tree, cur = self.optimize_branches(tree, 5, tol=0.05)
        nni_count = 0
        steps = 0
        for step in range(1, max_steps + 1):
            steps = step
            old = cur
            if on_tree is not None:
                on_tree(tree, cur)
            edges = tree.internal_edges()
            if len(edges) == 0:
                break
            ta = self.arrays(tree)
            edges_dev = ta.h2d.cpu().numpy()[edges]
            lnls, centers, base = self._evaluate(tree, ta, edges_dev)
            # paired deltas: swap minus the same edge's identity lnl
            delta = lnls - (base[:, None] if base is not None else cur)
            pos = np.argwhere(delta > LOGL_EPSILON)
            if len(pos) == 0:
                break
            order = pos[np.argsort(-delta[pos[:, 0], pos[:, 1]])]
            # non-conflicting: no shared endpoint nodes {v, parent(v)}
            chosen: List[Tuple[int, int]] = []
            used = set()
            for k, s in order:
                v = int(edges[k])
                u = int(tree.parent[v])
                if v in used or u in used:
                    continue
                used.update((v, u))
                chosen.append((k, int(s)))
            best_k, best_s = chosen[0]
            best_est = cur + delta[best_k, best_s]

            def apply_set(tr: PhyloTree, picks):
                for k, s in picks:
                    v = int(edges[k])
                    tr.apply_nni(v, s)
                    tr.blen[v] = centers[k, s]
                return tr

            trial = apply_set(tree.copy(), chosen)
            trial, new_lnl = self.optimize_branches(trial, 2, tol=0.05)
            if new_lnl >= best_est - LOGL_EPSILON:
                tree, cur = trial, new_lnl
                nni_count += len(chosen)
            else:
                # roll back: apply only the best NNI
                trial = apply_set(tree.copy(), [chosen[0]])
                trial, new_lnl = self.optimize_branches(trial, 2, tol=0.05)
                if new_lnl >= cur - LOGL_EPSILON:
                    tree, cur = trial, new_lnl
                    nni_count += 1
                else:
                    break
            if cur - old < 0.1:
                break
        tree, cur = self.optimize_branches(tree, 100, tol=0.01)
        return NNISearchResult(tree=tree, lnl=cur, nni_count=nni_count, steps=steps)
