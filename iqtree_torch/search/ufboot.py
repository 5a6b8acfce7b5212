"""Ultrafast bootstrap (UFBoot, Minh et al. 2013).

Every tree the NNI search visits is RELL-rescored against B bootstrap
pattern-weight vectors: its per-pattern log-likelihoods (the forward
kernel's output) times the [B, P] resampled pattern counts, one float64
matrix-vector product on the device.  Each sample keeps its best-scoring
tree; a split's support is its frequency over the samples' trees, and the
search may stop once the split frequencies correlate at -bcor between two
checks -nstep iterations apart.

The replicate counts and every tie draw come from the search's own numpy
Generator, in the JAX package's order, so a run with the same seed
resamples the same [B, P] matrix.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..io.alignment import Alignment
from ..trees.splits import SplitCounter, consensus_tree, map_supports
from ..trees.tree import PhyloTree

RELL_EPSILON = 0.5  # default -beps


class UFBoot:
    def __init__(self, aln: Alignment, n_replicates: int, rng: np.random.Generator,
                 device: torch.device, epsilon: float = RELL_EPSILON):
        self.aln = aln
        # -beps: a tree whose RELL score is within +-epsilon of a sample's
        # best ties with it and replaces it with probability 1/(ties + 1)
        self.epsilon = float(epsilon)
        self._rng = rng
        self.boot_counts = np.zeros(n_replicates, dtype=np.int64)
        probs = aln.pattern_freq / aln.pattern_freq.sum()
        freqs = rng.multinomial(aln.n_sites, probs, size=n_replicates)
        self.boot_freqs = torch.as_tensor(freqs, dtype=torch.float64,
                                          device=device)  # [B, P]
        self.boot_logl = np.full(n_replicates, -np.inf)
        self.boot_tree_id = np.full(n_replicates, -1, dtype=np.int64)
        self._trees: List[PhyloTree] = []
        self._tree_keys: Dict[frozenset, int] = {}
        self._checkpoint_freqs: Optional[Dict[frozenset, float]] = None

    def save_tree(self, tree: PhyloTree, pattern_lnl) -> None:
        """RELL-rescore one visited tree (pattern_lnl [P], a tensor on any
        device or an array; +ASC's unobservable patterns after the
        alignment's are left out) against every sample; one uniform draw a
        call."""
        P = self.boot_freqs.shape[1]
        lnl = torch.as_tensor(pattern_lnl, device=self.boot_freqs.device)[:P]
        rell = (self.boot_freqs @ lnl.to(torch.float64)).cpu().numpy()
        better = rell > self.boot_logl + self.epsilon
        near = (~better) & (rell > self.boot_logl - self.epsilon)
        rd = self._rng.uniform()
        tie_take = near & (rd <= 1.0 / (self.boot_counts + 1))
        take = better | tie_take
        if not take.any():
            return
        key = tree.splits_key()
        tid = self._tree_keys.get(key)
        if tid is None:
            tid = len(self._trees)
            self._trees.append(tree.copy())
            self._tree_keys[key] = tid
        self.boot_counts[tie_take] += 1
        self.boot_counts[better] = 1
        self.boot_logl[take] = np.maximum(self.boot_logl[take], rell[take])
        self.boot_tree_id[take] = tid

    def split_counter(self) -> SplitCounter:
        counter = SplitCounter(self.aln.n_taxa)
        ids, counts = np.unique(self.boot_tree_id[self.boot_tree_id >= 0],
                                return_counts=True)
        for tid, c in zip(ids, counts):
            counter.add_tree(self._trees[int(tid)], float(c))
        return counter

    def check_convergence(self) -> float:
        """Correlation of the split supports with those of the previous
        check (0.0 at the first check; 1.0 when either is constant)."""
        counter = self.split_counter()
        splits = sorted(counter.counts.keys(), key=lambda s: tuple(sorted(s)))
        keyed = dict(zip(splits, counter.frequency_vector(splits)))
        if self._checkpoint_freqs is None:
            self._checkpoint_freqs = keyed
            return 0.0
        all_splits = set(keyed) | set(self._checkpoint_freqs)
        a = np.array([keyed.get(s, 0.0) for s in all_splits])
        b = np.array([self._checkpoint_freqs.get(s, 0.0) for s in all_splits])
        self._checkpoint_freqs = keyed
        if a.std() < 1e-12 or b.std() < 1e-12:
            return 1.0
        return float(np.corrcoef(a, b)[0, 1])

    def supports_for(self, tree: PhyloTree) -> Dict[int, str]:
        return map_supports(tree, self.split_counter())

    def consensus(self) -> PhyloTree:
        return consensus_tree(self.split_counter())

    def write_ufboot(self, path: str, names, with_lengths: bool = False) -> None:
        """-wbt: every sample's best tree, one a line (-wbtl: with lengths)."""
        with open(path, "w") as f:
            for tid in self.boot_tree_id:
                if tid >= 0:
                    f.write(self._trees[int(tid)].to_newick(
                        names, with_lengths=with_lengths) + "\n")

    def write_splits_nex(self, path: str, names) -> None:
        """The counted splits with their supports, as a NEXUS splits block."""
        counter = self.split_counter()
        splits = sorted(counter.counts.items(), key=lambda kv: -kv[1])
        with open(path, "w") as f:
            f.write("#nexus\n\nBEGIN Taxa;\nDIMENSIONS ntax=%d;\nTAXLABELS\n"
                    % len(names))
            for i, n in enumerate(names, 1):
                f.write(f"[{i}] '{n}'\n")
            f.write(";\nEND; [Taxa]\n\nBEGIN Splits;\n")
            f.write(f"DIMENSIONS ntax={len(names)} nsplits={len(splits)};\n")
            f.write("FORMAT labels=no weights=yes confidences=yes;\n")
            f.write("MATRIX\n")
            for s, w in splits:
                sup = 100.0 * w / max(counter.total_weight, 1e-12)
                members = " ".join(str(i + 1) for i in sorted(s))
                f.write(f"\t{sup:.1f}\t{sup:.1f}\t{members},\n")
            f.write(";\nEND; [Splits]\n")
