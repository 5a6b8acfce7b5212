"""Bounded population of the best candidate trees, keyed by topology: a
score-ordered set of the best `max_size` distinct topologies; the
perturbation step picks a random tree among the top `pop_size`."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from ..trees.tree import PhyloTree


@dataclass
class CandidateSet:
    max_size: int = 10
    pop_size: int = 5
    entries: Dict[frozenset, Tuple[float, PhyloTree]] = field(default_factory=dict)

    def update(self, tree: PhyloTree, score: float) -> bool:
        """Insert or refresh; True if the tree entered the set as a new
        topology or with a better score.  Trees are stored canonical, so
        the perturbations drawn from them do not depend on how they were
        built."""
        key = tree.splits_key()
        if key in self.entries:
            if score > self.entries[key][0]:
                self.entries[key] = (score, tree.canonical())
                return True
            return False
        self.entries[key] = (score, tree.canonical())
        if len(self.entries) > self.max_size:
            worst = min(self.entries, key=lambda k: self.entries[k][0])
            del self.entries[worst]
            if worst == key:
                return False
        return True

    @staticmethod
    def _topo_rank(key) -> str:
        """Content-derived tie-break for equal scores (insertion order
        would depend on the run's history)."""
        parts = sorted(tuple(sorted(s)) for s in key)
        return hashlib.md5(repr(parts).encode()).hexdigest()

    def sorted_entries(self) -> List[Tuple[float, PhyloTree]]:
        return [v for _, v in sorted(
            self.entries.items(),
            key=lambda kv: (-kv[1][0], self._topo_rank(kv[0])))]

    def random_candidate(self, rng: np.random.Generator) -> PhyloTree:
        top = self.sorted_entries()[: self.pop_size]
        return top[int(rng.integers(len(top)))][1].copy()
