"""Splits, split frequencies, consensus trees and branch supports (host side).

The ultrafast bootstrap's summaries: every sample's best tree contributes
its nontrivial splits; a split's support is the share of samples whose
tree holds it.  A split is the frozenset of taxon ids on the side that
holds taxon 0 (as PhyloTree.splits_key has them).  Plain Python and NumPy;
nothing here runs on the card.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, Iterable, List, Tuple

import numpy as np

from .tree import MIN_BLEN, PhyloTree

Split = FrozenSet[int]


def tree_splits(tree: PhyloTree, with_nodes: bool = False):
    """Nontrivial splits of a tree; with `with_nodes`, (split, the child
    node of the edge that defines it) pairs."""
    N = tree.n_taxa
    all_taxa = frozenset(range(N))
    below: Dict[int, frozenset] = {}
    for v in tree.postorder():
        parts = []
        for c in tree.children[v]:
            c = int(c)
            parts.append(below.get(c, frozenset([c]) if c < N else frozenset()))
        below[int(v)] = frozenset().union(*parts)
    out = []
    for v in tree.internal_edges():
        s = below[int(v)]
        if 0 not in s:
            s = all_taxa - s
        if 1 < len(s) < N - 1:
            out.append((s, int(v)) if with_nodes else s)
    return out


class SplitCounter:
    """Weighted split frequencies across a collection of trees."""

    def __init__(self, n_taxa: int):
        self.n_taxa = n_taxa
        self.counts: Dict[Split, float] = {}
        self.total_weight = 0.0

    def add_tree(self, tree: PhyloTree, weight: float = 1.0):
        self.add_splits(tree_splits(tree), weight)

    def add_splits(self, splits: Iterable[Split], weight: float = 1.0):
        for s in splits:
            self.counts[s] = self.counts.get(s, 0.0) + weight
        self.total_weight += weight

    def support(self, split: Split) -> float:
        if self.total_weight == 0:
            return 0.0
        return self.counts.get(split, 0.0) / self.total_weight

    def frequency_vector(self, splits: List[Split]) -> np.ndarray:
        return np.array([self.support(s) for s in splits])


def splits_compatible(a: Split, b: Split, n_taxa: int) -> bool:
    """Two splits are compatible iff one of the four intersections of
    their sides is empty."""
    full = frozenset(range(n_taxa))
    a2, b2 = full - a, full - b
    return not (a & b) or not (a & b2) or not (a2 & b) or not (a2 & b2)


def consensus_tree(counter: SplitCounter) -> PhyloTree:
    """Extended majority-rule consensus: splits accepted greedily by
    decreasing support while compatible with every accepted one, then
    nested into a tree; multifurcations are resolved arbitrarily with
    MIN_BLEN edges."""
    N = counter.n_taxa
    items = sorted(counter.counts.items(), key=lambda kv: -kv[1])
    accepted: List[Split] = []
    for s, _ in items:
        if all(splits_compatible(s, t, N) for t in accepted):
            accepted.append(s)
    # each split's side without taxon 0 is a cluster; nest by containment
    clusters = sorted((frozenset(range(N)) - s if 0 in s else s for s in accepted),
                      key=lambda cl: -len(cl))
    next_id = [N]

    def new_node():
        v = next_id[0]
        next_id[0] += 1
        return v

    root = new_node()
    children: Dict[int, List[int]] = {root: list(range(N))}
    cluster_node: Dict[int, frozenset] = {}
    members_of = lambda ch: frozenset([ch]) if ch < N else cluster_node[ch]
    for cl in clusters:
        if len(cl) < 2 or len(cl) > N - 2:
            continue
        host = root  # the deepest node whose cluster holds cl
        changed = True
        while changed:
            changed = False
            for ch in children.get(host, []):
                if ch >= N and cluster_node.get(ch) and cl <= cluster_node[ch]:
                    host = ch
                    changed = True
                    break
        members = [ch for ch in children[host] if members_of(ch) <= cl]
        covered = frozenset().union(*[members_of(ch) for ch in members])
        if covered != cl:
            continue
        v = new_node()
        cluster_node[v] = cl
        children[v] = members
        children[host] = [ch for ch in children[host] if ch not in members] + [v]
    adj: Dict[int, List[Tuple[int, float]]] = {}

    def add_edge(a, b, length):
        adj.setdefault(a, []).append((b, length))
        adj.setdefault(b, []).append((a, length))

    def join(kids, keep):
        """Pair up kids under new nodes until `keep` remain."""
        while len(kids) > keep:
            a, b = kids.pop(), kids.pop()
            w = new_node()
            add_edge(w, a, MIN_BLEN)
            add_edge(w, b, MIN_BLEN)
            kids.append(w)
        return kids

    def emit(v) -> int:
        if v < N:
            return v
        kids = join([emit(c) for c in children[v]], 2)
        w = new_node()
        for k in kids:
            add_edge(w, k, MIN_BLEN)
        return w

    kids = join([emit(c) for c in children[root]], 3)
    top = new_node()
    for k in kids:
        add_edge(top, k, MIN_BLEN)
    if len(kids) == 2:  # splice out a degree-2 top
        (a, la), (b, lb) = adj[top]
        adj[a] = [(x, l) for x, l in adj[a] if x != top] + [(b, la + lb)]
        adj[b] = [(x, l) for x, l in adj[b] if x != top] + [(a, la + lb)]
        del adj[top]
    return PhyloTree.from_adjacency(N, adj)


def map_supports(tree: PhyloTree, counter: SplitCounter,
                 scale: float = 100.0) -> Dict[int, str]:
    """Support labels of the tree's internal nodes: the percentage of the
    counted trees that hold each node's split, rounded."""
    return {v: str(int(round(counter.support(s) * scale)))
            for s, v in tree_splits(tree, with_nodes=True)}

