"""Array-encoded phylogenetic trees (host side).

Flat array encoding for the device engine: topology is data (index
arrays), so one set of kernels serves every topology of a given taxon
count.

Encoding (for an unrooted binary tree with N taxa):
  * nodes 0..N-1 are tips, N..2N-2 are internal; node R = 2N-2 is a
    *virtual root* placed on the pendant edge of tip 0.
  * `parent[v]` / `children[v, 0:2]` describe the rooted view;
    children of tips are -1; parent[R] = -1.
  * `blen[v]` is the length of the edge above v.  The unrooted pendant
    edge of tip 0 is split by R into R--tip0 and R--c; its full length is
    stored on blen[tip0] and blen[c] is pinned to 0, so there are exactly
    2N-3 free branch lengths, matching the unrooted tree.

The engine treats R as an ordinary internal node (P(0) = I on the
zero-length half-edge), which by the pulley principle yields the unrooted
likelihood.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..io.newick import NewickNode, parse_newick, write_newick

DEFAULT_BLEN = 0.1
MIN_BLEN = 1e-6


@dataclass
class PhyloTree:
    n_taxa: int
    parent: np.ndarray  # [2N-1] int32
    children: np.ndarray  # [2N-1, 2] int32
    blen: np.ndarray  # [2N-1] float64

    # ------------------------------------------------------------------
    # structure helpers
    # ------------------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return 2 * self.n_taxa - 1

    @property
    def root(self) -> int:
        return 2 * self.n_taxa - 2

    def copy(self) -> "PhyloTree":
        return PhyloTree(self.n_taxa, self.parent.copy(), self.children.copy(),
                         self.blen.copy())

    def canonical(self) -> "PhyloTree":
        """Deterministic renumbering through a Newick round trip: trees
        equal as (topology, branch lengths) get identical arrays, so the
        numbering-dependent moves (internal_edges, apply_nni) draw the
        same NNIs from the same seed.  %.17g round-trips float64."""
        names = [str(i) for i in range(self.n_taxa)]
        return PhyloTree.from_newick(self.to_newick(names, precision=17), names)

    def internal_edges(self) -> np.ndarray:
        """Nodes v whose parent edge is an internal (NNI-able) edge."""
        N = self.n_taxa
        vs = np.arange(N, self.n_nodes - 1, dtype=np.int32)
        ok = (self.parent[vs] >= N) & (self.parent[vs] != self.root)
        return vs[ok]

    def check(self) -> None:
        """Raise ValueError unless the arrays encode a valid rooted view."""
        N, R = self.n_taxa, self.root

        def need(ok, what):
            if not ok:
                raise ValueError(f"malformed tree: {what}")

        need(self.parent[R] == -1, "the virtual root has a parent")
        for v in range(self.n_nodes - 1):
            p = self.parent[v]
            need(p >= N and v in self.children[p], f"node {v} and its parent {p}")
        for v in range(N, self.n_nodes):
            l, r = self.children[v]
            need(self.parent[l] == v and self.parent[r] == v, f"children of {v}")
        po = self.postorder()
        need(len(po) == N - 1 and po[-1] == R, "post-order")
        need(0 in self.children[R], "tip 0 under the virtual root")
        c = int(self.children[R, 0] if self.children[R, 1] == 0 else self.children[R, 1])
        need(self.blen[c] == 0.0, "the pinned half-edge has a length")

    def apply_nni(self, v: int, swap_child: int) -> None:
        """NNI around the internal edge (v, parent[v]): exchange
        children[v, swap_child] with v's sibling."""
        u = int(self.parent[v])
        if u < self.n_taxa or u == self.root:
            raise ValueError(f"the edge above {v} is not internal")
        w_slot = 0 if self.children[u, 0] == v else 1
        sib = int(self.children[u, 1 - w_slot])
        x = int(self.children[v, swap_child])
        self.children[u, 1 - w_slot] = x
        self.parent[x] = u
        self.children[v, swap_child] = sib
        self.parent[sib] = v

    def splits_key(self) -> frozenset:
        """Topology id: the set of nontrivial splits, each the taxon set on
        the side that holds taxon 0."""
        N = self.n_taxa
        below: Dict[int, frozenset] = {}
        all_taxa = frozenset(range(N))
        for v in self.postorder():
            l, r = self.children[v]
            sl = below.get(int(l), frozenset([int(l)]) if l < N else frozenset())
            sr = below.get(int(r), frozenset([int(r)]) if r < N else frozenset())
            below[int(v)] = sl | sr
        splits = set()
        for v in self.internal_edges():
            s = below[int(v)]
            if 0 not in s:
                s = all_taxa - s
            if 1 < len(s) < N - 1:
                splits.add(s)
        return frozenset(splits)

    def robinson_foulds(self, other: "PhyloTree") -> int:
        return len(self.splits_key() ^ other.splits_key())

    def device_numbering(self):
        """Level-contiguous device numbering of the nodes.

        Tips keep ids 0..N-1; internal nodes are renumbered level by level
        (height above the tips, children always on lower levels), so each
        level is one contiguous id range and the virtual root is id 2N-2.
        The plain pruning pass walks the levels in order.

        Returns (d2h [2N-1] device id -> host id, h2d [2N-1] host id ->
        device id, level_sizes [n_levels]), all numpy.
        """
        N = self.n_taxa
        depth = np.zeros(self.n_nodes, dtype=np.int32)
        po = self.postorder()
        for v in po:
            l, r = self.children[v]
            depth[v] = max(depth[l], depth[r]) + 1
        # stable sort keeps post-order within a level
        order = po[np.argsort(depth[po], kind="stable")]
        d2h = np.concatenate([np.arange(N), order]).astype(np.int32)
        h2d = np.empty_like(d2h)
        h2d[d2h] = np.arange(self.n_nodes, dtype=np.int32)
        level_sizes = np.bincount(depth[po])[1:]
        return d2h, h2d, level_sizes

    def postorder(self) -> np.ndarray:
        """Internal nodes (including the virtual root, last) in post-order."""
        order: List[int] = []
        stack = [(self.root, False)]
        while stack:
            v, done = stack.pop()
            if v < self.n_taxa:
                continue
            if done:
                order.append(v)
            else:
                stack.append((v, True))
                stack.append((int(self.children[v, 0]), False))
                stack.append((int(self.children[v, 1]), False))
        return np.asarray(order, dtype=np.int32)

    # ------------------------------------------------------------------
    # construction
    # ------------------------------------------------------------------
    @classmethod
    def from_adjacency(
        cls,
        n_taxa: int,
        adj: Dict[int, List[Tuple[int, float]]],
    ) -> "PhyloTree":
        """Build from an undirected adjacency map of an unrooted binary tree.

        Tips must be 0..n_taxa-1 (degree 1); internal nodes any ids with
        degree 3.  Internal nodes are renumbered N..2N-3; the virtual root
        2N-2 is inserted on tip 0's pendant edge.
        """
        N = n_taxa
        n_nodes = 2 * N - 1
        R = n_nodes - 1
        parent = np.full(n_nodes, -1, dtype=np.int32)
        children = np.full((n_nodes, 2), -1, dtype=np.int32)
        blen = np.zeros(n_nodes, dtype=np.float64)

        (c_old, pend_len), = adj[0]  # tip0's single neighbour
        # BFS/DFS from c_old, away from tip 0, assigning new internal ids
        new_id: Dict[int, int] = {i: i for i in range(N)}
        next_internal = N

        def get_id(old: int) -> int:
            nonlocal next_internal
            if old not in new_id:
                new_id[old] = next_internal
                next_internal += 1
            return new_id[old]

        c = get_id(c_old)
        parent[0] = R
        blen[0] = pend_len
        parent[c] = R
        blen[c] = 0.0
        children[R] = (0, c)
        stack = [(c_old, 0)]  # (old id, old parent id)
        while stack:
            v_old, p_old = stack.pop()
            v = get_id(v_old)
            kids = [(u, l) for (u, l) in adj[v_old] if u != p_old]
            if not kids:
                continue
            assert len(kids) == 2, f"node {v_old} has degree {len(kids)+1}, tree not binary"
            for slot, (u_old, l) in enumerate(kids):
                u = get_id(u_old)
                children[v, slot] = u
                parent[u] = v
                blen[u] = l
                stack.append((u_old, v_old))
        assert next_internal == R, f"expected {R - N} internal nodes, got {next_internal - N}"
        t = cls(N, parent, children, blen)
        return t

    @classmethod
    def from_newick(
        cls,
        text: str,
        taxon_names: Sequence[str],
        rng: Optional[np.random.Generator] = None,
        default_blen: float = DEFAULT_BLEN,
    ) -> "PhyloTree":
        """Parse Newick into the array encoding.

        Multifurcations are resolved (randomly if rng given, else
        deterministically) with zero-length branches; a bifurcating
        (rooted) top level is unrooted first.
        """
        ast = parse_newick(text)
        name_to_idx = {n: i for i, n in enumerate(taxon_names)}
        N = len(taxon_names)
        adj: Dict[int, List[Tuple[int, float]]] = {i: [] for i in range(N)}
        next_id = [N]

        def add_edge(a: int, b: int, l: float):
            adj.setdefault(a, []).append((b, l))
            adj.setdefault(b, []).append((a, l))

        def build2(node: NewickNode) -> int:
            if node.is_leaf:
                if node.name not in name_to_idx:
                    raise ValueError(f"unknown taxon {node.name!r} in tree")
                return name_to_idx[node.name]
            kid_ids: List[Tuple[int, float]] = []
            kids = node.children
            if rng is not None and len(kids) > 2:
                kids = [kids[i] for i in rng.permutation(len(kids))]
            for ch in kids:
                l = ch.length if ch.length is not None else default_blen
                kid_ids.append((build2(ch), l))
            # combine children pairwise into a single vertex (binarization)
            while len(kid_ids) > 2:
                (a, la) = kid_ids.pop()
                (b, lb) = kid_ids.pop()
                w = next_id[0]
                next_id[0] += 1
                add_edge(w, a, la)
                add_edge(w, b, lb)
                kid_ids.append((w, 0.0))
            v = next_id[0]
            next_id[0] += 1
            for (a, la) in kid_ids:
                add_edge(v, a, la)
            return v

        top = build2(ast)
        # Unroot: if top-level has degree 2, splice it out
        if len(adj[top]) == 2:
            (a, la), (b, lb) = adj[top]
            adj[a] = [(x, l) for (x, l) in adj[a] if x != top] + [(b, la + lb)]
            adj[b] = [(x, l) for (x, l) in adj[b] if x != top] + [(a, la + lb)]
            del adj[top]
        if N == 2:
            # degenerate two-taxon tree
            parent = np.full(3, -1, dtype=np.int32)
            children = np.full((3, 2), -1, dtype=np.int32)
            blen = np.zeros(3, dtype=np.float64)
            (b, l), = adj[0]
            parent[0] = 2
            parent[1] = 2
            children[2] = (0, 1)
            blen[0] = l
            return cls(2, parent, children, blen)
        return cls.from_adjacency(N, adj)

    def to_newick(
        self,
        taxon_names: Sequence[str],
        with_lengths: bool = True,
        precision: int = 10,
        support: Optional[Dict[int, str]] = None,
    ) -> str:
        """Write in the reference's unrooted style: trifurcation at the
        internal node adjacent to tip 0's pendant edge."""
        R = self.root
        c0, c1 = self.children[R]
        tip0, c = (c0, c1) if c1 != 0 else (c1, c0)
        if c < self.n_taxa:  # two-taxon tree
            return f"({taxon_names[0]}:{self.blen[0]:.{precision}g},{taxon_names[1]}:{self.blen[0]:.{precision}g});"

        def sub(v: int, length: float) -> NewickNode:
            node = NewickNode(length=length)
            if v < self.n_taxa:
                node.name = taxon_names[v]
            else:
                l, r = self.children[v]
                node.children = [sub(int(l), float(self.blen[l])),
                                 sub(int(r), float(self.blen[r]))]
                if support and v in support:
                    node.name = support[v]
            return node

        top = NewickNode()
        l, r = self.children[c]
        top.children = [
            sub(int(l), float(self.blen[l])),
            sub(int(r), float(self.blen[r])),
            sub(int(tip0), float(self.blen[tip0])),
        ]
        return write_newick(top, with_lengths=with_lengths, precision=precision)

# ---------------------------------------------------------------------------
# random trees
# ---------------------------------------------------------------------------


def random_tree(
    n_taxa: int,
    rng: np.random.Generator,
    mean_blen: float = 0.1,
) -> PhyloTree:
    """Yule-Harding-style random topology with exponential branch lengths
    (cf. IQ-TREE's MExtTree::generateRandomTree)."""
    N = n_taxa
    # grow an unrooted tree by random edge attachment
    adj: Dict[int, List[Tuple[int, float]]] = {}
    next_internal = [N]

    def add_edge(a, b, l):
        adj.setdefault(a, []).append((b, l))
        adj.setdefault(b, []).append((a, l))

    def bl():
        return float(rng.exponential(mean_blen)) + MIN_BLEN

    # start with 3-taxon star
    c = next_internal[0]
    next_internal[0] += 1
    for t in range(3):
        add_edge(c, t, bl())
    edges = [(c, 0), (c, 1), (c, 2)]
    for t in range(3, N):
        i = rng.integers(len(edges))
        a, b = edges[i]
        l_ab = next(l for (x, l) in adj[a] if x == b)
        w = next_internal[0]
        next_internal[0] += 1
        # split edge a-b at new node w; attach taxon t
        adj[a] = [(x, l) for (x, l) in adj[a] if x != b]
        adj[b] = [(x, l) for (x, l) in adj[b] if x != a]
        l1 = l_ab * rng.uniform()
        add_edge(a, w, max(l1, MIN_BLEN))
        add_edge(w, b, max(l_ab - l1, MIN_BLEN))
        add_edge(w, t, bl())
        edges[i] = (a, w)
        edges.append((w, b))
        edges.append((w, t))
    return PhyloTree.from_adjacency(N, adj)
