"""BIONJ distance-based tree construction (Gascuel 1997), host side.

Neighbor joining with variance-weighted branch estimates; O(N^3) in
NumPy.  Builds the search's start trees from the pairwise ML distances
(engine/distances.py).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .tree import MIN_BLEN, PhyloTree


def bionj_tree(dist: np.ndarray) -> PhyloTree:
    """An unrooted binary tree from a distance matrix [N, N]."""
    n = dist.shape[0]
    if n < 3:
        raise ValueError("BIONJ needs >= 3 taxa")
    d = dist.astype(np.float64).copy()
    v = d.copy()  # variances, initialized to the distances
    active: List[int] = list(range(n))  # working index -> adjacency vertex id
    adj: Dict[int, List[Tuple[int, float]]] = {i: [] for i in range(n)}
    next_id = n

    def add_edge(a, b, l):
        l = max(float(l), MIN_BLEN)
        adj.setdefault(a, []).append((b, l))
        adj.setdefault(b, []).append((a, l))

    while len(active) > 3:
        m = len(active)
        r = d.sum(axis=1)
        q = (m - 2) * d - r[:, None] - r[None, :]
        np.fill_diagonal(q, np.inf)
        i, j = np.unravel_index(np.argmin(q), q.shape)
        if i > j:
            i, j = j, i
        dij = d[i, j]
        bi = 0.5 * dij + (r[i] - r[j]) / (2.0 * (m - 2))
        bj = dij - bi
        vij = v[i, j]
        if vij > 0 and m > 3:
            # lambda = 1/2 + sum_k (V_jk - V_ik) / (2 (m-2) V_ij)
            lam = 0.5 + (
                (np.delete(v[j, :], [i, j]).sum() - np.delete(v[i, :], [i, j]).sum())
                / (2.0 * (m - 2) * vij))
            lam = min(max(lam, 0.0), 1.0)
        else:
            lam = 0.5
        u = next_id
        next_id += 1
        add_edge(u, active[i], bi)
        add_edge(u, active[j], bj)
        du = lam * (d[i, :] - bi) + (1 - lam) * (d[j, :] - bj)
        vu = lam * v[i, :] + (1 - lam) * v[j, :] - lam * (1 - lam) * vij
        keep = [k for k in range(m) if k not in (i, j)]
        d = np.vstack([d[keep][:, keep], du[keep][None, :]])
        d = np.hstack([d, np.append(du[keep], 0.0)[:, None]])
        v2 = np.vstack([v[keep][:, keep], vu[keep][None, :]])
        v = np.hstack([v2, np.append(vu[keep], 0.0)[:, None]])
        active = [active[k] for k in keep] + [u]

    c = next_id
    a, b, cc = active
    da, db, dc = d[0, 1], d[0, 2], d[1, 2]
    add_edge(c, a, 0.5 * (da + db - dc))
    add_edge(c, b, 0.5 * (da + dc - db))
    add_edge(c, cc, 0.5 * (db + dc - da))
    return PhyloTree.from_adjacency(n, adj)
