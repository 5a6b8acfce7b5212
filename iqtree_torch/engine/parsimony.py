"""Bit-parallel Fitch parsimony and stepwise-addition start trees.

State sets are int32 bitmask words [nodes, W, P] (W = ceil(S/32); DNA
W = 1), patterns on the last axis.  The Fitch combine is branchless:

    inter = a & b;  empty = all words of inter are 0
    out   = where(empty, a | b, inter);  cost += empty * pattern_freq

The score's up pass is level-batched tensor code on the caller's device:
every node of one height at once.  For stepwise addition a reversed
(root-to-tips) pass gives the state set of the tree minus each subtree
("rest"), and the cost of attaching a new leaf on the edge above v is

    delta(v) = sum_p freq[p] * [leaf & (up[v] | rest[v]) == 0]

for every edge of the current tree at once.  Stepwise-addition trees are
deep (hundreds of levels at 1000 taxa), so on the card both passes run as
one kernel that walks the whole tree per word of patterns in shared memory
(csrc/pars_insert.cu, `insertion_costs`); the level-batched form is its
plain twin.  The kernel packs a state set into a lane of a word: 4-bit
lanes, 8 patterns a 32-bit word, up to 4 states (DNA); one 32-bit lane up
to 32 (protein); one 64-bit lane up to 64 (codons, W = 2 words of the
masks in one) -- `kernel_tip_words`.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.alignment import Alignment
from ..trees.tree import MIN_BLEN, PhyloTree, random_tree
from .kernels import build

FULL = -1  # every bit of an int32 word


def pack_tip_masks(aln: Alignment) -> np.ndarray:
    """[N_taxa, W, P] int32 state-set bitmasks of the encoded patterns
    (an ambiguity code sets the bits of every state it allows)."""
    S = aln.num_states
    W = (S + 31) // 32
    code_masks = np.asarray(aln.states.code_masks) > 0  # [n_codes, S]
    packed = np.zeros((code_masks.shape[0], W), dtype=np.uint32)
    for s in range(S):
        packed[:, s // 32] |= code_masks[:, s].astype(np.uint32) << np.uint32(s % 32)
    out = packed[aln.patterns].transpose(0, 2, 1)
    return np.ascontiguousarray(out).view(np.int32)


def _combine(a: torch.Tensor, b: torch.Tensor):
    """Fitch combine of word stacks [..., W, P]: (state set, empty
    intersection [..., P])."""
    inter = a & b
    empty = (inter == 0).all(dim=-2)
    return torch.where(empty.unsqueeze(-2), a | b, inter), empty


def _fitch_up(up, child0, child1, levels):
    """Fill up[v] for the internal nodes, level by level (ranges or id
    tensors); returns the per-pattern step counts [P]."""
    steps = torch.zeros(up.shape[-1], dtype=torch.int64, device=up.device)
    for ids in levels:
        y, empty = _combine(up[child0[ids]], up[child1[ids]])
        up[ids] = y
        steps += empty.sum(0)
    return steps


def parsimony_score(tree: PhyloTree, aln: Alignment, device) -> float:
    """Unrooted Fitch parsimony score.  The virtual root has degree 2,
    which leaves the Fitch count unchanged."""
    N = tree.n_taxa
    masks = torch.as_tensor(pack_tip_masks(aln), device=device)
    up = torch.zeros((tree.n_nodes,) + masks.shape[1:], dtype=torch.int32,
                     device=device)
    up[:N] = masks
    po = tree.postorder()
    depth = np.zeros(tree.n_nodes, dtype=np.int64)
    for v in po:
        depth[v] = 1 + max(depth[tree.children[v, 0]], depth[tree.children[v, 1]])
    levels = [torch.as_tensor(po[depth[po] == d], dtype=torch.long, device=device)
              for d in range(1, int(depth.max()) + 1)]
    ch = torch.as_tensor(tree.children.astype(np.int64), device=device)
    steps = _fitch_up(up, ch[:, 0], ch[:, 1], levels)
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64, device=device)
    return float((steps.double() * freq).sum())


# ---------------------------------------------------------------------------
# stepwise addition
# ---------------------------------------------------------------------------


def _partial_layout(adj: Dict[int, List[int]], first_tip: int, n_taxa: int):
    """Numbering of a partial tree given as an undirected adjacency over
    tips (taxon ids < n_taxa) and internal nodes (any ids), rooted on
    first_tip's pendant edge.  Internal nodes get ids n_taxa.. sorted by
    height (stable on the post-order), the virtual root the next id.

    Returns (slot_to_old {new id: adjacency id}, parent [2N], sib [2N],
    child0 [2N], child1 [2N] (dummy-filled numpy), level ranges
    [(start, end)] of the internal nodes bottom-up, root id)."""
    N = n_taxa
    dummy = 2 * N - 1
    (c_old,) = adj[first_tip]
    kids_of: Dict[int, Tuple[int, int]] = {}
    depth: Dict[int, int] = {}
    order: List[int] = []
    stack = [(c_old, first_tip, False)]
    while stack:
        v, p, done = stack.pop()
        if v < N:
            depth[v] = 0
            continue
        kids = [u for u in adj[v] if u != p]
        if done:
            kids_of[v] = (kids[0], kids[1])
            depth[v] = max(depth[kids[0]], depth[kids[1]]) + 1
            order.append(v)
        else:
            stack.append((v, p, True))
            for u in kids:
                stack.append((u, v, False))
    order.sort(key=lambda v: depth[v])
    new_id = {v: N + i for i, v in enumerate(order)}
    slot_to_old = {i: i for i in range(N)}
    slot_to_old.update({nid: v for v, nid in new_id.items()})
    root = N + len(order)
    levels = []
    i = 0
    while i < len(order):
        j = i
        while j < len(order) and depth[order[j]] == depth[order[i]]:
            j += 1
        levels.append((N + i, N + j))
        i = j

    def nd(v):
        return v if v < N else new_id[v]

    parent = np.full(2 * N, dummy, dtype=np.int64)
    sib = np.full(2 * N, dummy, dtype=np.int64)
    child0 = np.full(2 * N, dummy, dtype=np.int64)
    child1 = np.full(2 * N, dummy, dtype=np.int64)
    c_new = nd(c_old)
    parent[first_tip] = parent[c_new] = root
    sib[first_tip], sib[c_new] = c_new, first_tip
    child0[root], child1[root] = first_tip, c_new
    for v, (a, b) in kids_of.items():
        va, vb, vv = nd(a), nd(b), nd(v)
        parent[va] = parent[vb] = vv
        sib[va], sib[vb] = vb, va
        child0[vv], child1[vv] = va, vb
    return slot_to_old, parent, sib, child0, child1, levels, root


def _adj_parent(adj, first_tip, v_old) -> int:
    """Parent of v_old with the tree rooted at first_tip."""
    (c_old,) = adj[first_tip]
    if v_old == first_tip:
        return c_old  # pendant edge: attach between first_tip and c_old
    stack = [(c_old, first_tip)]
    while stack:
        v, p = stack.pop()
        if v == v_old:
            return p
        for u in adj[v]:
            if u != p:
                stack.append((u, v))
    raise KeyError(v_old)


def _edge_costs(delta: np.ndarray, layout) -> np.ndarray:
    """Per-node insertion costs with inf where no attachment edge exists
    (absent nodes, the root, and the root's second child: the same
    unrooted edge as the first tip's)."""
    _, parent, _, _, child1, _, root = layout
    has_edge = parent != len(parent) - 1
    has_edge[child1[root]] = False
    out = np.full(len(parent), np.inf)
    out[has_edge] = delta[has_edge]
    return out


def _insertion_costs_plain(tips, freq, leaf, layout, present):
    """Plain twin of the insertion-cost kernel: level-batched Fitch up
    and rest passes.  tips [N, W, P] int32 masks, leaf a taxon id."""
    _, parent, sib, child0, child1, levels, root = layout
    N, device = tips.shape[0], tips.device
    dev = lambda a: torch.as_tensor(a, device=device)
    par, sb, c0, c1 = dev(parent), dev(sib), dev(child0), dev(child1)
    up = torch.zeros((2 * N,) + tips.shape[1:], dtype=torch.int32, device=device)
    up[:N] = tips
    ranges = [slice(s, e) for s, e in levels] + [slice(root, root + 1)]
    _fitch_up(up, c0, c1, ranges)
    rest = torch.zeros_like(up)
    rest[root] = FULL
    for r in reversed(ranges[:-1]):
        rest[r] = _combine(rest[par[r]], up[sb[r]])[0]
    tp = dev(np.asarray(present, dtype=np.int64))
    rest[tp] = _combine(rest[par[tp]], up[sb[tp]])[0]
    hit = ((tips[leaf][None] & (up | rest)) != 0).any(dim=1)  # [2N, P]
    return ((~hit).double() * freq[None, :]).sum(1).cpu().numpy()


def walk_orders(layout, present):
    """The kernel's two walks over a partial tree, int32 rows:
    post = (node, child0, child1) children first (ids ascend with height);
    pre = (node, parent or -1 under the root, sibling) parents first."""
    _, parent, sib, child0, child1, _, root = layout
    N = (len(parent)) // 2
    internal = np.arange(N, root + 1)
    post = np.stack([internal, child0[internal], child1[internal]], 1)
    nodes = np.concatenate([np.arange(root - 1, N - 1, -1),
                            np.asarray(present, dtype=np.int64)])
    pre = np.stack([nodes, np.where(parent[nodes] == root, -1, parent[nodes]),
                    sib[nodes]], 1)
    return post.astype(np.int32), pre.astype(np.int32)


def insertion_costs(tips, tipsw, freq, leaf: int, layout, present, scratch):
    """[2N] float64 cost of attaching taxon `leaf` on the edge above every
    node of a partial tree (inf where there is no such edge).  For CUDA
    tensors one launch of csrc/pars_insert.cu walks the whole tree per
    word of patterns (tipsw [N, n_words] from kernel_tip_words, scratch
    from kernel_scratch); for CPU tensors the plain twin runs."""
    if not tips.is_cuda:
        return _edge_costs(_insertion_costs_plain(tips, freq, leaf, layout, present),
                           layout)
    N, n_words = tipsw.shape
    miss, wts = scratch
    rows, n_post = kernel_rows(layout, present)
    cost = torch.zeros(2 * N, dtype=torch.float64, device=tipsw.device)
    build.launch("pars_insert", torch.as_tensor(rows, device=tipsw.device), n_post,
                 len(rows) - n_post, tipsw, N, leaf, wts, n_words, miss, cost,
                 lane_bits(tipsw, wts))
    insertion_costs.launches += 1
    return _edge_costs(cost.cpu().numpy(), layout)


insertion_costs.launches = 0


def kernel_rows(layout, present):
    """(rows [n_post + n_pre, 4] int32, n_post): walk_orders' two walks as
    the kernel reads them, one 16-byte row each (the 4th column unused)."""
    post, pre = walk_orders(layout, present)
    rows = np.zeros((len(post) + len(pre), 4), dtype=np.int32)
    rows[:len(post), :3] = post
    rows[len(post):, :3] = pre
    return rows, len(post)


def lane_width(num_states: int) -> int:
    """Bits a state set of the insertion-cost kernel: 4 (8 sets a 32-bit
    word) up to 4 states, 32 (a 32-bit word a set) up to 32, 64 (a 64-bit
    word a set) up to 64."""
    if num_states > 64:
        raise NotImplementedError(
            f"the parsimony kernel takes up to 64 states (one 64-bit word a set), "
            f"got {num_states}")
    return 4 if num_states <= 4 else 32 if num_states <= 32 else 64


def word_lanes(num_states: int) -> int:
    """Patterns a word of the insertion-cost kernel: 8 (4-bit sets) up to
    4 states, else 1."""
    return 8 if lane_width(num_states) == 4 else 1


def lane_bits(tipsw: torch.Tensor, wts: torch.Tensor) -> int:
    """The kernel instance of kernel_tip_words' words: its lane width in
    bits (4, 32 or 64), the word's bits over the patterns a word."""
    return tipsw.element_size() * 8 * tipsw.shape[1] // wts.numel()


def kernel_tip_words(tips: torch.Tensor, num_states: int) -> torch.Tensor:
    """[N, n_words] words of the insertion-cost kernel from the int32 masks
    [N, W, P]: pattern p in lane p % lanes of word p // lanes (lane k of a
    word is bits 4k..4k+3 for 4-bit sets), lanes past P empty.  int32
    words up to 32 states; int64 words (mask word 1 in the high half) past
    32, where the masks have W = 2 words."""
    lanes = word_lanes(num_states)
    word = tips[:, 0]
    if lane_width(num_states) == 64:
        high = tips[:, 1].to(torch.int64) << 32
        return (high | (word.to(torch.int64) & 0xFFFFFFFF)).contiguous()
    if lanes == 1:
        return word.contiguous()
    N, P = word.shape
    n_words = -(-P // lanes)
    nib = torch.zeros(N, n_words * lanes, dtype=torch.int64, device=tips.device)
    nib[:, :P] = word & 0xF
    shift = 4 * torch.arange(lanes, device=tips.device)
    packed = (nib.view(N, n_words, lanes) << shift).sum(-1)  # disjoint bits, < 2^32
    return torch.where(packed >= 2**31, packed - 2**32, packed).to(torch.int32).contiguous()


def kernel_scratch(tipsw: torch.Tensor, freq: torch.Tensor, num_states: int):
    """(miss [2N, n_words] uint8, weights [n_words * lanes] int32) for
    insertion_costs on the card: the kernel's per-node miss bits (a byte a
    word, whatever its width), and the pattern weights as integers (0 past
    P), so its cost sums are exact."""
    N, n_words = tipsw.shape
    lanes = word_lanes(num_states)
    if not bool((freq == freq.round()).all()):
        raise ValueError("the parsimony kernel sums integer pattern weights")
    wts = torch.zeros(n_words * lanes, dtype=torch.int32, device=tipsw.device)
    wts[:freq.shape[0]] = freq.to(torch.int32)
    miss = torch.empty(2 * N, n_words, dtype=torch.uint8, device=tipsw.device)
    return miss, wts


def parsimony_stepwise_tree(aln: Alignment, rng: np.random.Generator, device,
                            mean_blen: float = 0.1) -> PhyloTree:
    """Random-order stepwise-addition maximum-parsimony tree: each taxon in
    a random order goes onto the edge of least parsimony cost (ties
    broken at random), scored for every edge at once.  Draws from `rng`:
    the order, one tie-break per insertion, then exponential lengths."""
    N = aln.n_taxa
    if N < 4:
        return random_tree(N, rng, mean_blen)
    tips = torch.as_tensor(pack_tip_masks(aln), device=device)
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64, device=device)
    tipsw = scratch = None
    if tips.is_cuda:
        tipsw = kernel_tip_words(tips, aln.num_states)
        scratch = kernel_scratch(tipsw, freq, aln.num_states)

    order = [int(t) for t in rng.permutation(N)]
    a, b, c = order[0], order[1], order[2]
    center = N  # provisional internal id
    adj: Dict[int, List[int]] = {a: [center], b: [center], c: [center],
                                 center: [a, b, c]}
    next_internal = N + 1
    first_tip = a
    for t in order[3:]:
        layout = _partial_layout(adj, first_tip, N)
        present = [v for v in adj if v < N]
        cost = insertion_costs(tips, tipsw, freq, t, layout, present, scratch)
        best = float(cost.min())
        cands = np.nonzero(cost <= best + 1e-9)[0]
        pick = int(cands[rng.integers(len(cands))])
        v_old = layout[0][pick]
        p_old = _adj_parent(adj, first_tip, v_old)
        w = next_internal
        next_internal += 1
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old].append(w)
        adj[p_old].append(w)
        adj[w] = [v_old, p_old, t]
        adj[t] = [w]

    adj_len = {v: [(u, float(rng.exponential(mean_blen)) + MIN_BLEN) for u in us]
               for v, us in adj.items()}
    for v, us in adj.items():  # one length per edge: the lower id's draw
        for idx, u in enumerate(us):
            if u < v:
                l = next(l for (x, l) in adj_len[u] if x == v)
                adj_len[v][idx] = (u, l)
    return PhyloTree.from_adjacency(N, adj_len)
