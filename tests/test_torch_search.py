"""The port's tree search against the JAX package, on the CPU in float64.

Host modules (tree moves, BIONJ, the stop rule and candidate set) must
give the same arrays; the batched passes (ML distances, parsimony, the
hill climb) the same numbers to float64 rounding; the whole search a tree
and score that the JAX package's own likelihood confirms.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.derivatives import optimize_all_branches as jax_optimize_branches
from iqtree_tpu.engine.distances import ml_distances as jax_ml_distances
from iqtree_tpu.engine import parsimony as jax_pars
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.search.candidate_set import CandidateSet as JCandidateSet
from iqtree_tpu.search.nni_search import NNIEngine as JNNIEngine
from iqtree_tpu.search.stoprule import StopRule as JStopRule
from iqtree_tpu.trees.bionj import bionj_tree as jax_bionj
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.engine.distances import ml_distances
from iqtree_torch.engine.parsimony import parsimony_score, parsimony_stepwise_tree
from iqtree_torch.io.alignment import Alignment, read_alignment
from iqtree_torch.search.candidate_set import CandidateSet
from iqtree_torch.search.driver import SearchParams, run_search
from iqtree_torch.search.nni_search import NNIEngine
from iqtree_torch.search.stoprule import StopRule
from iqtree_torch.trees.bionj import bionj_tree
from iqtree_torch.trees.tree import PhyloTree, random_tree

from test_torch_cli import jax_lnl
from test_torch_nni import workload

CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def same_arrays(a, b):
    for f in ("parent", "children", "blen"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)


def jax_view(t: PhyloTree) -> JPhyloTree:
    return JPhyloTree(t.n_taxa, t.parent.copy(), t.children.copy(), t.blen.copy())


def simulate_jc(n_taxa=8, n_sites=300, seed=0):
    """Sequences evolved down a random tree under JC (as tests/test_search.py
    simulates them): (true tree, names, sequences)."""
    rng = np.random.default_rng(seed)
    tree = random_tree(n_taxa, rng, mean_blen=0.15)
    states = {tree.root: rng.integers(0, 4, n_sites)}
    for v in reversed(tree.postorder()):
        for child in tree.children[v]:
            t = tree.blen[child]
            p_same = 0.25 + 0.75 * np.exp(-4.0 / 3.0 * t)
            stay = rng.uniform(size=n_sites) < p_same
            states[int(child)] = np.where(stay, states[v], rng.integers(0, 4, n_sites))
    chars = np.array(list("ACGT"))
    return tree, [f"t{i}" for i in range(n_taxa)], \
        ["".join(chars[states[i]]) for i in range(n_taxa)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tree_moves_match_jax(seed):
    t, j = random_tree(17, np.random.default_rng(seed)), \
        jax_random_tree(17, np.random.default_rng(seed))
    same_arrays(t, j)
    rng = np.random.default_rng(seed + 10)
    for _ in range(6):
        edges = t.internal_edges()
        np.testing.assert_array_equal(edges, j.internal_edges())
        v, s = int(edges[rng.integers(len(edges))]), int(rng.integers(2))
        t.apply_nni(v, s)
        j.apply_nni(v, s)
        same_arrays(t, j)
    t.check()
    same_arrays(t.canonical(), j.canonical())
    assert t.splits_key() == j.splits_key()
    other = random_tree(17, np.random.default_rng(seed + 20))
    assert t.robinson_foulds(other) == j.robinson_foulds(jax_view(other)) > 0
    assert t.robinson_foulds(t.canonical()) == 0


def test_bionj_matches_jax():
    rng = np.random.default_rng(4)
    x = rng.uniform(size=(19, 6))
    dist = np.sqrt(((x[:, None] - x[None]) ** 2).sum(-1))
    got, want = bionj_tree(dist), jax_bionj(dist)
    np.testing.assert_array_equal(got.children, want.children)
    np.testing.assert_allclose(got.blen, want.blen, rtol=1e-12)


def test_ml_distances_match_jax():
    (_, jm, js), (_, tm, ts), _, _, _ = workload("GTR+G", n_taxa=10, n_sites=120)
    want = np.asarray(jax.jit(jax_ml_distances)(jm, js))
    np.testing.assert_allclose(ml_distances(tm, ts), want, rtol=1e-8, atol=1e-12)


def jax_stepwise_tree(aln, rng, mean_blen=0.1):
    """The JAX package's stepwise addition, its scorer given 32 spare rows:
    its row windows are 32 wide, and once the partial tree holds N-30 tips
    the root row's window reaches the dummy row, which then feeds the
    mailbox scatters' leftovers into rest[root] (ROADMAP Queue 3).  With
    the spare rows the dummy stays clear, as the scorer intends."""
    N = aln.n_taxa
    masks = jax_pars.pack_tip_masks(aln)
    pad = 32
    n_slots = 2 * N + pad
    tips = np.zeros((n_slots,) + masks.shape[1:], dtype=np.uint32)
    tips[:N] = masks
    tips = jnp.asarray(tips)
    freq = jnp.asarray(aln.pattern_freq, jnp.float32)
    order = [int(t) for t in rng.permutation(N)]
    a, b, c = order[:3]
    adj = {a: [N], b: [N], c: [N], N: [a, b, c]}
    next_internal = N + 1
    for t in order[3:]:
        parent, side, sib, rs, rl, n_rows, root, _ = jax_pars._partial_layout(adj, a, N)
        dummy = n_slots - 1
        parent = np.concatenate([parent, np.full(pad, dummy, np.int32)])
        parent[parent == 2 * N - 1] = dummy
        side = np.concatenate([side, np.zeros(pad, np.int32)])
        sib = np.concatenate([sib, np.full(pad, dummy, np.int32)])
        sib[sib == 2 * N - 1] = dummy
        sib[dummy] = root
        delta, _ = jax_pars._insertion_jit(
            *map(jnp.asarray, (parent, side, sib, rs, rl)),
            jnp.asarray(n_rows, jnp.int32), tips, N, tips[t], freq)
        delta = np.asarray(delta, dtype=np.float64)[: 2 * N]
        mask = np.full(2 * N, np.inf)
        has_parent = parent[: 2 * N] != dummy
        mask[has_parent] = delta[has_parent]
        mask[np.nonzero((parent[: 2 * N] == root) & (side[: 2 * N] == 1))[0]] = np.inf
        cands = np.nonzero(mask <= float(mask.min()) + 1e-9)[0]
        v_old = jax_pars._slot_map(adj, a, N)[int(cands[rng.integers(len(cands))])]
        p_old = jax_pars._adj_parent(adj, a, v_old)
        w = next_internal
        next_internal += 1
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old] += [w]
        adj[p_old] += [w]
        adj[w] = [v_old, p_old, t]
        adj[t] = [w]
    adj_len = {v: [(u, float(rng.exponential(mean_blen)) + 1e-6) for u in us]
               for v, us in adj.items()}
    for v, us in adj.items():
        for idx, u in enumerate(us):
            if u < v:
                adj_len[v][idx] = (u, next(l for (x, l) in adj_len[u] if x == v))
    return JPhyloTree.from_adjacency(N, adj_len)


def test_parsimony_matches_jax():
    aln = read_alignment(os.path.join(DATA, "example.phy"))
    jaln = jax_read_alignment(os.path.join(DATA, "example.phy"))
    for seed in (1, 2):
        t = random_tree(aln.n_taxa, np.random.default_rng(seed))
        assert parsimony_score(t, aln, CPU) == jax_pars.parsimony_score(jax_view(t), jaln)
    for seed in (1, 5):
        got = parsimony_stepwise_tree(aln, np.random.default_rng(seed), CPU)
        want = jax_stepwise_tree(jaln, np.random.default_rng(seed))
        assert got.robinson_foulds(jax_view(want)) == 0
        same_arrays(got, want)


def test_stoprule_and_candidate_set_match_jax():
    rng = np.random.default_rng(0)
    ours, theirs = CandidateSet(max_size=4, pop_size=2), JCandidateSet(max_size=4,
                                                                       pop_size=2)
    stop = StopRule(unsuccess_iteration=3)
    jstop = JStopRule(unsuccess_iteration=3)
    for i in range(12):
        t = random_tree(9, rng)
        score = float(rng.choice([-100.0, -90.0, -95.0, -80.0 - i]))
        assert ours.update(t, score) == theirs.update(jax_view(t), score)
        improved = bool(rng.integers(2))
        stop.iteration_done(improved)
        jstop.iteration_done(improved)
        assert stop.should_stop() == jstop.should_stop()
        assert stop.improved_iterations == jstop.improved_iterations
    assert [(s, t.splits_key()) for s, t in ours.sorted_entries()] == \
        [(s, t.splits_key()) for s, t in theirs.sorted_entries()]
    same_arrays(ours.random_candidate(np.random.default_rng(3)),
                theirs.random_candidate(np.random.default_rng(3)))


def test_hill_climb_matches_jax():
    """Both engines in float64 from the same 4-NNI-perturbed 12-taxon tree."""
    (_, jm, js), (_, tm, ts), tree, _, _ = workload("GTR+G", n_taxa=12, n_sites=120,
                                                    seed=3)
    rng = np.random.default_rng(0)
    start = tree.copy()
    for _ in range(4):
        e = start.internal_edges()
        start.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
    want = JNNIEngine(jm, js, dtype=jnp.float64, fused=False).hill_climb(start.copy())
    engine = NNIEngine(tm, ts)
    got = engine.hill_climb(convert.phylo_tree(start))
    assert abs(got.lnl - want.lnl) < 0.01, (got.lnl, want.lnl)
    assert got.tree.robinson_foulds(jax_view(want.tree)) == 0
    pattern_lnl = engine.pattern_lnl(got.tree)
    np.testing.assert_allclose((pattern_lnl * ts.pattern_freq.numpy()).sum(), got.lnl,
                               rtol=1e-12)
    assert engine.climbs == 1 and engine.prof["nni_eval_n"] >= 1


def jax_lnl_of(tree, names, seqs):
    """lnL of `tree` under JC by the JAX package, float64."""
    aln = JAlignment.from_sequences(names, seqs, "DNA")
    js, jr = jax_parse_model("JC", aln)
    lnl, _ = jax_compute_loglik(JTree.from_tree(jax_view(tree), jnp.float64),
                                JModel.from_model(js, jr, jnp.float64),
                                JSite.from_alignment(aln, jnp.float64))
    return float(lnl)


def test_run_search_end_to_end():
    true_tree, names, seqs = simulate_jc()
    aln = Alignment.from_sequences(names, seqs, "DNA")
    res = run_search(aln, SearchParams(device=CPU, model="JC", seed=3,
                                       fixed_iterations=3, n_init_trees=4,
                                       n_top_init=2, log=lambda s: None))
    res.best_tree.check()
    assert res.iterations == 3 and res.engine.prof["parsimony_n"] == 1
    jaln = JAlignment.from_sequences(names, seqs, "DNA")
    js, jr = jax_parse_model("JC", jaln)
    _, true_lnl = jax_optimize_branches(
        JTree.from_tree(jax_view(true_tree), jnp.float64),
        JModel.from_model(js, jr, jnp.float64), JSite.from_alignment(jaln, jnp.float64))
    assert res.best_lnl >= float(true_lnl) - 0.01, (res.best_lnl, float(true_lnl))
    assert res.best_tree.robinson_foulds(true_tree) <= 2
    got = jax_lnl_of(res.best_tree, names, seqs)
    np.testing.assert_allclose(got, res.best_lnl, rtol=1e-6)


def test_cli_search_on_cpu(tmp_path):
    _, names, seqs = simulate_jc(seed=1)
    aln_path = str(tmp_path / "sim.phy")
    with open(aln_path, "w") as f:
        f.write(f"{len(names)} {len(seqs[0])}\n")
        f.writelines(f"{n} {s}\n" for n, s in zip(names, seqs))
    prefix = str(tmp_path / "sim")
    assert cli_main(["-s", aln_path, "-m", "GTR+G", "-n", "1", "-ninit", "3",
                     "-ntop", "1", "-device", "cpu", "-pre", prefix]) == 0
    for ext in (".treefile", ".iqtree", ".log"):
        assert os.path.getsize(prefix + ext) > 0, ext
    with open(prefix + ".log") as f:
        log = f.read()
    lnl = float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1))
    model = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    with open(prefix + ".treefile") as f:
        nwk = f.read().strip()
    assert abs(jax_lnl(aln_path, nwk, model) - lnl) < 1e-3, (lnl, model)
    with open(prefix + ".iqtree") as f:
        assert f"Log-likelihood of the tree: {lnl:.4f}" in f.read()
    with pytest.raises(SystemExit, match="-alrt is not ported yet"):
        cli_main(["-s", aln_path, "-alrt", "1000", "-device", "cpu"])


def test_parsimony_kernel_walk_orders():
    """The insertion-cost kernel's walks (csrc/pars_insert.cu), replayed
    with numpy over all patterns at once, give the plain twin's costs."""
    from iqtree_torch.engine import parsimony as pars

    aln = read_alignment(os.path.join(DATA, "example.phy"))
    N = aln.n_taxa
    tips = pars.pack_tip_masks(aln)[:, 0].astype(np.uint8)  # [N, P]
    rng = np.random.default_rng(0)
    order = [int(t) for t in rng.permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    nxt = N + 1
    for t in order[3:]:
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        post, pre = pars.walk_orders(layout, present)
        val = np.zeros((2 * N, tips.shape[1]), np.uint8)
        val[:N] = tips
        fitch = lambda x, y: np.where((x & y) != 0, x & y, x | y)
        for v, a, b in post:
            val[v] = fitch(val[a], val[b])
        rest = np.zeros_like(val)
        cost = np.zeros(2 * N)
        for v, par, sib in pre:
            rest[v] = fitch(np.full_like(val[0], 0xFF) if par < 0 else rest[par],
                            val[sib])
            cost[v] = aln.pattern_freq[(tips[t] & (val[v] | rest[v])) == 0].sum()
        want = pars.insertion_costs(
            torch.as_tensor(pars.pack_tip_masks(aln)),
            None, torch.as_tensor(aln.pattern_freq), t, layout, present, None)
        np.testing.assert_array_equal(pars._edge_costs(cost, layout), want)
        v_old = layout[0][int(np.argmin(want))]
        p_old = pars._adj_parent(adj, order[0], v_old)
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old].append(nxt)
        adj[p_old].append(nxt)
        adj[nxt] = [v_old, p_old, t]
        adj[t] = [nxt]
        nxt += 1
