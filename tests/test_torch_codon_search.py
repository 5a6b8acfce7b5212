"""The codon tree search (-st CODON -m GY+F3X4+G, with -bb) of the port
against the JAX package.

Inputs: example_codon.phy cut to its first 12 taxa x 60 codons, GY+F3X4+G4
at kappa 1.8, omega 0.4, alpha 0.7, random trees and insertion orders from
numpy seeds; float64 on the CPU on both sides.  The JAX side runs its
stepwise-addition scorer (given 32 spare rows, as tests/test_torch_search.py
runs it), its ML distances, its NNI evaluator on its mailbox passes and its
NNI engine; the port runs the plain twins of its kernels.  The parsimony
kernel's 64-bit instance (csrc/pars_insert.cu) is held against the twin
here by replaying its walk with numpy on uint64 words, and on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine import parsimony as jax_pars
from iqtree_tpu.engine.distances import ml_distances as jax_ml_distances
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.engine.nni import evaluate_nnis as jax_evaluate_nnis
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.search.nni_search import NNIEngine as JNNIEngine
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.config import parse_args
from iqtree_torch.engine import banner
from iqtree_torch.engine import parsimony as pars
from iqtree_torch.engine import distances
from iqtree_torch.engine.distances import ml_distances
from iqtree_torch.engine.kernels.pruning import device_slot_schedule
from iqtree_torch.engine.likelihood import ModelArrays, SiteData
from iqtree_torch.engine.nni import evaluate_nnis
from iqtree_torch.io.alignment import Alignment, read_alignment
from iqtree_torch.models.factory import parse_model_string
from iqtree_torch.search.nni_search import NNIEngine
from iqtree_torch.trees.bionj import bionj_tree
from iqtree_torch.trees.tree import PhyloTree

from test_torch_likelihood import CPU, DATA
from test_torch_search import jax_stepwise_tree, jax_view

CODON_ALN = os.path.join(DATA, "example_codon.phy")


@functools.lru_cache(maxsize=None)
def trimmed(n_taxa=12, n_codons=60):
    """(names, sequences) of example_codon.phy's first taxa and codons."""
    with open(CODON_ALN) as f:
        rows = [l.split() for l in f.read().splitlines()[1:] if l.strip()]
    return ([r[0] for r in rows[:n_taxa]], [r[1][:3 * n_codons] for r in rows[:n_taxa]])


def alignments():
    names, seqs = trimmed()
    return (Alignment.from_sequences(names, seqs, "CODON"),
            JAlignment.from_sequences(names, seqs, "CODON"))


@functools.lru_cache(maxsize=1)
def workload(seed=5):
    """(jax (tree, model, site), port (tree, model, site), host tree):
    GY+F3X4+G4 on the trimmed alignment and a random tree, float64."""
    aln, jaln = alignments()
    (js, jr), (s, r) = jax_parse_model("GY+F3X4+G", jaln), parse_model_string("GY+F3X4+G",
                                                                              aln)
    for m in (js, s):
        m.kappa, m.omega = 1.8, 0.4
        m.refresh_exchange()
    jr.alpha = r.alpha = 0.7
    tree = jax_random_tree(aln.n_taxa, np.random.default_rng(seed), mean_blen=0.15)
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(js, jr, jnp.float64),
         JSite.from_alignment(jaln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    return j, t, tree


def insert(adj, first, v_old, t, nxt):
    """Attach taxon t on the edge above adjacency node v_old (new node nxt)."""
    p_old = pars._adj_parent(adj, first, v_old)
    adj[v_old].remove(p_old)
    adj[p_old].remove(v_old)
    adj[v_old].append(nxt)
    adj[p_old].append(nxt)
    adj[nxt] = [v_old, p_old, t]
    adj[t] = [nxt]


def jax_costs(jaln, adj, first, t):
    """{adjacency node: cost} of attaching t above every edge by the JAX
    package's scorer, given 32 spare rows (jax_stepwise_tree's setup)."""
    N, pad = jaln.n_taxa, 32
    masks = jax_pars.pack_tip_masks(jaln)
    n_slots = 2 * N + pad
    tips = np.zeros((n_slots,) + masks.shape[1:], dtype=np.uint32)
    tips[:N] = masks
    tips = jnp.asarray(tips)
    parent, side, sib, rs, rl, n_rows, root, _ = jax_pars._partial_layout(adj, first, N)
    dummy = n_slots - 1
    parent = np.concatenate([parent, np.full(pad, dummy, np.int32)])
    parent[parent == 2 * N - 1] = dummy
    side = np.concatenate([side, np.zeros(pad, np.int32)])
    sib = np.concatenate([sib, np.full(pad, dummy, np.int32)])
    sib[sib == 2 * N - 1] = dummy
    sib[dummy] = root
    delta, _ = jax_pars._insertion_jit(
        *map(jnp.asarray, (parent, side, sib, rs, rl)), jnp.asarray(n_rows, jnp.int32),
        tips, N, tips[t], jnp.asarray(jaln.pattern_freq, jnp.float32))
    delta = np.asarray(delta, dtype=np.float64)[:2 * N]
    edge = parent[:2 * N] != dummy
    edge[(parent[:2 * N] == root) & (side[:2 * N] == 1)] = False
    slot = jax_pars._slot_map(adj, first, N)
    return {slot[i]: delta[i] for i in np.nonzero(edge)[0]}


def test_codon_insertion_costs_match_jax():
    """Every insertion of one stepwise order: the plain twin's costs on the
    [N, 2, P] codon masks (a set empty only when both words are) equal the
    JAX scorer's, edge by edge, exactly."""
    aln, jaln = alignments()
    N = aln.n_taxa
    masks = pars.pack_tip_masks(aln)
    assert masks.shape == (N, 2, aln.n_patterns)
    np.testing.assert_array_equal(masks.view(np.uint32), jax_pars.pack_tip_masks(jaln))
    tips = torch.as_tensor(masks)
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64)
    order = [int(t) for t in np.random.default_rng(2).permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    for nxt, t in enumerate(order[3:], N + 1):
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        cost = pars.insertion_costs(tips, None, freq, t, layout, present, None)
        got = {layout[0][i]: cost[i] for i in np.nonzero(np.isfinite(cost))[0]}
        assert got == jax_costs(jaln, adj, order[0], t)
        insert(adj, order[0], layout[0][int(np.argmin(cost))], t, nxt)


@pytest.mark.parametrize("seed", [1, 5])
def test_codon_stepwise_tree_matches_jax(seed):
    """The stepwise-addition tree at 61 states under one seed, arrays equal,
    and the parsimony score of a random tree."""
    aln, jaln = alignments()
    t = PhyloTree.from_newick(
        jax_random_tree(aln.n_taxa, np.random.default_rng(seed)).to_newick(aln.names),
        aln.names)
    assert pars.parsimony_score(t, aln, CPU) == jax_pars.parsimony_score(jax_view(t), jaln)
    got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(seed), CPU)
    want = jax_stepwise_tree(jaln, np.random.default_rng(seed))
    assert got.robinson_foulds(jax_view(want)) == 0
    for f in ("parent", "children", "blen"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)


def test_parsimony_kernel_walks_with_64bit_sets():
    """The insertion-cost kernel's 64-bit instance: kernel_tip_words puts
    mask word 1 in the high half of one int64 word a pattern (no padding
    bit 61-63 set), the scratch keeps one integer weight a word, and the
    kernel's walks (walk_orders) replayed with numpy on uint64 words --
    fitch = i ? i : x | y, the root's rest all 64 bits, a miss where
    leaf & (up | rest) == 0 -- give the plain twin's costs at every
    insertion."""
    aln, _ = alignments()
    N, P = aln.n_taxa, aln.n_patterns
    masks = pars.pack_tip_masks(aln)
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64)
    words = pars.kernel_tip_words(torch.as_tensor(masks), aln.num_states)
    miss, wts = pars.kernel_scratch(words, freq, aln.num_states)
    assert words.dtype == torch.int64 and words.shape == (N, P)
    assert (pars.lane_width(aln.num_states), pars.lane_bits(words, wts)) == (64, 64)
    assert miss.shape == (2 * N, P) and wts.tolist() == aln.pattern_freq.tolist()
    w = words.numpy().view(np.uint64)
    m = masks.view(np.uint32).astype(np.uint64)
    np.testing.assert_array_equal(w, m[:, 0] | (m[:, 1] << np.uint64(32)))
    assert not (w >> np.uint64(61)).any()
    fitch = lambda x, y: np.where((x & y) != 0, x & y, x | y)
    order = [int(t) for t in np.random.default_rng(4).permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    for nxt, t in enumerate(order[3:], N + 1):
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        post, pre = pars.walk_orders(layout, present)
        val = np.zeros((2 * N, P), np.uint64)
        val[:N] = w
        for v, a, b in post:
            val[v] = fitch(val[a], val[b])
        rest = np.zeros_like(val)
        cost = np.zeros(2 * N)
        for v, par, sib in pre:
            rest[v] = fitch(np.full(P, ~np.uint64(0)) if par < 0 else rest[par], val[sib])
            cost[v] = aln.pattern_freq[(w[t] & (val[v] | rest[v])) == 0].sum()
        want = pars.insertion_costs(torch.as_tensor(masks), None, freq, t, layout,
                                    present, None)
        np.testing.assert_array_equal(pars._edge_costs(cost, layout), want)
        insert(adj, order[0], layout[0][int(np.argmin(want))], t, nxt)


def test_ml_distances_at_61_states_match_jax():
    (_, jm, js), (_, tm, ts), _ = workload()
    want = np.asarray(jax_ml_distances(jm, js))
    np.testing.assert_allclose(ml_distances(tm, ts), want, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("kind", ["dna", "protein", "codon"])
def test_distance_chunks_give_the_whole_matrix_bits(kind, monkeypatch):
    """The pairs a chunk of taxon rows at a time (one row, three rows) give
    the distances of all pairs at once (a budget that holds every pair:
    the whole-matrix form that ran before the byte budget) bit for bit, at
    S = 4, 20 and 61; the count matrices of a row slice are the whole
    matrix's rows."""
    if kind == "codon":
        _, (_, model, site), _ = workload()
    else:
        aln = read_alignment(os.path.join(
            DATA, "example.phy" if kind == "dna" else "prot_M126_27_269.phy"))
        s, r = parse_model_string("GTR+G" if kind == "dna" else "LG+G", aln)
        model = ModelArrays.from_model(s, r, CPU)
        site = SiteData.from_alignment(aln, CPU, torch.float64)
    T, S = site.tip_codes.shape[0], site.code_masks.shape[1]
    row = distances.PAIR_LIVE * S * S * 8 * T  # one row's pairs
    monkeypatch.setattr(distances, "PAIR_BUDGET", 1 << 40)
    assert distances.pair_chunk_rows(T, S) == T
    whole = ml_distances(model, site)
    for budget, rows in ((1, 1), (3 * row, 3)):
        monkeypatch.setattr(distances, "PAIR_BUDGET", budget)
        assert distances.pair_chunk_rows(T, S) == rows
        np.testing.assert_array_equal(ml_distances(model, site), whole)
    x, y = distances._profiles(site)
    counts = distances._counts(x, y, slice(None))
    assert counts.shape == (T, T, S, S)
    assert torch.equal(distances._counts(x, y, slice(2, 5)), counts[2:5])


@pytest.mark.parametrize("paired", [True, False])
def test_evaluate_nnis_at_61_states_matches_jax(paired):
    """Every internal edge's two NNIs at S=61, the local theta Newton on
    the twins' passes, two edges a chunk: lnL and the central lengths."""
    (jt, jm, js), (tt, tm, ts), tree = workload()
    edges = np.asarray(jt.h2d)[tree.internal_edges()]
    host = convert.phylo_tree(tree)
    steps, n_slots = device_slot_schedule(host, tt)
    want = jax.jit(jax_evaluate_nnis, static_argnames="paired")(
        jt, jm, js, jnp.asarray(edges), paired=paired)
    got = evaluate_nnis(tt, tm, ts, edges, torch.as_tensor(steps), n_slots,
                        paired=paired, edge_chunk=2)
    pairs = [(got.lnl, want.lnl), (got.center_blen, want.center_blen),
             (got.cur_lnl, want.cur_lnl)]
    if paired:
        pairs.append((got.base_lnl, want.base_lnl))
    else:
        assert got.base_lnl is None
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_codon_hill_climb_matches_jax():
    """Both engines in float64 from the same tree, one random NNI away from
    the port's climb of the ML-distance BIONJ tree (a short climb: the JAX
    engine compiles its sweeps anew for every climb): the same climbed
    topology and lnL."""
    (_, jm, js), (_, tm, ts), _ = workload()
    start = NNIEngine(tm, ts).hill_climb(bionj_tree(ml_distances(tm, ts))).tree
    rng = np.random.default_rng(1)
    e = start.internal_edges()
    start.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
    want = JNNIEngine(jm, js, dtype=jnp.float64, fused=False).hill_climb(jax_view(start))
    got = NNIEngine(tm, ts).hill_climb(start.copy())
    assert got.tree.robinson_foulds(jax_view(want.tree)) == 0
    assert abs(got.lnl - want.lnl) < 1e-6, (got.lnl, want.lnl)
    assert got.nni_count == want.nni_count


def test_codon_search_banner_and_engine(monkeypatch):
    """decide_engine serves the codon search at bench_data_codon.npz's size
    and at a few hundred taxa: up and out stored, at the padded width
    (S=64) on the card, where the wrappers' kernels write it; an NNI chunk
    that fits; the banner names the S=64 instance and the 64-bit
    parsimony lanes.  `-st CODON` without -te parses to the search."""
    cpu = banner.decide_engine(80, 4, 61, 457, CPU, torch.float64, search=True)
    assert cpu.store_bytes == 160 * 245 * 457 * 8 * 2
    text = banner.engine_banner(cpu, 80, 4, 61, 457, search=True)
    assert "theta path" in text and "of 77 internal edges" in text
    assert "plain twin of the insertion-cost kernel (64-bit parsimony lanes" in text
    monkeypatch.setattr(banner, "memory_capacity", lambda device: 64 << 30)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    card = torch.device("cuda")
    dec = banner.decide_engine(80, 4, 61, 457, card, torch.float32, search=True)
    assert dec.kernels and dec.store_bytes == 160 * 257 * 457 * 4 * 2
    assert dec.nni_chunk == 80  # every internal edge in one chunk
    text = banner.engine_banner(dec, 80, 4, 61, 457, search=True)
    assert "S=61 (padded 64)" in text and "64-bit parsimony lanes" in text
    big = banner.decide_engine(400, 4, 61, 2000, card, torch.float32, search=True)
    per_edge = 3 * banner.NNI_LIVE_TENSORS * 244 * 2000 * 4
    assert big.store_bytes == 800 * 257 * 2000 * 4 * 2
    assert 1 <= big.nni_chunk <= 400
    assert big.store_bytes + 2 * big.nni_chunk * per_edge <= big.mem_cap
    cfg = parse_args(["-s", "x", "-st", "CODON", "-bb", "1000"])
    assert (cfg.seq_type, cfg.fixed_tree, cfg.ufboot) == ("CODON", None, 1000)


@pytest.mark.parametrize("model,what", [("MIX{GY,MG}*R2", "mixture models"),
                                        ("MIX{GY,MG}+G4", "mixture models"),
                                        ("MIX{GY,MG}", "mixture models"),
                                        ("MIX{GY+G,MG}", "mixture models")])
def test_codon_search_refuses_unported_models(model, what):
    """The codon search takes the codon models (FreeRate too:
    tests/test_torch_freerate.py; +ASC: tests/test_torch_asc.py); mixtures
    (a mixture's braces included, one with a rate model, and one fused
    with FreeRate) still refuse by name."""
    aln, _ = alignments()
    with pytest.raises(NotImplementedError, match=what + " is not ported yet"):
        parse_model_string(model, aln)


def test_cli_codon_search_on_cpu(tmp_path):
    """`-st CODON -m GY+F3X4+G -n 1 -ninit 3 -ntop 1 -bb 100 -wbt -device
    cpu` on the trimmed alignment through the CLI: every output, a
    parsimony start tree drawn, 100 bootstrap trees, N-3 supports in
    0-100, the codon report, and the logged score re-evaluated by the JAX
    package's float64 likelihood."""
    names, seqs = trimmed()
    path = str(tmp_path / "codon.phy")
    with open(path, "w") as f:
        f.write(f"{len(names)} {len(seqs[0])}\n")
        f.writelines(f"{n} {s}\n" for n, s in zip(names, seqs))
    prefix = str(tmp_path / "cs")
    assert cli_main(["-s", path, "-st", "CODON", "-m", "GY+F3X4+G", "-n", "1", "-ninit",
                     "3", "-ntop", "1", "-seed", "1", "-bb", "100", "-wbt", "-device",
                     "cpu", "-pre", prefix]) == 0
    for ext in (".treefile", ".iqtree", ".log", ".ufboot", ".contree", ".splits.nex"):
        assert os.path.getsize(prefix + ext) > 0, ext
    with open(prefix + ".log") as f:
        log = f.read()
    assert re.search(r"parsimony: +\S+s +x1 ", log), "one parsimony start tree"
    assert "64-bit parsimony lanes" in log
    lnl = float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1))
    model = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    with open(prefix + ".ufboot") as f:
        assert len(f.read().splitlines()) == 100
    with open(prefix + ".treefile") as f:
        nwk = f.read().strip()
    supports = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    assert len(supports) == len(names) - 3 and all(0 <= x <= 100 for x in supports)
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "60 codon sites" in report and "pi(AAA)" in report
    assert "Nonsynonymous/synonymous ratio omega:" in report
    # the JAX parser takes no pinned GY{kappa,omega}: its model gets the
    # logged values, read by the port's parser
    s, r = parse_model_string(model, Alignment.from_sequences(names, seqs, "CODON"))
    jaln = JAlignment.from_sequences(names, seqs, "CODON")
    js, jr = jax_parse_model("GY+F3X4+G", jaln)
    js.kappa, js.omega, js.state_freq, jr.alpha = s.kappa, s.omega, s.state_freq, r.alpha
    js.refresh_exchange()
    tree = JPhyloTree.from_newick(nwk, jaln.names)
    want, _ = jax_compute_loglik(JTree.from_tree(tree, jnp.float64),
                                 JModel.from_model(js, jr, jnp.float64),
                                 JSite.from_alignment(jaln, jnp.float64))
    assert abs(float(want) - lnl) < 1.0, (float(want), lnl)
