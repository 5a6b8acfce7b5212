"""The protein tree search (-s ALN -m LG+G) of the port against the JAX package.

14 taxa x 100 aa simulated down a random tree under LG+G4, fitted as LG+G4
and LG+I+G4, all in float64 on the CPU.  The JAX side runs its general
(non-packable) Pallas store kernels in interpret mode and its mailbox
passes, as tests/test_torch_protein.py runs them; the port runs the plain
twins of its wide kernels.  The CUDA kernels themselves (wide_down_store.cu
and the 32-bit instance of pars_insert.cu) are held against the twins by
tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine import parsimony as jax_pars
from iqtree_tpu.engine.derivatives import all_passes as jax_all_passes
from iqtree_tpu.engine.distances import ml_distances as jax_ml_distances
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.kernels.pruning import fused_nni_passes_general as jax_passes
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import evaluate_nnis as jax_evaluate_nnis
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.protein import create_protein_model as jax_protein_model
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.search.nni_search import NNIEngine as JNNIEngine
from iqtree_tpu.trees.tree import random_tree as jax_random_tree
from iqtree_tpu.utils.simulate import simulate_alignment

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.engine import parsimony as pars
from iqtree_torch.engine.banner import decide_engine, engine_banner
from iqtree_torch.engine.distances import ml_distances
from iqtree_torch.engine.kernels import cs_kernels
from iqtree_torch.engine.likelihood import tip_partials
from iqtree_torch.engine.nni import evaluate_nnis
from iqtree_torch.io.alignment import Alignment, read_alignment
from iqtree_torch.search.nni_search import NNIEngine

from test_torch_cli import jax_lnl
from test_torch_protein import PROT
from test_torch_search import jax_stepwise_tree, jax_view

CPU = torch.device("cpu")


def protein_workload(model, n_taxa=14, n_sites=100, seed=11):
    """(jax (tree, model, site), port (tree, model, site), host tree, JAX
    schedule, n_slots, (names, seqs)), float64; sequences simulated under
    LG+G4 down a random tree."""
    rng = np.random.default_rng(seed)
    tree = jax_random_tree(n_taxa, rng, mean_blen=0.15)
    seqs = simulate_alignment(tree, jax_protein_model("LG"),
                              JRate.make(gamma_cats=4, alpha=0.8), n_sites, rng)
    names = [f"t{i}" for i in range(n_taxa)]
    aln = JAlignment.from_sequences(names, seqs, "AA")
    subst, rate = jax_parse_model(model, aln)
    if rate.has_invar:
        rate.p_invar = 0.2
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(subst, rate, jnp.float64),
         JSite.from_alignment(aln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, tree, steps, n_slots, (names, seqs)


@pytest.fixture(scope="module", params=["LG+G", "LG+I+G"])
def case(request):
    return protein_workload(request.param)


def test_wide_down_store_twin_matches_jax(case):
    """fused_nni_passes_cs at S=20 (the wide down-store's twin) against the
    JAX package's general store kernels and its mailbox passes, all from the
    same transition matrices (P(t) of small t rounds differently in the two
    packages' eigen-products, tests/test_torch_protein.py)."""
    (jt, jm, js), (tt, tm, ts), _, steps, n_slots, _ = case
    trans_j = jax_trans(jm, jt.blen)
    up_j, usc_j, out_j, osc_j = jax_passes(
        jnp.asarray(steps), n_slots, trans_j, jax_tips(js, 4), jm.props,
        jm.state_freq, interpret=True)
    _, _, out_x, osc_x, _ = jax_all_passes(jt, jm, js)
    st = convert.schedule(steps, CPU)
    trans = torch.tensor(np.asarray(trans_j))
    before = cs_kernels.fused_down_store.launches
    up, usc, out, osc = cs_kernels.fused_nni_passes_cs(st, n_slots, trans,
                                                       tip_partials(ts), tm.state_freq)
    assert cs_kernels.fused_down_store.launches == before  # CPU tensors: the twin
    P, N = up.shape[2], tt.n_taxa
    assert up.shape == out.shape == (2 * N, 80, P)
    rows = [v for v in range(2 * N - 1) if v != tt.root]  # the root row is unused
    np.testing.assert_allclose(
        up[:2 * N - 1].numpy(),
        np.asarray(up_j)[:2 * N - 1, :, :, :P].reshape(2 * N - 1, 80, P), rtol=1e-10)
    for want_out, want_osc in (
            (np.asarray(out_j)[..., :P].reshape(2 * N, 80, P),
             np.asarray(osc_j)[..., :P]),
            (np.asarray(out_x)[:2 * N].reshape(2 * N, 80, P), np.asarray(osc_x)[:2 * N])):
        np.testing.assert_allclose(out[rows].numpy(), want_out[rows], rtol=1e-10,
                                   atol=1e-300)
        np.testing.assert_allclose(osc[rows].numpy(), want_osc[rows], rtol=1e-10,
                                   atol=1e-12)


def test_evaluate_nnis_at_20_states_matches_jax(case):
    (jt, jm, js), (tt, tm, ts), tree, steps, n_slots, _ = case
    edges = np.asarray(jt.h2d)[tree.internal_edges()]
    st = convert.schedule(steps, CPU)
    for paired in (True, False):
        want = jax_evaluate_nnis(jt, jm, js, jnp.asarray(edges), paired=paired)
        got = evaluate_nnis(tt, tm, ts, edges, st, n_slots, paired=paired,
                            edge_chunk=4)
        pairs = [(got.lnl, want.lnl), (got.center_blen, want.center_blen),
                 (got.cur_lnl, want.cur_lnl)]
        if paired:
            pairs.append((got.base_lnl, want.base_lnl))
        else:
            assert got.base_lnl is None
        for g, w in pairs:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)


def test_ml_distances_at_20_states_match_jax(case):
    (_, jm, js), (_, tm, ts), _, _, _, _ = case
    want = np.asarray(jax.jit(jax_ml_distances)(jm, js))
    np.testing.assert_allclose(ml_distances(tm, ts), want, rtol=1e-8, atol=1e-12)


def test_protein_parsimony_matches_jax():
    """The stepwise-addition tree at 20 states (one 32-bit word a state set)
    against the JAX scorer given 32 spare rows, and the parsimony score."""
    _, _, true_tree, _, _, (names, seqs) = protein_workload("LG+G", n_taxa=16)
    aln = Alignment.from_sequences(names, seqs, "AA")
    jaln = JAlignment.from_sequences(names, seqs, "AA")
    assert pars.pack_tip_masks(aln).shape[1] == 1
    t = convert.phylo_tree(true_tree)
    assert pars.parsimony_score(t, aln, CPU) == jax_pars.parsimony_score(true_tree, jaln)
    for seed in (1, 5):
        got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(seed), CPU)
        want = jax_stepwise_tree(jaln, np.random.default_rng(seed))
        assert got.robinson_foulds(jax_view(want)) == 0
        np.testing.assert_array_equal(got.children, want.children)
        np.testing.assert_array_equal(got.blen, want.blen)


def test_parsimony_kernel_walks_with_32bit_sets():
    """The insertion-cost kernel's walks (csrc/pars_insert.cu) replayed with
    numpy on uint32 state sets over all patterns at once give the plain
    twin's costs at every insertion of a protein tree."""
    aln = read_alignment(PROT)
    N = aln.n_taxa
    masks = pars.pack_tip_masks(aln)
    tips = pars.kernel_tip_words(torch.as_tensor(masks), aln.num_states).numpy()
    assert tips.dtype == np.int32
    tips = tips.view(np.uint32)
    full = np.uint32(0xFFFFFFFF)  # the root's rest: all ones of the word
    fitch = lambda x, y: np.where((x & y) != 0, x & y, x | y)
    rng = np.random.default_rng(0)
    order = [int(t) for t in rng.permutation(N)]
    adj = {order[0]: [N], order[1]: [N], order[2]: [N], N: order[:3]}
    nxt = N + 1
    for t in order[3:]:
        layout = pars._partial_layout(adj, order[0], N)
        present = [v for v in adj if v < N]
        post, pre = pars.walk_orders(layout, present)
        val = np.zeros((2 * N, tips.shape[1]), np.uint32)
        val[:N] = tips
        for v, a, b in post:
            val[v] = fitch(val[a], val[b])
        rest = np.zeros_like(val)
        cost = np.zeros(2 * N)
        for v, par, sib in pre:
            rest[v] = fitch(np.full_like(val[0], full) if par < 0 else rest[par],
                            val[sib])
            cost[v] = aln.pattern_freq[(tips[t] & (val[v] | rest[v])) == 0].sum()
        want = pars.insertion_costs(torch.as_tensor(masks), None,
                                    torch.as_tensor(aln.pattern_freq), t, layout,
                                    present, None)
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
    # past 32 states a set's two mask words share one 64-bit kernel word,
    # word 0 in the low half and word 1 in the high half
    two = torch.as_tensor(rng.integers(-2**31, 2**31, (4, 2, 5)), dtype=torch.int32)
    w64 = pars.kernel_tip_words(two, 61)
    assert w64.dtype == torch.int64 and w64.shape == (4, 5)
    halves = w64.numpy().view(np.int32).reshape(4, 5, 2)  # little-endian
    np.testing.assert_array_equal(halves.transpose(0, 2, 1), two.numpy())


def test_protein_hill_climb_matches_jax():
    """Both engines in float64 from the same 4-NNI-perturbed tree: the same
    climbed topology and lnL."""
    (_, jm, js), (_, tm, ts), tree, _, _, _ = protein_workload("LG+G", seed=3)
    rng = np.random.default_rng(0)
    start = tree.copy()
    for _ in range(4):
        e = start.internal_edges()
        start.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
    want = JNNIEngine(jm, js, dtype=jnp.float64, fused=False).hill_climb(start.copy())
    visited = []
    engine = NNIEngine(tm, ts)
    got = engine.hill_climb(convert.phylo_tree(start),
                            on_tree=lambda t, l: visited.append(l))
    assert got.tree.robinson_foulds(jax_view(want.tree)) == 0
    assert abs(got.lnl - want.lnl) < 1e-6, (got.lnl, want.lnl)
    assert len(visited) == got.steps and got.nni_count == want.nni_count


def test_protein_search_banner_and_engine():
    """decide_engine serves the protein search at the size of
    bench_data_protein.npz and accounts up and out; the banner names the
    path."""
    dec = decide_engine(300, 4, 20, 1958, CPU, torch.float64, search=True)
    assert dec.store_bytes == 600 * 81 * 1958 * 8 * 2
    text = engine_banner(dec, 300, 4, 20, 1958, search=True)
    assert "plain twin of the outside-partial store" in text
    assert "of 297 internal edges" in text


def test_cli_protein_search_on_cpu(tmp_path):
    """`-s prot_M126_27_269.phy -m LG+G -n 1 -device cpu` through the CLI
    (the initial candidate set cut to 2 trees for time): the three outputs,
    and the logged score confirmed by the JAX package's likelihood."""
    prefix = str(tmp_path / "prot")
    assert cli_main(["-s", PROT, "-m", "LG+G", "-n", "1", "-ninit", "2", "-ntop", "1",
                     "-device", "cpu", "-pre", prefix]) == 0
    for ext in (".treefile", ".iqtree", ".log"):
        assert os.path.getsize(prefix + ext) > 0, ext
    with open(prefix + ".log") as f:
        log = f.read()
    assert "plain twin of the outside-partial store" in log
    lnl = float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1))
    model = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    with open(prefix + ".treefile") as f:
        nwk = f.read().strip()
    assert nwk.count(",") == 26
    assert abs(jax_lnl(PROT, nwk, model) - lnl) < 1e-3, (lnl, model)
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert f"Log-likelihood of the tree: {lnl:.4f}" in report
    assert "amino-acid sites" in report
