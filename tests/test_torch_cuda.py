"""The CUDA kernels against their plain twins, on the card.

These tests import nothing of JAX, so they run on a machine that has only
PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_cuda.py -m cuda -q

Without a CUDA device they skip.  Inputs: a random 40-taxon DNA alignment
(700 sites, a numpy seed), GTR+G4+I, and for the wide kernels a random
30-taxon protein alignment (300 sites), LG+G4+I, and for the codon
instances (S=64) a random 24-taxon codon alignment (101 codons) under
genetic codes 1, 2 and 6, GY+F3X4+I+G (the parsimony kernel's 64-bit
instance: 36 taxa x 150 codons).  Tolerances are float32 ones: the
kernels and the twins sum in different orders.  Fourteen tests hold
kernels' bits against their earlier designs, built from the csrc/ directory
that IQT_EARLIER_CSRC names; they skip without it.  The wide walks' DNA
instances past 8 categories (S=4) run on the 33-taxon DNA alignments of
_lane_case at C = 9, 10, 16 and 32.  Binary data (S=2: the CS-packed
kernels' S=2 instances, and the S=4 walks past 8 categories) and
morphology (3, 6 and 21 states, zero-padded to the S=4, S=20 and S=64
instances) run on random 33-taxon alignments (_states_case).
"""

import contextlib

import numpy as np
import pytest
import torch

from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.kernels import cs_kernels, pruning
from iqtree_torch.engine.likelihood import (
    ModelArrays,
    SiteData,
    TreeArrays,
    branch_transition_mats,
    compute_loglik,
    ptn_invar,
    tip_partials,
)
from iqtree_torch.io.alignment import Alignment
from iqtree_torch.models.dna import create_dna_model
from iqtree_torch.models.factory import parse_model_string
from iqtree_torch.models.rates import RateModel
from iqtree_torch.trees.tree import random_tree


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    n = 40
    seqs = ["".join(rng.choice(list("ACGT-"), 700)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "DNA")
    subst = create_dna_model("GTR")
    subst.state_freq = aln.state_frequencies()
    subst.set_rate_param_vector(rng.uniform(0.5, 3.0, 5))
    rate = RateModel.make(gamma_cats=4, invar=True, p_invar=0.1, alpha=0.6)
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    return dict(tree=ta, model=ModelArrays.from_model(subst, rate, dev),
                site=SiteData.from_alignment(aln, dev, torch.float32),
                steps=torch.as_tensor(steps, device=dev), n_slots=n_slots, host=tree)


@pytest.mark.cuda
def test_kernels_match_twins_on_card(card):
    ta, model, site = card["tree"], card["model"], card["site"]
    st, ns = card["steps"], card["n_slots"]
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    lnl = pruning.fused_site_lnl(st, ns, trans, tips, props, freq, inv)
    torch.testing.assert_close(
        lnl, pruning._site_lnl_plain(st, trans, tips, props, freq, inv),
        rtol=1e-5, atol=1e-4)
    up, usc = cs_kernels.fused_upward_store_cs(st, ns, trans, tips)
    up_p, usc_p = pruning.upward_plain(st, trans, tips)
    inner = slice(ta.n_taxa, 2 * ta.n_taxa - 1)
    torch.testing.assert_close(up[inner], up_p[inner], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(usc[inner], usc_p[inner], rtol=1e-5, atol=1e-4)
    cs_kernels.fill_tip_rows_cs(up, usc, tips, 4)
    wp = site.pattern_freq.contiguous()
    tb = cs_kernels.fused_tbar_cs(st, ns, trans, tips, props, freq, lnl, wp,
                                  up=up, usc=usc)
    tb_p = cs_kernels._tbar_plain(st, trans, props, freq, lnl, wp, up, usc)
    torch.testing.assert_close(tb, tb_p, rtol=1e-4,
                               atol=1e-4 * float(tb_p.abs().max()))
    mats = cs_kernels.stacked_deriv_mats(model, ta.blen).float().contiguous()
    got = cs_kernels.newton_sweep(st, ns, mats, props, freq, wp, inv, up, usc)
    want = cs_kernels._newton_plain(st, mats, props, freq, wp, inv, up, usc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
def test_gradient_on_card_matches_plain_autograd(card):
    """The kernel-backed autograd.Function against autograd through the
    plain pass, both with float32 partials on the card."""
    ta, model, site = card["tree"], card["model"], card["site"]
    fields = ("eigenvalues", "eigvec", "inv_eigvec", "state_freq", "rates",
              "props", "p_invar")

    def grads(fn):
        leaves = [ta.blen.clone().requires_grad_()]
        leaves += [getattr(model, f).clone().requires_grad_() for f in fields]
        total, _ = fn(ta.with_blen(leaves[0]), ModelArrays(*leaves[1:]))
        return torch.autograd.grad(total, leaves)

    got = grads(lambda t, m: loglik(t, m, site, card["steps"], card["n_slots"]))
    want = grads(lambda t, m: compute_loglik(t, m, site))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))


@pytest.mark.cuda
def test_down_store_and_nni_evaluator_on_card(card):
    """The outside-partial store kernel against its twin, and the NNI
    evaluator on the kernels' passes against the twins' passes: float32
    both, so the paired deltas (whose shared per-edge bias cancels) are
    compared."""
    from iqtree_torch.engine.nni import evaluate_nnis

    ta, model, site = card["tree"], card["model"], card["site"]
    st, ns = card["steps"], card["n_slots"]
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site)
    freq = model.state_freq.float()
    up, usc, out, osc = cs_kernels.fused_nni_passes_cs(st, ns, trans, tips, freq)
    launches = cs_kernels.fused_down_store_cs.launches
    out_p, osc_p = cs_kernels._down_store_plain(st, trans, up, usc, freq)
    assert cs_kernels.fused_down_store_cs.launches == launches
    rows = [v for v in range(2 * ta.n_taxa - 1) if v != ta.root]
    torch.testing.assert_close(out[rows], out_p[rows], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(osc[rows], osc_p[rows], rtol=1e-5, atol=1e-4)
    parent = ta.parent.cpu().numpy()
    edges = np.array([v for v in range(ta.n_taxa, ta.root) if parent[v] != ta.root])
    up_p, usc_p = pruning.upward_plain(st, trans, tips)
    cs_kernels.fill_tip_rows_cs(up_p, usc_p, tips, 4)
    plain = (up_p, usc_p, *cs_kernels._down_store_plain(st, trans, up_p, usc_p, freq))
    with torch.no_grad():
        got = evaluate_nnis(ta, model, site, edges, st, ns, paired=True)
        want = evaluate_nnis(ta, model, site, edges, st, ns, paired=True,
                             passes=plain)
    torch.testing.assert_close(got.lnl - got.base_lnl[:, None],
                               want.lnl - want.base_lnl[:, None], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_parsimony_kernel_builds_the_plain_twins_tree():
    """Stepwise addition with the insertion-cost kernel on the card and with
    its plain twin on the CPU: integer costs, so the same draws and the
    same tree."""
    from iqtree_torch.engine import parsimony as pars

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(5)
    n = 40
    seqs = ["".join(rng.choice(list("ACGT-"), 300)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "DNA")
    before = pars.insertion_costs.launches
    got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1),
                                       torch.device("cuda"))
    assert pars.insertion_costs.launches - before == n - 3
    want = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1),
                                        torch.device("cpu"))
    np.testing.assert_array_equal(got.children, want.children)
    np.testing.assert_array_equal(got.blen, want.blen)


@pytest.fixture
def protein_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(22)
    n = 30
    seqs = ["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV-XB"), 300)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "AA")
    subst, rate = parse_model_string("LG+I+G", aln)
    rate.p_invar, rate.alpha = 0.1, 0.6
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    return dict(tree=ta, model=ModelArrays.from_model(subst, rate, dev),
                site=SiteData.from_alignment(aln, dev, torch.float32),
                steps=torch.as_tensor(steps, device=dev), n_slots=n_slots)


@pytest.mark.cuda
def test_wide_kernels_match_twins_on_card(protein_card):
    """The four wide kernels (S=20) against their twins, each launched."""
    ta, model, site = protein_card["tree"], protein_card["model"], protein_card["site"]
    st, ns = protein_card["steps"], protein_card["n_slots"]
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    wrappers = (pruning.wide_site_lnl, pruning.fused_upward_store,
                cs_kernels.fused_downward_tbar, cs_kernels.wide_newton_sweep)
    before = [w.launches for w in wrappers]
    want = pruning._site_lnl_plain(st, trans, tips, props, freq, inv)
    for tile in (16, 32, 64):  # patterns a cluster (whole warps from 16 on)
        lnl = pruning.fused_site_lnl(st, ns, trans, tips, props, freq, inv, tile=tile)
        torch.testing.assert_close(lnl, want, rtol=1e-5, atol=1e-4)
    up, usc = pruning.fused_upward_store(st, ns, trans, tips)
    up_p, usc_p = pruning.upward_plain(st, trans, tips)
    inner = slice(ta.n_taxa, 2 * ta.n_taxa - 1)
    torch.testing.assert_close(up[inner], up_p[inner], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(usc[inner], usc_p[inner], rtol=1e-5, atol=1e-4)
    cs_kernels.fill_tip_rows_cs(up, usc, tips, 4)
    wp = site.pattern_freq.contiguous()
    tb = cs_kernels.fused_downward_tbar(st, ns, trans, tips, props, freq, lnl, wp,
                                        up=up, usc=usc)
    tb_p = cs_kernels._tbar_plain(st, trans, props, freq, lnl, wp, up, usc)
    torch.testing.assert_close(tb, tb_p, rtol=1e-4,
                               atol=1e-4 * float(tb_p.abs().max()))
    mats = cs_kernels.stacked_deriv_mats(model, ta.blen).float().contiguous()
    got = cs_kernels.wide_newton_sweep(st, ns, mats, props, freq, wp, inv, up, usc)
    want = cs_kernels._newton_plain(st, mats, props, freq, wp, inv, up, usc)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))
    assert [w.launches - b for w, b in zip(wrappers, before)] == [3, 1, 1, 1]


@pytest.mark.cuda
def test_wide_gradient_on_card_matches_plain_autograd(protein_card):
    """The kernel-backed gradient at S=20 against autograd through the
    plain pass, both with float32 partials on the card."""
    ta, model, site = protein_card["tree"], protein_card["model"], protein_card["site"]
    fields = ("eigenvalues", "eigvec", "inv_eigvec", "state_freq", "rates",
              "props", "p_invar")

    def grads(fn):
        leaves = [ta.blen.clone().requires_grad_()]
        leaves += [getattr(model, f).clone().requires_grad_() for f in fields]
        total, _ = fn(ta.with_blen(leaves[0]), ModelArrays(*leaves[1:]))
        return torch.autograd.grad(total, leaves)

    before = cs_kernels.fused_downward_tbar.launches
    got = grads(lambda t, m: loglik(t, m, site, protein_card["steps"],
                                    protein_card["n_slots"]))
    assert cs_kernels.fused_downward_tbar.launches == before + 1
    want = grads(lambda t, m: compute_loglik(t, m, site))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("tile, part_blocks", [(16, 1), (16, 2), (32, 2), (32, 6),
                                               (32, 7), (64, 4), (64, 8)])
def test_wide_tbar_in_chunks_of_blocks_matches_twin(protein_card, tile, part_blocks):
    """The gradient sweep with per-16-pattern part rows for fewer rows than
    the sweep has: the kernel runs in chunks of whole clusters (`tile`
    patterns, tile / 16 rows each; 7 rows at 32 rounds down to 3 clusters),
    the last chunk ragged where a chunk holds more than one cluster, and
    adds each chunk's rows onto the earlier ones."""
    ta, model, site = protein_card["tree"], protein_card["model"], protein_card["site"]
    st, ns = protein_card["steps"], protein_card["n_slots"]
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    lnl = pruning.fused_site_lnl(st, ns, trans, tips, props, freq, inv)
    up, usc = pruning.fused_upward_store(st, ns, trans, tips)
    cs_kernels.fill_tip_rows_cs(up, usc, tips, 4)
    wp = site.pattern_freq.contiguous()
    clusters = -(-tips.shape[2] // tile)
    chunk = part_blocks // (tile // cs_kernels.WIDE_TBAR_SUM_PATTERNS)
    assert clusters > chunk and (chunk == 1 or clusters % chunk)
    tb = cs_kernels.fused_downward_tbar(st, ns, trans, tips, props, freq, lnl, wp,
                                        up=up, usc=usc, tile=tile,
                                        part_blocks=part_blocks)
    tb_p = cs_kernels._tbar_plain(st, trans, props, freq, lnl, wp, up, usc)
    torch.testing.assert_close(tb, tb_p, rtol=1e-4,
                               atol=1e-4 * float(tb_p.abs().max()))


@pytest.mark.cuda
def test_wide_down_store_and_nni_evaluator_on_card(protein_card):
    """The wide outside-partial store (S=20) against its twin, and the NNI
    evaluator on the kernels' passes against the twins' passes (paired
    deltas, float32 both)."""
    from iqtree_torch.engine.nni import evaluate_nnis

    ta, model, site = protein_card["tree"], protein_card["model"], protein_card["site"]
    st, ns = protein_card["steps"], protein_card["n_slots"]
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site)
    freq = model.state_freq.float()
    before = (cs_kernels.fused_down_store.launches, cs_kernels.fused_down_store_cs.launches)
    up, usc, out, osc = cs_kernels.fused_nni_passes_cs(st, ns, trans, tips, freq)
    assert (cs_kernels.fused_down_store.launches - before[0],
            cs_kernels.fused_down_store_cs.launches - before[1]) == (1, 0)
    out_p, osc_p = cs_kernels._down_store_plain(st, trans, up, usc, freq)
    rows = [v for v in range(2 * ta.n_taxa - 1) if v != ta.root]
    torch.testing.assert_close(out[rows], out_p[rows], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(osc[rows], osc_p[rows], rtol=1e-5, atol=1e-4)
    assert not bool(out[ta.root].any()) and not bool(osc[2 * ta.n_taxa - 1].any())
    for tile in (32, 64):  # patterns a cluster beside the default's (whole warps)
        o_t, s_t = cs_kernels.fused_down_store(st, ns, trans, up, usc, freq, tile=tile)
        torch.testing.assert_close(o_t[rows], out_p[rows], rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(s_t[rows], osc_p[rows], rtol=1e-5, atol=1e-4)
    parent = ta.parent.cpu().numpy()
    edges = np.array([v for v in range(ta.n_taxa, ta.root) if parent[v] != ta.root])
    up_p, usc_p = pruning.upward_plain(st, trans, tips)
    cs_kernels.fill_tip_rows_cs(up_p, usc_p, tips, 4)
    plain = (up_p, usc_p, *cs_kernels._down_store_plain(st, trans, up_p, usc_p, freq))
    with torch.no_grad():
        got = evaluate_nnis(ta, model, site, edges, st, ns, paired=True)
        want = evaluate_nnis(ta, model, site, edges, st, ns, paired=True,
                             passes=plain)
    torch.testing.assert_close(got.lnl - got.base_lnl[:, None],
                               want.lnl - want.base_lnl[:, None], rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_parsimony_kernel_32bit_sets_match_the_twin():
    """The insertion-cost kernel's 32-bit instance (protein, 20 states plus
    ambiguity codes): the same costs as the plain twin at every insertion,
    so the same stepwise-addition tree."""
    from iqtree_torch.engine import parsimony as pars

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(6)
    n = 40
    seqs = ["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV-XBZ"), 300)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "AA")
    dev = torch.device("cuda")
    words = pars.kernel_tip_words(torch.as_tensor(pars.pack_tip_masks(aln), device=dev),
                                  20)
    assert words.dtype == torch.int32
    before = pars.insertion_costs.launches
    got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1), dev)
    assert pars.insertion_costs.launches - before == n - 3
    want = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1),
                                        torch.device("cpu"))
    np.testing.assert_array_equal(got.children, want.children)
    np.testing.assert_array_equal(got.blen, want.blen)


@pytest.mark.cuda
@pytest.mark.parametrize("code", [1, 2, 6])
def test_parsimony_kernel_64bit_sets_match_the_twin(code):
    """The insertion-cost kernel's 64-bit instance (codons: 60, 61 or 63
    states and gaps, the masks' two 32-bit words in one lane): the same
    costs as the plain twin at every insertion, exactly, so the same
    stepwise-addition tree."""
    from iqtree_torch.engine import parsimony as pars
    from iqtree_torch.models.codon import NT_ORDER, sense_codons

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(60 + code)
    n = 36
    sc = sense_codons(code)
    words = [NT_ORDER[c // 16] + NT_ORDER[(c // 4) % 4] + NT_ORDER[c % 4] for c in sc]
    seqs = ["".join("---" if rng.random() < 0.05 else words[rng.integers(len(words))]
                    for _ in range(150)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "CODON", code)
    dev = torch.device("cuda")
    masks = torch.as_tensor(pars.pack_tip_masks(aln))
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64)
    tipsw = pars.kernel_tip_words(masks.to(dev), aln.num_states)
    scratch = pars.kernel_scratch(tipsw, freq.to(dev), aln.num_states)
    assert tipsw.dtype == torch.int64 and pars.lane_bits(tipsw, scratch[1]) == 64
    order = [int(t) for t in rng.permutation(n)]
    adj = {order[0]: [n], order[1]: [n], order[2]: [n], n: order[:3]}
    nxt = n + 1
    for t in order[3:]:
        layout = pars._partial_layout(adj, order[0], n)
        present = [v for v in adj if v < n]
        got = pars.insertion_costs(masks.to(dev), tipsw, freq.to(dev), t, layout,
                                   present, scratch)
        want = pars.insertion_costs(masks, None, freq, t, layout, present, None)
        np.testing.assert_array_equal(got, want)
        v_old = layout[0][int(np.argmin(want))]
        p_old = pars._adj_parent(adj, order[0], v_old)
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old].append(nxt)
        adj[p_old].append(nxt)
        adj[nxt] = [v_old, p_old, t]
        adj[t] = [nxt]
        nxt += 1
    before = pars.insertion_costs.launches
    got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1), dev)
    assert pars.insertion_costs.launches - before == n - 3
    want = pars.parsimony_stepwise_tree(aln, np.random.default_rng(1),
                                        torch.device("cpu"))
    np.testing.assert_array_equal(got.children, want.children)
    np.testing.assert_array_equal(got.blen, want.blen)


@pytest.mark.cuda
def test_multi_tree_kernel_matches_twin_on_card(card):
    """The multi-tree kernel at K=1 (a plain schedule) and K=5 (a chain of
    NNIs from the fixture's tree) against the single-tree twin, and the
    multi-tree totals against forward.cu's."""
    model, site, dev = card["model"], card["site"], torch.device("cuda")
    rng = np.random.default_rng(3)
    trees = [card["host"]]
    for _ in range(4):
        t = trees[-1].copy()
        e = t.internal_edges()
        t.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
        trees.append(t)
    pairs = [(t, TreeArrays.from_tree(t, dev)) for t in trees]
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    trans = [branch_transition_mats(model, ta.blen).float().contiguous()
             for _, ta in pairs]
    scheds = [pruning.device_slot_schedule(t, ta) for t, ta in pairs]
    want = torch.stack([
        pruning._site_lnl_plain(torch.as_tensor(s, device=dev), tr, tips, props, freq,
                                inv) for (s, _), tr in zip(scheds, trans)])
    before = pruning.fused_site_lnl_cs_stream.launches
    got1 = pruning.fused_site_lnl_cs_stream(card["steps"], card["n_slots"], trans[0],
                                            tips, props, freq, inv)
    torch.testing.assert_close(got1, want[0], rtol=1e-5, atol=1e-4)
    sk, sg, n_slots, roots = pruning.multi_tree_schedule(pairs)
    on = lambda a: torch.as_tensor(a, device=dev)
    got = pruning.fused_site_lnl_cs_stream(on(sk), n_slots, torch.cat(trans), tips,
                                           props, freq, inv, roots=on(roots),
                                           gather_steps=on(sg))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    totals = pruning.fused_multi_tree_lnl(pairs, model, site)
    singles = torch.stack([pruning.fused_compute_loglik(ta, model, site, on(s), ns)[0]
                           for (_, ta), (s, ns) in zip(pairs, scheds)])
    torch.testing.assert_close(totals, singles, rtol=0, atol=1e-2)
    assert pruning.fused_site_lnl_cs_stream.launches == before + 3


@pytest.mark.cuda
def test_ablation_variants_match_twins_on_card(card):
    """The ablation variants of the forward kernel against their twins, on
    random trans and tips uniform in [0, 1).  The precision variants' twins
    sum the exact bfloat16 products in the kernel's order, so each kernel
    also lies within a tenth of its twin's distance from the kernel's
    `full`: a kernel that skipped its passes fails."""
    from iqtree_torch.engine.kernels import ablate

    n = card["tree"].n_taxa
    rng = np.random.default_rng(4)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device="cuda")
    trans = f32(rng.random((2 * n, 4, 4, 4)))
    tips = f32(rng.random((n, 4, 700)))
    before = ablate.forward_ablation.launches
    full = ablate.forward_ablation("full", card["steps"], card["n_slots"], trans, tips)
    for v in ablate.VARIANTS:
        got = ablate.forward_ablation(v, card["steps"], card["n_slots"], trans, tips)
        want = ablate.ablation_plain(v, card["steps"], trans, tips)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
        if v in ablate.PASSES:
            gap = float((want - full).abs().max())
            assert gap > 0
            assert float((got - want).abs().max()) <= gap / 10
    assert ablate.forward_ablation.launches == before + len(ablate.VARIANTS) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 4, 8])
def test_newton_lanes_match_twin_at_every_category_count(C):
    """The branch-Newton kernel's lane layout (C rounded up to a power of
    two lanes a pattern, idle lanes at C = 3) at an odd pattern count:
    within 1e-4 of the twin, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(30 + C)
    n = 33
    seqs = ["".join(rng.choice(list("ACGT-"), 301)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "DNA")
    assert aln.n_patterns % 2 == 1
    subst, rate = parse_model_string("GTR+I" + (f"+G{C}" if C > 1 else ""), aln)
    rate.p_invar = 0.1
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=dev)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    up, usc = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    cs_kernels.fill_tip_rows_cs(up, usc, tips, C)
    mats = cs_kernels.stacked_deriv_mats(model, ta.blen).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    wp = site.pattern_freq.contiguous()
    before = cs_kernels.newton_sweep.launches
    got = cs_kernels.newton_sweep(steps, n_slots, mats, props, freq, wp, inv, up, usc)
    again = cs_kernels.newton_sweep(steps, n_slots, mats, props, freq, wp, inv, up, usc)
    assert cs_kernels.newton_sweep.launches == before + 2
    want = cs_kernels._newton_plain(steps, mats, props, freq, wp, inv, up, usc)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4 * float(w.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 3, 4, 8])
def test_forward_and_store_lanes_match_twin_at_every_category_count(C):
    """The upward kernels' lane layout (C rounded up to a power of two lanes
    a pattern, idle lanes at C = 3) at an odd pattern count, with a ragged
    last block at every C: forward and store within the float32
    tolerances of test_kernels_match_twins_on_card, and two launches of
    each bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(40 + C)
    n = 33
    seqs = ["".join(rng.choice(list("ACGT-"), 301)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "DNA")
    assert aln.n_patterns % 2 == 1
    subst, rate = parse_model_string("GTR+I" + (f"+G{C}" if C > 1 else ""), aln)
    rate.p_invar = 0.1
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=dev)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    f_before = pruning.fused_site_lnl.launches
    s_before = cs_kernels.fused_upward_store_cs.launches
    lnl = pruning.fused_site_lnl(steps, n_slots, trans, tips, props, freq, inv)
    again = pruning.fused_site_lnl(steps, n_slots, trans, tips, props, freq, inv)
    up, usc = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    up2, usc2 = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    assert pruning.fused_site_lnl.launches == f_before + 2
    assert cs_kernels.fused_upward_store_cs.launches == s_before + 2
    assert torch.equal(lnl, again)
    inner = slice(n, 2 * n - 1)
    assert torch.equal(up[inner], up2[inner]) and torch.equal(usc, usc2)
    torch.testing.assert_close(
        lnl, pruning._site_lnl_plain(steps, trans, tips, props, freq, inv),
        rtol=1e-5, atol=1e-4)
    up_p, usc_p = pruning.upward_plain(steps, trans, tips)
    torch.testing.assert_close(up[inner], up_p[inner], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(usc[inner], usc_p[inner], rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("alphabet", ["ACGT-", "ARNDCQEGHILKMFPSTWYV-X"])
def test_parsimony_kernel_costs_equal_twin_at_ragged_patterns(alphabet):
    """Every insertion of a stepwise-addition tree at a pattern count that
    is not a multiple of 8 (a partial last word of 4-bit sets): the
    kernel's costs equal the twin's exactly, DNA and 32-bit sets."""
    from iqtree_torch.engine import parsimony as pars

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    rng = np.random.default_rng(len(alphabet))
    n = 24
    seqs = ["".join(rng.choice(list(alphabet), 203)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs,
                                   "DNA" if len(alphabet) == 5 else "AA")
    assert aln.n_patterns % 8
    masks = torch.as_tensor(pars.pack_tip_masks(aln))
    freq = torch.as_tensor(aln.pattern_freq, dtype=torch.float64)
    words = pars.kernel_tip_words(masks.to(dev), aln.num_states)
    scratch = pars.kernel_scratch(words, freq.to(dev), aln.num_states)
    order = [int(t) for t in rng.permutation(n)]
    adj = {order[0]: [n], order[1]: [n], order[2]: [n], n: order[:3]}
    nxt = n + 1
    for t in order[3:]:
        layout = pars._partial_layout(adj, order[0], n)
        present = [v for v in adj if v < n]
        got = pars.insertion_costs(masks.to(dev), words, freq.to(dev), t, layout,
                                   present, scratch)
        want = pars.insertion_costs(masks, None, freq, t, layout, present, None)
        np.testing.assert_array_equal(got, want)
        v_old = layout[0][int(np.argmin(want))]
        p_old = pars._adj_parent(adj, order[0], v_old)
        adj[v_old].remove(p_old)
        adj[p_old].remove(v_old)
        adj[v_old].append(nxt)
        adj[p_old].append(nxt)
        adj[nxt] = [v_old, p_old, t]
        adj[t] = [nxt]
        nxt += 1


def _lane_case(C, seed, alphabet="ACGT-", n=33, sites=301):
    """A random alignment at an odd pattern count (so no block size divides
    it), a random tree and GTR+I+GC (LG+I+GC for amino acids) on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    dna = len(alphabet) == 5
    seqs = ["".join(rng.choice(list(alphabet), sites)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "DNA" if dna else "AA")
    assert aln.n_patterns % 2 == 1
    name = "GTR" if dna else "LG"
    subst, rate = parse_model_string(f"{name}+I" + (f"+G{C}" if C > 1 else ""), aln)
    rate.p_invar = 0.1
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=dev)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    up, usc = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    cs_kernels.fill_tip_rows_cs(up, usc, tips, C)
    return dict(ta=ta, model=model, site=site, steps=steps, n_slots=n_slots, trans=trans,
                up=up, usc=usc, freq=model.state_freq.float())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8])
def test_down_store_lanes_match_twin_at_every_category_count(C, monkeypatch):
    """The outside-partial store on the lane layout (a lane a pattern and
    category, a category's lanes over the block's patterns) at an odd
    pattern count: within 1e-4 of the twin (O absolutely, osc relative to
    its largest), the root and dummy rows 0, two launches bit-equal, and
    the same bits at 8 (C >= 3) and 64 patterns a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 50 + C)
    args = (k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"])
    before = cs_kernels.fused_down_store_cs.launches
    out, osc = cs_kernels.fused_down_store_cs(*args)
    out2, osc2 = cs_kernels.fused_down_store_cs(*args)
    assert cs_kernels.fused_down_store_cs.launches == before + 2
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    for patterns in (8, 64) if C >= 3 else (64,):
        monkeypatch.setattr(cs_kernels, "DOWN_STORE_PATTERNS", patterns)
        out2, osc2 = cs_kernels.fused_down_store_cs(*args)
        assert torch.equal(out, out2) and torch.equal(osc, osc2), patterns
    out_p, osc_p = cs_kernels._down_store_plain(k["steps"], k["trans"], k["up"], k["usc"],
                                                k["freq"])
    R = 2 * k["ta"].n_taxa
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max()
                 / osc_p[rows].abs().max()) <= 1e-4
    assert not bool(out[R - 2:].any()) and not bool(osc[R - 2:].any())


def _earlier_csrc():
    """The csrc/ directory that IQT_EARLIER_CSRC names (an earlier commit's
    `iqtree_torch/engine/kernels/csrc`, unpacked by `git archive`)."""
    import os

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    earlier = os.environ.get("IQT_EARLIER_CSRC")
    if not earlier:
        pytest.skip("needs IQT_EARLIER_CSRC: an earlier commit's csrc/ directory")
    return earlier


@contextlib.contextmanager
def _earlier_design(kernel, earlier):
    """The wrappers launch `kernel` as the sources in `earlier` build it."""
    from iqtree_torch.engine.kernels import build, probe

    built = build.library(kernel)
    build._libs[kernel] = probe.variant_libraries(kernel, earlier, names=["base"])["base"]
    try:
        yield
    finally:
        build._libs[kernel] = built


@pytest.mark.cuda
def test_down_store_gives_the_earlier_designs_bits():
    """At C = 4 the lane-layout store gives the thread-a-pattern store's
    bits on the same inputs (the earlier design from IQT_EARLIER_CSRC)."""
    earlier = _earlier_csrc()
    k = _lane_case(4, 54)
    args = (k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"])
    got = cs_kernels.fused_down_store_cs(*args)
    with _earlier_design("down_store", earlier):
        want = cs_kernels.fused_down_store_cs(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_wide_newton_gives_the_earlier_designs_bits():
    """At C = 4 the cluster sweep adds in the thread-per-row-group design's
    orders, so d1/d2 keep its bits on the same inputs, at 16 and 32
    patterns a cluster (the earlier design from IQT_EARLIER_CSRC)."""
    earlier = _earlier_csrc()
    k = _lane_case(4, 64, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    model, site = k["model"], k["site"]
    mats = cs_kernels.stacked_deriv_mats(model, k["ta"].blen).float().contiguous()
    args = (k["steps"], k["n_slots"], mats, model.props.float(), k["freq"],
            site.pattern_freq.contiguous(), ptn_invar(model, site).float().contiguous(),
            k["up"], k["usc"])
    got = [cs_kernels.wide_newton_sweep(*args, tile=t) for t in (16, 32)]
    with _earlier_design("wide_newton", earlier):
        want = cs_kernels.wide_newton_sweep(*args, tile=16)
    for g in got:
        assert torch.equal(g[0], want[0]) and torch.equal(g[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8])
def test_wide_newton_clusters_match_twin(C):
    """The wide branch-Newton sweep (a cluster of C blocks, one a category)
    at an odd pattern count, over its patterns a cluster: within 1e-4
    relative of the twin, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 60 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    model, site = k["model"], k["site"]
    mats = cs_kernels.stacked_deriv_mats(model, k["ta"].blen).float().contiguous()
    args = (k["steps"], k["n_slots"], mats, model.props.float(), k["freq"],
            site.pattern_freq.contiguous(), ptn_invar(model, site).float().contiguous(),
            k["up"], k["usc"])
    want = cs_kernels._newton_plain(*args[:1], *args[2:])
    before = cs_kernels.wide_newton_sweep.launches
    got = cs_kernels.wide_newton_sweep(*args)
    again = cs_kernels.wide_newton_sweep(*args)
    for g, a in zip(got, again):
        assert torch.equal(g, a)
    for tile in (16, 32, 64):
        for g, w in zip(cs_kernels.wide_newton_sweep(*args, tile=tile), want):
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
    assert cs_kernels.wide_newton_sweep.launches == before + 5


def _tbar_args(k):
    """fused_tbar_cs's arguments for a _lane_case: the forward kernel's lnL,
    the pattern weights; up/usc go by keyword."""
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    props = model.props.float()
    inv = ptn_invar(model, site).float().contiguous()
    lnl = pruning.fused_site_lnl(k["steps"], k["n_slots"], k["trans"], tips, props,
                                 k["freq"], inv)
    return (k["steps"], k["n_slots"], k["trans"], tips, props, k["freq"], lnl,
            site.pattern_freq.contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 2, 3, 4, 5, 6, 7, 8])
def test_tbar_lanes_match_twin_at_every_category_count(C):
    """The gradient sweep on the lane layout (a lane a pattern and category,
    C x 64 lanes a block, the category's ordered sums after its named
    barrier) at an odd pattern count, so the last block is ragged: within
    1e-4 relative of the twin, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 90 + C)
    args = _tbar_args(k)
    before = cs_kernels.fused_tbar_cs.launches
    got = cs_kernels.fused_tbar_cs(*args, up=k["up"], usc=k["usc"])
    again = cs_kernels.fused_tbar_cs(*args, up=k["up"], usc=k["usc"])
    assert cs_kernels.fused_tbar_cs.launches == before + 2
    assert torch.equal(got, again)
    want = cs_kernels._tbar_plain(k["steps"], k["trans"], *args[4:], k["up"], k["usc"])
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8])
def test_wide_forward_clusters_match_twin(C):
    """The wide forward kernel (a cluster of C blocks, one a category) at an
    odd pattern count, at 16, 32 and 64 patterns a cluster: within 1e-3 of
    the twin, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 100 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    model, site = k["model"], k["site"]
    args = (k["steps"], k["n_slots"], k["trans"], tip_partials(site).contiguous(),
            model.props.float(), k["freq"], ptn_invar(model, site).float().contiguous())
    want = pruning._site_lnl_plain(*args[:1], *args[2:])
    before = pruning.wide_site_lnl.launches
    got = pruning.wide_site_lnl(*args)
    assert torch.equal(got, pruning.wide_site_lnl(*args))
    for tile in (16, 32, 64):
        assert float((pruning.wide_site_lnl(*args, tile=tile) - want).abs().max()) <= 1e-3
    assert pruning.wide_site_lnl.launches == before + 5


@pytest.mark.cuda
def test_tbar_gives_the_earlier_designs_bits():
    """The lane-layout gradient sweep adds each block's 64 patterns in the
    thread-a-pattern design's order, so its cotangents keep that design's
    bits on the same inputs at C = 1, 3, 4 and 8 (the earlier design from
    IQT_EARLIER_CSRC)."""
    earlier = _earlier_csrc()
    cases = [_lane_case(C, 110 + C) for C in (1, 3, 4, 8)]
    args = [_tbar_args(k) for k in cases]
    got = [cs_kernels.fused_tbar_cs(*a, up=k["up"], usc=k["usc"])
           for k, a in zip(cases, args)]
    with _earlier_design("tbar", earlier):
        want = [cs_kernels.fused_tbar_cs(*a, up=k["up"], usc=k["usc"])
                for k, a in zip(cases, args)]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_wide_forward_gives_the_earlier_designs_bits():
    """The cluster walk keeps upward_step's arithmetic and the root mix its
    order, so the per-pattern lnL is the thread-per-row-group design's bit
    for bit at C = 1, 4 and 8, at 16, 32 and 64 patterns a cluster (the
    earlier design, at 16 patterns a block, from IQT_EARLIER_CSRC)."""
    earlier = _earlier_csrc()
    calls = []
    for C in (1, 4, 8):
        k = _lane_case(C, 120 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
        model, site = k["model"], k["site"]
        calls.append((k["steps"], k["n_slots"], k["trans"],
                      tip_partials(site).contiguous(), model.props.float(), k["freq"],
                      ptn_invar(model, site).float().contiguous()))
    got = [[pruning.wide_site_lnl(*a, tile=t) for t in (16, 32, 64)] for a in calls]
    with _earlier_design("wide_forward", earlier):
        want = [pruning.wide_site_lnl(*a, tile=16) for a in calls]
    for gs, w in zip(got, want):
        for g in gs:
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wide_store", "wide_tbar", "wide_down_store"])
def test_wide_row_group_kernels_keep_the_earlier_designs_bits(kernel):
    """At C = 4 the wide store, the outside-partial store and the gradient
    sweep on clusters (the two reverse sweeps on the walk they share in
    wide_common.cuh) give the earlier build's bits at 16, 32 and 64
    patterns a cluster (the earlier build, at 16 patterns a block or
    cluster, from IQT_EARLIER_CSRC)."""
    earlier = _earlier_csrc()
    k = _lane_case(4, 130, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    inner = slice(k["ta"].n_taxa, 2 * k["ta"].n_taxa - 1)  # the store leaves tip rows
    props = model.props.float()
    lnl = pruning._site_lnl_plain(k["steps"], k["trans"], tips, props, k["freq"],
                                  ptn_invar(model, site).float().contiguous())

    def run(tile):
        if kernel == "wide_store":
            up, usc = pruning.fused_upward_store(k["steps"], k["n_slots"], k["trans"], tips,
                                                 tile=tile)
            return up[inner], usc[inner]
        if kernel == "wide_down_store":
            return cs_kernels.fused_down_store(k["steps"], k["n_slots"], k["trans"], k["up"],
                                               k["usc"], k["freq"], tile=tile)
        return (cs_kernels.fused_downward_tbar(
            k["steps"], k["n_slots"], k["trans"], tips, props, k["freq"], lnl,
            site.pattern_freq.contiguous(), up=k["up"], usc=k["usc"], tile=tile),)

    got = [run(t) for t in (16, 32, 64)]
    with _earlier_design(kernel, earlier):
        want = run(16)
    for gt in got:
        for g, w in zip(gt, want):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_wide_tbar_clusters_match_twin(C, tile):
    """The wide gradient sweep (a cluster of C blocks, one a category, and a
    sum warp for each 16 patterns) at `tile` patterns a cluster and an odd
    pattern count (the last cluster ragged, at 64 with a group past the
    last pattern): the edges' rows within 1e-4 of the twin relative to its
    largest entry, the root and dummy rows 0 (the twin's dummy row reads
    the store's unwritten dummy partials), and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 160 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    args = _tbar_args(k)
    before = cs_kernels.fused_downward_tbar.launches
    got = cs_kernels.fused_downward_tbar(*args, up=k["up"], usc=k["usc"], tile=tile)
    again = cs_kernels.fused_downward_tbar(*args, up=k["up"], usc=k["usc"], tile=tile)
    assert cs_kernels.fused_downward_tbar.launches == before + 2
    assert torch.equal(got, again)
    want = cs_kernels._tbar_plain(k["steps"], k["trans"], *args[4:], k["up"], k["usc"])
    edges = 2 * k["ta"].n_taxa - 2  # the device numbering puts the root, then the dummy
    assert not bool(got[edges:].any())
    assert float((got[:edges] - want[:edges]).abs().max() / want[:edges].abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_wide_store_clusters_match_twin(C, tile):
    """The wide upward store (a cluster of C blocks, one a category, its rows
    copied from the pool a warp's 16 patterns at a time) at `tile` patterns
    a cluster and an odd pattern count (the last cluster ragged): the
    internal rows within 1e-4 of the twin (up absolutely, usc relative to
    its largest), the tip rows not written, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 140 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    tips = tip_partials(k["site"]).contiguous()
    N = k["ta"].n_taxa
    inner = slice(N, 2 * N - 1)
    up_p, usc_p = pruning.upward_plain(k["steps"], k["trans"], tips)
    before = pruning.fused_upward_store.launches
    up, usc = pruning.fused_upward_store(k["steps"], k["n_slots"], k["trans"], tips, tile=tile)
    up2, usc2 = pruning.fused_upward_store(k["steps"], k["n_slots"], k["trans"], tips,
                                           tile=tile)
    assert pruning.fused_upward_store.launches == before + 2
    assert torch.equal(up[inner], up2[inner]) and torch.equal(usc, usc2)
    assert float((up[inner] - up_p[inner]).abs().max()) <= 1e-4
    assert float((usc[inner] - usc_p[inner]).abs().max()
                 / usc_p[inner].abs().max()) <= 1e-4
    assert not bool(usc[:N].any())


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [16, 32, 64])
@pytest.mark.parametrize("C", [1, 4, 8])
def test_wide_down_store_clusters_match_twin(C, tile):
    """The wide outside-partial store (a cluster of C blocks, one a category,
    one cluster barrier a step) at `tile` patterns a cluster: within 1e-4
    of the twin (O absolutely, osc relative to its largest), the root and
    dummy rows 0, and two launches bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(C, 150 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    args = (k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"])
    before = cs_kernels.fused_down_store.launches
    out, osc = cs_kernels.fused_down_store(*args, tile=tile)
    out2, osc2 = cs_kernels.fused_down_store(*args, tile=tile)
    assert cs_kernels.fused_down_store.launches == before + 2
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    out_p, osc_p = cs_kernels._down_store_plain(k["steps"], k["trans"], k["up"], k["usc"],
                                                k["freq"])
    R = 2 * k["ta"].n_taxa
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max()
                 / osc_p[rows].abs().max()) <= 1e-4
    assert not bool(out[R - 2:].any()) and not bool(osc[R - 2:].any())


def _codon_case(C, code, seed, n=24, codons=101):
    """A random codon alignment under genetic code `code` (60 to 63 sense
    codons, a share of the triplets gaps) at an odd pattern count, a
    random tree and GY+F3X4+I+G(C) at kappa 2, omega 0.3, on the card."""
    from iqtree_torch.models.codon import NT_ORDER, sense_codons

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    sc = sense_codons(code)
    words = [NT_ORDER[c // 16] + NT_ORDER[(c // 4) % 4] + NT_ORDER[c % 4] for c in sc]
    seqs = ["".join("---" if rng.random() < 0.05 else words[rng.integers(len(words))]
                    for _ in range(codons)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs, "CODON", code)
    assert aln.n_patterns % 2 == 1 and aln.num_states == len(sc)
    subst, rate = parse_model_string("GY+F3X4+I" + (f"+G{C}" if C > 1 else ""), aln)
    subst.kappa, subst.omega = 2.0, 0.3
    subst.refresh_exchange()
    rate.p_invar = 0.1
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    return dict(ta=ta, model=model, site=site, steps=torch.as_tensor(steps, device=dev),
                n_slots=n_slots,
                trans=branch_transition_mats(model, ta.blen).float().contiguous(),
                tips=tip_partials(site).contiguous(), freq=model.state_freq.float())


@pytest.mark.cuda
@pytest.mark.parametrize("code", [1, 2, 6])
@pytest.mark.parametrize("C", [1, 3, 4, 8])
def test_codon_instances_match_twins(C, code):
    """The S=64 instances of the four wide kernels, a codon space of 61
    (code 1), 60 (code 2) or 63 (code 6) states zero-padded on the way in
    and sliced on the way out, against their twins: forward 1e-3 absolute,
    the store and the outside-partial store 1e-4 (partials absolutely,
    scales relative to the largest), the gradient sweep 1e-4 relative to
    its largest entry with its root and dummy rows 0; each two launches
    bit-equal, each launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _codon_case(C, code, 200 + 10 * code + C)
    steps, n_slots, trans, tips, freq = (k[x] for x in ("steps", "n_slots", "trans", "tips",
                                                         "freq"))
    model, site = k["model"], k["site"]
    N, R, S = k["ta"].n_taxa, 2 * k["ta"].n_taxa, trans.shape[2]
    inner = slice(N, 2 * N - 1)
    props, invar = model.props.float(), ptn_invar(model, site).float().contiguous()
    wrappers = (pruning.wide_site_lnl, pruning.fused_upward_store,
                cs_kernels.fused_down_store, cs_kernels.fused_downward_tbar)
    before = [w.launches for w in wrappers]

    f_args = (steps, n_slots, trans, tips, props, freq, invar)
    lnl = pruning.wide_site_lnl(*f_args)
    assert torch.equal(lnl, pruning.wide_site_lnl(*f_args))
    assert float((lnl - pruning._site_lnl_plain(steps, trans, tips, props, freq,
                                                invar)).abs().max()) <= 1e-3

    up, usc = pruning.fused_upward_store(steps, n_slots, trans, tips)
    up2, usc2 = pruning.fused_upward_store(steps, n_slots, trans, tips)
    assert up.shape == (R, C * S, tips.shape[2])
    assert torch.equal(up[inner], up2[inner]) and torch.equal(usc, usc2)
    up_p, usc_p = pruning.upward_plain(steps, trans, tips)
    assert float((up[inner] - up_p[inner]).abs().max()) <= 1e-4
    assert float((usc[inner] - usc_p[inner]).abs().max() / usc_p[inner].abs().max()) <= 1e-4

    cs_kernels.fill_tip_rows_cs(up, usc, tips, C)
    d_args = (steps, n_slots, trans, up, usc, freq)
    out, osc = cs_kernels.fused_down_store(*d_args)
    out2, osc2 = cs_kernels.fused_down_store(*d_args)
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    out_p, osc_p = cs_kernels._down_store_plain(steps, trans, up, usc, freq)
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max() / osc_p[rows].abs().max()) <= 1e-4

    wp = site.pattern_freq.contiguous()
    t_args = (steps, n_slots, trans, tips, props, freq, lnl, wp)
    tb = cs_kernels.fused_downward_tbar(*t_args, up=up, usc=usc)
    assert torch.equal(tb, cs_kernels.fused_downward_tbar(*t_args, up=up, usc=usc))
    want = cs_kernels._tbar_plain(steps, trans, props, freq, lnl, wp, up, usc)
    assert tb.shape == (R, C, S, S) and not bool(tb[R - 2:].any())
    assert float((tb[:R - 2] - want[:R - 2]).abs().max() / want[:R - 2].abs().max()) <= 1e-4
    assert [w.launches for w in wrappers] == [b + 2 for b in before]


@pytest.mark.cuda
def test_codon_fit_on_card(tmp_path):
    """`-st CODON -te ... -m GY+F3X4+G` through the CLI on the card: the four
    wide kernels launch at S=64, the branch-Newton kernels do not (the
    theta path), and the fit reaches the reference binary's GY+F3X4
    optimum's neighbourhood with +G4 on top."""
    import os
    import re

    from iqtree_torch.cli import main as cli_main

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    data = os.path.join(os.path.dirname(__file__), "data")
    wrappers = {"wide_forward": pruning.wide_site_lnl,
                "wide_store": pruning.fused_upward_store,
                "wide_tbar": cs_kernels.fused_downward_tbar,
                "wide_down_store": cs_kernels.fused_down_store,
                "wide_newton": cs_kernels.wide_newton_sweep,
                "newton": cs_kernels.newton_sweep}
    for w in wrappers.values():
        w.launches = 0
    prefix = str(tmp_path / "gy")
    assert cli_main(["-s", os.path.join(data, "example_codon.phy"), "-st", "CODON", "-te",
                     os.path.join(data, "ssf_golden.treefile"), "-m", "GY+F3X4+G",
                     "-pre", prefix]) == 0
    launches = {k: w.launches for k, w in wrappers.items()}
    assert all(launches[k] > 0 for k in list(wrappers)[:4]), launches
    assert launches["wide_newton"] == launches["newton"] == 0
    with open(prefix + ".log") as f:
        log = f.read()
    assert "S=61 (padded 64)" in log and "theta path" in log
    lnl = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    assert lnl >= -11142.814 - 0.2  # +G4 only adds to the binary's GY+F3X4 optimum


def _wide_launch_raw(kernel, k, fill):
    """One launch of a wide walk's C entry on outputs filled with `fill`
    (the wrappers' outputs start empty or zeroed): (up, usc) of wide_store,
    (out, osc) of wide_down_store."""
    from iqtree_torch.engine.kernels import build

    steps, n_slots, trans = k["steps"], k["n_slots"], k["trans"]
    n_rows, C, S = trans.shape[:3]
    P = k["up"].shape[2]
    a = torch.full((n_rows, C * S, P), fill, device=trans.device)
    b = torch.full((n_rows, P), fill, device=trans.device)
    if kernel == "wide_store":
        build.launch("wide_store", steps, steps.shape[0], trans,
                     tip_partials(k["site"]).contiguous(), P, a, b, C, S, n_slots,
                     pruning.WIDE_STORE_TILE)
    else:
        build.launch("wide_down_store", steps, steps.shape[0], trans, k["freq"].reshape(-1),
                     k["up"], k["usc"], P, a, b, C, S, n_slots,
                     cs_kernels.WIDE_DOWN_STORE_TILE)
    return a, b


def _upward_warp_counts(C, n_slots, S=20):
    """(slots, W): from the tree's n_slots up, the first slot count at which
    the upward walk's chooser takes each of its category warp counts W, as
    far as its block fits (a larger slot pool is valid: the walk leaves the
    extra slots unused)."""
    from iqtree_torch.engine.kernels import build

    out, seen = [], set()
    while True:
        w = pruning.wide_forward_warps(S, C, pruning.WIDE_FORWARD_TILE, n_slots)
        if pruning.wide_forward_smem(S, C, pruning.WIDE_FORWARD_TILE, n_slots,
                                     warps=w) > build.MAX_BLOCK_SMEM:
            return out
        if w not in seen:
            seen.add(w)
            out.append((n_slots, w))
        n_slots += 1


def _upward_raw(kernel, k, n_slots):
    """One launch of wide_forward's or wide_store's C entry at n_slots slots
    (the wrappers take the tree's): the lnL [P], or (up, usc) filled with
    NaN where the store writes nothing."""
    from iqtree_torch.engine.kernels import build

    steps, trans = k["steps"], k["trans"]
    n_rows, C, S = trans.shape[:3]
    tips = tip_partials(k["site"]).contiguous()
    P = tips.shape[2]
    if kernel == "wide_store":
        up = torch.full((n_rows, C * S, P), float("nan"), device=trans.device)
        usc = torch.full((n_rows, P), float("nan"), device=trans.device)
        build.launch("wide_store", steps, steps.shape[0], trans, tips, P, up, usc, C, S,
                     n_slots, pruning.WIDE_STORE_TILE)
        return up, usc
    model = k["model"]
    rootw = (model.props.float()[:, None] * k["freq"]).reshape(-1).contiguous()
    out = torch.empty(P, device=trans.device)
    build.launch("wide_forward", steps, steps.shape[0], trans, tips, P, rootw,
                 ptn_invar(model, k["site"]).float().contiguous(), out, C, S, n_slots,
                 pruning.WIDE_FORWARD_TILE)
    return (out,)


def _reverse_team_counts(C, n_slots, sums, S=20):
    """(slots, W): from the tree's n_slots up, the first slot count at which
    the reverse walk's chooser takes each of its category team counts W for
    wide_down_store (wide_tbar with `sums`), as far as the kernel's block
    fits (a larger slot pool is valid: the walk leaves the extra slots
    unused)."""
    from iqtree_torch.engine.kernels import build

    smem = cs_kernels.wide_tbar_smem if sums else cs_kernels.wide_down_store_smem
    out, seen = [], set()
    while True:
        w = cs_kernels.wide_reverse_teams(S, C, 16, n_slots, sums=sums)
        if smem(S, C, 16, n_slots, warps=w) > build.MAX_BLOCK_SMEM:
            return out
        if w not in seen:
            seen.add(w)
            out.append((n_slots, w))
        n_slots += 1


def _reverse_raw(kernel, k, n_slots, targs):
    """One launch of wide_down_store's or wide_tbar's C entry at n_slots
    slots (the wrappers take the tree's): (out, osc) filled with NaN where
    the outside store writes nothing, or (tbar,) from part rows of 16
    patterns in one chunk (targs: _tbar_args(k))."""
    from iqtree_torch.engine.kernels import build

    steps, trans = k["steps"], k["trans"]
    n_rows, C, S = trans.shape[:3]
    P = k["up"].shape[2]
    if kernel == "wide_down_store":
        out = torch.full((n_rows, C * S, P), float("nan"), device=trans.device)
        osc = torch.full((n_rows, P), float("nan"), device=trans.device)
        build.launch("wide_down_store", steps, steps.shape[0], trans,
                     k["freq"].reshape(-1).contiguous(), k["up"], k["usc"], P, out, osc, C, S,
                     n_slots, cs_kernels.WIDE_DOWN_STORE_TILE)
        return out, osc
    tile = cs_kernels.WIDE_TBAR_TILE
    blocks = -(-P // tile) * (tile // 16)
    part = torch.zeros(blocks, n_rows, C, S, S, device=trans.device)
    tbar = torch.empty(n_rows, C, S, S, device=trans.device)
    rootd = (k["model"].props.float()[:, None] * k["freq"]).reshape(-1).contiguous()
    build.launch("wide_tbar", steps, steps.shape[0], trans, rootd, targs[6].contiguous(),
                 targs[7], k["up"], k["usc"], P, n_rows, part, blocks, tbar, C, S, n_slots,
                 tile)
    return (tbar,)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [9, 12, 20, 40, 80, 240])
def test_wide_walks_past_eight_categories_match_twins(C):
    """The four wide walks with several categories a block (build.wide_layout:
    C = 9 and 20 leave a padding category in the last block; 40, 80 and 240
    are C10's, C20's and C60's counts, C60's 30 a block fitting shared
    memory at this tree's 3 slots) at an odd pattern count: the forward lnL within
    1e-3 of the twin, the store, the outside store and the gradient sweep
    within 1e-4 (as at C <= 8), two launches of each bit-equal, and no
    write outside the real categories' rows: the store leaves the tip and
    dummy rows as they were, the outside store the root and dummy rows.
    The upward walks also at every count of category warps their chooser
    takes as the slot pool grows, and the reverse walks at every count of
    category teams theirs takes (each count's launch as the C entry makes
    it): the same bits at each, twice."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.engine.kernels import build

    assert build.wide_layout(C)[1] > 1
    k = _lane_case(C, 200 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
    assert build.wide_walk_smem(C, 20, k["n_slots"]) <= build.MAX_BLOCK_SMEM
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    N = k["ta"].n_taxa
    R = 2 * N
    # forward
    args = (k["steps"], k["n_slots"], k["trans"], tips, model.props.float(), k["freq"],
            ptn_invar(model, site).float().contiguous())
    want = pruning._site_lnl_plain(*args[:1], *args[2:])
    got = pruning.wide_site_lnl(*args)
    assert torch.equal(got, pruning.wide_site_lnl(*args))
    assert float((got - want).abs().max()) <= 1e-3
    # upward store (k["up"] came from it, tip rows filled)
    up_p, usc_p = pruning.upward_plain(k["steps"], k["trans"], tips)
    up, usc = _wide_launch_raw("wide_store", k, float("nan"))
    inner = slice(N, R - 1)
    assert torch.equal(up[inner], k["up"][inner]) and torch.equal(usc[inner], k["usc"][inner])
    assert float((up[inner] - up_p[inner]).abs().max()) <= 1e-4
    assert float((usc[inner] - usc_p[inner]).abs().max() / usc_p[inner].abs().max()) <= 1e-4
    assert bool(up[:N].isnan().all()) and bool(up[R - 1].isnan().all())
    assert bool(usc[:N].isnan().all()) and bool(usc[R - 1].isnan().all())
    # the upward walks at every count of category warps
    counts = _upward_warp_counts(C, k["n_slots"])
    assert counts[0] == (k["n_slots"], pruning.wide_forward_warps(20, C, 16, k["n_slots"]))
    for n_slots, w in counts:
        for kernel in ("wide_forward", "wide_store"):
            lay = build.walk_launch(kernel, C, 20, n_slots, 16)
            assert lay["warps"] == w and lay["threads"] == 32 * w and lay["clusters"] > 0
            assert lay["smem"] == pruning.wide_forward_smem(20, C, 16, n_slots, warps=w)
        assert torch.equal(_upward_raw("wide_forward", k, n_slots)[0], got)
        assert torch.equal(_upward_raw("wide_forward", k, n_slots)[0], got)
        for _ in range(2):
            up_w, usc_w = _upward_raw("wide_store", k, n_slots)
            assert torch.equal(up_w[inner], up[inner]) and torch.equal(usc_w[inner], usc[inner])
            assert bool(up_w[:N].isnan().all()) and bool(usc_w[R - 1].isnan().all())
    # outside-partial store
    dargs = (k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"])
    out, osc = cs_kernels.fused_down_store(*dargs)
    out2, osc2 = cs_kernels.fused_down_store(*dargs)
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    out_p, osc_p = cs_kernels._down_store_plain(k["steps"], k["trans"], k["up"], k["usc"],
                                                k["freq"])
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max() / osc_p[rows].abs().max()) <= 1e-4
    raw, raw_sc = _wide_launch_raw("wide_down_store", k, float("nan"))
    assert torch.equal(raw[rows], out[rows]) and torch.equal(raw_sc[rows], osc[rows])
    assert bool(raw[R - 2:].isnan().all()) and bool(raw_sc[R - 2:].isnan().all())
    # gradient sweep
    targs = _tbar_args(k)
    tb = cs_kernels.fused_downward_tbar(*targs, up=k["up"], usc=k["usc"])
    assert torch.equal(tb, cs_kernels.fused_downward_tbar(*targs, up=k["up"], usc=k["usc"]))
    tb_p = cs_kernels._tbar_plain(k["steps"], k["trans"], *targs[4:], k["up"], k["usc"])
    edges = R - 2
    assert not bool(tb[edges:].any())
    assert float((tb[:edges] - tb_p[:edges]).abs().max() / tb_p[:edges].abs().max()) <= 1e-4
    # the reverse walks at every count of category teams
    for kernel, sums in (("wide_down_store", False), ("wide_tbar", True)):
        counts = _reverse_team_counts(C, k["n_slots"], sums)
        assert counts[0] == (k["n_slots"],
                             cs_kernels.wide_reverse_teams(20, C, 16, k["n_slots"], sums=sums))
        for n_slots, w in counts:
            lay = build.walk_launch(kernel, C, 20, n_slots, 16)
            smem = (cs_kernels.wide_tbar_smem if sums else cs_kernels.wide_down_store_smem)(
                20, C, 16, n_slots, warps=w)
            threads = cs_kernels.wide_tbar_threads(20, 16, w) if sums else 64 * w
            assert lay["warps"] == w and lay["threads"] == threads and lay["clusters"] > 0
            assert lay["smem"] == smem
            for _ in range(2):
                got = _reverse_raw(kernel, k, n_slots, targs)
                if sums:
                    assert torch.equal(got[0], tb), (kernel, n_slots, w)
                else:
                    assert torch.equal(got[0][rows], out[rows]), (kernel, n_slots, w)
                    assert torch.equal(got[1][rows], osc[rows]), (kernel, n_slots, w)
                    assert bool(got[0][R - 2:].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wide_down_store", "wide_tbar"])
def test_reverse_walks_past_eight_categories_give_the_earlier_designs_bits(kernel):
    """Past 8 categories the reverse walk on W category teams (and, in the
    gradient sweep, sums that lag a unit behind the walk) keeps the one-team
    walk's arithmetic for every category and the sums' part rows, so the
    outside partials and scales and the cotangents are the earlier build's
    bit for bit at C = 9, 20 and 80, at every count of category teams the
    chooser takes as the slot pool grows (the earlier build from
    IQT_EARLIER_CSRC, at the same slots)."""
    earlier = _earlier_csrc()
    for C in (9, 20, 80):
        k = _lane_case(C, 400 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
        targs = _tbar_args(k)
        counts = _reverse_team_counts(C, k["n_slots"], kernel == "wide_tbar")
        got = [_reverse_raw(kernel, k, n, targs) for n, _ in counts]
        with _earlier_design(kernel, earlier):
            want = [_reverse_raw(kernel, k, n, targs) for n, _ in counts]
        for (n, w), gs, ws in zip(counts, got, want):
            for g, v in zip(gs, ws):
                assert torch.equal(g.nan_to_num(-1.0), v.nan_to_num(-1.0)), (C, n, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["wide_forward", "wide_store"])
def test_upward_walks_past_eight_categories_give_the_earlier_designs_bits(kernel):
    """Past 8 categories the upward walk on W category warps keeps the
    one-warp walk's arithmetic for every category, so the forward lnL and
    the stored partials and scales are the earlier build's bit for bit at C
    = 9, 20 and 80, at every count of category warps the chooser takes as
    the slot pool grows (the earlier build from IQT_EARLIER_CSRC, at the
    same slots)."""
    earlier = _earlier_csrc()
    for C in (9, 20, 80):
        k = _lane_case(C, 300 + C, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=30, sites=301)
        counts = _upward_warp_counts(C, k["n_slots"])
        got = [_upward_raw(kernel, k, n) for n, _ in counts]
        with _earlier_design(kernel, earlier):
            want = [_upward_raw(kernel, k, n) for n, _ in counts]
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                assert torch.equal(g.nan_to_num(-1.0), w.nan_to_num(-1.0)), (C, kernel)


@pytest.mark.cuda
def test_wide_walks_refuse_what_their_shared_memory_cannot_hold():
    """C60's 240 categories take 30 a block: on a 100-taxon tree of 4 slots
    the slot pool and O's stage need more shared memory than a block may
    have, and the wrappers say so (no launch, no CPU fallback)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.engine.kernels import build

    k = _lane_case(8, 240, alphabet="ARNDCQEGHILKMFPSTWYV-X", n=100, sites=301)
    assert build.wide_walk_smem(240, 20, k["n_slots"]) > build.MAX_BLOCK_SMEM
    trans = k["trans"].repeat(1, 30, 1, 1).contiguous()  # 240 categories
    tips = tip_partials(k["site"]).contiguous()
    with pytest.raises(NotImplementedError, match="shared memory"):
        pruning.fused_upward_store(k["steps"], k["n_slots"], trans, tips)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [9, 10, 16, 32, 40])
def test_dna_walks_past_eight_categories_match_twins(C):
    """The four wide walks' DNA instances (S = 4, one row a thread, several
    categories a block; none up to 8, where build.packed serves) at C = 9
    and 10 (+R9, +R10; a padding category in the last block at 9), 16, 32
    and 40 (past the branch-Newton kernels: the theta path), on a 33-taxon
    DNA alignment at an odd pattern count: the engine's wrappers route them
    there (build.packed is False past 8), the forward lnL within 1e-3 of the
    twin, the store, the outside store and the gradient sweep within 1e-4,
    two launches of each bit-equal, and no write outside the real rows; at
    every count of category warps (teams) the choosers take as the slot
    pool grows, each count's launch as the C entry makes it, the same bits
    twice.  The forward also at a FreeRate vector from 1e-3 to 20."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.engine.kernels import build

    assert not build.packed(C, 4) and build.wide_layout(C)[1] > 1
    k = _lane_case(C, 500 + C)
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    N = k["ta"].n_taxa
    R = 2 * N
    inv = ptn_invar(model, site).float().contiguous()
    args = (k["steps"], k["n_slots"], k["trans"], tips, model.props.float(), k["freq"], inv)
    before = pruning.wide_site_lnl.launches
    got = pruning.fused_site_lnl(*args)
    assert pruning.wide_site_lnl.launches == before + 1  # the wide walk, not forward.cu
    assert torch.equal(got, pruning.wide_site_lnl(*args))
    assert float((got - pruning._site_lnl_plain(*args[:1], *args[2:])).abs().max()) <= 1e-3
    # rates from 1e-3 to 20: the clamp, the floor and the renormalization
    rates = torch.tensor(np.geomspace(1e-3, 20.0, C), device="cuda")
    extreme = ModelArrays(model.eigenvalues, model.eigvec, model.inv_eigvec,
                          model.state_freq, rates, model.props, model.p_invar)
    trans_x = branch_transition_mats(extreme, k["ta"].blen).float().contiguous()
    xargs = (k["steps"], k["n_slots"], trans_x, *args[3:])
    got_x = pruning.wide_site_lnl(*xargs)
    assert torch.equal(got_x, pruning.wide_site_lnl(*xargs))
    assert float((got_x - pruning._site_lnl_plain(*xargs[:1], *xargs[2:])).abs().max()) <= 1e-3
    # upward store
    up_p, usc_p = pruning.upward_plain(k["steps"], k["trans"], tips)
    up, usc = _wide_launch_raw("wide_store", k, float("nan"))
    inner = slice(N, R - 1)
    assert torch.equal(up[inner], k["up"][inner]) and torch.equal(usc[inner], k["usc"][inner])
    assert float((up[inner] - up_p[inner]).abs().max()) <= 1e-4
    assert float((usc[inner] - usc_p[inner]).abs().max() / usc_p[inner].abs().max()) <= 1e-4
    assert bool(up[:N].isnan().all()) and bool(up[R - 1].isnan().all())
    counts = _upward_warp_counts(C, k["n_slots"], S=4)
    assert counts[0] == (k["n_slots"], pruning.wide_forward_warps(4, C, 16, k["n_slots"]))
    for n_slots, w in counts:
        for kernel in ("wide_forward", "wide_store"):
            lay = build.walk_launch(kernel, C, 4, n_slots, 16)
            assert lay["warps"] == w and lay["threads"] == 32 * w and lay["clusters"] > 0
            assert lay["smem"] == pruning.wide_forward_smem(4, C, 16, n_slots, warps=w)
        for _ in range(2):
            assert torch.equal(_upward_raw("wide_forward", k, n_slots)[0], got)
            up_w, usc_w = _upward_raw("wide_store", k, n_slots)
            assert torch.equal(up_w[inner], up[inner]) and torch.equal(usc_w[inner], usc[inner])
    # outside-partial store
    dargs = (k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"])
    out, osc = cs_kernels.fused_down_store_cs(*dargs)
    out2, osc2 = cs_kernels.fused_down_store(*dargs)
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    out_p, osc_p = cs_kernels._down_store_plain(k["steps"], k["trans"], k["up"], k["usc"],
                                                k["freq"])
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max() / osc_p[rows].abs().max()) <= 1e-4
    raw, raw_sc = _wide_launch_raw("wide_down_store", k, float("nan"))
    assert torch.equal(raw[rows], out[rows]) and torch.equal(raw_sc[rows], osc[rows])
    assert bool(raw[R - 2:].isnan().all()) and bool(raw_sc[R - 2:].isnan().all())
    # gradient sweep
    targs = _tbar_args(k)
    tb = cs_kernels.fused_tbar_cs(*targs, up=k["up"], usc=k["usc"])
    assert torch.equal(tb, cs_kernels.fused_downward_tbar(*targs, up=k["up"], usc=k["usc"]))
    tb_p = cs_kernels._tbar_plain(k["steps"], k["trans"], *targs[4:], k["up"], k["usc"])
    edges = R - 2
    assert not bool(tb[edges:].any())
    assert float((tb[:edges] - tb_p[:edges]).abs().max() / tb_p[:edges].abs().max()) <= 1e-4
    for kernel, sums in (("wide_down_store", False), ("wide_tbar", True)):
        counts = _reverse_team_counts(C, k["n_slots"], sums, S=4)
        assert counts[0] == (k["n_slots"],
                             cs_kernels.wide_reverse_teams(4, C, 16, k["n_slots"], sums=sums))
        for n_slots, w in counts:
            lay = build.walk_launch(kernel, C, 4, n_slots, 16)
            smem = (cs_kernels.wide_tbar_smem if sums else cs_kernels.wide_down_store_smem)(
                4, C, 16, n_slots, warps=w)
            threads = cs_kernels.wide_tbar_threads(4, 16, w) if sums else 64 * w
            assert lay["warps"] == w and lay["threads"] == threads and lay["clusters"] > 0
            assert lay["smem"] == smem
            for _ in range(2):
                res = _reverse_raw(kernel, k, n_slots, targs)
                if sums:
                    assert torch.equal(res[0], tb), (kernel, n_slots, w)
                else:
                    assert torch.equal(res[0][rows], out[rows]), (kernel, n_slots, w)
                    assert torch.equal(res[1][rows], osc[rows]), (kernel, n_slots, w)


@pytest.mark.cuda
def test_dna_walks_refuse_what_the_packed_kernels_serve():
    """Up to 8 categories the wide walks and the multi-category branch-Newton
    sweep have no DNA instance: the wrappers refuse C = 4 at S = 4 (the
    CS-packed kernels serve it); past 32 categories no branch-Newton kernel
    serves DNA (the theta path does, as in the JAX package)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    k = _lane_case(4, 540)
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    with pytest.raises(NotImplementedError, match="CS-packed kernels serve C=4"):
        pruning.fused_upward_store(k["steps"], k["n_slots"], k["trans"], tips)
    mats = cs_kernels.stacked_deriv_mats(model, k["ta"].blen).float().contiguous()
    freq = model.state_freq.float()
    rest = (site.pattern_freq.contiguous(), ptn_invar(model, site).float().contiguous(),
            k["up"], k["usc"])
    with pytest.raises(NotImplementedError, match="the CS-packed newton kernel below"):
        cs_kernels.wide_newton_sweep(k["steps"], k["n_slots"], mats, model.props.float(),
                                     freq, *rest)
    mats40 = mats.repeat(1, 1, 10, 1, 1).contiguous()  # 40 categories
    props40 = model.props.float().repeat(10) / 10
    with pytest.raises(NotImplementedError, match="the theta path above"):
        cs_kernels.wide_newton_sweep(k["steps"], k["n_slots"], mats40, props40,
                                     freq.repeat(10, 1), *rest)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [9, 10, 16, 32])
def test_dna_newton_past_eight_categories_matches_twin(C):
    """csrc/wide_newton.cu's multi-category instance (S = 4, a block all C
    categories of a tile of patterns) at C = 9, 10, 16 and 32 on a 33-taxon
    DNA alignment at an odd pattern count: newton_sweep routes there (not to
    the CS-packed newton.cu), within 1e-4 of the twin (relative to the
    largest entry) at every tile of 8, 16 and 32 patterns whose block fits,
    two launches bit-equal, the root and dummy rows 0; at GTR+I+G and at a
    FreeRate vector from 1e-3 to 20 (the clamp, the floor and the
    renormalization)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.engine import derivatives
    from iqtree_torch.engine.kernels import build

    assert derivatives.newton_serves(C, 4) and build.wide_newton_multi(C, 4)
    k = _lane_case(C, 580 + C)
    model, site, ta = k["model"], k["site"], k["ta"]
    tips = tip_partials(site).contiguous()
    extreme = torch.tensor(np.geomspace(1e-3, 20.0, C), device="cuda")
    for rates in (model.rates, extreme):
        m = ModelArrays(model.eigenvalues, model.eigvec, model.inv_eigvec,
                        model.state_freq, rates, model.props, model.p_invar)
        trans = branch_transition_mats(m, ta.blen).float().contiguous()
        up, usc = cs_kernels.fused_upward_store_cs(k["steps"], k["n_slots"], trans, tips)
        cs_kernels.fill_tip_rows_cs(up, usc, tips, C)
        mats = cs_kernels.stacked_deriv_mats(m, ta.blen).float().contiguous()
        args = (k["steps"], k["n_slots"], mats, m.props.float(), k["freq"],
                site.pattern_freq.contiguous(), ptn_invar(m, site).float().contiguous(),
                up, usc)
        want = cs_kernels._newton_plain(*args[:1], *args[2:])
        before = (cs_kernels.newton_sweep.launches, cs_kernels.wide_newton_sweep.launches)
        got = cs_kernels.newton_sweep(*args)
        again = cs_kernels.wide_newton_sweep(*args)
        assert (cs_kernels.newton_sweep.launches,
                cs_kernels.wide_newton_sweep.launches) == (before[0], before[1] + 2)
        for g, a, w in zip(got, again, want):
            assert torch.equal(g, a)
            assert not bool(g[[ta.root, ta.dummy]].any())
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
        for tile in (8, 16, 32):
            if -(-tile * C // 32) * 32 > cs_kernels.WIDE_NEWTON_MULTI_THREADS_MAX:
                continue
            for g, w in zip(cs_kernels.wide_newton_sweep(*args, tile=tile), want):
                assert float((g - w).abs().max() / w.abs().max()) <= 1e-4, tile


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 4, 8])
def test_dna_packed_kernels_keep_the_earlier_bits(C):
    """Up to 8 categories DNA stays on the CS-packed kernels (forward, store,
    gradient sweep, branch-Newton sweep, outside-partial store) with the
    bits of the earlier build from IQT_EARLIER_CSRC, through the engine's
    wrappers."""
    earlier = _earlier_csrc()
    k = _lane_case(C, 560 + C)
    model, site = k["model"], k["site"]
    tips = tip_partials(site).contiguous()
    inv = ptn_invar(model, site).float().contiguous()
    props = model.props.float()
    targs = _tbar_args(k)
    mats = cs_kernels.stacked_deriv_mats(model, k["ta"].blen).float().contiguous()
    calls = {
        "forward": lambda: (pruning.fused_site_lnl(k["steps"], k["n_slots"], k["trans"], tips,
                                                   props, k["freq"], inv),),
        "store": lambda: cs_kernels.fused_upward_store_cs(k["steps"], k["n_slots"],
                                                          k["trans"], tips),
        "tbar": lambda: (cs_kernels.fused_tbar_cs(*targs, up=k["up"], usc=k["usc"]),),
        "newton": lambda: cs_kernels.newton_sweep(
            k["steps"], k["n_slots"], mats, props, k["freq"], site.pattern_freq.contiguous(),
            inv, k["up"], k["usc"]),
        "down_store": lambda: cs_kernels.fused_down_store_cs(
            k["steps"], k["n_slots"], k["trans"], k["up"], k["usc"], k["freq"]),
    }
    inner = slice(k["ta"].n_taxa, 2 * k["ta"].n_taxa - 1)  # the store leaves tip rows
    for kernel, fn in calls.items():
        got = fn()
        with _earlier_design(kernel, earlier):
            want = fn()
        for g, w in zip(got, want):
            if kernel == "store":
                g, w = g[inner], w[inner]
            assert torch.equal(g, w), (kernel, C)


def _states_case(S, C, seed, n=33, sites=301):
    """A random binary (S = 2) or morphological (S states, symbols 0..)
    alignment with gaps and unknowns, a random tree and GTR2+I+GC (MK+I+GC
    for morphology) on the card."""
    from iqtree_torch.io.alignment import MORPH_SYMBOLS

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    alphabet = "01-" if S == 2 else MORPH_SYMBOLS[:S] + "?"
    seqs = ["".join(rng.choice(list(alphabet), sites)) for _ in range(n)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs,
                                   "BIN" if S == 2 else "MORPH")
    assert aln.num_states == S
    name = "GTR2" if S == 2 else "MK"
    subst, rate = parse_model_string(f"{name}+I" + (f"+G{C}" if C > 1 else ""), aln)
    rate.p_invar = 0.1
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    return dict(ta=ta, model=model, site=site, steps=torch.as_tensor(steps, device=dev),
                n_slots=n_slots, trans=branch_transition_mats(model, ta.blen).float().contiguous(),
                tips=tip_partials(site).contiguous(), freq=model.state_freq.float())


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(2, 1), (2, 3), (2, 4), (2, 8), (2, 10), (3, 4), (3, 1),
                                 (6, 4), (6, 12), (21, 4)])
def test_state_spaces_match_twins(S, C):
    """Binary data on the S = 2 instances of the five CS-packed kernels up to
    8 categories (past them on the S = 4 wide walks and wide_newton's
    multi-category instance), morphology padded to the instance
    build.instance_states names (S = 3 on the S = 4 CS-packed kernels,
    6 on the S = 20 wide kernels, 21 on the S = 64 walks), through the
    engine's wrappers: forward 1e-3 absolute, the stores 1e-4 (partials
    absolutely, scales relative to the largest), the gradient and
    branch-Newton sweeps 1e-4 relative to their largest entry; two
    launches bit-equal; the launches counted on the wrappers of the
    kernels that serve the shape.  No branch-Newton kernel serves 21
    states (the theta path does)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.engine.derivatives import newton_serves
    from iqtree_torch.engine.kernels import build

    k = _states_case(S, C, 700 + 10 * S + C)
    steps, n_slots, trans, tips, freq = (k[x] for x in ("steps", "n_slots", "trans", "tips",
                                                         "freq"))
    model, site = k["model"], k["site"]
    N, R = k["ta"].n_taxa, 2 * k["ta"].n_taxa
    inner = slice(N, 2 * N - 1)
    props, invar = model.props.float(), ptn_invar(model, site).float().contiguous()
    packed = build.packed(C, S)
    assert packed == (S <= 4 and C <= 8)
    if packed:
        counted = (pruning.fused_site_lnl, cs_kernels.fused_upward_store_cs,
                   cs_kernels.fused_down_store_cs, cs_kernels.fused_tbar_cs,
                   cs_kernels.newton_sweep)
    else:
        counted = (pruning.wide_site_lnl, pruning.fused_upward_store,
                   cs_kernels.fused_down_store, cs_kernels.fused_downward_tbar,
                   cs_kernels.wide_newton_sweep)
    newton = newton_serves(C, S)
    assert newton == (S < 21 and (C <= 8 or S <= 4))
    before = [w.launches for w in counted]

    f_args = (steps, n_slots, trans, tips, props, freq, invar)
    lnl = pruning.fused_site_lnl(*f_args)
    assert torch.equal(lnl, pruning.fused_site_lnl(*f_args))
    assert float((lnl - pruning._site_lnl_plain(*f_args[:1], *f_args[2:])).abs().max()) <= 1e-3

    up, usc = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    up2, usc2 = cs_kernels.fused_upward_store_cs(steps, n_slots, trans, tips)
    assert up.shape == (R, C * S, tips.shape[2])
    assert torch.equal(up[inner], up2[inner]) and torch.equal(usc[inner], usc2[inner])
    up_p, usc_p = pruning.upward_plain(steps, trans, tips)
    assert float((up[inner] - up_p[inner]).abs().max()) <= 1e-4
    assert float((usc[inner] - usc_p[inner]).abs().max() / usc_p[inner].abs().max()) <= 1e-4

    cs_kernels.fill_tip_rows_cs(up, usc, tips, C)
    d_args = (steps, n_slots, trans, up, usc, freq)
    out, osc = cs_kernels.fused_down_store_cs(*d_args)
    out2, osc2 = cs_kernels.fused_down_store_cs(*d_args)
    assert torch.equal(out, out2) and torch.equal(osc, osc2)
    out_p, osc_p = cs_kernels._down_store_plain(steps, trans, up, usc, freq)
    rows = [v for v in range(R - 1) if v != k["ta"].root]
    assert float((out[rows] - out_p[rows]).abs().max()) <= 1e-4
    assert float((osc[rows] - osc_p[rows]).abs().max() / osc_p[rows].abs().max()) <= 1e-4

    wp = site.pattern_freq.contiguous()
    t_args = (steps, n_slots, trans, tips, props, freq, lnl, wp)
    tb = cs_kernels.fused_tbar_cs(*t_args, up=up, usc=usc)
    assert torch.equal(tb, cs_kernels.fused_tbar_cs(*t_args, up=up, usc=usc))
    want = cs_kernels._tbar_plain(steps, trans, props, freq, lnl, wp, up, usc)
    assert tb.shape == (R, C, S, S)
    assert float((tb[:R - 2] - want[:R - 2]).abs().max() / want[:R - 2].abs().max()) <= 1e-4

    if newton:
        mats = cs_kernels.stacked_deriv_mats(model, k["ta"].blen).float().contiguous()
        n_args = (steps, n_slots, mats, props, freq, wp, invar, up, usc)
        got = cs_kernels.newton_sweep(*n_args)
        again = cs_kernels.newton_sweep(*n_args)
        for g, a, w in zip(got, again, cs_kernels._newton_plain(*n_args[:1], *n_args[2:])):
            assert torch.equal(g, a)
            assert float((g - w).abs().max() / w.abs().max()) <= 1e-4
    assert [w.launches for w in counted] == \
        [b + 2 for b in before[:4]] + [before[4] + (2 if newton else 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("S,C", [(2, 4), (6, 4)])
def test_asc_gradient_on_card_matches_plain_autograd(S, C):
    """+ASC on the kernels' path: the custom autograd.Function (whose
    gradient sweep's pattern weights carry the correction's terms) against
    autograd through the plain pass, both with float32 partials on the
    card, on the variable columns of a binary (S = 2, CS-packed) and a
    6-state (padded to the S = 20 wide kernels) alignment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from iqtree_torch.io.alignment import MORPH_SYMBOLS

    dev = torch.device("cuda")
    rng = np.random.default_rng(900 + S)
    n, sites = 33, 301
    seqs = ["".join(rng.choice(list("01" if S == 2 else MORPH_SYMBOLS[:S]), sites))
            for _ in range(n)]
    cols = [j for j in range(sites) if len({s[j] for s in seqs}) > 1]
    seqs = ["".join(s[j] for j in cols) for s in seqs]
    aln = Alignment.from_sequences([f"t{i}" for i in range(n)], seqs,
                                   "BIN" if S == 2 else "MORPH")
    subst, rate = parse_model_string(("GTR2" if S == 2 else "MK") + f"+G{C}+ASC", aln)
    rate.alpha = 0.6
    tree = random_tree(n, rng)
    ta = TreeArrays.from_tree(tree, dev)
    model = ModelArrays.from_model(subst, rate, dev)
    site = SiteData.from_alignment(aln, dev, torch.float32, asc=True)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=dev)
    fields = ("eigenvalues", "eigvec", "inv_eigvec", "state_freq", "rates", "props",
              "p_invar")

    def grads(fn):
        leaves = [ta.blen.clone().requires_grad_()]
        leaves += [getattr(model, f).clone().requires_grad_() for f in fields]
        total, _ = fn(ta.with_blen(leaves[0]), ModelArrays(*leaves[1:]))
        return torch.autograd.grad(total, leaves)

    got = grads(lambda t, m: loglik(t, m, site, steps, n_slots))
    want = grads(lambda t, m: compute_loglik(t, m, site))
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3 * float(w.abs().max()))
