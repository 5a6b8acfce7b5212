"""The protein fixed-topology fit (-te ... -m LG+G) of the port against the
JAX package.

Random protein cases (8 taxa x 80 aa with ambiguity codes, LG+G4 with and
without +I, inputs from a numpy seed) go through both packages on the CPU
in float64: the JAX side runs its Pallas kernels in interpret mode, as
tests/test_derivatives.py runs them, and the port's side runs the plain
twins of its wide kernels.  The CUDA kernels themselves are held against
the twins by tests/test_torch_cuda.py and chip_smoke.py on the card.
Tolerances are those of tests/test_torch_kernels.py: 1e-11 on lnL, 1e-9
relative to the largest entry on the cotangents and d1, d2.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.grad import loglik as jax_loglik
from iqtree_tpu.engine.kernels.cs_kernels import fused_newton_derivs as jax_newton
from iqtree_tpu.engine.kernels.pruning import _fused_site_lnl_local as jax_forward
from iqtree_tpu.engine.kernels.pruning import _fused_upward_store_local as jax_store
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.kernels.pruning import fused_downward_tbar as jax_tbar
from iqtree_tpu.engine.kernels.pruning import fused_upward_store as jax_store8
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import _ptn_invar as jax_ptn_invar
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import StateSpace as JStateSpace
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.optimize import ModelOptimizer as JOptimizer
from iqtree_tpu.models.protein import create_protein_model as jax_protein_model
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.models.subst import pair_index as jax_pair_index
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.engine.banner import decide_engine
from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.kernels import build, cs_kernels, pruning
from iqtree_torch.engine.kernels.cs_kernels import (
    fill_tip_rows_cs,
    fused_downward_tbar,
    fused_newton_derivs,
)
from iqtree_torch.engine.kernels.pruning import fused_site_lnl, fused_upward_store
from iqtree_torch.engine.likelihood import (
    SiteData,
    TreeArrays,
    branch_transition_mats,
    ptn_invar,
    tip_partials,
)
from iqtree_torch.io.alignment import AA_ORDER, StateSpace, read_alignment
from iqtree_torch.models.factory import default_model, parse_model_string
from iqtree_torch.models.optimize import ModelOptimizer, optimize_model_and_branches
from iqtree_torch.models.protein import PROTEIN_MODEL_NAMES, create_protein_model
from iqtree_torch.models.subst import pair_index
from iqtree_torch.trees.tree import PhyloTree

from test_torch_likelihood import CPU, DATA

PROT = os.path.join(DATA, "prot_M126_27_269.phy")
PROT_TREE = os.path.join(DATA, "lg_golden.treefile")
# IQ-TREE 1.4.3 on the same -te LG+G fit (tests/test_golden_configs.py)
GOLDEN_LG_LNL, GOLDEN_LG_ALPHA = -5008.231, 0.442


def make_case(pinv=0.0, n_taxa=8, n_sites=80, seed=5):
    """A random protein alignment, LG+G4(+I) and a random tree, as JAX
    arrays (f64) and as the port's tensors (f64, via convert.py), with the
    slot schedule: (jax (tree, model, site), port (tree, model, site),
    steps, n_slots)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list(AA_ORDER + "-XBZ"), n_sites))
            for _ in range(n_taxa)]
    aln = JAlignment.from_sequences([f"t{i}" for i in range(n_taxa)], seqs, "AA")
    rate = JRate.make(gamma_cats=4, invar=pinv > 0, p_invar=pinv, alpha=0.8)
    tree = jax_random_tree(n_taxa, rng)
    j = (JTree.from_tree(tree, jnp.float64),
         JModel.from_model(jax_protein_model("LG"), rate, jnp.float64),
         JSite.from_alignment(aln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, steps, n_slots


def test_aa_alignment_matches_jax():
    """The protein state space (ambiguity codes included), pattern
    compression and empirical frequencies give the same numbers."""
    js, s = JStateSpace.make("AA"), StateSpace.make("AA")
    assert s.char_to_code == js.char_to_code and s.num_states == 20
    np.testing.assert_array_equal(s.code_masks, js.code_masks)
    a, ja = read_alignment(PROT), jax_read_alignment(PROT)
    assert a.states.seq_type == ja.states.seq_type == "AA"
    for f in ("patterns", "pattern_freq", "const_state", "site_to_pattern"):
        np.testing.assert_array_equal(getattr(a, f), getattr(ja, f), err_msg=f)
    np.testing.assert_allclose(a.state_frequencies(), ja.state_frequencies(),
                               rtol=1e-15)
    assert a.num_informative_sites() == ja.num_informative_sites()
    assert default_model(a) == "LG+G"
    (_, _, js_), (_, _, ts), _, _ = make_case()
    np.testing.assert_array_equal(ts.tip_codes.numpy(), np.asarray(js_.tip_codes))
    np.testing.assert_array_equal(ts.const_state.numpy(), np.asarray(js_.const_state))
    np.testing.assert_array_equal(tip_partials(ts).numpy(), np.asarray(jax_tips(js_, 4)))


def test_protein_models_and_eigensystem_match_jax():
    """All 19 matrices, the model strings, the LG eigensystem and the
    ModelOptimizer's ModelArrays against the JAX package's."""
    assert pair_index(20) == jax_pair_index(20)
    for name in PROTEIN_MODEL_NAMES:
        m, jm = create_protein_model(name), jax_protein_model(name)
        np.testing.assert_array_equal(m.exchange, jm.exchange, err_msg=name)
        np.testing.assert_array_equal(m.state_freq, jm.state_freq, err_msg=name)
        np.testing.assert_allclose(m.rate_matrix(), jm.rate_matrix(), rtol=1e-14,
                                   atol=1e-15, err_msg=name)
    a, ja = read_alignment(PROT), jax_read_alignment(PROT)
    for ms in ("LG+G", "WAG+F+I+G", "JTT+FO", "LG+I{0.2}+G8{0.5}", "Dayhoff+FQ"):
        (s, r), (js, jr) = parse_model_string(ms, a), jax_parse_model(ms, ja)
        assert s.name == js.name and s.freq_type == js.freq_type, ms
        np.testing.assert_allclose(s.state_freq, js.state_freq, rtol=1e-15)
        np.testing.assert_allclose(s.sym_rates(), js.sym_rates(), rtol=1e-15)
        assert (r.kind, r.ncat, r.alpha, r.p_invar, r.fix_alpha, r.fix_p_invar) == \
            (jr.kind, jr.ncat, jr.alpha, jr.p_invar, jr.fix_alpha, jr.fix_p_invar)
        lam, v, vinv = s.eigen()
        jlam, jv, jvinv = js.eigen()
        np.testing.assert_allclose(lam, jlam, atol=1e-13)
        np.testing.assert_allclose(v @ np.diag(lam) @ vinv, jv @ np.diag(jlam) @ jvinv,
                                   atol=1e-13)
        # the optimizer's eigensystem (torch) against the JAX optimizer's
        opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
        got = opt.build(opt.init_params())
        want = convert.model_arrays(jopt.build(jopt.init_params()), CPU)
        blen = torch.tensor([0.0, 0.01, 0.3, 2.0], dtype=torch.float64)
        np.testing.assert_allclose(branch_transition_mats(got, blen).numpy(),
                                   branch_transition_mats(want, blen).numpy(),
                                   atol=1e-12, err_msg=ms)
        for f in ("state_freq", "rates", "props", "p_invar"):
            np.testing.assert_allclose(getattr(got, f).numpy(),
                                       getattr(want, f).numpy(), rtol=1e-12)
    with pytest.raises(Exception, match="takes no rate parameters"):
        parse_model_string("LG{1,2}+G", a)


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_forward_twin_matches_jax(pinv):
    (jt, jm, js), (tt, tm, ts), steps, n_slots = make_case(pinv)
    want = jax_forward(jnp.asarray(steps), jax_trans(jm, jt.blen), jax_tips(js, 4),
                       jm.props, jm.state_freq, jax_ptn_invar(jm, js),
                       n_slots=n_slots, interpret=True)
    got = fused_site_lnl(convert.schedule(steps, CPU), n_slots,
                         branch_transition_mats(tm, tt.blen), tip_partials(ts),
                         tm.props, tm.state_freq, ptn_invar(tm, ts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11)


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_store_twin_matches_jax(pinv):
    """Both from the same transition matrices: P(t) of small t rounds
    differently in the two packages' eigen-products (1e-9 relative on its
    smallest entries at S=20)."""
    (jt, jm, js), (tt, tm, ts), steps, n_slots = make_case(pinv)
    trans = jax_trans(jm, jt.blen)
    up_j, usc_j = jax_store(jnp.asarray(steps), trans, jax_tips(js, 4),
                            n_slots=n_slots, interpret=True)
    up, usc = fused_upward_store(convert.schedule(steps, CPU), n_slots,
                                 torch.tensor(np.asarray(trans)), tip_partials(ts))
    N, P = tt.n_taxa, up.shape[2]
    inner = slice(N, 2 * N - 1)  # the store leaves tip rows to the caller
    np.testing.assert_allclose(up[inner].numpy(),
                               np.asarray(up_j)[inner, :, :, :P].reshape(N - 1, 80, P),
                               rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(usc[inner].numpy(), np.asarray(usc_j)[inner, :P],
                               rtol=1e-11, atol=1e-12)


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_tbar_twin_matches_jax(pinv):
    """The JAX gradient sweep as its backward runs it: the store's padded
    state axis and 8-row scales, tip rows filled, inputs tile-padded."""
    (jt, jm, js), (tt, tm, ts), steps, n_slots = make_case(pinv)
    N, P = tt.n_taxa, ts.pattern_freq.shape[0]
    lnl = np.asarray(jax_forward(jnp.asarray(steps), jax_trans(jm, jt.blen),
                                 jax_tips(js, 4), jm.props, jm.state_freq,
                                 jax_ptn_invar(jm, js), n_slots=n_slots,
                                 interpret=True))
    wp = np.asarray(js.pattern_freq) * np.random.default_rng(5).uniform(0.5, 1.5, P)
    trans_j, tips_j = jax_trans(jm, jt.blen), jax_tips(js, 4)
    up, _, usc8 = jax_store8(jnp.asarray(steps), n_slots, trans_j, tips_j,
                             want_scale8=True, interpret=True)
    P_pad, S_pad = up.shape[-1], up.shape[2]
    tips_f = jnp.pad(tips_j, ((0, 0), (0, S_pad - 20), (0, P_pad - P)),
                     constant_values=0.0)
    up = up.at[:N].set(tips_f[:, None])
    usc8 = usc8.at[:N].set(0.0)
    pad = lambda x: jnp.pad(jnp.asarray(x), (0, P_pad - P))
    want = jax_tbar(jnp.asarray(steps), n_slots, trans_j, tips_j, up, usc8,
                    jm.state_freq, jm.props, pad(lnl), pad(wp), interpret=True)
    got = fused_downward_tbar(convert.schedule(steps, CPU), n_slots,
                              branch_transition_mats(tm, tt.blen), tip_partials(ts),
                              tm.props, tm.state_freq, torch.tensor(lnl),
                              torch.tensor(wp))
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want).max()))


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_newton_twin_matches_jax(pinv, monkeypatch):
    """Against the JAX package's streamed wide Newton sweep
    (_kernel_newton_cs_stream, forced as it runs at 300 taxa)."""
    monkeypatch.setenv("IQTREE_TPU_FORCE_STREAM_MSTK", "1")
    (jt, jm, js), (tt, tm, ts), steps, n_slots = make_case(pinv)
    d1_j, d2_j = jax_newton(jnp.asarray(steps), n_slots, jm, jt.blen, jax_tips(js, 4),
                            js.pattern_freq, jax_ptn_invar(jm, js), interpret=True)
    d1, d2 = fused_newton_derivs(convert.schedule(steps, CPU), n_slots, tm, tt.blen,
                                 tip_partials(ts), ts.pattern_freq, ptn_invar(tm, ts))
    for got, want in ((d1, d1_j), (d2, d2_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_alpha_gradient_matches_jax(pinv):
    """d lnL / d(alpha, p_invar parameters) through the port's sweep
    gradient against jax.grad of the JAX lnL, both from the optimizers'
    unconstrained parameters."""
    (jt, _, js), (tt, _, ts), steps, n_slots = make_case(pinv)
    model = "LG+I+G" if pinv else "LG+G"
    js_, jr = jax_parse_model(model, jax_read_alignment(PROT))
    s, r = parse_model_string(model, read_alignment(PROT))
    jr.alpha, jr.p_invar = r.alpha, r.p_invar = 0.8, pinv
    jopt, opt = JOptimizer(js_, jr, dtype=jnp.float64), ModelOptimizer(s, r, CPU)
    jp = jopt.init_params()
    want = jax.grad(lambda p: jax_loglik(jt, jopt.build(p), js)[0])(jp)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    total, _ = loglik(tt, opt.build(p), ts, convert.schedule(steps, CPU), n_slots)
    got = torch.autograd.grad(total, list(p.values()))
    assert set(p) == {"alpha_logit"} | ({"logit_pinv"} if pinv else set())
    for k, g in zip(p, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]), rtol=1e-8,
                                   err_msg=k)


def test_golden_lg_fit():
    """The slice as a whole: the port's -te fit of LG+G4 reaches the
    reference binary's optimum on the 27-taxon protein example."""
    aln = read_alignment(PROT)
    with open(PROT_TREE) as f:
        tree = PhyloTree.from_newick(f.read(), aln.names, rng=np.random.default_rng(0))
    subst, rate = parse_model_string("LG+G", aln)
    ta = TreeArrays.from_tree(tree, CPU)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    opt = ModelOptimizer(subst, rate, CPU)
    _, params, lnl = optimize_model_and_branches(
        opt, ta, SiteData.from_alignment(aln, CPU, torch.float64),
        torch.as_tensor(steps), n_slots, tol=0.001)
    _, rate = opt.unpack(params)
    assert lnl >= GOLDEN_LG_LNL - 0.05, lnl
    assert abs(rate.alpha - GOLDEN_LG_ALPHA) < 0.02, rate.alpha


def test_cli_protein_fit_and_search(tmp_path, capsys):
    """`-te ... -m LG+G -device cpu` through the CLI: the golden optimum, a
    report naming LG+G4; the protein search runs (its candidate set cut to
    one tree for time) and writes its tree; `-st BIN` on protein data
    refuses its characters."""
    prefix = str(tmp_path / "lg")
    assert cli_main(["-s", PROT, "-st", "AA", "-te", PROT_TREE, "-m", "LG+G",
                     "-device", "cpu", "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    lnl = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    alpha = float(re.search(r"\+G4\{(\S+)\}", log).group(1))
    assert lnl >= GOLDEN_LG_LNL - 0.05 and abs(alpha - GOLDEN_LG_ALPHA) < 0.02
    assert "plain PyTorch twins" in log and "4x20" in log
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "Model of substitution: LG+G4" in report
    assert "amino-acid sites" in report and "pi(V)" in report
    search = str(tmp_path / "s")
    assert cli_main(["-s", PROT, "-n", "1", "-ninit", "1", "-ntop", "1", "-device",
                     "cpu", "-pre", search]) == 0
    with open(search + ".log") as f:
        log = f.read()
    assert "parameters: LG+F{" in log and "outside-partial store" in log
    assert float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1)) > GOLDEN_LG_LNL
    with open(search + ".treefile") as f:
        assert f.read().count(",") == 26
    with pytest.raises(ValueError, match="invalid character .* for BIN"):
        cli_main(["-s", PROT, "-st", "BIN", "-device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli_main(["-s", PROT, "-te", PROT_TREE, "-pre", str(tmp_path / "c")])


def test_shapes_served_and_cpu_twins():
    """The kernels serve S=2, S=4, S=20 and the codon spaces (and what pads
    to them); a shape past them names the slice that ports it, and the
    search serves S=20 with up and out stored.  CPU tensors take the twins:
    no wide kernel launch is counted."""
    build.check_shape(4, 20)
    build.check_shape(4, 61)
    build.check_shape(4, 2)
    with pytest.raises(NotImplementedError, match="the codon mixture slice"):
        build.check_shape(12, 30)
    assert decide_engine(27, 4, 20, 184, CPU, torch.float64,
                         search=True).store_bytes == 2 * 54 * 81 * 184 * 8
    assert decide_engine(27, 4, 20, 184, CPU, torch.float64).store_bytes == \
        54 * 81 * 184 * 8
    wrappers = (pruning.wide_site_lnl, pruning.fused_upward_store,
                cs_kernels.fused_downward_tbar, cs_kernels.wide_newton_sweep,
                cs_kernels.fused_down_store)
    before = [w.launches for w in wrappers]
    (_, _, _), (tt, tm, ts), steps, n_slots = make_case()
    st, tips = convert.schedule(steps, CPU), tip_partials(ts)
    trans = branch_transition_mats(tm, tt.blen)
    pruning.wide_site_lnl(st, n_slots, trans, tips, tm.props, tm.state_freq,
                          ptn_invar(tm, ts))
    up, usc = fused_upward_store(st, n_slots, trans, tips)
    fill_tip_rows_cs(up, usc, tips, 4)
    fused_newton_derivs(st, n_slots, tm, tt.blen, tips, ts.pattern_freq,
                        ptn_invar(tm, ts))
    cs_kernels.fused_nni_passes_cs(st, n_slots, trans, tips, tm.state_freq)
    assert [w.launches for w in wrappers] == before
