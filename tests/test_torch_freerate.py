"""FreeRate and the rest of the rate tail (+R, +R+I, +K, +GM, -i/-a/-gmedian,
LG4X) of the port against the JAX package.

Inputs are files of tests/data, cuts of them, or alignments and trees made
from numpy seeds, handed to both packages; both run in float64 on the CPU
(the JAX side's Pallas kernels in interpret mode, as its own tests run
them; the port's side on the plain twins of its kernels).  The DNA
instances of the wide walks past 8 categories (S = 4, C = 10) are held
against their twins on the card by tests/test_torch_cuda.py and
chip_smoke.py.  Tolerances: 1e-12 relative on parsed and built arrays,
1e-6 relative on gradients (the port's sweep gradient against jax.grad),
1e-9 relative on the twins (1e-9 of the largest entry on cotangents),
1e-3 on a written model's lnL (its numbers are rounded to 6 digits), 0.01
on fits of the same inputs (each package's fit run here).
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.config import parse_args as jax_parse_args
from iqtree_tpu.engine.kernels.cs_kernels import fused_newton_derivs as jax_newton
from iqtree_tpu.engine.kernels.pruning import _fused_site_lnl_local as jax_forward
from iqtree_tpu.engine.kernels.pruning import _fused_upward_store_local as jax_store
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.kernels.pruning import fused_downward_tbar as jax_tbar
from iqtree_tpu.engine.kernels.pruning import fused_nni_passes_general as jax_passes
from iqtree_tpu.engine.kernels.pruning import fused_upward_store as jax_store8
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import _ptn_invar as jax_ptn_invar
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.io.report import _append_rate_het as jax_rate_section
from iqtree_tpu.models.dna import create_dna_model as jax_dna_model
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.optimize import ModelOptimizer as JOptimizer
from iqtree_tpu.models.optimize import optimize_model_and_branches as jax_fit
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.config import parse_args
from iqtree_torch.engine import banner
from iqtree_torch.engine.derivatives import newton_serves
from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.kernels import build, cs_kernels, pruning
from iqtree_torch.engine.kernels.pruning import device_slot_schedule
from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays,
                                            branch_transition_mats, compute_loglik,
                                            ptn_invar, tip_partials)
from iqtree_torch.io.alignment import read_alignment
from iqtree_torch.io.report import write_report
from iqtree_torch.models.factory import ModelParseError, parse_model_string
from iqtree_torch.models.mixture import category_count
from iqtree_torch.models.optimize import ModelOptimizer, optimize_model_and_branches
from iqtree_torch.trees.tree import PhyloTree

from test_torch_likelihood import CPU, DATA

DNA = os.path.join(DATA, "example.phy")
PROT = os.path.join(DATA, "prot_M126_27_269.phy")
CODON = os.path.join(DATA, "example_codon.phy")
# IQ-TREE 1.4.3 on -te fits (tests/test_golden_configs.py; DIFFTEST.md
# prot_lg4x_te)
GOLDEN_HKY_R4, GOLDEN_LG4X = -11276.547, -4949.861


def _alignments(path, seq_type=None):
    return jax_read_alignment(path, seq_type), read_alignment(path, seq_type)


def _cut(tmp_path, path, n_taxa=8, n_chars=120, seed=3, seq_type=None):
    """The first n_taxa rows and n_chars columns of an example alignment and
    a random tree on them, as files: (alignment path, tree path)."""
    rows = [line.split() for line in open(path).read().split("\n")[1:] if line.strip()]
    aln_path, tree_path = str(tmp_path / "cut.phy"), str(tmp_path / "cut.tree")
    with open(aln_path, "w") as f:
        f.write(f"{n_taxa} {n_chars}\n")
        f.writelines(f"{a} {b[:n_chars]}\n" for a, b in rows[:n_taxa])
    jaln = jax_read_alignment(aln_path, seq_type)
    tree = jax_random_tree(n_taxa, np.random.default_rng(seed), mean_blen=0.15)
    with open(tree_path, "w") as f:
        f.write(tree.to_newick(jaln.names) + "\n")
    return aln_path, tree_path


def _case(path, seq_type=None, n_taxa=8, n_chars=120, seed=3):
    """(JAX alignment, port alignment, JAX tree arrays, port tree arrays,
    JAX site data, port site data, schedule, n_slots) of a cut of an
    example alignment on a random tree."""
    rows = [line.split() for line in open(path).read().split("\n")[1:] if line.strip()]
    names = [a for a, _ in rows[:n_taxa]]
    seqs = [b[:n_chars] for _, b in rows[:n_taxa]]
    st = seq_type or ("AA" if path == PROT else "DNA")
    jaln = JAlignment.from_sequences(names, seqs, st)
    from iqtree_torch.io.alignment import Alignment

    aln = Alignment.from_sequences(names, seqs, st)
    tree = jax_random_tree(n_taxa, np.random.default_rng(seed), mean_blen=0.15)
    jt = JTree.from_tree(tree, jnp.float64)
    tt = convert.tree_arrays(jt, CPU)
    steps, n_slots = device_slot_schedule(convert.phylo_tree(tree), tt)
    return (jaln, aln, jt, tt, JSite.from_alignment(jaln, jnp.float64),
            SiteData.from_alignment(aln, CPU, torch.float64), torch.as_tensor(steps),
            n_slots)


MODELS = [(DNA, "HKY+R4"), (DNA, "GTR+I+R3"), (PROT, "LG+R4{0.1,0.2,0.2,0.5,0.3,1,0.4,2}"),
          (DNA, "JC+K3"), (DNA, "HKY+GM4"), (CODON, "GY+R4"), (PROT, "LG4X"),
          (DNA, "MIX{JC,HKY,GTR}+G4")]


@pytest.mark.parametrize("path,model", MODELS)
def test_models_parse_as_the_jax_package_does(path, model):
    """The rate model (kind, categories, parameters, flags, df, name suffix),
    category_rates' three conventions and the engine's ModelArrays against
    the JAX package's; a mixture's weights and the fused *R4 tie (LG4X: the
    class weights pinned, fix_weights, its rates FreeRate's)."""
    jaln, aln = _alignments(path, "CODON" if path == CODON else None)
    (s, r), (js, jr) = parse_model_string(model, aln), jax_parse_model(model, jaln)
    for f in ("kind", "ncat", "alpha", "p_invar", "gamma_median", "fix_alpha",
              "fix_p_invar", "is_free_rate", "is_kategory", "df"):
        assert getattr(r, f) == getattr(jr, f), f
    assert r.name_suffix() == jr.name_suffix()
    for got, want in zip(r.category_rates(), jr.category_rates()):
        np.testing.assert_allclose(got, want, rtol=1e-12)
    if r.is_kategory:  # weight 1.0 a category: props sum to K
        assert r.category_rates()[1].sum() == r.ncat
    if hasattr(js, "n_mix"):
        assert (s.fix_weights, s.fused_with_rate) == (js.fix_weights, js.fused_with_rate)
        np.testing.assert_array_equal(s.weights, js.weights)
    got, want = ModelArrays.from_model(s, r, CPU), JModel.from_model(js, jr, jnp.float64)
    assert category_count(s, r) == got.ncat == want.ncat
    for f in ("rates", "props", "p_invar", "state_freq", "eigenvalues"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-12, atol=1e-14, err_msg=f)


@pytest.mark.parametrize("flags", [["-a", "0.5"], ["-i", "0.2"], ["-gmedian"],
                                   ["-a", "0.5", "-i", "0.2", "-gmedian"]])
def test_rate_flags_rewrite_the_model_as_the_jax_cli_does(flags):
    """-a, -i and -gmedian through config.parse_args: the same model string
    as the JAX CLI's, which parses into the same rate model."""
    argv = ["-s", DNA, "-m", "HKY+I+G4", *flags]
    cfg, jcfg = parse_args(argv), jax_parse_args(argv)
    assert cfg.model == jcfg.model != "HKY+I+G4"
    jaln, aln = _alignments(DNA)
    r, jr = parse_model_string(cfg.model, aln)[1], jax_parse_model(jcfg.model, jaln)[1]
    assert (r.kind, r.alpha, r.p_invar, r.gamma_median, r.fix_alpha, r.fix_p_invar) == \
        (jr.kind, jr.alpha, jr.p_invar, jr.gamma_median, jr.fix_alpha, jr.fix_p_invar)
    assert parse_args(["-s", DNA, *flags]).model is None  # the default model is left be


def test_rate_model_errors_are_the_jax_packages():
    """+K with +G, +R or +I, and a wrong count of +R values: the JAX
    package's messages."""
    jaln, aln = _alignments(DNA)
    for model, msg in (("HKY+K4+G", r"\+K cannot combine with \+G/\+R/\+I"),
                       ("HKY+I+K3", r"\+K cannot combine with \+G/\+R/\+I"),
                       ("HKY+K3+R3", r"\+K cannot combine with \+G/\+R/\+I"),
                       ("HKY+R3{0.5,1,0.5}", r"\+R3 expects 6 values \(w1,r1,...\)")):
        for parse, a in ((parse_model_string, aln), (jax_parse_model, jaln)):
            with pytest.raises(ValueError, match=msg):
                parse(model, a)
        with pytest.raises(ModelParseError):
            parse_model_string(model, aln)


@pytest.mark.parametrize("model", ["HKY+R3", "HKY+I+R3", "HKY+K3", "LG4X"])
def test_optimizer_build_and_gradient_match_jax(model):
    """ModelOptimizer's parameters (log_free_rates, free_logits,
    kat_logits), its ModelArrays and d lnL / d(every parameter) through the
    port's sweep gradient against jax.grad of the JAX lnL, at the same
    parameters (the start moved by numpy noise), to 1e-6 relative."""
    jaln, aln, jt, tt, js, ts, steps, n_slots = _case(PROT if model == "LG4X" else DNA,
                                                      n_taxa=6, n_chars=80)
    (s, r), (jsub, jr) = parse_model_string(model, aln), jax_parse_model(model, jaln)
    jopt, opt = JOptimizer(jsub, jr, dtype=jnp.float64), ModelOptimizer(s, r, CPU)
    jp = jopt.init_params()
    assert set(jp) == set(opt.init_params())
    for k in jp:
        np.testing.assert_allclose(opt.init_params()[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-12)
    rng = np.random.default_rng(11)
    jp = {k: v + rng.normal(0.0, 0.3, np.shape(v)) for k, v in jp.items()}
    p = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    got, want = opt.build(p), jopt.build(jp)
    for f in ("rates", "props", "p_invar"):
        np.testing.assert_allclose(getattr(got, f).detach().numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-12, err_msg=f)
    want_lnl, grads = jax.jit(jax.value_and_grad(
        lambda q: jax_compute_loglik(jt, jopt.build(q), js)[0]))(jp)
    total, _ = loglik(tt, got, ts, steps, n_slots)
    np.testing.assert_allclose(float(total.detach()), float(want_lnl), rtol=1e-12)
    for k, g in zip(p, torch.autograd.grad(total, list(p.values()))):
        np.testing.assert_allclose(g.numpy(), np.asarray(grads[k]), rtol=1e-6, atol=1e-9,
                                   err_msg=k)
    # the fitted values written back as the JAX package writes them
    s2, r2 = opt.unpack(p)
    js2, jr2 = jopt.unpack(jp)
    for f in ("free_rates", "free_props", "p_invar"):
        np.testing.assert_allclose(np.asarray(getattr(r2, f), float),
                                   np.asarray(getattr(jr2, f), float), rtol=1e-12, err_msg=f)


def test_gamma_median_is_two_functions_in_both_packages():
    """+GM: the optimizer builds mean-quadrature rates (the JAX package's
    discrete_gamma_rates_jax has no median), category_rates -- which the
    evaluation after the fit and the report read -- the median ones; the
    port matches each JAX function as it is (a fault of the reference,
    ROADMAP Queue 3)."""
    jaln, aln = _alignments(DNA)
    (s, r), (js, jr) = parse_model_string("HKY+I+GM4", aln), jax_parse_model("HKY+I+GM4",
                                                                            jaln)
    r.alpha = jr.alpha = 0.7
    r.p_invar = jr.p_invar = 0.2
    opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
    built = opt.build(opt.init_params()).rates.numpy()
    np.testing.assert_allclose(built, np.asarray(jopt.build(jopt.init_params()).rates),
                               rtol=1e-10)
    median = r.category_rates()[0]
    np.testing.assert_allclose(median, jr.category_rates()[0], rtol=1e-14)
    mean = parse_model_string("HKY+I+G4{0.7}", aln)[1]
    mean.p_invar = 0.2
    assert not np.allclose(median, mean.category_rates()[0], rtol=1e-3)
    np.testing.assert_allclose(built, mean.category_rates()[0], rtol=1e-10)


def test_lg4x_weights_differ_between_the_fit_and_the_evaluation():
    """LG4X: in the fit the class weights are the FreeRate weights
    (ModelOptimizer._build_mixture: props = props_r); after it the engine's
    ModelArrays.from_mixture takes the mixture's defined weights times their
    sum, since unpack writes the fitted weights nowhere back -- in both
    packages alike (ROADMAP Queue 3)."""
    jaln, aln = _alignments(PROT)
    (s, r), (js, jr) = parse_model_string("LG4X", aln), jax_parse_model("LG4X", jaln)
    assert s.fix_weights and js.fix_weights
    opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
    jp = jopt.init_params()
    jp["free_logits"] = jnp.log(jnp.asarray([0.1, 0.2, 0.3, 0.4]))
    p = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
    fit = opt.build(p).props.numpy()
    np.testing.assert_allclose(fit, np.asarray(jopt.build(jp).props), rtol=1e-12)
    np.testing.assert_allclose(fit, [0.1, 0.2, 0.3, 0.4], rtol=1e-12)
    s2, r2 = opt.unpack(p)
    js2, jr2 = jopt.unpack(jp)
    np.testing.assert_allclose(r2.free_props, jr2.free_props, rtol=1e-12)
    np.testing.assert_array_equal(s2.weights, js2.weights)  # the defined 0.25 each
    after = ModelArrays.from_model(s2, r2, CPU).props.numpy()
    np.testing.assert_allclose(after, np.asarray(JModel.from_model(js2, jr2,
                                                                   jnp.float64).props),
                               rtol=1e-12)
    np.testing.assert_allclose(after, [0.25] * 4, rtol=1e-12)


@pytest.mark.parametrize("model", ["HKY+R3", "HKY+I+R3", "JC+K3", "HKY+I+GM4"])
def test_report_rate_section_matches_jax(model, tmp_path):
    """The report's rate heterogeneity section (FreeRate with k categories,
    each category's rate and proportion) and the model's name suffix are
    the JAX report's lines."""
    jaln, aln = _alignments(DNA)
    (s, r), (js, jr) = parse_model_string(model, aln), jax_parse_model(model, jaln)
    rng = np.random.default_rng(4)
    for x in (r, jr):
        x.alpha, x.p_invar = 0.6, (0.15 if x.has_invar else 0.0)
        if x.free_rates is not None:
            x.free_rates = np.geomspace(0.05, 3.0, x.ncat)
            x.free_props = np.random.default_rng(4).dirichlet(np.ones(x.ncat))
    tree = PhyloTree.from_newick(open(os.path.join(DATA, "ssf_golden.treefile")).read(),
                                 aln.names, rng=rng)
    path = str(tmp_path / "r.iqtree")
    write_report(path, aln, s, r, tree, -1.0, "iqtree-torch", 1.0)
    text = open(path).read().split("\n")
    want = []
    jax_rate_section(want, jr)
    start = text.index("RATE HETEROGENEITY")
    assert text[start:start + len(want)] == want
    assert f"Model of substitution: {s.name}{jr.name_suffix()}" in text


@functools.lru_cache(maxsize=1)
def _dna_c10(pinv=0.1, seed=8, n_taxa=6, n_sites=40):
    """A random DNA alignment, GTR+I+R10 with rates from 1e-3 to 20 and
    random weights, and a random tree, as JAX arrays (f64) and the port's
    tensors: (jax (tree, model, site), port (tree, model, site), steps,
    n_slots)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT-"), n_sites)) for _ in range(n_taxa)]
    aln = JAlignment.from_sequences([f"t{i}" for i in range(n_taxa)], seqs, "DNA")
    subst = jax_dna_model("GTR")
    subst.state_freq = aln.state_frequencies()
    subst.set_rate_param_vector(rng.uniform(0.5, 3.0, 5))
    rate = JRate.make(free_cats=10, invar=True, p_invar=pinv)
    rate.free_rates = np.geomspace(1e-3, 20.0, 10)
    rate.free_props = rng.dirichlet(np.ones(10))
    tree = jax_random_tree(n_taxa, rng, mean_blen=0.2)
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(subst, rate, jnp.float64),
         JSite.from_alignment(aln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, steps, n_slots


@functools.lru_cache(maxsize=1)
def _jax_c10_lnl():
    """The JAX general forward body's per-pattern lnL of _dna_c10, in
    interpret mode (the forward's and the gradient sweep's reference)."""
    (jt, jm, js), _, steps, n_slots = _dna_c10()
    return np.asarray(jax_forward(jnp.asarray(steps), jax_trans(jm, jt.blen),
                                  jax_tips(js, 10), jm.props, jm.state_freq,
                                  jax_ptn_invar(jm, js), n_slots=n_slots, interpret=True))


@pytest.mark.parametrize("kernel", ["forward", "store", "tbar", "down_store", "newton"])
def test_dna_twins_past_eight_categories_match_the_jax_bodies(kernel):
    """At S = 4, C = 10 (GTR+I+R10, rates 1e-3 .. 20) the engine's wrappers
    take the wide walks (build.packed is False) and their plain twins
    against the JAX package's general bodies (_kernel, _kernel_store,
    _kernel_down_tbar, _kernel_down_store: C S = 40 is past its packed
    path) in interpret mode, from the same transition matrices; the branch
    lengths take wide_newton's DNA instance, whose twin (fused_newton_derivs
    on the CPU) is held against the JAX package's fused_newton_derivs (its
    wide-CS reverse sweep, _newton_body, C S = 40 <= 128)."""
    (jt, jm, js), (tt, tm, ts), steps, n_slots = _dna_c10()
    assert tm.ncat == 10 and not build.packed(10, 4) and newton_serves(10, 4)
    assert build.wide_newton_multi(10, 4)
    N, P = tt.n_taxa, ts.pattern_freq.shape[0]
    trans_j, tips_j = jax_trans(jm, jt.blen), jax_tips(js, 10)
    st = convert.schedule(steps, CPU)
    trans, tips = torch.tensor(np.asarray(trans_j)), tip_partials(ts)
    if kernel == "newton":
        want = jax_newton(jnp.asarray(steps), n_slots, jm, jt.blen, tips_j, js.pattern_freq,
                          jax_ptn_invar(jm, js))
        got = cs_kernels.fused_newton_derivs(st, n_slots, tm, tt.blen, tips,
                                             ts.pattern_freq, ptn_invar(tm, ts))
        for g, w in zip(got, want):
            w = np.asarray(w)[:g.shape[0]]
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-9, atol=1e-9 * np.abs(w).max())
        return
    if kernel in ("forward", "tbar"):
        lnl = _jax_c10_lnl()
    if kernel == "forward":
        got = pruning.fused_site_lnl(st, n_slots, trans, tips, tm.props, tm.state_freq,
                                     ptn_invar(tm, ts))
        np.testing.assert_allclose(got.numpy(), lnl, rtol=1e-11)
        return
    if kernel == "store":
        up_j, usc_j = jax_store(jnp.asarray(steps), trans_j, tips_j, n_slots=n_slots,
                                interpret=True)
        up, usc = cs_kernels.fused_upward_store_cs(st, n_slots, trans, tips)
        inner = slice(N, 2 * N - 1)
        np.testing.assert_allclose(
            up[inner].numpy(),
            np.asarray(up_j)[inner, :, :4, :P].reshape(N - 1, 40, P), rtol=1e-10,
            atol=1e-14)
        np.testing.assert_allclose(usc[inner].numpy(), np.asarray(usc_j)[inner, :P],
                                   rtol=1e-10, atol=1e-12)
        return
    if kernel == "down_store":
        up_j, usc_j, out_j, osc_j = jax_passes(jnp.asarray(steps), n_slots, trans_j, tips_j,
                                               jm.props, jm.state_freq, interpret=True)
        up, usc, out, osc = cs_kernels.fused_nni_passes_cs(st, n_slots, trans, tips,
                                                           tm.state_freq)
        rows = [v for v in range(2 * N - 1) if v != tt.root]
        np.testing.assert_allclose(out[rows].numpy(),
                                   np.asarray(out_j)[..., :P].reshape(2 * N, 40, P)[rows],
                                   rtol=1e-9, atol=1e-13)
        np.testing.assert_allclose(osc[rows].numpy(), np.asarray(osc_j)[rows, :P],
                                   rtol=1e-9, atol=1e-11)
        return
    wp = np.asarray(js.pattern_freq) * np.random.default_rng(5).uniform(0.5, 1.5, P)
    up, _, usc8 = jax_store8(jnp.asarray(steps), n_slots, trans_j, tips_j, want_scale8=True,
                             interpret=True)
    P_pad, S_pad = up.shape[-1], up.shape[2]
    tips_f = jnp.pad(tips_j, ((0, 0), (0, S_pad - 4), (0, P_pad - P)), constant_values=0.0)
    up = up.at[:N].set(tips_f[:, None])
    usc8 = usc8.at[:N].set(0.0)
    pad = lambda x: jnp.pad(jnp.asarray(x), (0, P_pad - P))
    want = np.asarray(jax_tbar(jnp.asarray(steps), n_slots, trans_j, tips_j, up, usc8,
                               jm.state_freq, jm.props, pad(lnl), pad(wp), interpret=True))
    got = cs_kernels.fused_tbar_cs(st, n_slots, trans, tips, tm.props, tm.state_freq,
                                   torch.tensor(lnl), torch.tensor(wp))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * float(np.abs(want).max()))


def _written(prefix):
    log = open(prefix + ".log").read()
    lnl = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    model = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    return log, lnl, model, open(prefix + ".treefile").read().strip()


def _jax_lnl(aln_path, nwk, model, seq_type=None, build_model=None):
    """lnL of a written tree and model string by the JAX package, float64
    (ModelArrays.from_model, or `build_model(subst, rate)`)."""
    aln = jax_read_alignment(aln_path, seq_type)
    subst, rate = jax_parse_model(model, aln)
    tree = JTree.from_tree(JPhyloTree.from_newick(nwk, aln.names), jnp.float64)
    m = (build_model or (lambda s, r: JModel.from_model(s, r, jnp.float64)))(subst, rate)
    return float(jax_compute_loglik(tree, m, JSite.from_alignment(aln, jnp.float64))[0])


@pytest.mark.parametrize("path,argv", [
    (DNA, ["-blfix", "-m", "HKY+I+R3"]),
    (DNA, ["-m", "HKY+I+G", "-a", "0.5", "-i", "0.2", "-gmedian"]),
    (DNA, ["-m", "MIX{JC,HKY,GTR}+G4"]),
    (CODON, ["-st", "CODON", "-blfix", "-m", "GY+R4"])])
def test_cli_fit_matches_the_jax_package(path, argv, tmp_path):
    """`-te TREE ... -device cpu` through the port's CLI on a cut of the
    example (GY+R4 at S = 61 and HKY+I+R3 with -blfix: the model fit
    alone, as +I+R's small cuts converge slowly in the alternation): no
    "not ported" exit, the report's rate section, and the
    written tree and model evaluated by the JAX package at the logged lnL
    (+GM: the fit's lnL is the optimizer's mean-quadrature one, which the
    JAX optimizer's ModelArrays give; the written model evaluates with the
    median rates in both packages; GY{kappa,omega}, which the JAX parser
    does not read: the written model's float64 lnL by the port and its
    transition matrices, rates and proportions against the JAX package's
    at the same parameters)."""
    st = "CODON" if path == CODON else None
    aln_path, tree_path = _cut(tmp_path, path, n_taxa=6, n_chars=150 if st else 100,
                               seq_type=st)
    prefix = str(tmp_path / "fit")
    assert cli_main(["-s", aln_path, "-te", tree_path, *argv, "-device", "cpu",
                     "-pre", prefix]) == 0
    log, lnl, model, nwk = _written(prefix)
    report = open(prefix + ".iqtree").read()
    if "-gmedian" in argv:
        assert "+I{0.200000}+GM4{0.500000}" in model
        mean = _jax_lnl(aln_path, nwk, model, build_model=lambda s, r: JOptimizer(
            s, r, dtype=jnp.float64).build({}))
        assert abs(mean - lnl) < 1e-3, (mean, lnl)
        median = compute_loglik(*_port_arrays(aln_path, nwk, model))[0]
        assert abs(_jax_lnl(aln_path, nwk, model) - float(median)) < 1e-8
        assert abs(float(median) - lnl) > 1e-3
        return
    if st:  # GY{kappa,omega}: the JAX parser takes no codon parameters; set them
        ta, got, site = _port_arrays(aln_path, nwk, model, st)
        assert abs(float(compute_loglik(ta, got, site)[0]) - lnl) < 1e-3
        s, r = parse_model_string(model, read_alignment(aln_path, st))
        js, jr = jax_parse_model(argv[-1], jax_read_alignment(aln_path, st))
        js.kappa, js.omega, js.state_freq = s.kappa, s.omega, s.state_freq
        js.refresh_exchange()
        jr.free_rates, jr.free_props = r.free_rates, r.free_props
        want = JModel.from_model(js, jr, jnp.float64)
        blen = torch.tensor([0.01, 0.3])
        np.testing.assert_allclose(branch_transition_mats(got, blen).numpy(),
                                   np.asarray(jax_trans(want, jnp.asarray(blen.numpy()))),
                                   atol=1e-12)
        for f in ("rates", "props", "state_freq"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-12, err_msg=f)
    else:
        assert abs(_jax_lnl(aln_path, nwk, model) - lnl) < 1e-3, (lnl, model)
    if "+R" in argv[-1]:
        assert re.search(r"FreeRate with \d+ categories", report)
    if "MIX" in argv[-1]:  # 12 categories: the DNA instances past 8 on the card
        assert "branch-Newton sweep" in log and "theta path" not in log


def _port_arrays(aln_path, nwk, model, seq_type=None):
    aln = read_alignment(aln_path, seq_type)
    s, r = parse_model_string(model, aln)
    return (TreeArrays.from_tree(PhyloTree.from_newick(nwk, aln.names), CPU),
            ModelArrays.from_model(s, r, CPU), SiteData.from_alignment(aln, CPU,
                                                                       torch.float64))


def test_kategory_fit_matches_jax(tmp_path):
    """+K3 through the CLI and the fit it runs: the fitted rates (mean 1,
    weight 1.0 each, so the lnL carries n log K) evaluated by the JAX
    package at the logged lnL.  The written +K3 takes no values, so the
    check goes through the fit's own objects."""
    aln_path, tree_path = _cut(tmp_path, DNA, n_taxa=6, n_chars=100)
    prefix = str(tmp_path / "k")
    assert cli_main(["-s", aln_path, "-te", tree_path, "-m", "JC+K3", "-device", "cpu",
                     "-pre", prefix]) == 0
    _, lnl, model, _ = _written(prefix)
    assert model.endswith("+K3")
    aln, jaln = read_alignment(aln_path), jax_read_alignment(aln_path)
    s, r = parse_model_string("JC+K3", aln)
    tree = PhyloTree.from_newick(open(tree_path).read(), aln.names,
                                 rng=np.random.default_rng(1))
    ta = TreeArrays.from_tree(tree, CPU)
    steps, n_slots = device_slot_schedule(tree, ta)
    opt = ModelOptimizer(s, r, CPU)
    ta, params, got = optimize_model_and_branches(opt, ta, SiteData.from_alignment(
        aln, CPU, torch.float64), torch.as_tensor(steps), n_slots, tol=0.001)
    assert abs(got - lnl) < 1e-3
    _, r = opt.unpack(params)
    assert abs(r.free_rates.sum() - 3.0) < 1e-12
    js, jr = jax_parse_model("JC+K3", jaln)
    jr.free_rates = r.free_rates
    tree.blen = ta.host_blen()
    want = jax_compute_loglik(JTree.from_tree(convert_tree(tree), jnp.float64),
                              JModel.from_model(js, jr, jnp.float64),
                              JSite.from_alignment(jaln, jnp.float64))[0]
    assert abs(float(want) - got) < 1e-8


def convert_tree(tree):
    """The JAX package's host tree of the port's (the encoding both share)."""
    return JPhyloTree(tree.n_taxa, tree.parent.copy(), tree.children.copy(),
                      tree.blen.copy())


def _cut_arrays(aln_path, tree_path):
    """Both packages' (alignment, tree arrays, float64 site data) of an
    alignment and tree file, and the port's schedule: (port tuple, JAX
    tuple, steps, n_slots)."""
    aln, jaln = read_alignment(aln_path), jax_read_alignment(aln_path)
    nwk = open(tree_path).read()
    ta = TreeArrays.from_tree(PhyloTree.from_newick(nwk, aln.names,
                                                    rng=np.random.default_rng(0)), CPU)
    tree = PhyloTree.from_newick(nwk, aln.names, rng=np.random.default_rng(0))
    steps, n_slots = device_slot_schedule(tree, ta)
    jt = JTree.from_tree(JPhyloTree.from_newick(nwk, jaln.names,
                                                rng=np.random.default_rng(0)), jnp.float64)
    return ((aln, ta, SiteData.from_alignment(aln, CPU, torch.float64)),
            (jaln, jt, JSite.from_alignment(jaln, jnp.float64)), torch.as_tensor(steps),
            n_slots)


def _fits(aln_path, tree_path, model, start):
    """Both packages' float64 fits of `model` on an alignment and tree file
    (optimize_model_and_branches at tol 0.001, as tests/test_golden_configs.py
    runs the JAX one) from init_params() with the entries of `start`
    replaced: (port lnL, JAX lnL)."""
    (aln, ta, site), (jaln, jt, jsite), steps, n_slots = _cut_arrays(aln_path, tree_path)
    s, r = parse_model_string(model, aln)
    js, jr = jax_parse_model(model, jaln)
    opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
    opt.max_pinv = jopt.max_pinv = max(jaln.frac_const_sites(), 1e-4)
    p = {**opt.init_params(), **{k: torch.tensor(v) for k, v in start.items()}}
    jp = {**jopt.init_params(), **{k: jnp.asarray(v) for k, v in start.items()}}
    got = optimize_model_and_branches(opt, ta, site, steps, n_slots, params=p, tol=0.001)[2]
    return got, float(jax_fit(opt=jopt, tree=jt, site=jsite, params=jp, tol=0.001)[2])


@pytest.mark.parametrize("path,tree,model,golden,tol", [
    (DNA, "ssf_golden.treefile", "HKY+R4", GOLDEN_HKY_R4, 0.1),
    (PROT, "lg_golden.treefile", "LG4X", GOLDEN_LG4X, 0.05)])
def test_freerate_goldens(path, tree, model, golden, tol, tmp_path):
    """The reference binary's -te optimum (HKY+R4: tests/test_golden_configs.py;
    LG4X: DIFFTEST prot_lg4x_te) met by the port's CLI fit in float64 on the
    CPU, as the lower bound; and on a cut of the same alignment (8 taxa, a
    random tree) the port's fit within 0.01 of the JAX package's fit of the
    same inputs, both run here.  HKY's fits there start at kappa = 2: at
    kappa = 1, every HKY fit's start, both packages' kappa derivative is
    wrong (test_degenerate_start_gradient_is_a_fault_of_both_packages),
    their first steps differ, and on this cut the FreeRate fits end in
    different optima (-868.8391 in the port, -868.4757 in the JAX package;
    ROADMAP Queue 3)."""
    prefix = str(tmp_path / "g")
    assert cli_main(["-s", path, "-te", os.path.join(DATA, tree), "-m", model,
                     "-device", "cpu", "-pre", prefix]) == 0
    log, lnl, written, nwk = _written(prefix)
    assert lnl >= golden - tol, lnl
    if model == "HKY+R4":
        assert abs(_jax_lnl(path, nwk, written) - lnl) < 1e-3
    else:  # the fit's weights are FreeRate's (the written string's evaluation is not)
        assert written.startswith("MIX{LG4X1:1:0.25,") and "*R4+R4{" in written
    aln_path, tree_path = _cut(tmp_path, path, n_taxa=8, n_chars=150 if path == DNA else 100)
    start = {"log_rates": np.log([2.0])} if model == "HKY+R4" else {}
    got, want = _fits(aln_path, tree_path, model, start)
    assert abs(got - want) < 0.01, (got, want)


def test_degenerate_start_gradient_is_a_fault_of_both_packages(tmp_path):
    """At an HKY or GTR fit's start (kappa = 1, equal rates) the rate
    matrix's eigenvalue is threefold.  Both packages' degenerate-safe eigh
    derivative (models/eigen.py SafeEigh, JAX safe_eigh) zeroes the cross
    terms inside that eigenspace, whose limit in P(t) = V exp(Lambda t)
    V^-1 is f'(lambda), not 0: d lnL / d log kappa misses the central
    finite difference by more than 1 in both, by amounts that depend on the
    eigenvector basis each eigh returns (a fault of the reference, kept:
    ROADMAP Queue 3).  At kappa = 2 both are within 1e-5 of it."""
    aln_path, tree_path = _cut(tmp_path, DNA, n_taxa=8, n_chars=150)
    (aln, ta, site), (jaln, jt, jsite), steps, n_slots = _cut_arrays(aln_path, tree_path)
    s, r = parse_model_string("HKY+G4", aln)
    js, jr = jax_parse_model("HKY+G4", jaln)
    opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
    jgrad = jax.jit(jax.value_and_grad(lambda q: jax_compute_loglik(jt, jopt.build(q),
                                                                    jsite)[0]))

    def lnl(p):
        return loglik(ta, opt.build(p), site, steps, n_slots)[0]

    for kappa, faulty in ((1.0, True), (2.0, False)):
        p = {**opt.init_params(), "log_rates": torch.tensor([np.log(kappa)])}
        p = {k: v.clone().requires_grad_() for k, v in p.items()}
        total = lnl(p)
        got = float(torch.autograd.grad(total, [p["log_rates"]])[0])
        jl, jg = jgrad({k: jnp.asarray(v.detach().numpy()) for k, v in p.items()})
        assert abs(float(total.detach()) - float(jl)) < 1e-8
        with torch.no_grad():
            h = 1e-6
            fd = (float(lnl({**p, "log_rates": p["log_rates"] + h}))
                  - float(lnl({**p, "log_rates": p["log_rates"] - h}))) / (2 * h)
        errs = [abs(got - fd), abs(float(jg["log_rates"][0]) - fd)]
        if faulty:
            assert min(errs) > 1.0, (got, float(jg["log_rates"][0]), fd)
        else:
            assert max(errs) < 1e-5 * max(1.0, abs(fd)), (got, float(jg["log_rates"][0]), fd)


def test_engine_routes_dna_past_eight_categories_to_the_wide_walks(monkeypatch):
    """+R10 on DNA: C = 10 at S = 4 is no CS-packed shape; the banner names
    the wide walks' DNA instance and the branch-Newton sweep kernel (its DNA
    instance serves up to 32 categories, the theta path past them), and
    check_shape serves the walks as far as their shared memory allows (the
    card's launches: tests/test_torch_cuda.py)."""
    monkeypatch.setattr(banner, "memory_capacity", lambda device: 64 << 30)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    card = torch.device("cuda")
    dec = banner.decide_engine(1000, 10, 4, 9962, card, torch.float32)
    text = banner.engine_banner(dec, 1000, 10, 4, 9962, search=True)
    assert "wide [C,S,S] x [C,S,tile], S=4, 2 categories a block on 5-block clusters" in text
    assert "branch-Newton sweep kernel" in text and "theta path" not in text
    assert "wide outside-partial store" in text
    packed = banner.engine_banner(banner.decide_engine(1000, 8, 4, 9962, card,
                                                       torch.float32), 1000, 8, 4, 9962)
    assert "CS-packed" in packed and "branch-Newton sweep kernel" in packed
    past = banner.engine_banner(banner.decide_engine(1000, 40, 4, 9962, card,
                                                     torch.float32), 1000, 40, 4, 9962)
    assert "5 categories a block on 8-block clusters" in past and "theta path" in past
    with pytest.raises(NotImplementedError, match="shared memory"):
        banner.decide_engine(1000, 545, 4, 9962, card, torch.float32)
