"""The mixture models of the port against the JAX package.

Both packages parse the same model strings on the same alignments: the
27-taxon protein example (tests/data/prot_M126_27_269.phy) with a random
tree from a numpy seed, an 8-taxon x 80-site cut of it for the fits (the
JAX optimizer's CPU fit of C10 takes ~100 s on the whole example), and the
44-taxon DNA example for a mixture of at most 8 categories.  Everything
runs in float64 on the CPU: the JAX side as its own tests run it, the
port's side on the plain twins of its kernels.  The kernels at C > 8
themselves are held against the twins by tests/test_torch_cuda.py and
chip_smoke.py on the card.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.grad import loglik as jax_loglik
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.optimize import ModelOptimizer as JOptimizer
from iqtree_tpu.models.optimize import optimize_model_and_branches as jax_fit
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.config import parse_args
from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.kernels.pruning import device_slot_schedule, fused_compute_loglik
from iqtree_torch.engine.likelihood import ModelArrays, SiteData
from iqtree_torch.io.alignment import read_alignment
from iqtree_torch.models import mixture
from iqtree_torch.models.factory import parse_model_string
from iqtree_torch.models.mixture import MixtureModel, category_count
from iqtree_torch.models.optimize import ModelOptimizer, optimize_model_and_branches

from test_torch_likelihood import CPU, DATA

PROT = os.path.join(DATA, "prot_M126_27_269.phy")
DNA = os.path.join(DATA, "example.phy")


def _prot_case(path=PROT, seed=7):
    """(JAX alignment, port alignment, JAX tree, port TreeArrays, JAX
    SiteData, port SiteData, slot schedule, n_slots) on a random tree."""
    jaln, aln = jax_read_alignment(path), read_alignment(path)
    tree = jax_random_tree(jaln.n_taxa, np.random.default_rng(seed))
    jt = JTree.from_tree(tree, jnp.float64)
    tt = convert.tree_arrays(jt, CPU)
    steps, n_slots = device_slot_schedule(convert.phylo_tree(tree), tt)
    return (jaln, aln, jt, tt, JSite.from_alignment(jaln, jnp.float64),
            SiteData.from_alignment(aln, CPU, torch.float64),
            torch.as_tensor(steps), n_slots)


@pytest.mark.parametrize("name,ncat", [("EX2", 2), ("EHO", 3), ("C10", 40), ("LG4M", 4),
                                       ("CF4", 20)])
def test_builtin_mixtures_have_the_jax_packages_categories(name, ncat):
    """A built-in mixture parses into the JAX package's classes, weights,
    rates and category count."""
    jaln, aln = jax_read_alignment(PROT), read_alignment(PROT)
    js, jr = jax_parse_model(name, jaln)
    s, r = parse_model_string(name, aln)
    assert isinstance(s, MixtureModel) and s.n_mix == js.n_mix
    assert (s.fix_weights, s.fused_with_rate) == (js.fix_weights, js.fused_with_rate)
    np.testing.assert_array_equal(s.weights, js.weights)
    np.testing.assert_array_equal(s.comp_rates, js.comp_rates)
    assert category_count(s, r) == ncat == JModel.from_model(js, jr, jnp.float64).ncat
    assert ModelArrays.from_model(s, r, CPU).ncat == ncat


def test_lg4x_and_frequency_suffixes_are_refused():
    """LG4X fuses its classes with FreeRate (*R4; tests/test_torch_freerate.py),
    so a +K suffix cannot join it; a +F suffix does not apply to a mixture
    (the JAX package's messages, both)."""
    aln, jaln = read_alignment(PROT), jax_read_alignment(PROT)
    for parse, a in ((parse_model_string, aln), (jax_parse_model, jaln)):
        with pytest.raises(ValueError, match=r"\+K cannot combine with \+G/\+R/\+I"):
            parse("LG4X+K4", a)
    with pytest.raises(ValueError, match="frequency suffixes don't apply to mixture"):
        parse_model_string("C10+F", aln)


@pytest.mark.parametrize("model,path", [("EX2+G", PROT), ("C10", PROT), ("LG4M", PROT),
                                        ("MIX{WAG,LG}", PROT), ("CF4", PROT),
                                        ("MIX{JC,HKY}+G4", DNA)])
def test_model_arrays_match_jax(model, path):
    """The fused category axis (m-major, rates r x comp_rate, proportions
    w x w_r, each category its class's eigensystem and frequencies): the
    port's from the port's parse, and carried across from the JAX
    package's MixtureModel, equal the JAX package's ModelArrays."""
    js, jr = jax_parse_model(model, jax_read_alignment(path))
    s, r = parse_model_string(model, read_alignment(path))
    want = convert.model_arrays(JModel.from_model(js, jr, jnp.float64), CPU)
    for got in (ModelArrays.from_model(s, r, CPU),
                ModelArrays.from_mixture(convert.mixture_model(js), r, CPU)):
        for f in ("eigenvalues", "eigvec", "inv_eigvec", "state_freq", "rates", "props",
                  "p_invar"):
            np.testing.assert_allclose(getattr(got, f).numpy(), getattr(want, f).numpy(),
                                       rtol=1e-12, atol=1e-12, err_msg=f)


@pytest.mark.parametrize("model", ["MIX{WAG,LG}", "EX2+G", "LG4M", "C10"])
def test_site_lnl_matches_jax(model):
    """Per-pattern lnL through the port's forward wrapper (its plain twin)
    against JAX compute_loglik, to 1e-9 relative; MIX{WAG,LG} is also the
    weighted sum of its components' likelihoods."""
    jaln, aln, jt, tt, js, ts, steps, n_slots = _prot_case()
    jsub, jr = jax_parse_model(model, jaln)
    s, r = parse_model_string(model, aln)
    _, want = jax_compute_loglik(jt, JModel.from_model(jsub, jr, jnp.float64), js)
    total, got = fused_compute_loglik(tt, ModelArrays.from_model(s, r, CPU), ts, steps,
                                      n_slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    if model == "MIX{WAG,LG}":
        parts = [fused_compute_loglik(tt, ModelArrays.from_model(*parse_model_string(m, aln),
                                                                 CPU), ts, steps, n_slots)[1]
                 for m in ("WAG", "LG")]
        np.testing.assert_allclose(
            got.numpy(), np.log(0.5 * np.exp(parts[0].numpy()) + 0.5 * np.exp(parts[1].numpy())),
            rtol=1e-10)


def test_gradient_matches_jax():
    """d lnL / d(mix_logits, alpha_logit) through the optimizers' parameters
    and d lnL / d(two branch lengths), the port's sweep gradient against
    jax.grad of the JAX lnL, to 1e-6 relative."""
    jaln, aln, jt, tt, js, ts, steps, n_slots = _prot_case()
    jsub, jr = jax_parse_model("EX2+G", jaln)
    s, r = parse_model_string("EX2+G", aln)
    jopt, opt = JOptimizer(jsub, jr, dtype=jnp.float64), ModelOptimizer(s, r, CPU)
    jp = jopt.init_params()
    assert set(jp) == {"mix_logits", "alpha_logit"} == set(opt.init_params())
    want_p, want_b = jax.grad(lambda p, b: jax_loglik(jt.with_blen(b), jopt.build(p), js)[0],
                              argnums=(0, 1))(jp, jt.blen)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    blen = tt.blen.clone().requires_grad_()
    total, _ = loglik(tt.with_blen(blen), opt.build(p), ts, steps, n_slots)
    got = torch.autograd.grad(total, [*p.values(), blen])
    for k, g in zip(p, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[k]), rtol=1e-6, err_msg=k)
    for v in (1, tt.n_taxa + 2):
        np.testing.assert_allclose(float(got[-1][v]), float(want_b[v]), rtol=1e-6)


def test_ex2_weight_optimization_raises_lnl():
    """EX2+G's free class weights and alpha, fitted with the branches: the
    lnL rises and the weights stay a distribution."""
    _, aln, _, tt, _, ts, steps, n_slots = _prot_case()
    s, r = parse_model_string("EX2+G", aln)
    assert not s.fix_weights
    opt = ModelOptimizer(s, r, CPU)
    p = opt.init_params()
    lnl0 = float(fused_compute_loglik(tt, opt.build(p), ts, steps, n_slots)[0])
    _, p2, lnl = optimize_model_and_branches(opt, tt, ts, steps, n_slots, params=p,
                                             rounds=1)
    assert lnl > lnl0
    w = opt.unpack(p2)[0].weights
    assert abs(w.sum() - 1.0) < 1e-12 and (w > 0).all()


def _cut(tmp_path, n_taxa=8, n_sites=80, seed=3):
    """The first n_taxa rows and n_sites columns of the protein example and
    a random tree on them, as files: (alignment path, tree path, JAX
    alignment, JAX tree)."""
    rows = [line.split() for line in open(PROT).read().split("\n")[1:] if line.strip()]
    aln_path, tree_path = str(tmp_path / "cut.phy"), str(tmp_path / "cut.tree")
    with open(aln_path, "w") as f:
        f.write(f"{n_taxa} {n_sites}\n")
        f.writelines(f"{a} {b[:n_sites]}\n" for a, b in rows[:n_taxa])
    jaln = jax_read_alignment(aln_path)
    tree = jax_random_tree(n_taxa, np.random.default_rng(seed))
    with open(tree_path, "w") as f:
        f.write(tree.to_newick(jaln.names) + "\n")
    return aln_path, tree_path, jaln, tree


@pytest.mark.parametrize("model", ["EX2+G", "C10"])
def test_cli_fit_matches_the_jax_optimizer(model, tmp_path):
    """`-te TREE -m MODEL -device cpu` through the port's CLI against the
    JAX optimizer's float64 fit of the same inputs, within 0.01 lnL; the
    report has the mixture table and the model's rate suffix."""
    aln_path, tree_path, jaln, tree = _cut(tmp_path)
    prefix = str(tmp_path / "fit")
    assert cli_main(["-s", aln_path, "-te", tree_path, "-m", model, "-device", "cpu",
                     "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    got = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    jsub, jr = jax_parse_model(model, jaln)
    jopt = JOptimizer(jsub, jr, dtype=jnp.float64)
    _, _, want = jax_fit(jopt, JTree.from_tree(tree, jnp.float64),
                         JSite.from_alignment(jaln, jnp.float64), tol=0.001)
    assert abs(got - float(want)) < 0.01, (got, float(want))
    assert ("theta path" in log) == (model == "C10")  # C10's 40 categories
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "Mixture model of substitution (class, rate, weight):" in report
    assert "Model of substitution: " + ("MIX+G4" if model == "EX2+G" else "POISSON+FMIX+G4") \
        in report
    assert "State frequencies (class-weighted means):" in report


def test_dna_mixture_of_eight_categories_matches_jax():
    """MIX{JC,HKY}+G4 on the DNA example: 8 categories, the CS-packed
    kernels' shapes; the per-pattern lnL against JAX compute_loglik and the
    branch Newton on its sweep (C <= 8), not the theta path."""
    from iqtree_torch.engine.derivatives import newton_serves

    jaln, aln, jt, tt, js, ts, steps, n_slots = _prot_case(DNA, seed=4)
    jsub, jr = jax_parse_model("MIX{JC,HKY}+G4", jaln)
    s, r = parse_model_string("MIX{JC,HKY}+G4", aln)
    model = ModelArrays.from_model(s, r, CPU)
    assert model.ncat == 8 and newton_serves(8, 4)
    _, want = jax_compute_loglik(jt, JModel.from_model(jsub, jr, jnp.float64), js)
    _, got = fused_compute_loglik(tt, model, ts, steps, n_slots)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)


def test_lg4m_search_on_cpu(tmp_path):
    """`-m LG4M -n 1` through the CLI on the CPU: a search with the fused
    mixture (class m with Gamma rate class m), its tree and report."""
    prefix = str(tmp_path / "lg4m")
    assert cli_main(["-s", PROT, "-m", "LG4M", "-n", "1", "-ninit", "2", "-ntop", "1",
                     "-device", "cpu", "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    lnl = float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1))
    assert np.isfinite(lnl) and "4x20" in log and "branch-Newton sweep" in log
    with open(prefix + ".treefile") as f:
        assert f.read().count(",") == 26
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "Model of substitution: MIX+G4" in report and "LG4M1" in report


def test_mwopt_frees_pinned_weights(monkeypatch):
    """-mwopt: C10's pinned weights become free parameters."""
    aln = read_alignment(PROT)
    assert parse_args(["-s", PROT, "-mwopt"]).optimize_mixmodel_weight
    assert not parse_args(["-s", PROT]).optimize_mixmodel_weight
    assert parse_model_string("C10", aln)[0].fix_weights
    monkeypatch.setattr(mixture, "FORCE_OPT_WEIGHTS", True)
    s, r = parse_model_string("C10", aln)
    assert not s.fix_weights and "mix_logits" in ModelOptimizer(s, r, CPU).init_params()
