"""Binary (-st BIN) and morphological (-st MORPH) data in the port against
the JAX package: state spaces, pattern compression, the models JC2, GTR2,
MK and ORDERED, their likelihoods, the -te MK+G fit of a simulated
morphology matrix, and the kernels' padding rule.

Inputs are made with numpy from seeds (the morphology matrix by the JAX
package's simulator, as scripts/difftest.py builds its `morph_mk_te`
case); both packages run in float64 on the CPU, the port on its kernels'
plain twins.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.distances import ml_distances as jax_ml_distances
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.factory import default_model as jax_default_model
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.optimize import ModelOptimizer as JOptimizer
from iqtree_tpu.models.optimize import optimize_model_and_branches as jax_fit
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.models.subst import ReversibleModel as JReversible
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree
from iqtree_tpu.trees.tree import random_tree as jax_random_tree
from iqtree_tpu.utils.simulate import simulate_alignment

from iqtree_torch.cli import main as cli_main
from iqtree_torch.config import parse_args
from iqtree_torch.engine import banner
from iqtree_torch.engine import parsimony as pars
from iqtree_torch.engine.derivatives import newton_serves
from iqtree_torch.engine.distances import ml_distances
from iqtree_torch.engine.kernels import build
from iqtree_torch.engine.likelihood import ModelArrays, SiteData, TreeArrays, compute_loglik
from iqtree_torch.io.alignment import MORPH_SYMBOLS, Alignment, read_alignment
from iqtree_torch.models.factory import ModelParseError, default_model, parse_model_string
from iqtree_torch.models.optimize import ModelOptimizer
from iqtree_torch.trees.tree import random_tree

from test_torch_search import jax_stepwise_tree

torch.set_num_threads(1)
CPU = torch.device("cpu")
MORPH_REF_LNL = -2804.829  # the C++ binary's -te MK+G fit of morph_mk_te (DIFFTEST.md)


def sequences(S, n_taxa=12, n_sites=200, seed=0, gaps=True):
    """(names, sequences, seq type) of random binary (S = 2) or
    morphological data with every state used."""
    rng = np.random.default_rng(seed)
    alphabet = "01" if S == 2 else MORPH_SYMBOLS[:S]
    seqs = [list(rng.choice(list(alphabet), n_sites)) for _ in range(n_taxa)]
    seqs[0][0] = alphabet[-1]  # the state count is the highest symbol's
    if gaps:
        for s in seqs:
            for j in rng.choice(n_sites, n_sites // 20, replace=False):
                s[j] = rng.choice(["-", "?"])
    return ([f"t{i}" for i in range(n_taxa)], ["".join(s) for s in seqs],
            "BIN" if S == 2 else "MORPH")


@pytest.mark.parametrize("S", [2, 3, 6, 21])
def test_state_spaces_and_patterns_match_jax(S):
    """The state space (codes, ambiguity masks), the detected type, the
    pattern compression and every derived count of both packages agree."""
    names, seqs, st = sequences(S, seed=S)
    a, j = Alignment.from_sequences(names, seqs, st), JAlignment.from_sequences(names, seqs, st)
    assert a.num_states == j.num_states == S
    assert a.states.char_to_code == j.states.char_to_code
    np.testing.assert_array_equal(a.states.code_masks, j.states.code_masks)
    for f in ("patterns", "pattern_freq", "site_to_pattern", "const_state"):
        np.testing.assert_array_equal(getattr(a, f), getattr(j, f))
    assert a.frac_const_sites() == j.frac_const_sites()
    assert a.num_informative_sites() == j.num_informative_sites()
    np.testing.assert_allclose(a.state_frequencies(), j.state_frequencies(), rtol=1e-12)
    assert default_model(a) == jax_default_model(j)
    if S <= 10:  # digits only: detected as the type they are
        detected = Alignment.from_sequences(names, seqs)
        assert detected.states.seq_type == JAlignment.from_sequences(
            names, seqs).states.seq_type == st
    else:  # letters past 9: detected as protein, whose characters they are not
        for pkg in (Alignment, JAlignment):
            with pytest.raises(ValueError, match="invalid character"):
                pkg.from_sequences(names, seqs)


@pytest.mark.parametrize("model,S", [("JC2", 2), ("GTR2", 2), ("MK", 6), ("MK", 3),
                                     ("ORDERED", 6), ("ORDERED", 3)])
def test_models_match_jax(model, S):
    """Q, the eigensystem (as P(t) = V e^(lam t) V^-1, which no eigenvector
    sign changes) and the free parameters: ORDERED has fixed rates, JC2 and
    MK equal frequencies, GTR2 counted ones; none has a free rate."""
    names, seqs, st = sequences(S, seed=10 + S)
    a, j = Alignment.from_sequences(names, seqs, st), JAlignment.from_sequences(names, seqs, st)
    (s, r), (js, jr) = parse_model_string(model, a), jax_parse_model(model, j)
    assert (s.name, s.num_states, s.freq_type, s.fixed_rates, s.n_rate_params) == \
        (js.name, js.num_states, js.freq_type, js.fixed_rates, js.n_rate_params) == \
        (model, S, s.freq_type, model == "ORDERED", 0)
    np.testing.assert_allclose(s.state_freq, js.state_freq, rtol=1e-12)
    np.testing.assert_allclose(s.rate_matrix(), js.rate_matrix(), rtol=1e-12, atol=1e-14)
    p = lambda lam, v, vi: v @ np.diag(np.exp(0.3 * lam)) @ vi
    np.testing.assert_allclose(p(*s.eigen()), p(*js.eigen()), atol=1e-12)
    assert set(ModelOptimizer(s, r, CPU).init_params()) == \
        set(JOptimizer(js, jr, dtype=jnp.float64).init_params()) == set()
    if model == "ORDERED":  # changes only between neighbouring states
        q = s.rate_matrix()
        assert np.all(q[np.abs(np.subtract.outer(range(S), range(S))) > 1] == 0)


def simulated(model, S, tree, seed, variable=False, n_sites=200):
    """(names, sequences, seq type) simulated by the JAX package under
    `model` (its own frequencies: GTR2's 0.6 / 0.4) +G4 (alpha 0.6) on
    `tree`, 5% of the characters unknown unless `variable`, which keeps the
    columns with two or more states and no unknown."""
    rng = np.random.default_rng(seed)
    if model == "ORDERED":
        band = np.eye(S, k=1) + np.eye(S, k=-1)
        subst = JReversible(model, S, exchange=band, fixed_rates=True)
    else:
        subst = JReversible(model, S, rate_groups=np.zeros(S * (S - 1) // 2, int),
                            state_freq=np.array([0.6, 0.4]) if model == "GTR2" else None)
    seqs = [list(x) for x in simulate_alignment(tree, subst, JRate.make(gamma_cats=4, alpha=0.6),
                                                n_sites, rng)]
    if variable:
        cols = [j for j in range(n_sites) if len({x[j] for x in seqs}) > 1]
        seqs = [[x[j] for j in cols] for x in seqs]
    else:
        for x in seqs:
            for j in rng.choice(n_sites, n_sites // 20, replace=False):
                x[j] = "?"
    return ([f"t{i}" for i in range(tree.n_taxa)], ["".join(x) for x in seqs],
            "BIN" if S == 2 else "MORPH")


@pytest.mark.parametrize("asc", [False, True])
@pytest.mark.parametrize("model,S", [("JC2", 2), ("GTR2", 2), ("MK", 6), ("ORDERED", 6)])
def test_lnl_matches_jax(model, S, asc):
    """The lnL of each model +G4 with and without +ASC (on the variable
    columns) on data simulated under it: the port's plain pass against the
    JAX package's, to 1e-8 relative."""
    host = jax_random_tree(10, np.random.default_rng(S), mean_blen=0.2)
    port_tree = random_tree(10, np.random.default_rng(S), mean_blen=0.2)
    names, seqs, st = simulated(model, S, host, 20 + S, variable=asc)
    a, j = Alignment.from_sequences(names, seqs, st), JAlignment.from_sequences(names, seqs, st)
    assert a.num_states == S
    m = model + "+G4" + ("+ASC" if asc else "")
    (s, r), (js, jr) = parse_model_string(m, a), jax_parse_model(m, j)
    assert s.asc == js.asc == asc
    r.alpha = jr.alpha = 0.6
    got, _ = compute_loglik(TreeArrays.from_tree(port_tree, CPU),
                            ModelArrays.from_model(s, r, CPU),
                            SiteData.from_alignment(a, CPU, torch.float64, asc=asc))
    want, _ = jax_compute_loglik(JTree.from_tree(host, jnp.float64),
                                 JModel.from_model(js, jr, jnp.float64),
                                 JSite.from_alignment(j, jnp.float64, asc=asc))
    assert abs(float(got) - float(want)) <= 1e-8 * abs(float(want)), (float(got), float(want))


@pytest.mark.parametrize("S", [2, 6])
def test_distances_and_stepwise_trees_match_jax(S):
    """The search's start trees at S = 2 (4-bit parsimony lanes) and S = 6
    (32-bit lanes): ML distances under JC2+G4 / MK+G4 to 1e-8, and the
    stepwise-addition tree of a seed, arrays equal."""
    names, seqs, st = sequences(S, n_taxa=12, n_sites=150, seed=40 + S)
    a, j = Alignment.from_sequences(names, seqs, st), JAlignment.from_sequences(names, seqs, st)
    m = "JC2+G4" if S == 2 else "MK+G4"
    (s, r), (js, jr) = parse_model_string(m, a), jax_parse_model(m, j)
    got = ml_distances(ModelArrays.from_model(s, r, CPU),
                       SiteData.from_alignment(a, CPU, torch.float64))
    want = jax_ml_distances(JModel.from_model(js, jr, jnp.float64),
                            JSite.from_alignment(j, jnp.float64))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-8, atol=1e-10)
    assert pars.lane_width(S) == (4 if S == 2 else 32)
    tree = pars.parsimony_stepwise_tree(a, np.random.default_rng(S), CPU)
    jtree = jax_stepwise_tree(j, np.random.default_rng(S))
    for f in ("parent", "children", "blen"):
        np.testing.assert_array_equal(getattr(tree, f), getattr(jtree, f), err_msg=f)


def morph_mk_te(tmp_path):
    """scripts/difftest.py's `morph_mk_te` input, rebuilt: MK (k = 6) +G4
    (alpha 1) simulated by the JAX package on a random 18-taxon tree,
    200 sites, numpy seed 6; (alignment path, tree path)."""
    rng = np.random.default_rng(6)
    n, k, sites = 18, 6, 200
    t = jax_random_tree(n, rng, mean_blen=0.3)
    subst = JReversible("MK", k, rate_groups=np.zeros(k * (k - 1) // 2, int))
    seqs = simulate_alignment(t, subst, JRate.make(gamma_cats=4, alpha=1.0), sites, rng)
    names = [f"m{i:02d}" for i in range(n)]
    aln, tree = str(tmp_path / "morph.phy"), str(tmp_path / "morph.nwk")
    with open(aln, "w") as f:
        f.write(f" {n} {sites}\n" + "".join(f"{nm}  {sq}\n" for nm, sq in zip(names, seqs)))
    with open(tree, "w") as f:
        f.write(t.to_newick(names) + "\n")
    return aln, tree


def test_morph_mk_te_fit_matches_jax_and_the_binary(tmp_path):
    """`-st MORPH -te TREE -m MK+G -device cpu` through the CLI on the
    rebuilt morph_mk_te input: within 0.01 of the JAX package's float64 fit
    of the same files (run live) and at least the C++ binary's -2804.829
    less 0.05; the report names the morphological sites and their states."""
    aln_path, tree_path = morph_mk_te(tmp_path)
    prefix = str(tmp_path / "mk")
    assert cli_main(["-s", aln_path, "-st", "MORPH", "-te", tree_path, "-m", "MK+G",
                     "-device", "cpu", "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        lnl = float(re.search(r"Optimal log-likelihood: (\S+)", f.read()).group(1))
    ja = jax_read_alignment(aln_path, seq_type="MORPH")
    assert read_alignment(aln_path, "MORPH").num_states == ja.num_states == 6
    js, jr = jax_parse_model("MK+G", ja)
    with open(tree_path) as f:
        jt = JPhyloTree.from_newick(f.read(), ja.names, rng=np.random.default_rng(1))
    _, _, want = jax_fit(JOptimizer(js, jr, dtype=jnp.float64), JTree.from_tree(jt, jnp.float64),
                         JSite.from_alignment(ja, jnp.float64), tol=0.001)
    assert abs(lnl - float(want)) <= 0.01, (lnl, float(want))
    assert lnl >= MORPH_REF_LNL - 0.05
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "200 morphological sites" in report and "Model of substitution: MK+G4" in report
    assert "pi(5) = 0.1667" in report


@pytest.mark.parametrize("S,C,SK,packed,newton", [
    (2, 4, 2, True, True), (2, 8, 2, True, True), (2, 10, 4, False, True),
    (2, 40, 4, False, False), (3, 4, 4, True, True), (3, 12, 4, False, True),
    (4, 4, 4, True, True), (5, 4, 20, False, True), (6, 4, 20, False, True),
    (20, 8, 20, False, True), (6, 12, 20, False, False), (21, 4, 64, False, False),
    (32, 8, 64, False, False)])
def test_padding_rule_routes_every_state_count(S, C, SK, packed, newton):
    """build.instance_states is the padding rule of every wrapper: S = 2 on
    its own CS-packed instance up to 8 categories, S <= 4 past them on the
    S = 4 walks and wide_newton's multi-category instance, 5 to 20 states
    on the S = 20 wide kernels, 21 to 32 on the S = 64 walks (the theta
    path for their branch lengths); check_shape serves each and refuses
    21 to 32 states past 8 categories; the banner names the padded
    instance."""
    assert build.instance_states(S, C) == SK
    assert build.packed(C, S) == packed
    assert newton_serves(C, S) == newton
    assert not newton_serves(C, S, asc=True)  # +ASC: the theta path
    build.check_shape(C, S, n_slots=8)
    if packed:
        with pytest.raises(NotImplementedError, match="CS-packed kernels serve"):
            build.check_shape(C, S, walk=True)
    dec = banner.decide_engine(30, C, S, 500, CPU, torch.float64)
    text = banner.engine_banner(dec, 30, C, S, 500)
    assert ("theta path" in text) == (not newton)


def test_padding_rule_refusals_and_card_banner(monkeypatch):
    """Past 8 categories 21 to 32 states are refused, naming the slice that
    brings them; on the card the banner names each instance and its
    padding, and +ASC's theta path."""
    with pytest.raises(NotImplementedError, match="the codon mixture slice"):
        build.check_shape(12, 21)
    monkeypatch.setattr(banner, "memory_capacity", lambda device: 64 << 30)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device: "card")
    card = torch.device("cuda")
    for S, C, want in ((2, 4, "CS-packed, S=2 forward"), (3, 4, "CS-packed, S=3 (padded 4)"),
                       (4, 4, "(CS-packed forward"), (6, 4, "S=6 (padded 20)"),
                       (2, 10, "S=2 (padded 4), 2 categories a block"),
                       (21, 4, "S=21 (padded 64)")):
        dec = banner.decide_engine(30, C, S, 500, card, torch.float32, search=True)
        assert dec.store_bytes == 60 * (C * build.instance_states(S, C) + 1) * 500 * 4 * 2
        assert want in banner.engine_banner(dec, 30, C, S, 500, search=True), (S, C)
    dec = banner.decide_engine(30, 4, 2, 500, card, torch.float32, has_asc=True)
    text = banner.engine_banner(dec, 30, 4, 2, 500, has_asc=True)
    assert "theta path on the upward-store and outside-partial-store kernels (+ASC's terms)" \
        in text


def test_cli_binary_and_morphology_run(tmp_path):
    """`-st BIN` and `-st MORPH` parse; a binary alignment is detected and
    fitted with the default JC2+G, the written model parses back to the
    lnL; an unknown model of the type is refused with the JAX message."""
    assert parse_args(["-s", "x", "-st", "bin", "-te", "t"]).seq_type == "BIN"
    assert parse_args(["-s", "x", "-st", "MORPH"]).seq_type == "MORPH"
    names, seqs, _ = sequences(2, n_taxa=9, n_sites=120, seed=3)
    path = str(tmp_path / "b.phy")
    with open(path, "w") as f:
        f.write(f"9 120\n" + "".join(f"{n} {s}\n" for n, s in zip(names, seqs)))
    tree = str(tmp_path / "b.nwk")
    with open(tree, "w") as f:
        f.write(random_tree(9, np.random.default_rng(3)).to_newick(names) + "\n")
    prefix = str(tmp_path / "b")
    assert cli_main(["-s", path, "-te", tree, "-device", "cpu", "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    assert "(BIN)" in log and "parameters: JC2+F{0.500000,0.500000}+G4{" in log
    with open(prefix + ".iqtree") as f:
        assert "120 binary sites" in f.read()
    a = read_alignment(path)
    for name, jname in (("GTR", "unknown binary model"), ("LG", "unknown binary model")):
        with pytest.raises(ModelParseError, match=jname):
            parse_model_string(name, a)
        with pytest.raises(ValueError, match=jname):
            jax_parse_model(name, JAlignment.from_sequences(names, seqs, "BIN"))
