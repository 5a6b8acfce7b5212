"""+ASC (Lewis's ascertainment-bias correction) in the port against the JAX
package: the two refusals, the corrected lnL, its gradient through the
kernels' sweep, the branch derivatives on the theta path, the NNI
evaluator's scores, and a small binary search.

Data are simulated by the JAX package's simulator down a random tree from
numpy seeds (DNA under GTR, protein under LG, binary under GTR2, all +G4)
and cut to their variable columns, as +ASC takes them; both packages run
in float64 on the CPU, the port on its kernels' plain twins.
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
from iqtree_tpu.engine.derivatives import branch_lnl_derivs as jax_branch_lnl_derivs
from iqtree_tpu.engine.derivatives import compute_thetas as jax_compute_thetas
from iqtree_tpu.engine.grad import loglik as jax_loglik
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.nni import evaluate_nnis as jax_evaluate_nnis
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.dna import create_dna_model as jax_dna_model
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.protein import create_protein_model as jax_protein_model
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.models.subst import ReversibleModel as JReversible
from iqtree_tpu.trees.tree import random_tree as jax_random_tree
from iqtree_tpu.utils.simulate import simulate_alignment

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.engine import parsimony as pars
from iqtree_torch.engine.derivatives import branch_derivs, newton_serves, optimize_branch_mask
from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.likelihood import (ModelArrays, SiteData, TreeArrays, compute_loglik,
                                            ptn_invar, tip_partials)
from iqtree_torch.engine.nni import evaluate_nnis
from iqtree_torch.io.alignment import Alignment, read_alignment
from iqtree_torch.models.factory import ModelParseError, parse_model_string
from iqtree_torch.trees.tree import PhyloTree

from test_torch_search import jax_stepwise_tree, jax_view

torch.set_num_threads(1)
CPU = torch.device("cpu")
DATA = os.path.join(os.path.dirname(__file__), "data")
FIELDS = ("eigenvalues", "eigvec", "inv_eigvec", "state_freq", "rates", "props",
          "p_invar")
MODELS = {"DNA": "GTR+G4+ASC", "AA": "LG+G4+ASC", "BIN": "GTR2+G4+ASC"}


def variable_data(kind, n_taxa=12, n_sites=160, seed=0):
    """(names, sequences, the JAX package's tree) simulated under `kind`'s
    model +G4 (alpha 0.7) down a random tree, cut to the columns with two
    or more states."""
    rng = np.random.default_rng(seed)
    tree = jax_random_tree(n_taxa, rng, mean_blen=0.15)
    if kind == "DNA":
        subst = jax_dna_model("GTR")
        subst.group_rates = np.array([1.0, 2.1, 0.7, 1.3, 3.0, 1.0])
    elif kind == "AA":
        subst = jax_protein_model("LG")
    else:
        subst = JReversible("GTR2", 2, rate_groups=np.array([0]),
                            state_freq=np.array([0.6, 0.4]))
    seqs = simulate_alignment(tree, subst, JRate.make(gamma_cats=4, alpha=0.7), n_sites, rng)
    cols = [j for j in range(n_sites) if len({s[j] for s in seqs}) > 1]
    return ([f"t{i}" for i in range(n_taxa)], ["".join(s[j] for j in cols) for s in seqs],
            tree)


def workload(kind, seed=0, **kw):
    """(jax (tree, model, site), port (tree, model, site), host tree,
    schedule, n_slots): MODELS[kind] with +ASC's patterns, float64."""
    names, seqs, tree = variable_data(kind, seed=seed, **kw)
    jaln = JAlignment.from_sequences(names, seqs, kind)
    js, jr = jax_parse_model(MODELS[kind], jaln)
    assert js.asc and jaln.frac_const_sites() == 0
    jr.alpha = 0.7
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(js, jr, jnp.float64),
         JSite.from_alignment(jaln, jnp.float64, asc=True))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, tree, convert.schedule(steps, CPU), n_slots


@pytest.fixture(scope="module", params=["DNA", "AA", "BIN"])
def case(request):
    return workload(request.param)


def test_refusals_carry_the_jax_messages():
    """+ASC refuses +I and an alignment with constant sites, with the JAX
    package's messages, in both packages; the same models parse on
    variable columns."""
    port = read_alignment(os.path.join(DATA, "example.phy"))
    jax_aln = jax_read_alignment(os.path.join(DATA, "example.phy"))
    assert port.frac_const_sites() == jax_aln.frac_const_sites() > 0
    names, seqs, _ = variable_data("DNA")
    var, jvar = Alignment.from_sequences(names, seqs), JAlignment.from_sequences(names, seqs)
    for model, (a, ja), msg in (
            ("GTR+G+ASC", (port, jax_aln), "+ASC requires an alignment without constant sites"),
            ("GTR+I+G+ASC", (var, jvar), "+ASC is incompatible with +I"),
            ("GTR+I+ASC", (port, jax_aln), "+ASC is incompatible with +I")):
        with pytest.raises(ModelParseError, match=re.escape(msg)):
            parse_model_string(model, a)
        with pytest.raises(ValueError, match=re.escape(msg)):
            jax_parse_model(model, ja)
    for model in ("GTR+G+ASC", "HKY+ASC", "GTR+R3+ASC"):
        assert parse_model_string(model, var)[0].asc and jax_parse_model(model, jvar)[0].asc


def test_corrected_lnl_matches_jax(case):
    """The corrected lnL and the per-pattern lnl (the S appended patterns
    included) through the plain pass and through the kernels' path (their
    twins), against the JAX package's, to 1e-8 relative."""
    (jt, jm, js), (tt, tm, ts), _, steps, n_slots = case
    want, want_pat = jax_loglik(jt, jm, js)
    S = tm.num_states
    assert float(ts.asc_mask.sum()) == S and bool((ts.asc_mask[-S:] == 1).all())
    for got, pat in (compute_loglik(tt, tm, ts), loglik(tt, tm, ts, steps, n_slots)):
        assert abs(float(got) - float(want)) <= 1e-8 * abs(float(want))
        np.testing.assert_allclose(pat.detach().numpy(), np.asarray(want_pat), rtol=1e-8)


def test_asc_gradient_matches_jax(case):
    """d(lnL + 0.3 sum lnl_p) / d(branch lengths, every ModelArrays field,
    pattern weights) through the sweep gradient (the +ASC terms in its
    pattern weights) against jax.grad of the JAX package's loglik."""
    (jt, jm, js), (tt, tm, ts), _, steps, n_slots = case

    def jax_obj(blen, model, freq):
        total, pat = jax_loglik(jt._replace(blen=blen), model, js._replace(pattern_freq=freq))
        return total + 0.3 * jnp.sum(pat)

    want = jax.grad(jax_obj, argnums=(0, 1, 2))(jt.blen, jm, js.pattern_freq)
    leaves = [tt.blen.clone().requires_grad_()]
    leaves += [getattr(tm, f).clone().requires_grad_() for f in FIELDS]
    freq = ts.pattern_freq.clone().requires_grad_()
    site = SiteData(ts.tip_codes, ts.code_masks, freq, ts.const_state, ts.asc_mask)
    total, pat = loglik(tt.with_blen(leaves[0]), ModelArrays(*leaves[1:]), site, steps,
                        n_slots)
    got = torch.autograd.grad(total + 0.3 * pat.sum(), leaves + [freq])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-8, atol=1e-8)
    for f, g in zip(FIELDS, got[1:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(want[1], f)), rtol=1e-8,
                                   atol=1e-8, err_msg=f)
    np.testing.assert_allclose(got[-1].numpy(), np.asarray(want[2]), rtol=1e-8, atol=1e-10)


def test_branch_derivatives_match_jax(case):
    """Under +ASC no branch-Newton kernel serves: the theta path's d1/d2,
    with the correction's terms, against the JAX package's
    branch_lnl_derivs on its mailbox passes, on every free branch."""
    (jt, jm, js), (tt, tm, ts), _, steps, n_slots = case
    assert not newton_serves(tm.ncat, tm.num_states, asc=True)
    up, us, out, os_, _ = jax_all_passes(jt, jm, js)
    _, jd1, jd2 = jax_branch_lnl_derivs(jax_compute_thetas(jt, jm, js, up, us, out, os_),
                                        jm, js, jt.blen)
    d1, d2 = branch_derivs(steps, n_slots, tm, ts, tt.blen, tip_partials(ts).contiguous(),
                           ptn_invar(tm, ts).contiguous())
    mask = optimize_branch_mask(tt).numpy()[:len(jd1)]
    np.testing.assert_allclose(d1.numpy()[:len(jd1)][mask], np.asarray(jd1)[mask], rtol=1e-8,
                               atol=1e-8)
    np.testing.assert_allclose(d2.numpy()[:len(jd2)][mask], np.asarray(jd2)[mask], rtol=1e-8,
                               atol=1e-8)


def test_nni_scores_match_jax(case):
    """The NNI evaluator's local Newton and scores with the +ASC terms (1 - q
    clamped at 1e-10) against the JAX package's evaluate_nnis."""
    (jt, jm, js), (tt, tm, ts), tree, steps, n_slots = case
    edges = np.asarray(jt.h2d)[tree.internal_edges()]
    want = jax_evaluate_nnis(jt, jm, js, jnp.asarray(edges), paired=True)
    got = evaluate_nnis(tt, tm, ts, edges, steps, n_slots, paired=True, edge_chunk=4)
    for g, w in ((got.lnl, want.lnl), (got.center_blen, want.center_blen),
                 (got.cur_lnl, want.cur_lnl), (got.base_lnl, want.base_lnl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)
    assert abs(float(got.cur_lnl) - float(compute_loglik(tt, tm, ts)[0])) < 1e-6


def test_binary_asc_search_on_cpu(tmp_path):
    """A 14-taxon binary GTR2+ASC+G search (`-n 2 -bb 100`) through the CLI:
    the stepwise-addition trees of its seed equal the JAX package's, the
    written model (+ASC) re-evaluates to the best score, and the bootstrap
    outputs are written."""
    names, seqs, _ = variable_data("BIN", n_taxa=14, n_sites=300, seed=3)
    aln, jaln = Alignment.from_sequences(names, seqs), JAlignment.from_sequences(names, seqs)
    assert aln.states.seq_type == jaln.states.seq_type == "BIN"
    for seed in (1, 2):
        got = pars.parsimony_stepwise_tree(aln, np.random.default_rng(seed), CPU)
        want = jax_stepwise_tree(jaln, np.random.default_rng(seed))
        for f in ("parent", "children", "blen"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        assert pars.parsimony_score(got, aln, CPU) == jax_pars.parsimony_score(
            jax_view(got), jaln)
    path, prefix = str(tmp_path / "b.phy"), str(tmp_path / "b")
    with open(path, "w") as f:
        f.write(f"{len(names)} {len(seqs[0])}\n" +
                "".join(f"{n} {s}\n" for n, s in zip(names, seqs)))
    assert cli_main(["-s", path, "-st", "BIN", "-m", "GTR2+ASC+G", "-n", "2", "-ninit", "3",
                     "-ntop", "1", "-bb", "100", "-wbt", "-device", "cpu", "-pre",
                     prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    assert "theta path on the plain twins" in log and "(+ASC's terms)" in log
    best = float(re.search(r"BEST SCORE FOUND : (\S+)", log).group(1))
    fitted = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    assert fitted.endswith("+ASC")
    s, r = parse_model_string(fitted, aln)
    with open(prefix + ".treefile") as f:
        tree = PhyloTree.from_newick(f.read(), aln.names)
    lnl, _ = compute_loglik(TreeArrays.from_tree(tree, CPU), ModelArrays.from_model(s, r, CPU),
                            SiteData.from_alignment(aln, CPU, torch.float64, asc=True))
    assert abs(float(lnl) - best) < 0.01
    with open(prefix + ".ufboot") as f:
        assert len(f.read().splitlines()) == 100
    with open(prefix + ".iqtree") as f:
        assert "Model of substitution: GTR2+G4+ASC" in f.read()
