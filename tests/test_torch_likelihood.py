"""The port's host copies and plain likelihood against the JAX package.

Inputs are made with numpy from a seed and handed to both packages; the
JAX side runs in float64 (tests/conftest.py) on the CPU, the port's side
in float64 on the CPU.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.kernels.schedule import slot_schedule as jax_slot_schedule
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.dna import create_dna_model as jax_dna_model
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.engine.kernels.schedule import slot_schedule
from iqtree_torch.engine.likelihood import (
    ModelArrays,
    SiteData,
    TreeArrays,
    compute_loglik,
)
from iqtree_torch.io.alignment import read_alignment
from iqtree_torch.models.dna import create_dna_model
from iqtree_torch.models.factory import parse_model_string
from iqtree_torch.models.rates import RateModel
from iqtree_torch.trees.tree import PhyloTree, random_tree

# the tests run several to a machine (pytest-xdist workers): one torch
# thread each keeps them from oversubscribing the cores
torch.set_num_threads(1)

DATA = os.path.join(os.path.dirname(__file__), "data")
GOLDEN_GTR_G_LNL = -17848.038178  # IQ-TREE 1.4.3, see tests/test_golden.py
CPU = torch.device("cpu")


def make_case(n_taxa=12, n_sites=300, seed=0, pinv=0.0, gamma=4):
    """A random DNA alignment, GTR model and tree, as JAX arrays (f64) and
    as the port's tensors (f64, via convert.py).  Returns
    (jax (tree, model, site), port (tree, model, site), host tree)."""
    rng = np.random.default_rng(seed)
    seqs = ["".join(rng.choice(list("ACGT-"), n_sites)) for _ in range(n_taxa)]
    aln = JAlignment.from_sequences([f"t{i}" for i in range(n_taxa)], seqs, "DNA")
    subst = jax_dna_model("GTR")
    subst.state_freq = aln.state_frequencies()
    subst.set_rate_param_vector(rng.uniform(0.5, 3.0, 5))
    rate = JRate.make(gamma_cats=gamma, invar=pinv > 0, p_invar=pinv, alpha=0.7)
    tree = jax_random_tree(n_taxa, rng)
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(subst, rate, jnp.float64),
         JSite.from_alignment(aln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    return j, t, tree


@pytest.mark.parametrize("n_taxa", [8, 17])
@pytest.mark.parametrize("pinv", [0.0, 0.2])
def test_compute_loglik_matches_jax(n_taxa, pinv):
    (jt, jm, js), (tt, tm, ts), _ = make_case(n_taxa, 200, seed=n_taxa, pinv=pinv)
    want, want_pat = jax_compute_loglik(jt, jm, js)
    got, got_pat = compute_loglik(tt, tm, ts)
    # same float64 arithmetic in another order
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)
    np.testing.assert_allclose(got_pat.numpy(), np.asarray(want_pat), rtol=1e-10)


def test_golden_gtr_gamma_f64():
    """The reference binary's pinned GTR+G score on the 44-taxon example."""
    aln = read_alignment(os.path.join(DATA, "example.phy"))
    with open(os.path.join(DATA, "golden_tree_44.nwk")) as f:
        tree = PhyloTree.from_newick(f.read(), aln.names)
    subst = create_dna_model("GTR")
    subst.group_rates = np.array([1.0, 1.5, 2.0, 0.8, 1.2, 3.0])
    subst.state_freq = np.array([0.25, 0.26, 0.25, 0.24])
    rate = RateModel.make(gamma_cats=4, alpha=0.5)
    lnl, _ = compute_loglik(TreeArrays.from_tree(tree, CPU),
                            ModelArrays.from_model(subst, rate, CPU),
                            SiteData.from_alignment(aln, CPU, torch.float64))
    assert abs(float(lnl) - GOLDEN_GTR_G_LNL) < 1e-4


def test_host_copies_match_jax():
    """Alignment compression, tree numbering, slot schedule and model
    parsing give the same numbers in both packages."""
    path = os.path.join(DATA, "example.phy")
    a, ja = read_alignment(path), jax_read_alignment(path)
    np.testing.assert_array_equal(a.patterns, ja.patterns)
    np.testing.assert_array_equal(a.pattern_freq, ja.pattern_freq)
    np.testing.assert_array_equal(a.const_state, ja.const_state)
    np.testing.assert_array_equal(a.states.code_masks, ja.states.code_masks)
    np.testing.assert_allclose(a.state_frequencies(), ja.state_frequencies(),
                               rtol=1e-15)
    with open(os.path.join(DATA, "golden_tree_44.nwk")) as f:
        nwk = f.read()
    t, jt = PhyloTree.from_newick(nwk, a.names), JPhyloTree.from_newick(nwk, a.names)
    np.testing.assert_array_equal(t.children, jt.children)
    np.testing.assert_array_equal(t.blen, jt.blen)
    assert t.to_newick(a.names) == jt.to_newick(a.names)
    np.testing.assert_array_equal(t.device_numbering()[0], jt.device_layout()["d2h"])
    r, jr = random_tree(30, np.random.default_rng(9)), jax_random_tree(30, np.random.default_rng(9))
    np.testing.assert_array_equal(r.children, jr.children)
    np.testing.assert_array_equal(r.blen, jr.blen)
    steps, n_slots = slot_schedule(t)
    jsteps, jn_slots = jax_slot_schedule(jt)
    np.testing.assert_array_equal(steps, jsteps)
    assert n_slots == jn_slots
    for m in ("GTR+G", "HKY+I+G4", "GTR{1.5,2,0.8,1.2,3}+F{0.25,0.26,0.25,0.24}+G{0.5}",
              "K2P+I{0.3}", "TN+FO+G8"):
        (s, r), (js_, jr) = parse_model_string(m, a), jax_parse_model(m, ja)
        np.testing.assert_allclose(s.group_rates, js_.group_rates)
        np.testing.assert_allclose(s.state_freq, js_.state_freq)
        assert s.freq_type == js_.freq_type and s.fixed_rates == js_.fixed_rates
        assert (r.kind, r.ncat, r.alpha, r.p_invar, r.fix_alpha, r.fix_p_invar) == \
            (jr.kind, jr.ncat, jr.alpha, jr.p_invar, jr.fix_alpha, jr.fix_p_invar)
        np.testing.assert_allclose(r.category_rates()[0], jr.category_rates()[0])


@pytest.mark.parametrize("model", ["LG+G", "GTR+R4+FC", "UNREST+G", "UNREST"])
def test_unported_models_name_their_slice(model):
    aln = read_alignment(os.path.join(DATA, "example.phy"))
    with pytest.raises((NotImplementedError, ValueError), match="port|unknown"):
        parse_model_string(model, aln)
