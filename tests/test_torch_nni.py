"""The outside-partial store and the NNI evaluator against the JAX package.

14 taxa x 83 sites simulated down a random tree (GTR+G4), fitted as GTR+G
and HKY+I+G, all in float64.  The JAX side runs its Pallas store kernels
in interpret mode on the CPU and its mailbox passes; the port runs the
kernels' plain twins on the CPU.  The CUDA kernel itself is held against
its twin by tests/test_torch_cuda.py and chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.derivatives import all_passes as jax_all_passes
from iqtree_tpu.engine.kernels.cs_kernels import fused_nni_passes_cs as jax_passes
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import evaluate_nnis as jax_evaluate_nnis
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.models.dna import create_dna_model as jax_dna_model
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.rates import RateModel as JRate
from iqtree_tpu.trees.tree import random_tree as jax_random_tree
from iqtree_tpu.utils.simulate import simulate_alignment

from iqtree_torch import convert
from iqtree_torch.engine.kernels import cs_kernels
from iqtree_torch.engine.likelihood import branch_transition_mats, tip_partials
from iqtree_torch.engine.nni import evaluate_nnis

CPU = torch.device("cpu")


def workload(model, n_taxa=14, n_sites=83, seed=7):
    """(jax (tree, model, site), port (tree, model, site), host tree,
    JAX schedule, n_slots), float64."""
    rng = np.random.default_rng(seed)
    tree = jax_random_tree(n_taxa, rng, mean_blen=0.12)
    s = jax_dna_model("GTR")
    s.group_rates = np.array([1.0, 2.1, 0.7, 1.3, 3.0, 1.0])
    seqs = simulate_alignment(tree, s, JRate.make(gamma_cats=4, alpha=0.8),
                              n_sites, rng)
    aln = JAlignment.from_sequences([f"t{i}" for i in range(n_taxa)], seqs, "DNA")
    subst, rate = jax_parse_model(model, aln)
    if rate.has_invar:
        rate.p_invar = 0.2
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(subst, rate, jnp.float64),
         JSite.from_alignment(aln, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, tree, steps, n_slots


@pytest.fixture(scope="module", params=["GTR+G", "HKY+I+G"])
def case(request):
    return workload(request.param)


def test_down_store_twin_matches_jax(case):
    (jt, jm, js), (tt, tm, ts), _, steps, n_slots = case
    up_j, usc_j, out_j, osc_j = jax_passes(
        jnp.asarray(steps), n_slots, jax_trans(jm, jt.blen), jax_tips(js, 4),
        jm.props, jm.state_freq, tile=128)
    _, _, out_x, osc_x, _ = jax_all_passes(jt, jm, js)  # the mailbox passes
    st = convert.schedule(steps, CPU)
    up, usc, out, osc = cs_kernels.fused_nni_passes_cs(
        st, n_slots, branch_transition_mats(tm, tt.blen), tip_partials(ts),
        tm.state_freq)
    out_t, osc_t = cs_kernels._down_store_plain(
        st, branch_transition_mats(tm, tt.blen), up, usc, tm.state_freq)
    np.testing.assert_array_equal(out.numpy(), out_t.numpy())
    P, N = up.shape[2], tt.n_taxa
    rows = [v for v in range(2 * N - 1) if v != tt.root]  # the root row is unused
    np.testing.assert_allclose(up[:2 * N - 1].numpy(),
                               np.asarray(up_j)[:2 * N - 1, :, :P], rtol=1e-10)
    for want_out, want_osc in ((np.asarray(out_j)[..., :P], np.asarray(osc_j)[..., :P]),
                               (np.asarray(out_x)[:2 * N].reshape(2 * N, 16, P),
                                np.asarray(osc_x)[:2 * N])):
        np.testing.assert_allclose(out[rows].numpy(), want_out[rows], rtol=1e-10,
                                   atol=1e-300)
        np.testing.assert_allclose(osc[rows].numpy(), want_osc[rows], rtol=1e-10,
                                   atol=1e-12)


def test_evaluate_nnis_matches_jax(case):
    (jt, jm, js), (tt, tm, ts), tree, steps, n_slots = case
    edges = np.asarray(jt.h2d)[tree.internal_edges()]
    want = jax_evaluate_nnis(jt, jm, js, jnp.asarray(edges), paired=True)
    got = evaluate_nnis(tt, tm, ts, edges, convert.schedule(steps, CPU), n_slots,
                        paired=True, edge_chunk=4)
    for g, w in ((got.lnl, want.lnl), (got.center_blen, want.center_blen),
                 (got.cur_lnl, want.cur_lnl), (got.base_lnl, want.base_lnl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-8)
    # unpaired, one chunk: the same candidates
    plain = evaluate_nnis(tt, tm, ts, edges, convert.schedule(steps, CPU), n_slots)
    assert plain.base_lnl is None
    np.testing.assert_allclose(plain.lnl.numpy(), got.lnl.numpy(), rtol=1e-12)


def test_cpu_tensors_run_the_down_store_twin(case):
    _, (tt, tm, ts), _, steps, n_slots = case
    before = cs_kernels.fused_down_store_cs.launches
    cs_kernels.fused_nni_passes_cs(convert.schedule(steps, CPU), n_slots,
                                   branch_transition_mats(tm, tt.blen),
                                   tip_partials(ts), tm.state_freq)
    assert cs_kernels.fused_down_store_cs.launches == before
