"""The multi-tree forward (fused_site_lnl_cs_stream, fused_multi_tree_lnl,
multi_tree_schedule) against the JAX package's.

12 taxa x 200 sites, GTR+G4 (+I), inputs from a numpy seed.  The JAX side
runs its streaming Pallas kernel in interpret mode on the CPU, in float64
under tests/conftest.py, on its pack-4 schedule; the port's twin runs in
float64 on the CPU on the pack-1 schedule of the same tree.  Tolerance:
rtol 1e-11 (the same float64 arithmetic in another order).  The CUDA
kernel itself is held against the twin by tests/test_torch_cuda.py and
chip_smoke.py on the card.
"""

from dataclasses import replace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.kernels.pruning import fused_multi_tree_lnl as jax_multi
from iqtree_tpu.engine.kernels.pruning import fused_site_lnl_cs_stream as jax_stream
from iqtree_tpu.engine.kernels.pruning import multi_tree_schedule as jax_multi_schedule
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import _ptn_invar as jax_ptn_invar

from iqtree_torch import convert
from iqtree_torch.engine.kernels import pruning
from iqtree_torch.engine.likelihood import (
    branch_transition_mats,
    compute_loglik,
    ptn_invar,
    tip_partials,
)

from test_torch_likelihood import make_case

CPU = torch.device("cpu")


def nni_chain(tree, n, seed=1):
    """`tree` and n-1 more, each one NNI and a branch-length scaling from
    the last (as tests/test_stream_kernel.py builds them)."""
    rng = np.random.default_rng(seed)
    trees = [tree]
    for _ in range(n - 1):
        t = trees[-1].copy()
        e = t.internal_edges()
        t.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
        t.blen = t.blen * float(rng.uniform(0.8, 1.2))
        trees.append(t)
    return trees


def pairs_of(trees):
    """(JAX pairs, the port's pairs) of the same trees."""
    jp = [(t, JTree.from_tree(t, jnp.float64)) for t in trees]
    return jp, [(convert.phylo_tree(t), convert.tree_arrays(ta, CPU)) for t, ta in jp]


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_single_tree_stream_matches_jax(pinv):
    (jt, jm, js), (tt, tm, ts), tree = make_case(12, 200, seed=4, pinv=pinv)
    steps4, slots4 = jax_schedule(tree, jt, pack=4)
    want = jax_stream(jnp.asarray(steps4), slots4, jax_trans(jm, jt.blen),
                      jax_tips(js, 4), jm.props, jm.state_freq, jax_ptn_invar(jm, js))
    steps, n_slots = jax_schedule(tree, jt)
    before = pruning.fused_site_lnl_cs_stream.launches
    got = pruning.fused_site_lnl_cs_stream(
        convert.schedule(steps, CPU), n_slots, branch_transition_mats(tm, tt.blen),
        tip_partials(ts), tm.props, tm.state_freq, ptn_invar(tm, ts))
    assert pruning.fused_site_lnl_cs_stream.launches == before  # CPU: the twin
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-11)


def test_multi_tree_lnl_matches_jax():
    (jt, jm, js), (tt, tm, ts), tree = make_case(12, 200, seed=5, pinv=0.15)
    jp, tp = pairs_of(nni_chain(tree, 5))
    want = np.asarray(jax_multi(jp, jm, js))
    got = pruning.fused_multi_tree_lnl(tp, tm, ts)
    assert got.dtype == torch.float64 and got.shape == (5,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11)
    single = [float(compute_loglik(ta, tm, ts)[0]) for _, ta in tp]
    np.testing.assert_allclose(got.numpy(), single, rtol=1e-11)
    assert np.ptp(single) > 1.0  # the topologies differ in lnL


def test_multi_tree_schedule_equals_jax_pack1():
    (jt, _, _), _, tree = make_case(12, 50, seed=6)
    jp, tp = pairs_of(nni_chain(tree, 4, seed=2))
    want = jax_multi_schedule(jp, 1)
    got = pruning.multi_tree_schedule(tp)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[0].dtype == np.int32 and got[1].dtype == np.int32
    # one tree's rows use at most its own schedule's slots
    assert pruning.pool_slots(got[0], 4) == max(
        pruning.device_slot_schedule(t, ta)[1] for t, ta in tp)


def test_wide_shapes_raise():
    """S=20 has no multi-tree kernel: a ValueError, as in the JAX package."""
    (_, _, _), (tt, tm, ts), tree = make_case(12, 50, seed=7)
    m20 = replace(tm, eigenvalues=torch.zeros(4, 20))  # num_states 20
    with pytest.raises(ValueError):
        pruning.fused_multi_tree_lnl([(convert.phylo_tree(tree), tt)], m20, ts)
    steps, n_slots = pruning.device_slot_schedule(convert.phylo_tree(tree), tt)
    with pytest.raises(ValueError):
        pruning.fused_site_lnl_cs_stream(
            torch.as_tensor(steps), n_slots, torch.zeros(2 * tt.n_taxa, 4, 20, 20),
            torch.zeros(tt.n_taxa, 20, 5), tm.props, torch.zeros(4, 20), torch.zeros(5))
