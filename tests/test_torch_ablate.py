"""The forward kernel's ablation variants (engine/kernels/ablate.py): each
plain twin against a literal walk of the slot schedule, and `full` against
the JAX package's root log-scale.

12 taxa x 200 sites, GTR+G4 from a numpy seed.  The variants run on random
trans and tips uniform in [0, 1) (as the bench inputs are: a stochastic
matrix would make `nostage` trivially 0); the walk keeps one slot pool and
visits the rows in order, as the kernel does.  The JAX side's upward store
runs its Pallas kernel in interpret mode on the CPU.  All float64;
tolerance rtol 1e-11 (the same arithmetic in another order).  The CUDA
kernel is held against the twins by tests/test_torch_cuda.py and
chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.kernels.cs_kernels import fused_upward_store_cs as jax_store
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips

from iqtree_torch import convert
from iqtree_torch.engine.kernels import ablate
from iqtree_torch.engine.likelihood import branch_transition_mats, tip_partials

from test_torch_likelihood import make_case

CPU = torch.device("cpu")
TINY = 1e-30


def walk(variant, steps, n_slots, trans, tips):
    """The variant as the kernel runs it: rows in order, one slot pool."""
    C, P = trans.shape[1], tips.shape[2]
    slots = np.zeros((n_slots, C, 4, P))
    sscale = np.zeros((n_slots, P))
    sc = np.zeros(P)
    if variant == "empty":
        return sc

    def child(node, slot):
        if variant == "nostage":
            return np.ones((C, 4, P)), 0.0
        if slot < 0:
            return np.broadcast_to(tips[node], (C, 4, P)), 0.0
        return slots[slot], 0.0 if variant == "noscale" else sscale[slot]

    for l, r, ls, rs, out, _ in steps:
        (xl, sl), (xr, sr) = child(l, ls), child(r, rs)
        if variant != "nomatmul":
            xl = np.einsum("cst,ctp->csp", trans[l], xl)
            xr = np.einsum("cst,ctp->csp", trans[r], xr)
        y = xl * xr
        if variant == "norescale":
            sc = sl + sr
        else:
            mx = np.maximum(y.max(axis=(0, 1)), TINY)
            y, sc = y / mx, sl + sr + np.log(mx)
        slots[out] = y
        if variant != "noscale":
            sscale[out] = sc
    return sc


@pytest.mark.parametrize("variant", ablate.VARIANTS)
def test_variant_twin_matches_walk(variant):
    (jt, _, _), _, tree = make_case(12, 200, seed=8)
    steps, n_slots = jax_schedule(tree, jt)
    rng = np.random.default_rng(0)
    trans = rng.random((2 * 12, 4, 4, 4))
    tips = rng.random((12, 4, 150))
    want = walk(variant, steps, n_slots, trans, tips)
    before = ablate.forward_ablation.launches
    got = ablate.forward_ablation(variant, convert.schedule(steps, CPU), n_slots,
                                  torch.tensor(trans), torch.tensor(tips))
    assert ablate.forward_ablation.launches == before  # CPU: the twin
    assert got.shape == (150,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-11, atol=1e-12)


def test_full_matches_jax_root_scale():
    (jt, jm, js), (tt, tm, ts), tree = make_case(12, 200, seed=9, pinv=0.15)
    steps, n_slots = jax_schedule(tree, jt)
    _, usc8 = jax_store(jnp.asarray(steps), n_slots, jax_trans(jm, jt.blen),
                        jax_tips(js, 4), tile=128)
    got = ablate.forward_ablation("full", convert.schedule(steps, CPU), n_slots,
                                  branch_transition_mats(tm, tt.blen), tip_partials(ts))
    root = int(steps[-1, 5])
    np.testing.assert_allclose(got.numpy(), np.asarray(usc8)[root, 0, :got.shape[0]],
                               rtol=1e-11, atol=1e-12)


def test_unknown_variant_raises():
    (jt, _, _), (tt, tm, ts), tree = make_case(12, 50, seed=10)
    steps, n_slots = jax_schedule(tree, jt)
    with pytest.raises(ValueError):
        ablate.forward_ablation("highprec3", convert.schedule(steps, CPU), n_slots,
                                branch_transition_mats(tm, tt.blen), tip_partials(ts))
