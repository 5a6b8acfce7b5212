"""The forward kernel's ablation variants (engine/kernels/ablate.py): each
plain twin against a literal walk of the slot schedule, `full` against
the JAX package's root log-scale, and the two precision variants within
bfloat16 roundoff of `full`.

12 taxa x 200 sites, GTR+G4 from a numpy seed.  The variants run on random
trans and tips uniform in [0, 1) (as the bench inputs are: a stochastic
matrix would make `nostage` trivially 0); the walk keeps one slot pool and
visits the rows in order, as the kernel does.  The precision variants
(`highprec3`, `defprec`) split both operands of each edge product into
bfloat16 parts in the walk with numpy's own rounding (float32, then to
nearest even at 8 significand bits) and in the twin with torch's casts.
The JAX side's upward store runs its Pallas kernel in interpret mode on
the CPU.  All float64; tolerance rtol 1e-11 (the same arithmetic in
another order; the split parts are the same numbers).  The CUDA kernel is
held against the twins by tests/test_torch_cuda.py and chip_smoke.py on
the card.
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


def bf16(x):
    """x rounded to bfloat16 (through float32, to nearest even), as float64."""
    b = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32).astype(np.float64)


def edge_product(variant, P, x):
    """sum_t P[c,s,t] x[c,t,p], at a precision variant's passes over the
    operands' bfloat16 parts hi = bf16(v), lo = bf16(v - hi)."""
    prod = lambda a, b: np.einsum("cst,ctp->csp", a, b)
    if variant not in ablate.PASSES:
        return prod(P, x)
    ph, xh = bf16(P), bf16(x)
    m = prod(ph, xh)
    if variant == "highprec3":
        m = m + prod(ph, bf16(x - xh)) + prod(bf16(P - ph), xh)
    return m


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
            xl = edge_product(variant, trans[l], xl)
            xr = edge_product(variant, trans[r], xr)
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


@pytest.mark.parametrize("variant", sorted(ablate.PASSES))
def test_precision_variant_within_bf16_roundoff_of_full(variant):
    """The precision variants' root log-scales stay within the bound that
    bfloat16 roundoff sets.  Every value here is positive and a partial is
    multilinear in the edge products below it, so a factor in [1-e, 1+e]
    on each product moves the root's log-scale by at most E * -log(1-e),
    E = 2(N-1) edge products.  hi carries a relative error u <= 2^-8
    (8 significand bits; + 2^-23 for the rounding through float32), so
    defprec's hi*hi has e = 2u + u^2, and highprec3 drops only lo*lo of a
    split with hi + lo within u^2: e = 2u^2 + u^4 + u^2 (1+u)^2.  XLA on the
    CPU ignores Precision (every pass count gives the float32 product), so
    the JAX package can hold only `full`; the variants are held to the
    walk above and to this bound."""
    (jt, _, _), _, tree = make_case(12, 200, seed=8)
    steps, n_slots = jax_schedule(tree, jt)
    rng = np.random.default_rng(0)
    trans = torch.tensor(rng.random((2 * 12, 4, 4, 4)))
    tips = torch.tensor(rng.random((12, 4, 150)))
    st = convert.schedule(steps, CPU)
    full = ablate.forward_ablation("full", st, n_slots, trans, tips).numpy()
    got = ablate.forward_ablation(variant, st, n_slots, trans, tips).numpy()
    u = 2.0 ** -8 + 2.0 ** -23
    e = 2 * u + u * u if variant == "defprec" else 2 * u * u + u ** 4 + (u * (1 + u)) ** 2
    dist = np.abs(got - full)
    assert dist.max() <= 2 * (12 - 1) * -np.log1p(-e)
    assert dist.max() > 0  # the passes do change the products


def test_unknown_variant_raises():
    (jt, _, _), (tt, tm, ts), tree = make_case(12, 50, seed=10)
    steps, n_slots = jax_schedule(tree, jt)
    with pytest.raises(ValueError):
        ablate.forward_ablation("tf32", convert.schedule(steps, CPU), n_slots,
                                branch_transition_mats(tm, tt.blen), tip_partials(ts))
