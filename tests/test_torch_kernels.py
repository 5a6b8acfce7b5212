"""Each kernel's plain twin against the JAX package's fused function.

12 taxa x 300 sites, GTR+G4(+I), inputs from a numpy seed.  The JAX side
runs its Pallas kernels in interpret mode on the CPU, in float64 under
tests/conftest.py; the port's twins run in float64 on the CPU.  The CUDA
kernels themselves are held against the twins by tests/test_torch_cuda.py
and chip_smoke.py on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.kernels.cs_kernels import fused_newton_derivs as jax_newton
from iqtree_tpu.engine.kernels.cs_kernels import fused_tbar_cs as jax_tbar
from iqtree_tpu.engine.kernels.cs_kernels import fused_upward_store_cs as jax_store
from iqtree_tpu.engine.kernels.pruning import device_slot_schedule as jax_schedule
from iqtree_tpu.engine.kernels.pruning import fused_compute_loglik as jax_forward
from iqtree_tpu.engine.likelihood import branch_transition_mats as jax_trans
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import _ptn_invar as jax_ptn_invar

from iqtree_torch import convert
from iqtree_torch.engine.kernels import cs_kernels, pruning
from iqtree_torch.engine.kernels.cs_kernels import (
    fused_newton_derivs,
    fused_tbar_cs,
    fused_upward_store_cs,
)
from iqtree_torch.engine.kernels.pruning import fused_compute_loglik
from iqtree_torch.engine.likelihood import (
    branch_transition_mats,
    compute_loglik,
    ptn_invar,
    tip_partials,
)

from test_torch_likelihood import make_case

CPU = torch.device("cpu")


def case(pinv=0.15, seed=3):
    (jt, jm, js), (tt, tm, ts), tree = make_case(12, 300, seed=seed, pinv=pinv)
    steps, n_slots = jax_schedule(tree, jt)
    return (jt, jm, js), (tt, tm, ts), steps, n_slots


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_forward_twin_matches_jax(pinv):
    (jt, jm, js), (tt, tm, ts), steps, n_slots = case(pinv)
    want, want_pat = jax_forward(jt, jm, js, jnp.asarray(steps), n_slots, tile=128)
    got, got_pat = fused_compute_loglik(tt, tm, ts, convert.schedule(steps, CPU),
                                        n_slots)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-11)
    np.testing.assert_allclose(got_pat.numpy(), np.asarray(want_pat), rtol=1e-11)
    np.testing.assert_allclose(float(got), float(compute_loglik(tt, tm, ts)[0]),
                               rtol=1e-11)


def test_store_twin_matches_jax():
    (jt, jm, js), (tt, tm, ts), steps, n_slots = case()
    up_j, usc8_j = jax_store(jnp.asarray(steps), n_slots, jax_trans(jm, jt.blen),
                             jax_tips(js, 4), tile=128)
    up, usc = fused_upward_store_cs(convert.schedule(steps, CPU), n_slots,
                                    branch_transition_mats(tm, tt.blen),
                                    tip_partials(ts))
    P, N = up.shape[2], tt.n_taxa
    inner = slice(N, 2 * N - 1)  # the store leaves tip rows to the caller
    np.testing.assert_allclose(up[inner].numpy(), np.asarray(up_j)[inner, :, :P],
                               rtol=1e-11, atol=1e-14)
    np.testing.assert_allclose(usc[inner].numpy(),
                               np.asarray(usc8_j)[inner, 0, :P], rtol=1e-11,
                               atol=1e-12)


def test_tbar_twin_matches_jax():
    (jt, jm, js), (tt, tm, ts), steps, n_slots = case()
    _, lnl = jax_forward(jt, jm, js, jnp.asarray(steps), n_slots, tile=128)
    rng = np.random.default_rng(5)
    wp = np.asarray(js.pattern_freq) * rng.uniform(0.5, 1.5, lnl.shape[0])
    want = jax_tbar(jnp.asarray(steps), n_slots, jax_trans(jm, jt.blen),
                    jax_tips(js, 4), jm.props, jm.state_freq, lnl, jnp.asarray(wp))
    got = fused_tbar_cs(convert.schedule(steps, CPU), n_slots,
                        branch_transition_mats(tm, tt.blen), tip_partials(ts),
                        tm.props, tm.state_freq, torch.tensor(np.asarray(lnl)),
                        torch.tensor(wp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-9 * float(np.abs(want).max()))


@pytest.mark.parametrize("pinv", [0.0, 0.15])
def test_newton_twin_matches_jax(pinv):
    (jt, jm, js), (tt, tm, ts), steps, n_slots = case(pinv)
    d1_j, d2_j = jax_newton(jnp.asarray(steps), n_slots, jm, jt.blen,
                            jax_tips(js, 4), js.pattern_freq, jax_ptn_invar(jm, js))
    d1, d2 = fused_newton_derivs(convert.schedule(steps, CPU), n_slots, tm, tt.blen,
                                 tip_partials(ts), ts.pattern_freq,
                                 ptn_invar(tm, ts))
    for got, want in ((d1, d1_j), (d2, d2_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_cpu_tensors_run_the_twins():
    """A CPU tensor takes the plain twin: no kernel launch is counted."""
    _, (tt, tm, ts), steps, n_slots = case()
    wrappers = (pruning.fused_site_lnl, cs_kernels.fused_upward_store_cs,
                cs_kernels.fused_tbar_cs, cs_kernels.newton_sweep)
    before = [w.launches for w in wrappers]
    st = convert.schedule(steps, CPU)
    fused_compute_loglik(tt, tm, ts, st, n_slots)
    fused_newton_derivs(st, n_slots, tm, tt.blen, tip_partials(ts), ts.pattern_freq,
                        ptn_invar(tm, ts))
    assert [w.launches for w in wrappers] == before


def test_newton_probe_variants_apply_to_the_kernel_source():
    """Every variant of the branch-Newton probe edits csrc/newton.cu (the
    probe runs on the card; here its edits are checked against the source)."""
    from iqtree_torch.engine.kernels import probe

    src = (probe.build.CSRC / "newton.cu").read_text()
    for name in probe.KERNELS["newton"]:
        out = probe.variant_sources("newton", name)["newton.cu"]
        assert (out == src) == (name == "as built"), name


@pytest.mark.parametrize("kernel", ["forward", "store"])
def test_upward_probe_variants_apply_to_the_kernel_sources(kernel):
    """Every variant of the upward kernels' probe edits csrc/<kernel>.cu or
    the upward walk of csrc/cs_common.cuh, and every edit lands."""
    from iqtree_torch.engine.kernels import probe

    base = probe.variant_sources(kernel, "as built")
    for name, edits in probe.KERNELS[kernel].items():
        out = probe.variant_sources(kernel, name)
        assert (out == base) == (name == "as built"), name
        for old, new in edits:
            assert all(old not in text for text in out.values()), (name, old)


@pytest.mark.parametrize("kernel", ["forward", "store", "down_store", "wide_newton",
                                    "wide_forward", "tbar", "wide_store", "wide_down_store",
                                    "wide_tbar"])
def test_probe_base_variant_reads_both_files_from_its_directory(kernel, tmp_path):
    """`--base DIR` builds <kernel>.cu and the headers it includes
    (cs_common.cuh; the wide kernels also wide_common.cuh) as DIR holds them
    (an earlier commit's sources), untouched by any edit."""
    from iqtree_torch.engine.kernels import probe

    want = {f"{kernel}.cu": f"// {kernel} of an earlier design\n",
            probe.HEADER: "// its header\n"}
    if kernel.startswith("wide_"):
        want["wide_common.cuh"] = "// the wide kernels' header\n"
    for f, text in want.items():
        (tmp_path / f).write_text(text)
    assert probe.variant_sources(kernel, "base", tmp_path) == want


@pytest.mark.parametrize("kernel", ["down_store", "wide_newton", "wide_forward", "tbar",
                                    "wide_store", "wide_down_store", "wide_tbar"])
def test_redesigned_probe_variants_apply_to_the_kernel_sources(kernel):
    """Every variant of the probes of the kernels redesigned on the lane
    layout and on clusters edits csrc/<kernel>.cu or a header it includes,
    and every edit lands."""
    from iqtree_torch.engine.kernels import probe

    base = probe.variant_sources(kernel, "as built")
    assert f"{kernel}.cu" in base
    for name, edits in probe.KERNELS[kernel].items():
        out = probe.variant_sources(kernel, name)
        assert (out == base) == (name == "as built"), name
        for old, new in edits:
            assert all(old not in text for text in out.values()), (name, old)


def test_wide_newton_part_rows_and_shared_memory():
    """csrc/wide_newton.cu's host-side sizes: a part row a group of 16
    patterns of each cluster's tile (the earlier design's tile, whose sum
    order it keeps), and the shared memory of its header's formula -- under
    the 227 KB a block may have at S=61, C=4 (8 patterns a cluster, 10
    slots), where the earlier design staged 2 x 3 x C x S x S floats
    (357 KB)."""
    rows = cs_kernels.wide_newton_part_rows
    assert rows(1958, 16) == 123
    assert rows(1958, 32) == 62 * 2
    assert rows(301, 64) == 5 * 4
    assert rows(301, 8) == 38
    for bad in (0, 24, 40):
        with pytest.raises(ValueError):
            rows(1958, bad)
    smem = cs_kernels.wide_newton_smem
    assert smem(20, 4, 32, 10) == 4 * 16640
    assert smem(61, 4, 8, 10) == 4 * 52860 <= 232448
    assert smem(61, 4, 16, 10) > 232448
    assert 2 * 3 * 4 * 61 * 61 * 4 > 232448
    # one block a category: only the max buffers (2 C tile) grow with C
    assert smem(20, 8, 32, 12) - smem(20, 1, 32, 12) == 4 * 2 * 7 * 32


def test_wide_forward_and_tbar_shared_memory():
    """The shared memory of csrc/wide_forward.cu (the cluster walk of
    csrc/wide_common.cuh) and of csrc/tbar.cu by their headers' formulas:
    wide_forward at S=20 and S=61 (codon) under the 227 KB a block may have
    at every C = 1-8, 32 patterns a cluster and a 1000-taxon tree's 11
    slots, one block a category so that only its max buffers grow with C;
    tbar's C x 64 lanes a block under it up to 15 slots (a 16 384-taxon
    tree's) at C = 8."""
    block = 232448
    wf = pruning.wide_forward_smem
    assert wf(20, 4, 32, 10) == 4 * 11136
    assert wf(61, 4, 16, 11) == 119312
    for C in range(1, 9):
        for S in (20, 61):
            assert wf(S, C, 32, 11) <= block, (S, C)
        assert wf(20, C, 64, 12) <= block
        assert wf(20, C, 32, 12) - wf(20, 1, 32, 12) == 4 * 2 * (C - 1) * 32
    assert wf(61, 4, 64, 11) > block
    assert wf(20, 4, 32, 10, stages=3) - wf(20, 4, 32, 10) == 4 * 2 * (400 + 20 * 32)
    tb = cs_kernels.tbar_smem
    assert tb(4, 11) == 92480
    for C in range(1, 9):
        assert tb(C, 15) <= block, C
        # a slot of the pool is S + 1 = 5 words a lane (C x 64 lanes)
        assert tb(C, 12) - tb(C, 11) == 4 * 5 * 64 * C
    assert tb(8, 16) > block
    assert tb(4, 11, stages=3) - tb(4, 11) == 4 * (8 * 2 * 20 + 10 * (256 + 4))


def test_wide_store_and_down_store_shared_memory():
    """The shared memory of csrc/wide_store.cu (the cluster walk's, as
    wide_forward.cu's) and of csrc/wide_down_store.cu (the formula of its
    header) at S=20 and S=61 (codon), C = 1-8, 16 patterns a cluster and a
    1000-taxon tree's 11 slots: under the 227 KB a block may have, where
    the row-group designs' launchers asked 307 168 and 356 944 bytes at
    S=61, C=4 (a row group a state).  One
    block a category: only the max buffers (double-buffered by step parity
    in the down-store, for both children) grow with C."""
    block = 232448
    ds = cs_kernels.wide_down_store_smem
    assert ds(20, 4, 16, 11) == 30144
    assert ds(61, 4, 16, 11) == 127888
    for C in range(1, 9):
        for S in (20, 61):
            assert pruning.wide_forward_smem(S, C, 16, 11) <= block, (S, C)
            assert ds(S, C, 16, 11) <= block, (S, C)
        assert ds(20, C, 64, 12) <= block
        assert ds(20, C, 16, 11) - ds(20, 1, 16, 11) == 4 * 4 * (C - 1) * 16
    assert ds(20, 4, 16, 11, stages=3) - ds(20, 4, 16, 11) == 4 * (2 * 400 + 2 * 21 * 16)


def test_wide_tbar_shared_memory():
    """The shared memory of csrc/wide_tbar.cu by its header's formula: the
    cluster reverse walk's (wide_down_store.cu's), each child's fac for the
    tile's patterns and a sum warp's stage of both children's [S,S] blocks
    for each 16 patterns, at S=20, C=4, 16 patterns a cluster and a
    1000-taxon tree's 11 slots; and the formula at S=61 (codon) under the
    227 KB a block may have at every C = 1-8.  That is the formula only:
    no S=61 instance builds, as group_sums needs S % 4 == 0."""
    block = 232448
    tb = cs_kernels.wide_tbar_smem
    S, C, tile, slots = 20, 4, 16, 11
    ring = 2 * (2 * S * S + 2 * (S + 1) * tile)
    assert tb(S, C, tile, slots) == 4 * (ring + slots * (S + 1) * tile + 2 * S * tile
                                         + 4 * C * tile + 2 * tile + 2 * S * S) == 33472
    assert tb(61, 4, 16, 11) == 157784 <= block
    walk = cs_kernels.wide_down_store_smem
    assert tb(20, 4, 16, 11) - walk(20, 4, 16, 11) == 4 * (2 * 16 + 2 * 400)
    assert tb(20, 4, 64, 11) - walk(20, 4, 64, 11) == 4 * (2 * 64 + 4 * 2 * 400)
    for C in range(1, 9):
        assert tb(61, C, 16, 11) <= block, C
        assert tb(20, C, 64, 12) <= block, C


@pytest.mark.parametrize("C,K,CB", [(12, 6, 2), (40, 8, 5), (80, 8, 10), (240, 8, 30)])
def test_wide_walks_shared_memory_past_eight_categories(C, K, CB):
    """Past 8 categories a wide walk's block holds CB = ceil(C / 8) of them
    on K = ceil(C / CB) blocks a cluster; its ring stays one category's, its
    slot pool grows to CB S + 1 rows a slot and the reverse walks' O stage
    to both children's CB S rows, at the wrappers' 16 patterns a cluster.
    At a 300-taxon tree's 10 slots C = 12, 40 (C10) and 80 (C20) fit the
    232 448 bytes a block may have, and C = 240 (C60) does not; at 3 slots
    it does."""
    from iqtree_torch.engine.kernels import build

    assert build.wide_layout(C) == (K, CB)
    S, tile, slots = 20, 16, 10
    ring_up = 2 * 2 * (S * S + S * tile)
    ring_rev = 2 * (2 * S * S + 2 * (S + 1) * tile)
    fwd = 4 * (ring_up + slots * (CB * S + 1) * tile + 2 * K * tile)
    down = 4 * (ring_rev + slots * (CB * S + 1) * tile + 2 * CB * S * tile + 4 * K * tile)
    assert pruning.wide_forward_smem(S, C, tile, slots) == fwd
    assert cs_kernels.wide_down_store_smem(S, C, tile, slots) == down
    assert cs_kernels.wide_tbar_smem(S, C, tile, slots) == down + 4 * (2 * tile + 2 * S * S)
    assert build.wide_walk_smem(C, S, slots) == down + 4 * (2 * tile + 2 * S * S)
    assert (build.wide_walk_smem(C, S, slots) <= build.MAX_BLOCK_SMEM) == (C < 240)
    assert build.wide_walk_smem(C, S, 3) <= build.MAX_BLOCK_SMEM
    assert build.max_slots(300) == slots


def test_check_shape_past_eight_categories():
    """The wide walks serve S=20 and S=4 past 8 categories as far as their
    shared memory allows (and S=4 only there: up to 8 the CS-packed kernels
    serve DNA, as build.packed says); the branch-Newton kernel's cluster
    instance, the CS-packed kernels and the codon instance stop at 8, each
    naming what serves or will serve; wide_newton's DNA instance serves 9
    to 32 categories (C*S <= 128)."""
    from iqtree_torch.engine.kernels import build

    build.check_shape(80, 20, n_slots=10)
    build.check_shape(80, 20, build.WIDE_STATES, 10)
    for C, S in ((4, 20), (80, 20), (4, 61), (12, 4)):  # the walks' wrappers' call
        build.check_shape(C, S, build.PACKED_STATES, 10, multi=False, walk=True)
    with pytest.raises(NotImplementedError, match="the theta path serve"):
        build.check_shape(80, 20, build.WIDE_NEWTON_STATES, multi=False)
    with pytest.raises(NotImplementedError, match="the codon mixture slice"):
        build.check_shape(12, 64)
    for C in (9, 12, 32, 40):
        build.check_shape(C, 4, n_slots=11)
        build.check_shape(C, 4, n_slots=11, walk=True)
        assert not build.packed(C, 4)
        assert build.wide_newton_multi(C, 4) == (C <= 32)
    assert not build.wide_newton_multi(8, 4) and not build.wide_newton_multi(12, 20)
    with pytest.raises(NotImplementedError, match="the CS-packed kernels serve C=8"):
        build.check_shape(8, 4, n_slots=11, walk=True)
    with pytest.raises(NotImplementedError, match="serves at most 8 categories"):
        build.check_shape(12, 4, build.PACKED_STATES, multi=False)
    assert build.wide_walk_smem(544, 4, 11) <= build.MAX_BLOCK_SMEM
    with pytest.raises(NotImplementedError, match="shared memory"):
        build.check_shape(545, 4, n_slots=11)
    with pytest.raises(NotImplementedError, match="shared memory"):
        build.check_shape(240, 20, n_slots=10)


@pytest.mark.parametrize("warps,slots,want", [(1, 5, 76864), (5, 5, 106560),
                                               (10, 5, 143680), (10, 10, 208000)])
def test_upward_walk_shared_memory_on_category_warps(warps, slots, want):
    """Past 8 categories the upward walk's block has W category warps: a
    ring stage holds W categories' [S,S] blocks of both children, the tip
    rows once a stage (a step's), the max buffers K W rows.  At C20's 80
    categories (10 a block on 8 blocks), 16 patterns a cluster: 4 (2 (W 2
    S^2 + 2 S tile) + slots (CB S + 1) tile + 2 K W tile) bytes, the
    one-warp layout's at W = 1."""
    S, C, tile, K, cb = 20, 80, 16, 8, 10
    got = pruning.wide_forward_smem(S, C, tile, slots, warps=warps)
    assert got == want == 4 * (2 * (warps * 2 * S * S + 2 * S * tile)
                               + slots * (cb * S + 1) * tile + 2 * K * warps * tile)
    assert pruning.wide_forward_smem(S, C, tile, slots) == \
        pruning.wide_forward_smem(S, C, tile, slots, warps=1)


@pytest.mark.parametrize("C,slots,want", [
    (80, 5, 5), (80, 6, 4), (80, 7, 10), (80, 10, 10), (80, 11, 10), (80, 12, 5),
    (80, 15, 4), (80, 16, 2), (80, 17, 1), (40, 5, 5), (40, 10, 5), (240, 3, 10),
    (240, 5, 4), (9, 3, 2), (4, 10, 1), (8, 10, 1)])
def test_upward_walk_category_warps_chooser(C, slots, want):
    """The wrappers' launch takes, of the W = ceil(CB / U) category warps
    whose block fits 320 threads (32 a warp at 16 patterns a cluster) and
    the 232 448 bytes a block may have, the least (U + 2) / b for b =
    min(2, blocks an SM's 233 472 bytes hold at 1 024 reserved a block),
    then the most blocks an SM, then the most warps.  C20 (80 categories,
    10 a block): 5 warps two blocks an SM at the bench tree's 5 slots, 4 at
    6, 10 one block an SM from 7 to 11, then 5, 4, 2 and 1 as the pool
    grows; C10 (40, 5 a block) 5; C60 (240, 30 a block) 10 at 3 slots (the
    thread bound), 4 at 5; C <= 8 one category and one warp a block."""
    from iqtree_torch.engine.kernels import build

    S, tile = 20, 16
    assert pruning.wide_forward_warps(S, C, tile, slots) == want
    K, cb = build.wide_layout(C)
    if cb == 1:
        return
    cands = []
    for u in range(1, cb + 1):
        w = -(-cb // u)
        smem = pruning.wide_forward_smem(S, C, tile, slots, warps=w)
        if w * 32 <= 320 and smem <= 232448:
            b = min(2, 233472 // (smem + 1024))
            cands.append(((u + 2) / b, -b, -w))
    assert -min(cands)[2] == want


@pytest.mark.parametrize("C", [12, 40, 80, 240])
def test_check_shape_refuses_exactly_what_fits_at_no_warps(C):
    """A wide walk at C categories is served at n_slots slots exactly when
    each of the four walks fits a block: the upward walk on one category
    warp (its smallest block; the chooser takes more warps only where they
    fit) and both reverse walks."""
    from iqtree_torch.engine.kernels import build

    S, tile = 20, 16
    cb = build.wide_layout(C)[1]
    for slots in range(1, 24):
        smallest = min(pruning.wide_forward_smem(S, C, tile, slots, warps=-(-cb // u))
                       for u in range(1, cb + 1))
        assert smallest == pruning.wide_forward_smem(S, C, tile, slots, warps=1)
        fits = max(smallest, cs_kernels.wide_down_store_smem(S, C, tile, slots),
                   cs_kernels.wide_tbar_smem(S, C, tile, slots)) <= build.MAX_BLOCK_SMEM
        if fits:
            build.check_shape(C, S, n_slots=slots)
        else:
            with pytest.raises(NotImplementedError, match="shared memory"):
                build.check_shape(C, S, n_slots=slots)


@pytest.mark.parametrize("warps,down,grad", [(1, 103744, 107072), (2, 115520, 133824),
                                             (4, 139072, 175552), (5, 150848, 196416)])
def test_reverse_walk_shared_memory_on_category_teams(warps, down, grad):
    """Past 8 categories the reverse walks' block has W category teams: a
    ring stage holds W categories' [S,S] blocks of both children and their
    rows and scales, the max buffers stay a block's (4 K tile), and the
    gradient sweep's ring is a stage deeper past one team (its sums lag a
    unit behind the walk), with a sum warp's stage for each team.  At C20's
    80 categories (10 a block on 8 blocks), 16 patterns a cluster and the
    bench tree's 5 slots: 4 (NS W (2 S^2 + 2 (S+1) tile) + slots (CB S + 1)
    tile + 2 CB S tile + 4 K tile) bytes, and for the gradient sweep 4 (2
    tile + W 2 S^2) more; at W = 1 the one-team layout's 103 744 and 107 072
    bytes."""
    S, C, tile, slots, K, cb = 20, 80, 16, 5, 8, 10
    ring = 2 * S * S + 2 * (S + 1) * tile
    rest = slots * (cb * S + 1) * tile + 2 * cb * S * tile + 4 * K * tile
    stages = 3 if warps > 1 else 2
    assert cs_kernels.wide_down_store_smem(S, C, tile, slots, warps=warps) == down == \
        4 * (2 * warps * ring + rest)
    assert cs_kernels.wide_tbar_smem(S, C, tile, slots, warps=warps) == grad == \
        4 * (stages * warps * ring + rest + 2 * tile + warps * 2 * S * S)
    assert cs_kernels.wide_tbar_threads(S, tile, warps) == 96 * warps


@pytest.mark.parametrize("C", [9, 40, 80, 240])
def test_reverse_walk_category_teams_chooser(C):
    """The reverse walks' launch takes, of the W = ceil(CB / U) category
    teams whose block fits its thread bound (64 walk threads a team at 16
    patterns a cluster, 320 a block; the gradient sweep 96 with its sum
    warp, 480) and the 232 448 bytes a block may have, the least (2 U + 2)
    / b for b = min(2, blocks an SM's 233 472 bytes hold at 1 024 reserved
    a block), then the most blocks an SM, then the most teams: a
    restatement over 1-15 slots.  C20 at the bench tree's 5 slots: 2 teams
    and two blocks an SM for the outside store, 5 and one for the gradient
    sweep; C9 (2 a block) 2 teams."""
    from iqtree_torch.engine.kernels import build

    S, tile = 20, 16
    cb = build.wide_layout(C)[1]
    for slots in range(1, 16):
        for sums, smem in ((False, cs_kernels.wide_down_store_smem),
                           (True, cs_kernels.wide_tbar_smem)):
            cands = []
            for u in range(1, cb + 1):
                w = -(-cb // u)
                by = smem(S, C, tile, slots, warps=w)
                if w * (96 if sums else 64) <= (480 if sums else 320) and by <= 232448:
                    b = min(2, 233472 // (by + 1024))
                    cands.append(((2 * u + 2) / b, -b, -w))
            want = -min(cands)[2] if cands else 1
            assert cs_kernels.wide_reverse_teams(S, C, tile, slots, sums=sums) == want
    if C == 80:
        assert cs_kernels.wide_reverse_teams(S, C, tile, 5) == 2
        assert cs_kernels.wide_reverse_teams(S, C, tile, 5, sums=True) == 5
    if C == 9:
        assert cs_kernels.wide_reverse_teams(S, C, tile, 5) == 2
    assert cs_kernels.wide_reverse_teams(S, 8, tile, 5) == 1


@pytest.mark.parametrize("C", [12, 40, 80, 240])
def test_check_shape_serves_what_one_team_served(C):
    """The reverse walks' shared memory at one category team is the layout
    they had before category teams (a ring of two stages of one category),
    the least of any team count, so check_shape accepts and refuses exactly
    the (C, slots) that layout and the upward walk's one-warp layout fit;
    and wherever it accepts, the launch each of the four walks' choosers
    picks fits a block."""
    from iqtree_torch.engine.kernels import build

    S, tile = 20, 16
    K, cb = build.wide_layout(C)
    ds, tb = cs_kernels.wide_down_store_smem, cs_kernels.wide_tbar_smem
    for slots in range(1, 24):
        one = 4 * (2 * (2 * S * S + 2 * (S + 1) * tile) + slots * (cb * S + 1) * tile
                   + 2 * cb * S * tile + 4 * K * tile)
        assert ds(S, C, tile, slots) == one
        assert tb(S, C, tile, slots) == one + 4 * (2 * tile + 2 * S * S)
        for f in (ds, tb):
            assert min(f(S, C, tile, slots, warps=-(-cb // u))
                       for u in range(1, cb + 1)) == f(S, C, tile, slots)
        up = 4 * (2 * 2 * (S * S + S * tile) + slots * (cb * S + 1) * tile + 2 * K * tile)
        if max(up, one + 4 * (2 * tile + 2 * S * S)) <= build.MAX_BLOCK_SMEM:
            build.check_shape(C, S, n_slots=slots)
            for sums, f in ((False, ds), (True, tb)):
                w = cs_kernels.wide_reverse_teams(S, C, tile, slots, sums=sums)
                assert f(S, C, tile, slots, warps=w) <= build.MAX_BLOCK_SMEM
            w = pruning.wide_forward_warps(S, C, tile, slots)
            assert pruning.wide_forward_smem(S, C, tile, slots, warps=w) <= build.MAX_BLOCK_SMEM
        else:
            with pytest.raises(NotImplementedError, match="shared memory"):
                build.check_shape(C, S, n_slots=slots)


def _forty_case():
    """C10 (40 categories) on an 8-taxon protein alignment with ambiguity
    codes and a random tree, float64 on the CPU."""
    from iqtree_torch.engine.likelihood import ModelArrays, SiteData, TreeArrays
    from iqtree_torch.io.alignment import AA_ORDER, Alignment
    from iqtree_torch.models.factory import parse_model_string
    from iqtree_torch.trees.tree import random_tree

    rng = np.random.default_rng(40)
    seqs = ["".join(rng.choice(list(AA_ORDER + "-XB"), 90)) for _ in range(8)]
    aln = Alignment.from_sequences([f"t{i}" for i in range(8)], seqs, "AA")
    tree = random_tree(8, rng)
    ta = TreeArrays.from_tree(tree, CPU)
    model = ModelArrays.from_model(*parse_model_string("C10", aln), CPU)
    steps, n_slots = pruning.device_slot_schedule(tree, ta)
    return ta, model, SiteData.from_alignment(aln, CPU, torch.float64), \
        torch.as_tensor(steps), n_slots


def test_plain_twins_take_forty_categories():
    """The kernels' plain twins at C = 40 (C10): the forward twin equals the
    plain pass, the gradient sweep's cotangents equal autograd's of the
    plain lnL, the outside store gives every edge's pattern likelihoods
    (sum_c w_c O_c . P_c U_c with both scales), and the theta path's d lnL/dt
    equals autograd's."""
    from iqtree_torch.engine.derivatives import branch_derivs
    from iqtree_torch.engine.likelihood import SCALE_TINY, upward_pass

    ta, model, site, steps, n_slots = _forty_case()
    assert model.ncat == 40
    tips = tip_partials(site)
    invar = ptn_invar(model, site)
    total, pat = fused_compute_loglik(ta, model, site, steps, n_slots)
    np.testing.assert_allclose(float(total), float(compute_loglik(ta, model, site)[0]),
                               rtol=1e-12)
    trans = branch_transition_mats(model, ta.blen).detach().requires_grad_()
    up, usc = upward_pass(ta.levels, ta.children, trans, tips)
    rootw = (model.props[:, None] * model.state_freq).reshape(-1)
    lnl = torch.log(rootw @ up[ta.root].reshape(-1, up.shape[-1])) + usc[ta.root]
    want = torch.autograd.grad((site.pattern_freq * lnl).sum(), trans)[0]
    got = fused_tbar_cs(steps, n_slots, trans.detach(), tips, model.props, model.state_freq,
                        lnl.detach(), site.pattern_freq)
    edges = 2 * ta.n_taxa - 2
    np.testing.assert_allclose(got[:edges].numpy(), want[:edges].numpy(), rtol=1e-9,
                               atol=1e-9 * float(want.abs().max()))
    up_s, usc_s = fused_upward_store_cs(steps, n_slots, trans.detach(), tips)
    cs_kernels.fill_tip_rows_cs(up_s, usc_s, tips, 40)
    out, osc = cs_kernels.fused_down_store_cs(steps, n_slots, trans.detach(), up_s, usc_s,
                                              model.state_freq)
    C, S, P = 40, 20, up_s.shape[2]
    msg = trans.detach() @ up_s.reshape(-1, C, S, P)  # P_e U_e, [2N, C, S, P]
    like = (model.props[None, :, None, None] * out.reshape(-1, C, S, P) * msg).sum((1, 2))
    for e in range(edges):
        if e == ta.root:
            continue
        np.testing.assert_allclose((torch.log(torch.clamp(like[e], min=SCALE_TINY))
                                    + osc[e] + usc_s[e]).numpy(), lnl.detach().numpy(),
                                   rtol=1e-10)
    blen = ta.blen.clone().requires_grad_()
    d_blen = torch.autograd.grad(compute_loglik(ta.with_blen(blen), model, site)[0], blen)[0]
    d1, _ = branch_derivs(steps, n_slots, model, site, ta.blen, tips.contiguous(),
                          invar.contiguous())
    mask = torch.ones_like(d1, dtype=torch.bool)
    mask[[ta.root, ta.dummy]] = False
    np.testing.assert_allclose(d1[mask].numpy(), d_blen[mask].numpy(), rtol=1e-7,
                               atol=1e-9 * float(d_blen.abs().max()))


def test_theta_path_in_chunks_equals_all_at_once(monkeypatch):
    """The theta path's branches in chunks under THETA_BUDGET give the
    values of every branch at once, bit for bit (C10: the theta path)."""
    from iqtree_torch.engine import derivatives

    ta, model, site, steps, n_slots = _forty_case()
    assert not derivatives.newton_serves(40, 20) and derivatives.newton_serves(8, 20)
    args = (steps, n_slots, model, site, ta.blen, tip_partials(site).contiguous(),
            ptn_invar(model, site).contiguous())
    whole = derivatives.branch_derivs(*args)
    per_edge = derivatives.THETA_LIVE * 40 * 20 * site.pattern_freq.shape[0] * 8
    for edges in (1, 3):
        monkeypatch.setattr(derivatives, "THETA_BUDGET", edges * per_edge)
        assert derivatives.theta_chunk_edges(16, 800, site.pattern_freq.shape[0], 8) == edges
        for got, want in zip(derivatives.branch_derivs(*args), whole):
            assert torch.equal(got, want)


def test_distance_chunks_count_the_categories(monkeypatch):
    """pair_chunk_rows sizes a chunk by the wider of the Newton loop's S*S
    and C*S temporaries (C20: C*S = 1 600 = 4 S*S, so a quarter of the rows
    of LG+G4); the ML distances of C10 in one-row chunks equal those in one
    chunk, bit for bit."""
    from iqtree_torch.engine import distances

    f = distances.pair_chunk_rows
    assert f(300, 20, 4) == f(300, 20) == 300
    budget = distances.PAIR_BUDGET // (distances.PAIR_LIVE * 8)
    assert f(300, 20, 80) == budget // 1600 // 300 < f(300, 20, 4)
    assert f(1000, 61, 4) == f(1000, 61) == 12
    ta, model, site, _, _ = _forty_case()
    whole = distances.ml_distances(model, site)
    monkeypatch.setattr(distances, "PAIR_BUDGET", distances.PAIR_LIVE * 800 * 8 * 8)
    assert f(8, 20, 40) == 1
    assert np.array_equal(distances.ml_distances(model, site), whole)


def test_engine_decision_counts_the_theta_chunk():
    """C20 (80 categories) takes the theta path: the decision keeps up and
    out and reckons a chunk of branches' theta buffers; LG+G4's numbers are
    as before (no theta path)."""
    from iqtree_torch.engine import derivatives
    from iqtree_torch.engine.banner import decide_engine, engine_banner

    dec = decide_engine(300, 80, 20, 1958, CPU, torch.float32)
    per_edge = derivatives.THETA_LIVE * 1600 * 1958 * 4
    assert dec.store_bytes == 2 * 600 * 1601 * 1958 * 4
    assert dec.theta_bytes == derivatives.THETA_BUDGET // per_edge * per_edge
    assert "theta buffers" in engine_banner(dec, 300, 80, 20, 1958)
    lg = decide_engine(300, 4, 20, 1958, CPU, torch.float32)
    assert lg.store_bytes == 600 * 81 * 1958 * 4 and lg.theta_bytes == 0
