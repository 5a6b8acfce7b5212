"""The codon fixed-topology fit (-st CODON -te ... -m GY+F3X4+G) of the port
against the JAX package.

Genetic codes, codon encoding, the codon models and their eigensystems,
the likelihood and its gradient, the plain twins of the four wide kernels
at S=61 and the theta path's branch Newton step go through both packages
on the CPU in float64 (random 6-taxon x 40-codon cases from a numpy seed;
the JAX side runs its Pallas kernels in interpret mode, as
tests/test_torch_protein.py does).  The CUDA kernels' S=64 instances (a
codon space padded with zeros) are held against the twins by
tests/test_torch_cuda.py and chip_smoke.py on the card; here the padding
is held against the unpadded arithmetic through the twins.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.engine.derivatives import compute_thetas as jax_thetas
from iqtree_tpu.engine.derivatives import newton_direction as jax_newton_direction
from iqtree_tpu.engine.grad import loglik as jax_loglik
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
from iqtree_tpu.engine.likelihood import tip_partials as jax_tips
from iqtree_tpu.engine.nni import _ptn_invar as jax_ptn_invar
from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models import codon as jax_codon
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.models.optimize import ModelOptimizer as JOptimizer
from iqtree_tpu.trees.tree import random_tree as jax_random_tree

from iqtree_torch import convert
from iqtree_torch.cli import main as cli_main
from iqtree_torch.config import parse_args
from iqtree_torch.engine.banner import decide_engine, engine_banner
from iqtree_torch.engine.derivatives import branch_derivs, newton_target
from iqtree_torch.engine.grad import loglik
from iqtree_torch.engine.kernels import build, cs_kernels, pruning
from iqtree_torch.engine.kernels.cs_kernels import fused_downward_tbar, fused_nni_passes_cs
from iqtree_torch.engine.kernels.pruning import fused_site_lnl, fused_upward_store
from iqtree_torch.engine.likelihood import (
    ModelArrays,
    SiteData,
    TreeArrays,
    branch_transition_mats,
    compute_loglik,
    ptn_invar,
    tip_partials,
)
from iqtree_torch.io.alignment import Alignment, read_alignment
from iqtree_torch.models import codon
from iqtree_torch.models.factory import default_model, parse_model_string
from iqtree_torch.models.optimize import ModelOptimizer
from iqtree_torch.trees.tree import PhyloTree

from test_torch_likelihood import CPU, DATA

CODON_ALN = os.path.join(DATA, "example_codon.phy")
CODON_TREE = os.path.join(DATA, "ssf_golden.treefile")
# IQ-TREE 1.4.3 on the same -te GY+F3X4 fit (tests/test_golden_configs.py)
GOLDEN_GY_LNL, GOLDEN_OMEGA, GOLDEN_KAPPA = -11142.814, 0.136, 1.072


def random_codons(rng, n_taxa, n_codons, code=1, gaps=0.05):
    """Random sense codons of a genetic code, a share of them gaps or
    ambiguous triplets."""
    sc = codon.sense_codons(code)
    nt = codon.NT_ORDER

    def one():
        r = rng.random()
        if r < gaps:
            return "---" if r < gaps / 2 else "ANC"
        c = int(rng.choice(sc))
        return nt[c // 16] + nt[(c // 4) % 4] + nt[c % 4]

    return ["".join(one() for _ in range(n_codons)) for _ in range(n_taxa)]


def make_case(C=4, n_taxa=6, n_codons=40, seed=3):
    """A random codon alignment, GY+G(C) at kappa 1.8, omega 0.4 and a
    random tree, as JAX arrays (f64) and as the port's tensors (f64, via
    convert.py), with the slot schedule and both packages' model objects."""
    rng = np.random.default_rng(seed)
    seqs = random_codons(rng, n_taxa, n_codons)
    names = [f"t{i}" for i in range(n_taxa)]
    ja = JAlignment.from_sequences(names, seqs, "CODON")
    a = Alignment.from_sequences(names, seqs, "CODON")
    model = f"GY+G{C}" if C > 1 else "GY"
    (js, jr), (s, r) = jax_parse_model(model, ja), parse_model_string(model, a)
    for m in (js, s):
        m.kappa, m.omega = 1.8, 0.4
        m.refresh_exchange()
    jr.alpha = r.alpha = 0.7
    tree = jax_random_tree(n_taxa, rng)
    j = (JTree.from_tree(tree, jnp.float64), JModel.from_model(js, jr, jnp.float64),
         JSite.from_alignment(ja, jnp.float64))
    t = (convert.tree_arrays(j[0], CPU), convert.model_arrays(j[1], CPU),
         convert.site_data(j[2], CPU))
    steps, n_slots = jax_schedule(tree, j[0])
    return j, t, steps, n_slots, (js, jr), (s, r)


@functools.lru_cache(maxsize=1)
def twin_case():
    """The C=2 case of the kernel and theta comparisons, with the JAX
    package's forward lnL and its two global passes (computed once)."""
    case = make_case(C=2)
    (jt, jm, js), _, steps, n_slots, _, _ = case
    trans_j, tips_j = jax_trans(jm, jt.blen), jax_tips(js, 2)
    lnl_j = jax_forward(jnp.asarray(steps), trans_j, tips_j, jm.props, jm.state_freq,
                        jax_ptn_invar(jm, js), n_slots=n_slots, interpret=True)
    passes_j = jax_passes(jnp.asarray(steps), n_slots, trans_j, tips_j, jm.props,
                          jm.state_freq, interpret=True)
    return case, lnl_j, passes_j


@pytest.mark.parametrize("code", sorted(codon.GENETIC_CODES))
def test_genetic_codes_match_jax(code):
    """The translation table, the sense codons (60 to 63 of them), their
    names and the single-step masks of every genetic code."""
    assert codon.genetic_code_table(code) == jax_codon.genetic_code_table(code)
    np.testing.assert_array_equal(codon.sense_codons(code), jax_codon.sense_codons(code))
    assert codon.codon_strings(code) == jax_codon.codon_strings(code)
    assert 60 <= len(codon.sense_codons(code)) <= 63
    got, want = codon.codon_masks(code), jax_codon.codon_masks(code)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_codon_alignment_matches_jax():
    """Encoding (gaps and ambiguities unknown), pattern compression, the
    stop-codon error, the per-position nucleotide frequencies and the
    counted codon frequencies on example_codon.phy and a random case."""
    a = read_alignment(CODON_ALN, "CODON")
    ja = jax_read_alignment(CODON_ALN, "CODON")
    assert a.num_states == ja.num_states == 61 and a.states.genetic_code == 1
    for f in ("patterns", "pattern_freq", "const_state", "site_to_pattern"):
        np.testing.assert_array_equal(getattr(a, f), getattr(ja, f), err_msg=f)
    np.testing.assert_array_equal(a.states.code_masks, ja.states.code_masks)
    np.testing.assert_array_equal(a.states.codon_to_state, ja.states.codon_to_state)
    np.testing.assert_allclose(a.state_frequencies(), ja.state_frequencies(), rtol=1e-14)
    for by_position in (True, False):
        np.testing.assert_allclose(a.codon_nt_frequencies(by_position),
                                   ja.codon_nt_frequencies(by_position), rtol=1e-14)
    assert a.num_informative_sites() == ja.num_informative_sites()
    assert default_model(a) == "GY+G"
    seqs = random_codons(np.random.default_rng(9), 5, 30, code=2, gaps=0.2)
    names = [f"t{i}" for i in range(5)]
    got = Alignment.from_sequences(names, seqs, "CODON", 2)
    want = JAlignment.from_sequences(names, seqs, "CODON", genetic_code=2)
    assert got.num_states == 60
    np.testing.assert_array_equal(got.patterns, want.patterns)
    for bad in ("ATGTAA", "ATGAGA"):  # TAA stops code 1; AGA only code 2
        code = 1 if bad.endswith("TAA") else 2
        with pytest.raises(ValueError, match="stop codon") as e:
            Alignment.from_sequences(["a"], [bad], "CODON", code)
        with pytest.raises(ValueError) as je:
            JAlignment.from_sequences(["a"], [bad], "CODON", genetic_code=code)
        assert str(e.value) == str(je.value) and "position 4" in str(e.value)


@pytest.mark.parametrize("model", ["GY", "GY+F1X4", "GY+F3X4", "MG+F3X4", "KOSI07",
                                   "SCHN05", "ECMREST"])
def test_codon_models_match_jax(model):
    """parse_model_string: the same Q, frequencies and eigensystem as the
    JAX package's within 1e-10, and the optimizer's transition matrices."""
    a, ja = read_alignment(CODON_ALN, "CODON"), jax_read_alignment(CODON_ALN, "CODON")
    (s, r), (js, jr) = parse_model_string(model, a), jax_parse_model(model, ja)
    assert s.name == js.name and s.freq_type == js.freq_type
    np.testing.assert_allclose(s.state_freq, js.state_freq, rtol=1e-13)
    np.testing.assert_allclose(s.rate_matrix(), js.rate_matrix(), rtol=1e-10, atol=1e-12)
    lam, v, vinv = s.eigen()
    jlam, jv, jvinv = js.eigen()
    np.testing.assert_allclose(lam, jlam, atol=1e-10)
    np.testing.assert_allclose(v @ np.diag(lam) @ vinv, jv @ np.diag(jlam) @ jvinv,
                               atol=1e-10)
    if isinstance(js, jax_codon.CodonModel):
        carried = convert.codon_model(js)
        np.testing.assert_allclose(carried.exchange, js.exchange, rtol=1e-14)
        np.testing.assert_allclose(carried.rate_matrix(), js.rate_matrix(), rtol=1e-12)
    opt, jopt = ModelOptimizer(s, r, CPU), JOptimizer(js, jr, dtype=jnp.float64)
    p, jp = opt.init_params(), jopt.init_params()
    assert set(p) == set(jp)
    got = opt.build(p)
    want = convert.model_arrays(jopt.build(jp), CPU)
    blen = torch.tensor([0.0, 0.01, 0.3, 2.0], dtype=torch.float64)
    np.testing.assert_allclose(branch_transition_mats(got, blen).numpy(),
                               branch_transition_mats(want, blen).numpy(), atol=1e-10)


def test_codon_lnl_and_gradient_match_jax():
    """GY+G4 in float64 on 6 taxa x 40 codons: the lnL within 1e-8
    relative, and its gradient in log_kappa, log_omega, alpha and the
    branch lengths within 1e-6, both from the optimizers' parameters."""
    (jt, _, js), (tt, _, ts), steps, n_slots, (jsub, jr), (s, r) = make_case()
    jopt, opt = JOptimizer(jsub, jr, dtype=jnp.float64), ModelOptimizer(s, r, CPU)
    jp = jopt.init_params()
    assert set(jp) == {"log_kappa", "log_omega", "alpha_logit"}

    def jlnl(p, blen):
        return jax_loglik(jt._replace(blen=blen), jopt.build(p), js)[0]

    want_lnl, (want_g, want_gb) = jax.jit(jax.value_and_grad(jlnl, argnums=(0, 1)))(
        jp, jt.blen)
    want_lnl = float(want_lnl)
    p = {k: torch.tensor(np.asarray(v)).requires_grad_() for k, v in jp.items()}
    blen = tt.blen.clone().requires_grad_()
    total, _ = loglik(tt.with_blen(blen), opt.build(p), ts, convert.schedule(steps, CPU),
                      n_slots)
    got = torch.autograd.grad(total, [*p.values(), blen])
    assert abs(float(total) - want_lnl) <= 1e-8 * abs(want_lnl)
    for k, g in zip(p, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_g[k]), rtol=1e-6, err_msg=k)
    gb, wb = got[-1].numpy(), np.asarray(want_gb)
    np.testing.assert_allclose(gb, wb, rtol=1e-6, atol=1e-6 * np.abs(wb).max())


@pytest.mark.parametrize("kernel", ["forward", "store", "tbar", "down_store"])
def test_codon_twins_match_jax(kernel):
    """The plain twins of the four wide kernels at S=61, C=2 against the
    JAX package's Pallas bodies (_kernel, _kernel_store, _kernel_down_tbar,
    _kernel_down_store) in interpret mode, from the same transition
    matrices; tolerances of tests/test_torch_protein.py."""
    ((jt, jm, js), (tt, tm, ts), steps, n_slots, _, _), lnl_j, passes_j = twin_case()
    trans_j, tips_j = jax_trans(jm, jt.blen), jax_tips(js, 2)
    trans, tips = torch.tensor(np.asarray(trans_j)), tip_partials(ts)
    st = convert.schedule(steps, CPU)
    N, P, CS = tt.n_taxa, ts.pattern_freq.shape[0], 2 * 61
    if kernel == "forward":
        got = fused_site_lnl(st, n_slots, trans, tips, tm.props, tm.state_freq,
                             ptn_invar(tm, ts))
        np.testing.assert_allclose(got.numpy(), np.asarray(lnl_j), rtol=1e-11)
    elif kernel == "store":
        up_j, usc_j = jax_store(jnp.asarray(steps), trans_j, tips_j, n_slots=n_slots,
                                interpret=True)
        up, usc = fused_upward_store(st, n_slots, trans, tips)
        inner = slice(N, 2 * N - 1)
        np.testing.assert_allclose(
            up[inner].numpy(), np.asarray(up_j)[inner, :, :61, :P].reshape(N - 1, CS, P),
            rtol=1e-11, atol=1e-14)
        np.testing.assert_allclose(usc[inner].numpy(), np.asarray(usc_j)[inner, :P],
                                   rtol=1e-11, atol=1e-12)
    elif kernel == "tbar":
        lnl = np.asarray(lnl_j)
        wp = np.asarray(js.pattern_freq) * np.random.default_rng(5).uniform(0.5, 1.5, P)
        up, _, usc8 = jax_store8(jnp.asarray(steps), n_slots, trans_j, tips_j,
                                 want_scale8=True, interpret=True)
        P_pad, S_pad = up.shape[-1], up.shape[2]
        tips_f = jnp.pad(tips_j, ((0, 0), (0, S_pad - 61), (0, P_pad - P)))
        up = up.at[:N].set(tips_f[:, None])
        usc8 = usc8.at[:N].set(0.0)
        pad = lambda x: jnp.pad(jnp.asarray(x), (0, P_pad - P))
        want = np.asarray(jax_tbar(jnp.asarray(steps), n_slots, trans_j, tips_j, up, usc8,
                                   jm.state_freq, jm.props, pad(lnl), pad(wp),
                                   interpret=True))[:, :, :61, :61]
        got = fused_downward_tbar(st, n_slots, trans, tips, tm.props, tm.state_freq,
                                  torch.tensor(lnl), torch.tensor(wp))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * float(np.abs(want).max()))
    else:
        _, _, out_j, osc_j = passes_j
        _, _, out, osc = fused_nni_passes_cs(st, n_slots, trans, tips, tm.state_freq)
        rows = [v for v in range(2 * N - 1) if v != tt.root]
        np.testing.assert_allclose(out[rows].numpy(),
                                   np.asarray(out_j)[..., :P].reshape(2 * N, CS, P)[rows],
                                   rtol=1e-10, atol=1e-300)
        np.testing.assert_allclose(osc[rows].numpy(), np.asarray(osc_j)[..., :P][rows],
                                   rtol=1e-10, atol=1e-12)


def test_theta_newton_step_matches_jax():
    """The codon branch Newton's theta path (the upward and outside-partial
    stores, then the thetas and every branch's joint Newton target) against
    the JAX package's compute_thetas + newton_direction within 1e-8
    relative to the largest target (a target divides by d2, so a branch
    with a small target carries the others' rounding)."""
    ((jt, jm, js), (tt, tm, ts), steps, n_slots, _, _), _, passes_j = twin_case()
    before = [cs_kernels.newton_sweep.launches, cs_kernels.wide_newton_sweep.launches]
    tips = tip_partials(ts).contiguous()
    d1, d2 = branch_derivs(convert.schedule(steps, CPU), n_slots, tm, ts, tt.blen, tips,
                           ptn_invar(tm, ts))
    assert [cs_kernels.newton_sweep.launches,
            cs_kernels.wide_newton_sweep.launches] == before
    got = newton_target(d1, d2, tt.blen)
    up, usc, out, osc = passes_j
    P = ts.pattern_freq.shape[0]
    theta = jax_thetas(jt, jm, js, up[..., :P], usc[..., :P], out[..., :P], osc[..., :P])
    want = np.asarray(jax_newton_direction(theta, jm, js, jt.blen))
    free = [v for v in range(2 * tt.n_taxa - 1) if v != tt.root]
    np.testing.assert_allclose(got.numpy()[free], want[free], rtol=1e-8,
                               atol=1e-8 * np.abs(want[free]).max())


def test_padded_instance_arithmetic_is_the_unpadded():
    """What the wrappers hand the S=64 kernel instance: trans, tips, root
    weights and stored partials zero-padded from S=61 (pad_states,
    pad_partials).  Through the plain twins the padded rows stay 0 and the
    real rows, scales, cotangents and site lnL are the unpadded ones."""
    (_, _, _), (tt, tm, ts), steps, n_slots, _, _ = make_case(C=2, seed=6)
    st = convert.schedule(steps, CPU)
    trans, tips = branch_transition_mats(tm, tt.blen), tip_partials(ts)
    S, SK, C = 61, build.instance_states(61), 2
    assert SK == 64 and build.instance_states(60) == build.instance_states(63) == 64
    trans_p, tips_p = pruning.pad_states(trans, SK, 2, 3), pruning.pad_states(tips, SK, 1)
    freq_p = pruning.pad_states(tm.state_freq, SK, 1)
    assert trans_p.shape == (2 * tt.n_taxa, C, SK, SK) and trans_p.is_contiguous()
    invar = ptn_invar(tm, ts)
    want = fused_site_lnl(st, n_slots, trans, tips, tm.props, tm.state_freq, invar)
    got = fused_site_lnl(st, n_slots, trans_p, tips_p, tm.props, freq_p, invar)
    assert torch.equal(got, want)
    up, usc = fused_upward_store(st, n_slots, trans, tips)
    up_p, usc_p = fused_upward_store(st, n_slots, trans_p, tips_p)
    inner = slice(tt.n_taxa, 2 * tt.n_taxa - 1)
    assert torch.equal(pruning.unpad_partials(up_p, C, S)[inner], up[inner])
    assert torch.equal(usc_p[inner], usc[inner])
    assert not bool(up_p.reshape(-1, C, SK, up.shape[-1])[inner, :, S:].any())
    np.testing.assert_array_equal(pruning.pad_partials(up, C, SK)[inner].numpy(),
                                  up_p[inner].numpy())
    _, _, out, osc = fused_nni_passes_cs(st, n_slots, trans, tips, tm.state_freq)
    _, _, out_p, osc_p = fused_nni_passes_cs(st, n_slots, trans_p, tips_p, freq_p)
    rows = [v for v in range(2 * tt.n_taxa - 1) if v != tt.root]
    assert torch.equal(pruning.unpad_partials(out_p, C, S)[rows], out[rows])
    assert torch.equal(osc_p[rows], osc[rows])
    wp = ts.pattern_freq
    tb = fused_downward_tbar(st, n_slots, trans, tips, tm.props, tm.state_freq, want, wp)
    tb_p = fused_downward_tbar(st, n_slots, trans_p, tips_p, tm.props, freq_p, want, wp)
    torch.testing.assert_close(tb_p[:, :, :S, :S], tb, rtol=1e-13, atol=0)
    assert not bool(tb_p[:, :, S:].any()) and not bool(tb_p[:, :, :, S:].any())


def test_shapes_and_banner_name_the_codon_instance():
    """The wide kernels serve the codon spaces (60 to 63 states) through
    the S=64 instance; the branch-Newton kernel serves no codon space (the
    theta path); the banner names both."""
    for S in (60, 61, 62, 63):
        build.check_shape(4, S)
        build.check_shape(8, S, build.WIDE_STATES)
        with pytest.raises(NotImplementedError, match="instances for S in"):
            build.check_shape(4, S, build.WIDE_NEWTON_STATES)
    # 21 to 32 morphological states share the S=64 instance, and its limit
    with pytest.raises(NotImplementedError, match="the codon mixture slice"):
        build.check_shape(12, 25)
    dec = decide_engine(80, 4, 61, 457, CPU, torch.float64)
    assert dec.store_bytes == 2 * 160 * 245 * 457 * 8  # up and out: the theta path
    text = engine_banner(dec, 80, 4, 61, 457)
    assert "theta path" in text and "up and outside partials" in text
    assert cs_kernels.wide_tbar_smem(64, 4, 16, 11) == \
        cs_kernels.wide_down_store_smem(64, 4, 16, 11) + 4 * 2 * 16 == 137280
    assert pruning.wide_forward_smem(64, 4, 16, 11) == 128192 <= 232448
    assert cs_kernels.wide_tbar_threads(64, 16) == 16 * 8 + 4 * 32
    assert cs_kernels.wide_tbar_threads(20, 16) == 16 * 4 + 32


def test_cli_codon_fit(tmp_path):
    """`-st CODON -te ... -m GY+F3X4 -device cpu` through the CLI: the
    reference binary's optimum, its omega and kappa, a report with codon
    names; `-st CODON2` picks genetic code 2; `-st CODON` without -te is
    the codon search (tests/test_torch_codon_search.py runs it), while an
    unported sequence type refuses before any work."""
    prefix = str(tmp_path / "gy")
    assert cli_main(["-s", CODON_ALN, "-st", "CODON", "-te", CODON_TREE, "-m", "GY+F3X4",
                     "-device", "cpu", "-pre", prefix]) == 0
    with open(prefix + ".log") as f:
        log = f.read()
    lnl = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    kappa, omega = map(float, re.search(r"parameters: GY\{(\S+),(\S+)\}\+F", log).groups())
    assert lnl >= GOLDEN_GY_LNL - 0.2, lnl
    assert abs(omega - GOLDEN_OMEGA) < 0.01 and abs(kappa - GOLDEN_KAPPA) < 0.03
    assert "theta path" in log and "1x61" in log
    with open(prefix + ".iqtree") as f:
        report = f.read()
    assert "128 codon sites" in report and "pi(AAA)" in report and "pi(TTT)" in report
    assert "pi(TAA)" not in report and "Rate matrix Q" not in report
    assert f"Nonsynonymous/synonymous ratio omega: {omega:.4f}" in report
    # the logged model string pins what was fitted: it re-evaluates to the lnL
    fitted = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    a = read_alignment(CODON_ALN, "CODON")
    s, r = parse_model_string(fitted, a)
    assert (s.kappa, s.omega, s.fix_kappa, s.fix_omega) == (kappa, omega, True, True)
    with open(prefix + ".treefile") as f:
        tree = PhyloTree.from_newick(f.read(), a.names)
    lnl64, _ = compute_loglik(TreeArrays.from_tree(tree, CPU), ModelArrays.from_model(s, r, CPU),
                              SiteData.from_alignment(a, CPU, torch.float64))
    assert abs(float(lnl64) - lnl) < 0.05  # the written values' 6 decimals
    with pytest.raises(ValueError, match="takes two parameters"):
        parse_model_string("GY{2.0}", a)
    assert parse_args(["-s", "x", "-st", "CODON2", "-te", "t"]).genetic_code == 2
    assert parse_args(["-s", "x", "-st", "CODON", "-te", "t"]).seq_type == "CODON"
    search = parse_args(["-s", CODON_ALN, "-st", "CODON", "-device", "cpu"])
    assert (search.seq_type, search.fixed_tree) == ("CODON", None)
    with pytest.raises(SystemExit, match="-st NT2AA: unsupported sequence type"):
        cli_main(["-s", CODON_ALN, "-st", "NT2AA", "-device", "cpu",
                  "-pre", str(tmp_path / "s")])
    with pytest.raises(SystemExit, match="unknown genetic code"):
        parse_args(["-s", "x", "-st", "CODON7", "-te", "t"])
