"""Ablation variants of the forward kernel: where a forward step's time goes.

`forward_ablation(variant, steps, n_slots, trans, tips)` returns the root
slot's log-scale [P] after the forward walk with a part of each step's
work taken out: csrc/forward_ablate.cu for CUDA tensors, the variant's
plain twin for CPU tensors.  The variants (the kernel's header says what
each computes):

  full       the forward step (forward.cu)
  nomatmul   the children's columns multiplied without their edge product
  norescale  no max, divide or log; scale = sl + sr
  nostage    no per-step child loads: a fixed column of ones instead
  noscale    no scale reads or writes
  empty      the loop reads the step rows and does nothing
  highprec3  full, each edge product at the TPU matrix unit's 3 passes:
             hi*hi + hi*lo + lo*hi of the operands' bfloat16 parts
  defprec    full, each edge product at its 1 pass: hi*hi

    python -m iqtree_torch.engine.kernels.ablate

times every variant on the card at the bench shapes (bench_data.npz's
tree, 1000 taxa, its 9 962 patterns; random trans and tips from numpy seed
0) and prints ms a launch and us a step (a launch's time over the
schedule's steps).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from . import build
from .pruning import DEFAULT_TILE, device_slot_schedule, schedule_tree, upward_plain
from ..likelihood import SCALE_TINY, TreeArrays

VARIANTS = ("full", "nomatmul", "norescale", "nostage", "noscale", "empty",
            "highprec3", "defprec")
# the precision variants: the matrix unit's passes over bfloat16 parts
PASSES = {"highprec3": 3, "defprec": 1}
# the kernel's one instance: the bench shapes' C=4 rate categories
ABLATE_CATEGORIES = 4
BENCH_DATA = Path(__file__).resolve().parents[3] / "bench_data.npz"


def bf16_split(x: torch.Tensor):
    """(hi, lo) in x's dtype: hi = x rounded to bfloat16 (through float32,
    to nearest even), lo = x - hi rounded the same way."""
    hi = x.to(torch.bfloat16).to(x.dtype)
    return hi, (x - hi).to(torch.bfloat16).to(x.dtype)


def pass_product(passes: int, P: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """P @ x ([n, C, S, S] @ [n, C, S, P]) over the operands' bfloat16
    parts, summed in the kernel's order: for each t, hi*hi, then in 3
    passes hi*lo and lo*hi.  A product of two bfloat16 values is exact in
    float32, so each add rounds once, as the kernel's FMA does: the twin
    gives the kernel's bits."""
    (ph, pl), (xh, xl) = bf16_split(P), bf16_split(x)
    pairs = ((ph, xh), (ph, xl), (pl, xh))[:passes]
    acc = None
    for t in range(P.shape[-1]):
        for a, b in pairs:
            term = a[..., :, t, None] * b[..., t, None, :]
            acc = term if acc is None else acc + term
    return acc


def precision_plain(passes: int, steps, trans, tips) -> torch.Tensor:
    """Plain twin of a precision variant: the root slot's log-scale [P]
    of the level-batched walk with each edge product at `passes`."""
    n_rows, C, S = trans.shape[:3]
    N, _, P = tips.shape
    levels, children = schedule_tree(steps, n_rows)
    up = tips.new_zeros(n_rows, C, S, P)
    up[:N] = tips[:, None]
    usc = tips.new_zeros(n_rows, P)
    for ids in levels:
        l, r = children[ids, 0], children[ids, 1]
        y = pass_product(passes, trans[l], up[l]) * pass_product(passes, trans[r], up[r])
        mx = torch.clamp(y.amax(dim=(1, 2)), min=SCALE_TINY)
        up[ids] = y / mx[:, None, None, :]
        usc[ids] = usc[l] + usc[r] + torch.log(mx)
    return usc[int(steps[-1, 5])]


def ablation_plain(variant, steps, trans, tips) -> torch.Tensor:
    """Plain twin of one variant: the root slot's log-scale [P]."""
    n_rows, C, S = trans.shape[:3]
    P = tips.shape[2]
    l, r, root = (int(x) for x in steps[-1, [0, 1, 5]])
    if variant in PASSES:
        return precision_plain(PASSES[variant], steps, trans, tips)
    if variant in ("norescale", "empty"):
        # norescale: every scale is the sum of its children's, 0 at the tips
        return tips.new_zeros(P)
    if variant == "nostage":
        m = trans.sum(-1)  # each edge times a column of ones: [n_rows, C, S]
        mx = torch.clamp((m[l] * m[r]).max(), min=SCALE_TINY)
        return torch.log(mx).expand(P).contiguous()
    if variant == "nomatmul":
        trans = torch.eye(S, dtype=trans.dtype, device=trans.device).expand(
            n_rows, C, S, S)
    up, usc = upward_plain(steps, trans, tips)
    if variant == "noscale":  # the root step's log(max) alone
        y = ((trans[l] @ up[l].view(C, S, P)) * (trans[r] @ up[r].view(C, S, P)))
        return torch.log(torch.clamp(y.amax(dim=(0, 1)), min=SCALE_TINY))
    return usc[root]


def forward_ablation(variant, steps, n_slots, trans, tips, tile=None) -> torch.Tensor:
    """The root slot's log-scale [P] of one variant's forward walk.

    steps [N-1, 6] int32, trans [2N, C, S, S], tips [N, S, P].  CUDA
    tensors launch csrc/forward_ablate.cu (C=4, S=4 only; ValueError
    otherwise), CPU tensors run the plain twin.  `tile` is patterns a
    block (DEFAULT_TILE, as the other thread-a-pattern kernels)."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown ablation variant {variant!r}; one of {VARIANTS}")
    if not trans.is_cuda:
        return ablation_plain(variant, steps, trans, tips)
    C, S = trans.shape[1], trans.shape[2]
    if C != ABLATE_CATEGORIES:
        raise ValueError(f"the ablation kernel is instanced at C={ABLATE_CATEGORIES}, "
                         f"got C={C}")
    build.check_inputs(C, S, steps, trans, tips)
    P = tips.shape[2]
    out = torch.empty(P, dtype=torch.float32, device=trans.device)
    build.launch("forward_ablate", VARIANTS.index(variant), steps, steps.shape[0],
                 trans, tips, P, out, C, n_slots, tile or DEFAULT_TILE)
    forward_ablation.launches += 1
    return out


forward_ablation.launches = 0


def bench_inputs(device):
    """(steps, n_slots, trans, tips) at the bench shapes: the schedule of
    bench_data.npz's tree, trans [2N-1, 4, 4, 4] and tips [N, 4, P] uniform
    in [0, 1) from numpy seed 0, float32 on `device`."""
    from ...io.alignment import Alignment
    from ...trees.tree import PhyloTree

    z = np.load(BENCH_DATA, allow_pickle=True)
    aln = Alignment.from_sequences([str(n) for n in z["names"]],
                                   [str(s) for s in z["seqs"]], "DNA")
    tree = PhyloTree.from_newick(str(z["tree"]), aln.names)
    steps, n_slots = device_slot_schedule(tree, TreeArrays.from_tree(tree, device))
    rng = np.random.default_rng(0)
    N = aln.n_taxa
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    trans = f32(rng.random((2 * N - 1, ABLATE_CATEGORIES, 4, 4)))
    tips = f32(rng.random((N, 4, aln.n_patterns)))
    return torch.as_tensor(steps, device=device), n_slots, trans, tips


def time_variants(steps, n_slots, trans, tips, reps=10, tile=None, variants=VARIANTS):
    """{variant: ms a launch} on the card: one warm-up launch, then `reps`
    launches between two CUDA events."""
    times = {}
    for v in variants:
        forward_ablation(v, steps, n_slots, trans, tips, tile)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        for _ in range(reps):
            forward_ablation(v, steps, n_slots, trans, tips, tile)
        b.record()
        torch.cuda.synchronize()
        times[v] = a.elapsed_time(b) / reps
    return times


def main() -> int:
    from ... import resolve_device

    dev = resolve_device()
    steps, n_slots, trans, tips = bench_inputs(dev)
    n_steps = steps.shape[0]
    print(f"{torch.cuda.get_device_name(dev)}: {n_steps} steps, {tips.shape[2]} "
          f"patterns, {n_slots} slots, tile {DEFAULT_TILE}")
    for v, ms in time_variants(steps, n_slots, trans, tips).items():
        print(f"{v:10s} {ms:8.3f} ms  {ms * 1e3 / n_steps:7.3f} us/step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
