"""Variants of the branch-Newton kernel: what its time is made of.

    python -m iqtree_torch.engine.kernels.newton_probe

On a CUDA card, at the bench shapes (bench_data.npz: its tree, 1000 taxa,
9 962 patterns, GTR+G4 at the model's start values), builds each variant
of csrc/newton.cu -- a text edit that takes one cost out -- loads it in
place of the kernel and prints ms a call of `newton_sweep` (CUDA events
around 10 calls after a warm-up; the per-warp sums' zeroing and reduction
inside) at 32, 64 and 128 lanes a block:

  as built         csrc/newton.cu
  partials cached  every step fetches node 0's partials and scales (cache
                   hits): the cost of reading the stored partials
  no shuffles      no cross-category max or sums (wrong values)
  stages 3, 4      the cp.async ring three and four steps deep

Only the variants' times mean something; their derivatives are wrong by
design.  The variants build beside the kernels, under build/<hash>/probe.
"""

from __future__ import annotations

import ctypes
import subprocess

import numpy as np
import torch

from . import build
from . import cs_kernels as csk
from .ablate import BENCH_DATA
from .pruning import device_slot_schedule

VARIANTS = {
    "as built": (),
    "partials cached": (("((size_t)sj.l * C + c)", "((size_t)0 * C + c)"),
                        ("((size_t)sj.r * C + c)", "((size_t)0 * C + c)"),
                        ("usc + (size_t)sj.l * P", "usc"),
                        ("usc + (size_t)sj.r * P", "usc")),
    "no shuffles": (("for (int off = 1; off < CL; off <<= 1)",
                     "for (int off = CL; off < CL; off <<= 1)"),),
    "stages 3": (("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),),
    "stages 4": (("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),),
}
LANES = (32, 64, 128)


def variant_source(name: str) -> str:
    """newton.cu with the edits of variant `name` applied."""
    src = (build.CSRC / "newton.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise ValueError(f"variant {name!r}: {old!r} is not in newton.cu")
        src = src.replace(old, new)
    return src


def variant_library(name: str) -> ctypes.CDLL:
    """Variant `name` built and loaded like the kernel."""
    src = variant_source(name)
    out = build.build_all() / "probe"
    out.mkdir(exist_ok=True)
    tag = name.replace(" ", "_")
    (out / f"{tag}.cu").write_text(src)
    lib = out / f"lib{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
                    str(lib), str(out / f"{tag}.cu")], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    dll.iqt_newton.argtypes = build.SIGNATURES["iqt_newton"]
    dll.iqt_newton.restype = ctypes.c_int
    dll.iqt_error_string.argtypes = [ctypes.c_int]
    dll.iqt_error_string.restype = ctypes.c_char_p
    return dll


def bench_args(device):
    """newton_sweep's arguments at the bench shapes."""
    from ..likelihood import (ModelArrays, SiteData, TreeArrays, branch_transition_mats,
                              ptn_invar, tip_partials)
    from ...io.alignment import Alignment
    from ...models.factory import parse_model_string
    from ...trees.tree import PhyloTree

    z = np.load(BENCH_DATA, allow_pickle=True)
    aln = Alignment.from_sequences([str(n) for n in z["names"]],
                                   [str(s) for s in z["seqs"]], "DNA")
    tree = PhyloTree.from_newick(str(z["tree"]), aln.names)
    ta = TreeArrays.from_tree(tree, device)
    steps, n_slots = device_slot_schedule(tree, ta)
    steps = torch.as_tensor(steps, device=device)
    model = ModelArrays.from_model(*parse_model_string("GTR+G", aln), device)
    site = SiteData.from_alignment(aln, device, torch.float32)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    up, usc = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    csk.fill_tip_rows_cs(up, usc, tips, model.ncat)
    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    return (steps, n_slots, mats, model.props.float(), model.state_freq.float(),
            site.pattern_freq.contiguous(), ptn_invar(model, site).float().contiguous(),
            up, usc)


def call_ms(args, reps=10) -> float:
    csk.newton_sweep(*args)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        csk.newton_sweep(*args)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main() -> int:
    from ... import resolve_device

    dev = resolve_device()
    args = bench_args(dev)
    print(f"{torch.cuda.get_device_name(dev)}: newton_sweep, ms a call at "
          + ", ".join(f"{t} lanes" for t in LANES) + " a block")
    kernel, lanes = build.library("newton"), csk.NEWTON_THREADS
    try:
        for name in VARIANTS:
            build._libs["newton"] = variant_library(name)
            times = []
            for t in LANES:
                csk.NEWTON_THREADS = t
                times.append(call_ms(args))
            print(f"{name:16s}" + "".join(f"{ms:9.3f}" for ms in times))
    finally:
        build._libs["newton"], csk.NEWTON_THREADS = kernel, lanes
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
