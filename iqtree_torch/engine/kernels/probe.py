"""Source variants of the lane-layout kernels: what their time is made of.

    python -m iqtree_torch.engine.kernels.probe [-C N[,N...]] [--base DIR]
                                                [newton|forward|store ...]

On a CUDA card, at the bench shapes (bench_data.npz: its tree, 1000 taxa,
9 962 patterns, GTR+G4 at the model's start values; GTR+GN with -C N, each
of a list in turn), builds each variant of a kernel -- a text edit of
csrc/<kernel>.cu or of csrc/cs_common.cuh that takes one cost out -- loads
it in place of the kernel and prints ms a call of the kernel's wrapper
(CUDA events around 10 calls after a warm-up) at 32, 64 and 128 lanes a
block.  With no kernel named, all three.

--base DIR adds the variant `base`: <kernel>.cu and cs_common.cuh taken
whole from DIR, e.g. an earlier commit's csrc/ (`git archive COMMIT
iqtree_torch/engine/kernels/csrc`), with the same C entry point.  It is
timed first and last, `as built` second and second to last, so that the
two designs are compared in one process on one card.  The earlier
thread-a-pattern forward.cu and store.cu read the block argument as
patterns a block.

newton (newton_sweep; the per-warp sums' zeroing and reduction inside):
  as built         csrc/newton.cu
  partials cached  every step fetches node 0's partials and scales (cache
                   hits): the cost of reading the stored partials
  no shuffles      no cross-category max or sums (wrong values)
  stages 3, 4      the cp.async ring three and four steps deep

forward (fused_site_lnl) and store (fused_upward_store_cs), the upward
walk of cs_common.cuh:
  as built         csrc/forward.cu, csrc/store.cu
  tips cached      every tip child fetches tip 0's words (cache hits): the
                   cost of reading the tips
  no shuffles      no cross-category max (wrong values)
  stages 3         the cp.async ring three steps deep
  reciprocal       a reciprocal and a multiply in place of the division
  no stores        (store) nothing written to up and usc
  one row          (store) only the first of a lane's S rows written

Only the variants' times mean something; their results are wrong by
design.  The variants build beside the kernels, under build/<hash>/probe.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from . import build
from . import cs_kernels as csk
from . import pruning
from .ablate import BENCH_DATA
from .pruning import device_slot_schedule

HEADER = "cs_common.cuh"
_UPWARD = {
    "as built": (),
    "tips cached": (("tips + ((size_t)sj.l * S + s) * P + p",
                     "tips + ((size_t)0 * S + s) * P + p"),
                    ("tips + ((size_t)sj.r * S + s) * P + p",
                     "tips + ((size_t)0 * S + s) * P + p")),
    "no shuffles": (("for (int off = 1; off < CL; off <<= 1) v = fmaxf",
                     "for (int off = CL; off < CL; off <<= 1) v = fmaxf"),),
    "stages 3": (("constexpr int UP_STAGES = 2;", "constexpr int UP_STAGES = 3;"),),
    "reciprocal": (("for (int s = 0; s < S; ++s) y[s] = y[s] / mx;",
                    "for (int s = 0; s < S; ++s) y[s] = y[s] * __frcp_rn(mx);"),),
}
# kernel: {variant: ((old, new) text edits of csrc/<kernel>.cu and cs_common.cuh)}
KERNELS: Dict[str, Dict[str, Tuple[Tuple[str, str], ...]]] = {
    "newton": {
        "as built": (),
        "partials cached": (("((size_t)sj.l * C + c)", "((size_t)0 * C + c)"),
                            ("((size_t)sj.r * C + c)", "((size_t)0 * C + c)"),
                            ("usc + (size_t)sj.l * P", "usc"),
                            ("usc + (size_t)sj.r * P", "usc")),
        "no shuffles": (("for (int off = 1; off < CL; off <<= 1)",
                         "for (int off = CL; off < CL; off <<= 1)"),),
        "stages 3": (("constexpr int STAGES = 2;", "constexpr int STAGES = 3;"),),
        "stages 4": (("constexpr int STAGES = 2;", "constexpr int STAGES = 4;"),),
    },
    "forward": _UPWARD,
    "store": {**_UPWARD, "no stores": (("if (!writes) return;", "return;"),),
              "one row": (("for (int s = 0; s < S; ++s) dst[(size_t)s * P] = ys[s];",
                           "for (int s = 0; s < 1; ++s) dst[(size_t)s * P] = ys[s];"),)},
}
LANES = (32, 64, 128)


def variant_sources(kernel: str, name: str, base=None) -> Dict[str, str]:
    """{file: text} of csrc/<kernel>.cu and cs_common.cuh with the edits
    of variant `name` applied; each edit must change one of them.  The
    variant `base` is both files as they are in the directory `base`."""
    if name == "base":
        return {f: (Path(base) / f).read_text() for f in (f"{kernel}.cu", HEADER)}
    files = {f: (build.CSRC / f).read_text() for f in (f"{kernel}.cu", HEADER)}
    for old, new in KERNELS[kernel][name]:
        hits = [f for f, text in files.items() if old in text]
        if not hits:
            raise ValueError(f"variant {name!r} of {kernel}: {old!r} is in neither file")
        for f in hits:
            files[f] = files[f].replace(old, new)
    return files


def variant_libraries(kernel: str, base=None) -> Dict[str, ctypes.CDLL]:
    """Every variant of `kernel` built (all at once) and loaded like the
    kernel, with `base` (module docstring) if a directory is given.  A
    variant's edited header sits beside its source, so its #include finds
    that copy."""
    root = build.build_all() / "probe"
    procs = {}
    for name in [*KERNELS[kernel], *(["base"] if base else [])]:
        out = root / f"{kernel}_{name.replace(' ', '_')}"
        out.mkdir(parents=True, exist_ok=True)
        for f, text in variant_sources(kernel, name, base).items():
            (out / f).write_text(text)
        lib = out / f"lib{kernel}.so"
        procs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(out / f"{kernel}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r} of {kernel} failed to build:\n{log}")
        dll = ctypes.CDLL(str(lib))
        fn = getattr(dll, f"iqt_{kernel}")
        fn.argtypes = build.SIGNATURES[f"iqt_{kernel}"]
        fn.restype = ctypes.c_int
        dll.iqt_error_string.argtypes = [ctypes.c_int]
        dll.iqt_error_string.restype = ctypes.c_char_p
        libs[name] = dll
    return libs


def bench_calls(device, categories=4):
    """{kernel: a call of its wrapper} at the bench shapes, GTR+G with
    `categories` rate categories."""
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
    model = ModelArrays.from_model(*parse_model_string(f"GTR+G{categories}", aln),
                                   device)
    site = SiteData.from_alignment(aln, device, torch.float32)
    trans = branch_transition_mats(model, ta.blen).float().contiguous()
    tips = tip_partials(site).contiguous()
    props, freq = model.props.float(), model.state_freq.float()
    invar = ptn_invar(model, site).float().contiguous()
    up, usc = csk.fused_upward_store_cs(steps, n_slots, trans, tips)
    csk.fill_tip_rows_cs(up, usc, tips, model.ncat)
    mats = csk.stacked_deriv_mats(model, ta.blen).float().contiguous()
    wp = site.pattern_freq.contiguous()
    return {
        "newton": lambda: csk.newton_sweep(steps, n_slots, mats, props, freq, wp, invar,
                                           up, usc),
        "forward": lambda: pruning.fused_site_lnl(steps, n_slots, trans, tips, props,
                                                  freq, invar),
        "store": lambda: csk.fused_upward_store_cs(steps, n_slots, trans, tips),
    }


def call_ms(fn, reps=10) -> float:
    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def set_lanes(kernel: str, lanes: int) -> None:
    if kernel == "newton":
        csk.NEWTON_THREADS = lanes
    else:
        pruning.UPWARD_LANES = lanes


def main(argv=None) -> int:
    from ... import resolve_device

    args = list(argv if argv is not None else sys.argv[1:])
    options = {"-C": "4", "--base": None}
    for flag in options:
        if flag in args:
            i = args.index(flag)
            options[flag] = args[i + 1]
            del args[i:i + 2]
    base = options["--base"]
    kernels = args or list(KERNELS)
    dev = resolve_device()
    libs = {kernel: variant_libraries(kernel, base) for kernel in kernels}
    lanes0 = csk.NEWTON_THREADS, pruning.UPWARD_LANES
    for categories in (int(c) for c in options["-C"].split(",")):
        calls = bench_calls(dev, categories)
        for kernel in kernels:
            order = list(libs[kernel])
            if base:
                order = ["base", "as built", *order[1:-1], "as built", "base"]
            print(f"{torch.cuda.get_device_name(dev)}: {kernel} at C={categories}, ms a "
                  f"call at " + ", ".join(f"{t} lanes" for t in LANES) + " a block",
                  flush=True)
            built = build.library(kernel)
            try:
                for name in order:
                    build._libs[kernel] = libs[kernel][name]
                    times = []
                    for t in LANES:
                        set_lanes(kernel, t)
                        times.append(call_ms(calls[kernel]))
                    print(f"{name:16s}" + "".join(f"{ms:9.3f}" for ms in times), flush=True)
            finally:
                build._libs[kernel] = built
                csk.NEWTON_THREADS, pruning.UPWARD_LANES = lanes0
        del calls
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
