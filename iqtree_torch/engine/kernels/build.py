"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into its own shared library with a plain
C interface (no PyTorch headers, so a build takes seconds) and loaded with
ctypes.  The libraries go to build/<hash of the sources>/ beside this
module, so a checkout builds them at first use and an edited source is
rebuilt; all sources compile in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_ROOT = Path(__file__).with_name("build")
SOURCES = ("forward", "store", "tbar", "newton", "down_store", "pars_insert",
           "wide_forward", "wide_store", "wide_tbar", "wide_newton", "wide_down_store",
           "stream_forward", "forward_ablate")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

P_, I_ = ctypes.c_void_p, ctypes.c_int
# C entry points: (steps, n_steps, ...inputs..., C, n_slots, tile, stream)
SIGNATURES = {
    # the CS-packed kernels: (..., C, S, n_slots, lanes or tile, stream)
    "iqt_forward": [P_, I_, P_, P_, I_, P_, P_, P_, I_, I_, I_, I_, P_],
    "iqt_store": [P_, I_, P_, P_, I_, P_, P_, I_, I_, I_, I_, P_],
    "iqt_tbar": [P_, I_, P_, P_, P_, P_, P_, P_, I_, I_, P_, P_, I_, I_, I_, I_, P_],
    "iqt_newton": [P_, I_, P_, P_, P_, P_, P_, P_, I_, I_, P_, P_, I_, I_, I_, I_, P_],
    "iqt_down_store": [P_, I_, P_, P_, P_, P_, I_, P_, P_, I_, I_, I_, I_, P_],
    # (rows, n_post, n_pre, tips, n_taxa, leaf, weights, n_words, miss, cost,
    #  lane bits 4 / 32 / 64, stream)
    "iqt_pars_insert": [P_, I_, I_, P_, I_, I_, P_, I_, P_, P_, I_, P_],
    # wide kernels: (steps, n_steps, ...inputs..., C, S, n_slots, tile, stream)
    "iqt_wide_forward": [P_, I_, P_, P_, I_, P_, P_, P_, I_, I_, I_, I_, P_],
    "iqt_wide_store": [P_, I_, P_, P_, I_, P_, P_, I_, I_, I_, I_, P_],
    # (..., P, n_nodes, part, part_blocks, tbar, C, S, n_slots, tile, stream)
    "iqt_wide_tbar": [P_, I_, P_, P_, P_, P_, P_, P_, I_, I_, P_, I_, P_, I_, I_,
                      I_, I_, P_],
    "iqt_wide_newton": [P_, I_, P_, P_, P_, P_, P_, P_, I_, I_, P_, P_, I_, I_, I_,
                        I_, P_],
    # (steps, n_steps, trans, rootd, up, usc, P, out, osc, C, S, n_slots, tile,
    #  stream)
    "iqt_wide_down_store": [P_, I_, P_, P_, P_, P_, I_, P_, P_, I_, I_, I_, I_, P_],
    # (steps, gather, n_rows, K, roots, trans, tips, P, rootw, invar, out, C,
    #  pool, tile, stream)
    "iqt_stream_forward": [P_, P_, I_, I_, P_, P_, P_, I_, P_, P_, P_, I_, I_, I_, P_],
    # (variant, steps, n_steps, trans, tips, P, out, C, n_slots, tile, stream)
    "iqt_forward_ablate": [I_, P_, I_, P_, P_, I_, P_, I_, I_, I_, P_],
}
# Where the CS-packed kernels' C entries take S (after C): their earlier
# builds, before the S = 2 instances, take no S there (probe.py loads them).
STATE_ARGUMENT = {"iqt_forward": 9, "iqt_store": 8, "iqt_tbar": 13, "iqt_newton": 13,
                  "iqt_down_store": 10}

# State counts with a kernel instance: the CS-packed kernels (S=2, binary;
# S=4, DNA) and the wide kernels (S=20, protein; S=64, codons); every other
# state count runs zero-padded on one of them (instance_states).
PACKED_STATES = (2, 4)
WIDE_STATES = (20, 64)
# csrc/wide_newton.cu's cluster instance: protein up to MAX_CATEGORIES (codon
# branch lengths take the theta path, engine/derivatives.py)
WIDE_NEWTON_STATES = (20,)
# Categories of the CS-packed kernels (a lane a pattern and category) and of
# csrc/wide_newton.cu's cluster instance (a cluster block a category): 1..8.
# The four wide walks (csrc/wide_common.cuh) hold several categories a block
# past 8, at the S=20 and S=4 instances, as far as their shared memory
# allows (wide_layout, wide_walk_smem).
MAX_CATEGORIES = 8
# Wide instances that hold several categories a block (MULTI): protein and
# DNA (S=4, one row a thread).
MULTI_CATEGORY_STATES = (4, 20)
# csrc/wide_newton.cu's multi-category instance (a block all categories of a
# tile of patterns): DNA past MAX_CATEGORIES up to C*S = 128 rows a pattern,
# the bound of the JAX package's streamed sweep (newton_kernel_serves);
# further on the theta path serves.
MULTI_NEWTON_STATES = (4,)
MULTI_NEWTON_ROWS = 128
# The portable thread-block cluster size: a wide walk's cluster has at most
# 8 blocks (MAX_CLUSTER_BLOCKS of csrc/wide_common.cuh).
MAX_CLUSTER_BLOCKS = 8
# Dynamic shared memory a block may opt in to on an H100 (bytes).
MAX_BLOCK_SMEM = 232448
# An SM's shared memory and what the card keeps of it for each resident
# block (bytes; csrc/wide_common.cuh).
SM_SMEM = 233472
BLOCK_SMEM_RESERVED = 1024
# The largest block of the upward walk past 8 categories (W category warps;
# MULTI_THREADS_MAX of csrc/wide_common.cuh) and of csrc/wide_down_store.cu
# past 8 categories (W category teams; REVERSE_MULTI_THREADS_MAX).
MULTI_THREADS_MAX = 320
REVERSE_MULTI_THREADS_MAX = 320
# the slice that brings a state count's kernels past MAX_CATEGORIES
LATER_CATEGORY_SLICES = {
    4: "a later slice (a wide walk whose slot pool outgrows shared memory)",
    64: "the codon mixture slice (the S=64 instance keeps one category a block; "
        "morphology with 21 to 32 states past 8 categories comes with it)",
    20: "a later slice (a wide walk whose slot pool outgrows shared memory)",
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    return BUILD_ROOT / source_hash()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc (PATH or /usr/local/cuda/bin)")


def build_all() -> Path:
    """Compile every missing library, all sources at once.  Returns the
    build directory, which also holds each source's compiler log
    (registers, shared memory, spills)."""
    out = build_dir()
    missing = [n for n in SOURCES if not (out / f"lib{n}.so").exists()]
    if not missing:
        return out
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in missing:
        tmp = out / f"lib{n}.so.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        (out / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"--- {n}.cu ---\n{log}")
        else:
            os.replace(tmp, out / f"lib{n}.so")
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded library of one source, built on first use."""
    with _lock:
        if name not in _libs:
            path = build_all() / f"lib{name}.so"
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, f"iqt_{name}")
            fn.argtypes = SIGNATURES[f"iqt_{name}"]
            fn.restype = ctypes.c_int
            lib.iqt_error_string.argtypes = [ctypes.c_int]
            lib.iqt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def launch(name: str, *args) -> None:
    """Call one kernel's C entry on the current stream; raise on a CUDA
    error (a refused launch never runs, and synchronize would not say so)."""
    lib = library(name)
    conv = [ctypes.c_void_p(a.data_ptr()) if isinstance(a, torch.Tensor) else a
            for a in args]
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(lib, f"iqt_{name}")(*conv, ctypes.c_void_p(stream))
    if rc != 0:
        msg = lib.iqt_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: {msg} ({rc})")


def least_units(cb: int, x: int, per_warp: int, threads_max: int, smem_of) -> int:
    """Category warps (or teams) a block of a wide walk past 8 categories
    (least_units of csrc/wide_common.cuh): of the W = ceil(cb / U) whose
    block of W x per_warp threads fits threads_max and whose smem_of(W)
    bytes fit MAX_BLOCK_SMEM, the one of least (U + x) / b for b = min(2,
    blocks an SM's shared memory holds), then the most blocks an SM, then
    the most W; 1 if none fits.  x = 2 for the upward walk (U units a step
    and about two of exchange), 1 for the reverse walk (2 U and two)."""
    best, bu, bb = 1, cb, 0
    for units in range(1, cb + 1):
        w = -(-cb // units)
        smem = smem_of(w)
        if w * per_warp > threads_max or smem > MAX_BLOCK_SMEM:
            continue
        b = 2 if SM_SMEM // (smem + BLOCK_SMEM_RESERVED) > 1 else 1
        if (units + x) * bb < (bu + x) * b or ((units + x) * bb == (bu + x) * b and b > bb):
            best, bu, bb = w, units, b
    return best


def walk_launch(name: str, C: int, S: int, n_slots: int, tile: int) -> Dict[str, int]:
    """The launch csrc/<name>.cu (one of the four wide walks) makes at these
    sizes, as its C entry chooses it: category warps or teams `warps`,
    `threads` and shared memory bytes `smem` a block, and the most of its
    clusters the card holds at once (`clusters`,
    cudaOccupancyMaxActiveClusters)."""
    lib = library(name)
    fn = getattr(lib, f"iqt_{name}_layout")
    fn.argtypes = [I_, I_, I_, I_, P_]
    fn.restype = ctypes.c_int
    info = (ctypes.c_int * 4)()
    rc = fn(C, S, n_slots, tile, info)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} layout failed: "
                           f"{lib.iqt_error_string(rc).decode()} ({rc})")
    return dict(zip(("warps", "threads", "smem", "clusters"), info))


def packed(C: int, S: int) -> bool:
    """Whether the CS-packed kernels serve C categories x S states (S <= 4,
    C <= 8: the S=2 instance, or S=4 with S=3 padded); every other shape
    runs the wide kernels."""
    return instance_states(S, C) in PACKED_STATES and C <= MAX_CATEGORIES


def wide_newton_multi(C: int, S: int) -> bool:
    """Whether csrc/wide_newton.cu's multi-category instance serves C
    categories x S states (DNA past the CS-packed kernels, C*S <=
    MULTI_NEWTON_ROWS)."""
    return (S in MULTI_NEWTON_STATES and not packed(C, S)
            and C * S <= MULTI_NEWTON_ROWS)


def instance_states(S: int, C: int = 1) -> int:
    """The state count of the kernel instance that serves S states at C
    categories, the padding rule of every wrapper: binary (S=2) on the S=2
    CS-packed instance up to MAX_CATEGORIES, past them on the S=4 walks;
    S=3 on the S=4 instances; 5 to 20 states (morphology) on the S=20 wide
    kernels; 21 to 64 (morphology to 32 states, the codon spaces 60 to 63)
    on the S=64 instance.  The padded rows and columns are zero."""
    if S == 2 and C <= MAX_CATEGORIES:
        return 2
    for SK in (4, 20, 64):
        if S <= SK:
            return SK
    return S


def wide_layout(C: int):
    """(K, CB): a wide walk's C categories on K blocks a cluster, CB a block
    -- one a block up to 8, else ceil(C / 8) a block on ceil(C / CB)
    blocks, the last block's missing categories padding (wide_k / wide_cb
    of csrc/wide_common.cuh)."""
    cb = -(-C // MAX_CLUSTER_BLOCKS)
    return -(-C // cb), cb


def max_slots(n_taxa: int) -> int:
    """The most slots a slot schedule of n_taxa takes: the Strahler number
    of a binary tree, at most ceil(log2 N) + 1 (schedule.py)."""
    return max(1, (n_taxa - 1).bit_length()) + 1


def wide_walk_smem(C: int, S: int, n_slots: int) -> int:
    """Bytes of shared memory a block of the most demanding of the four wide
    walks takes at their default tiles (pruning.wide_forward_smem,
    cs_kernels.wide_down_store_smem, cs_kernels.wide_tbar_smem)."""
    from . import cs_kernels, pruning

    return max(pruning.wide_forward_smem(S, C, pruning.WIDE_STORE_TILE, n_slots),
               cs_kernels.wide_down_store_smem(S, C, cs_kernels.WIDE_DOWN_STORE_TILE,
                                               n_slots),
               cs_kernels.wide_tbar_smem(S, C, cs_kernels.WIDE_TBAR_TILE, n_slots))


def check_shape(C: int, S: int, states=PACKED_STATES + WIDE_STATES,
                n_slots: int = None, multi: bool = True, walk: bool = False) -> None:
    """Raise NotImplementedError unless a kernel of `states` (default: any
    kernel of the port) serves C categories x S states (S padded as
    instance_states says).  Past MAX_CATEGORIES only the wide walks serve
    (multi: the caller is one, or any kernel; csrc/wide_newton.cu's cluster
    instance is not),
    at the S=20 and S=4 instances, when their shared memory at `n_slots`
    slots fits a block (MAX_BLOCK_SMEM; n_slots None: no slot count to check
    yet).  walk: the caller is one of the four wide walks
    (csrc/wide_forward.cu, wide_store.cu, wide_tbar.cu, wide_down_store.cu),
    which have an instance at every S of the port (IQT_DISPATCH_WIDE_S of
    wide_common.cuh) but serve no shape that `packed` gives the CS-packed
    kernels."""
    S = instance_states(S, C)
    if walk:
        states, multi = PACKED_STATES + WIDE_STATES, True
    if S not in PACKED_STATES + WIDE_STATES:
        raise NotImplementedError(
            f"no CUDA kernel for C={C} categories x S={S} states: the port's "
            f"kernels serve 2 to 64 states (instances at S = 2, 4, 20 and 64)")
    if S not in states:
        raise NotImplementedError(
            f"this kernel has instances for S in {states}, got S={S}")
    if walk and packed(C, S):
        raise NotImplementedError(
            f"the wide walks' S={S} instance serves past {MAX_CATEGORIES} "
            f"categories only: the CS-packed kernels serve C={C}")
    if 1 <= C <= MAX_CATEGORIES:
        return
    if S not in MULTI_CATEGORY_STATES:
        raise NotImplementedError(
            f"no CUDA kernel for C={C} categories x S={S} states: the port's S={S} "
            f"kernels serve at most {MAX_CATEGORIES} categories; this shape is not "
            f"ported yet ({LATER_CATEGORY_SLICES[S]})")
    if not multi:
        raise NotImplementedError(
            f"no CUDA kernel for C={C} categories x S={S} states: this kernel "
            f"serves at most {MAX_CATEGORIES} categories (past them the wide walks "
            f"and the theta path serve)")
    need = 0 if n_slots is None else wide_walk_smem(C, S, n_slots)
    if need > MAX_BLOCK_SMEM:
        K, cb = wide_layout(C)
        raise NotImplementedError(
            f"no CUDA kernel for C={C} categories x S={S} states at {n_slots} slots: "
            f"the wide walks' blocks ({cb} categories each, {K} a cluster) need "
            f"{need} bytes of shared memory, over the {MAX_BLOCK_SMEM} a block may "
            f"have; this shape is not ported yet ({LATER_CATEGORY_SLICES[S]})")


def check_inputs(C: int, S: int, steps: torch.Tensor, *tensors: torch.Tensor,
                 states=PACKED_STATES, n_slots: int = None, multi: bool = False,
                 walk: bool = False) -> None:
    """The kernels take contiguous CUDA tensors: an int32 [R, 6] schedule,
    float32 data, S in `states` (the kernel's instances) and the categories
    check_shape allows (walk: a wide walk, at n_slots slots)."""
    check_shape(C, S, states, n_slots, multi, walk)
    if steps.dtype != torch.int32 or steps.dim() != 2 or steps.shape[1] != 6:
        raise ValueError("the slot schedule must be an int32 [n_steps, 6] tensor")
    for t in (steps, *tensors):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous CUDA tensors")
        if t is not steps and t.dtype != torch.float32:
            raise TypeError(f"kernel data is float32, got {t.dtype}")
