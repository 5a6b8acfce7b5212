"""Engine-selection banner and the pre-run memory model.

Names the path the run really takes -- the CUDA kernels on the card, or
the kernels' plain PyTorch twins on the CPU -- and checks the stored
partials the reverse sweeps need against the card's free memory before
anything is allocated.  A tree search, and the branch Newton's theta
path (the codon spaces, the mixtures past 8 categories, +ASC), also hold the
outside partials, and the theta path a chunk of branches' theta buffers;
a search sizes the NNI evaluator's edge chunks from what is left.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .derivatives import THETA_LIVE, newton_serves, theta_chunk_edges
from .kernels import build
from .kernels.build import check_shape
from .parsimony import lane_width


class EngineDecision(NamedTuple):
    device: torch.device
    kernels: bool  # CUDA kernels (else the plain twins on the CPU)
    store_bytes: int  # the stored partials + scales (up, and out for a search)
    mem_cap: int  # usable device memory
    nni_chunk: int  # edges whose NNI candidates are evaluated at once
    theta_bytes: int = 0  # the theta path's chunk of branch buffers (0: no theta path)


# live [C, S, P] tensors per NNI candidate in engine/nni.py evaluate_nnis
# (gathered messages, their transforms, the local partials and thetas)
NNI_LIVE_TENSORS = 24
# the evaluator's working memory on the CPU
HOST_NNI_BUDGET = 2 << 30


def parse_mem(s: str) -> int:
    """'4G' / '500M' / '64K' / bytes -> bytes (the JAX CLI's -mem syntax;
    no flag of this slice takes a memory size yet)."""
    s = s.strip().upper()
    mult = 1
    for suffix, m in (("G", 2**30), ("M", 2**20), ("K", 2**10)):
        if s.endswith(suffix):
            mult, s = m, s[:-1]
            break
    return int(float(s) * mult)


def memory_capacity(device: torch.device) -> int:
    """Usable bytes: 80% of the card's free memory (torch.cuda.mem_get_info),
    or 0 for the CPU (no check)."""
    if device.type == "cuda":
        free, _ = torch.cuda.mem_get_info(device)
        return int(free * 0.8)
    return 0


def decide_engine(n_taxa: int, ncat: int, num_states: int, n_patterns: int,
                  device: torch.device, dtype: torch.dtype,
                  search: bool = False, has_asc: bool = False) -> EngineDecision:
    """The path for this problem and its device-memory footprint
    (n_patterns: the device's, +ASC's unobservable patterns included).
    Raises when the card cannot hold the stored partials, or the shape has
    no kernel yet; never falls back to the CPU or to another engine."""
    n_rows = 2 * n_taxa
    item = torch.finfo(dtype).bits // 8
    CS = ncat * num_states
    kernels = device.type == "cuda"
    # up [2N, C*S, P] + usc [2N, P]; a search and the theta path also store
    # out + osc.  The kernels write a padded state space's rows at the
    # instance's width (build.instance_states) and the wrappers slice them,
    # so on the card a pass holds its rows at that width
    width = ncat * build.instance_states(num_states, ncat) if kernels else CS
    theta = not newton_serves(ncat, num_states, has_asc)
    store = n_rows * (width + 1) * n_patterns * item * (2 if search or theta else 1)
    # the theta path's buffers, a chunk of branches at a time (derivatives.py)
    theta_bytes = (theta_chunk_edges(n_rows, CS, n_patterns, item) * THETA_LIVE * CS
                   * n_patterns * item if theta else 0)
    cap = memory_capacity(device)
    if kernels:
        check_shape(ncat, num_states, n_slots=build.max_slots(n_taxa))
        if store + theta_bytes > cap:
            raise MemoryError(
                f"stored partials need ~{store / 2**30:.1f} GB and the theta path "
                f"~{theta_bytes / 2**30:.1f} GB, the card has {cap / 2**30:.1f} GB "
                "usable")
    per_edge = 3 * NNI_LIVE_TENSORS * CS * n_patterns * item  # 3 swaps (paired)
    budget = (cap - store - theta_bytes) // 2 if kernels else HOST_NNI_BUDGET
    chunk = max(1, min(n_taxa, budget // per_edge))
    return EngineDecision(device, kernels, store, cap, chunk, theta_bytes)


def engine_banner(dec: EngineDecision, n_taxa: int, ncat: int, num_states: int,
                  n_patterns: int, search: bool = False, has_asc: bool = False) -> str:
    """Human-readable engine/memory report (logged at startup)."""
    # codon, protein past 8, DNA past 32, +ASC
    theta = not newton_serves(ncat, num_states, has_asc)
    if dec.kernels:
        name = torch.cuda.get_device_name(dec.device)
        padded = build.instance_states(num_states, ncat)
        K, cb = build.wide_layout(ncat)
        wide = not build.packed(ncat, num_states)
        states = f"S={num_states}" + (f" (padded {padded})" if padded != num_states else "")
        if not wide:
            shape = "CS-packed" + (f", {states}" if num_states != 4 else "")
        else:
            shape = (f"wide [C,S,S] x [C,S,tile], {states}"
                     + (f", {cb} categories a block on {K}-block clusters" if cb > 1 else ""))
        last = "outside-partial store" if theta else "branch-Newton sweep"
        path = (f"CUDA kernels on {name} ({shape} forward, upward store, "
                f"gradient sweep, {last}; CS={ncat * num_states})")
        newton = ("theta path on the upward-store and outside-partial-store kernels"
                  if theta else "branch-Newton sweep kernel")
        if theta and has_asc:
            newton += " (+ASC's terms)"
        budget = f"budget {dec.mem_cap / 2**30:.1f} GB"
    else:
        path = "plain PyTorch twins of the kernels on the CPU (float64)"
        newton = ("theta path on the plain twins of the upward and outside-partial "
                  "stores" if theta else "plain twin of the branch-Newton sweep")
        if theta and has_asc:
            newton += " (+ASC's terms)"
        budget = "host memory"
    lines = [f"Likelihood engine: {path}", f"Branch optimization: {newton}"]
    if search:
        lines.append(
            "Tree search: batched NNI evaluator on the upward store and the "
            + (("wide " if wide else "") + "outside-partial store kernel"
               if dec.kernels else "plain twin of the outside-partial store")
            + f", {dec.nni_chunk} edges per evaluator chunk "
            f"(of {n_taxa - 3} internal edges)")
        bits = lane_width(num_states)
        lines.append("Parsimony start trees: " + (
            f"insertion-cost kernel on {bits}-bit parsimony lanes "
            f"({num_states} states a set)" if dec.kernels else
            f"plain twin of the insertion-cost kernel ({bits}-bit parsimony lanes "
            "on the card)"))
    what = "up and outside partials" if search or theta else "stored partials"
    lines.append(f"Memory: {what} ~{dec.store_bytes / 2**20:.0f} MB for "
                 f"{n_taxa} taxa x {n_patterns} patterns x {ncat}x{num_states} "
                 + (f"+ theta buffers ~{dec.theta_bytes / 2**20:.0f} MB a chunk of "
                    "branches " if theta else "") + f"({budget})")
    return "\n".join(lines)
