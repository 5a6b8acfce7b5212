"""Command-line configuration of the port: the fixed-topology fit (-te)
and the default tree search with its ultrafast bootstrap (-bb), for DNA,
protein, codons (-st CODON[n]), binary and morphological data (-st BIN,
-st MORPH) and the mixture models (-m C10..C60,
EX2, LG4M, LG4X, MIX{...}, +FMIX{...}; -mwopt frees pinned class weights);
-i, -a and -gmedian pin or change the rate model through the model string."""

from __future__ import annotations

import argparse
import re
from dataclasses import dataclass
from typing import Optional

PORTED_FLAGS = ("-s", "-st", "-te", "-t", "-m", "-pre", "-seed", "-blfix", "-redo",
                "-device", "-n", "-nstop", "-ninit", "-ntop", "-pers", "-maxtime",
                "-starttree", "-keep-ident", "-keep_ident", "-bb", "-beps", "-bcor",
                "-nstep", "-wbt", "-wbtl", "-mwopt", "-i", "-a", "-gmedian")


@dataclass
class RunConfig:
    aln_file: str
    fixed_tree: Optional[str]  # -te: fit on this topology, no search
    start_tree: Optional[str]  # -t: the search's start tree
    model: Optional[str]
    prefix: Optional[str]
    seed: int
    fix_branch_lengths: bool
    redo: bool
    device: Optional[str]
    n_iterations: Optional[int] = None
    unsuccess_iteration: int = 100
    n_init_trees: int = 20
    n_top_init: int = 5
    pers: float = 0.5
    max_seconds: Optional[float] = None
    start_tree_mode: str = "BIONJ"
    keep_identical: bool = False
    seq_type: Optional[str] = None  # -st DNA|AA|BIN|MORPH|CODON; None = detected
    genetic_code: int = 1  # -st CODONn: NCBI genetic code n
    ufboot: int = 0  # -bb: ultrafast bootstrap samples
    ufboot_epsilon: float = 0.5  # -beps
    min_correlation: float = 0.99  # -bcor
    step_iterations: int = 100  # -nstep
    write_boot_trees: bool = False  # -wbt (or -wbtl)
    write_boot_tree_blens: bool = False  # -wbtl
    optimize_mixmodel_weight: bool = False  # -mwopt: free a mixture's pinned weights

    @property
    def out_prefix(self) -> str:
        return self.prefix or self.aln_file


class _Parser(argparse.ArgumentParser):
    def error(self, message):
        self.print_usage()
        raise SystemExit(f"{self.prog}: error: {message}")


def parse_args(argv) -> RunConfig:
    for a in argv:
        if a.startswith("-") and a not in PORTED_FLAGS and not _is_number(a):
            raise SystemExit(
                f"iqtree-torch: option {a} is not ported yet; this version runs "
                f"the fixed-topology fit and the default search with its bootstrap, "
                f"for DNA, protein, codon, binary, morphology and mixture models "
                f"({' '.join(PORTED_FLAGS)})")
    p = _Parser(prog="iqtree-torch",
                description="IQ-TREE tree search and fixed-topology fit on "
                            "PyTorch and hand-written CUDA kernels")
    p.add_argument("-s", dest="aln_file", required=True, help="alignment file")
    p.add_argument("-st", dest="seq_type", default=None, type=str.upper,
                   help="sequence type DNA, AA, BIN, MORPH or CODON[n] (codons "
                        "under NCBI genetic code n, default 1; default: DNA, AA, "
                        "BIN or MORPH detected from the characters)")
    p.add_argument("-te", dest="fixed_tree", default=None,
                   help="user tree file: fit on this fixed topology, no search")
    p.add_argument("-t", dest="start_tree", default=None,
                   help="start tree file of the search")
    p.add_argument("-m", dest="model", default=None,
                   help="model string, e.g. GTR+G, HKY+I+G, LG+G, C20, EX2+G, LG4M, "
                        "MIX{WAG,LG}+G (default HKY+G for DNA, LG+G for protein)")
    p.add_argument("-pre", dest="prefix", default=None, help="output prefix")
    p.add_argument("-seed", dest="seed", type=int, default=1)
    p.add_argument("-blfix", dest="fix_branch_lengths", action="store_true",
                   help="fix branch lengths of the -te tree")
    p.add_argument("-redo", dest="redo", action="store_true",
                   help="overwrite the outputs of an earlier run")
    p.add_argument("-device", dest="device", default=None,
                   help="cuda (default) or cpu")
    p.add_argument("-n", dest="n_iterations", type=int, default=None,
                   help="fixed number of search iterations")
    p.add_argument("-nstop", dest="unsuccess", type=int, default=100,
                   help="stop after this many unsuccessful iterations")
    p.add_argument("-ninit", dest="ninit", type=int, default=20,
                   help="initial candidate trees")
    p.add_argument("-ntop", dest="ntop", type=int, default=5,
                   help="initial candidates that are NNI-climbed")
    p.add_argument("-pers", dest="pers", type=float, default=0.5,
                   help="perturbation strength")
    p.add_argument("-maxtime", dest="maxtime", type=float, default=None,
                   help="max wall time in minutes")
    p.add_argument("-starttree", dest="starttree", default="BIONJ",
                   choices=["BIONJ", "PARS"],
                   help="start tree: BIONJ (ML distances) or PARS "
                        "(randomized stepwise-addition parsimony)")
    p.add_argument("-keep-ident", "-keep_ident", dest="keep_ident",
                   action="store_true",
                   help="keep identical sequences during the search")
    p.add_argument("-bb", dest="ufboot", type=int, default=0,
                   help="ultrafast bootstrap replicates (e.g. 1000)")
    p.add_argument("-beps", dest="beps", type=float, default=0.5,
                   help="UFBoot RELL tie epsilon")
    p.add_argument("-bcor", dest="bcor", type=float, default=0.99,
                   help="min UFBoot split correlation for convergence")
    p.add_argument("-nstep", dest="nstep", type=int, default=100,
                   help="UFBoot correlation check interval (iterations)")
    p.add_argument("-wbt", dest="wbt", action="store_true",
                   help="write the UFBoot trees to PREFIX.ufboot")
    p.add_argument("-wbtl", dest="wbtl", action="store_true",
                   help="write the UFBoot trees with branch lengths (implies -wbt)")
    p.add_argument("-mwopt", dest="mwopt", action="store_true",
                   help="optimize mixture class weights even where the model "
                        "pins them (C10..C60)")
    p.add_argument("-i", dest="p_invar_fix", type=float, default=None,
                   help="fix the proportion of invariable sites (+I)")
    p.add_argument("-a", dest="alpha_fix", type=float, default=None,
                   help="fix the Gamma shape parameter (+G)")
    p.add_argument("-gmedian", dest="gmedian", action="store_true",
                   help="median (not mean) discrete-Gamma category rates")
    a = p.parse_args(argv)
    if a.fixed_tree and a.start_tree:
        p.error("-te and -t exclude each other")
    if a.beps <= 0:
        p.error("-beps epsilon must be positive")
    genetic_code = 1
    if a.seq_type and a.seq_type.startswith("CODON"):
        from .models.codon import GENETIC_CODES

        code = a.seq_type[5:]
        if code and (not code.isdigit() or int(code) not in GENETIC_CODES):
            p.error(f"-st {a.seq_type}: unknown genetic code {code!r} (known: "
                    f"{', '.join(map(str, GENETIC_CODES))})")
        genetic_code = int(code) if code else 1
        a.seq_type = "CODON"
    if a.seq_type not in (None, "DNA", "AA", "BIN", "MORPH", "CODON"):
        raise SystemExit(
            f"iqtree-torch: -st {a.seq_type}: unsupported sequence type (DNA, AA, "
            "BIN, MORPH or CODON[n])")
    return RunConfig(
        a.aln_file, a.fixed_tree, a.start_tree, rate_flags_model(a), a.prefix, a.seed,
        a.fix_branch_lengths, a.redo, a.device, n_iterations=a.n_iterations,
        unsuccess_iteration=a.unsuccess, n_init_trees=a.ninit, n_top_init=a.ntop,
        pers=a.pers, max_seconds=a.maxtime * 60 if a.maxtime else None,
        start_tree_mode=a.starttree, keep_identical=a.keep_ident,
        seq_type=a.seq_type, genetic_code=genetic_code, ufboot=a.ufboot,
        ufboot_epsilon=a.beps, min_correlation=a.bcor, step_iterations=a.nstep,
        write_boot_trees=a.wbt or a.wbtl, write_boot_tree_blens=a.wbtl,
        optimize_mixmodel_weight=a.mwopt)


def rate_flags_model(a) -> Optional[str]:
    """The model string with -a, -i and -gmedian written into it: the
    first +G takes {alpha}, the first +I {p_invar}, and -gmedian turns the
    first +G into +GM (as the JAX package's CLI rewrites it)."""
    model = a.model
    if model:
        if a.alpha_fix is not None:
            model = re.sub(r"\+G(\d*)(?!\{|\d)",
                           lambda m: f"+G{m.group(1)}{{{a.alpha_fix}}}", model, count=1)
        if a.p_invar_fix is not None:
            model = re.sub(r"\+I(?!\{)", f"+I{{{a.p_invar_fix}}}", model, count=1)
        if a.gmedian:
            model = re.sub(r"\+G(\d*)(?!M)", r"+GM\1", model, count=1)
    return model


def _is_number(s: str) -> bool:
    try:
        float(s)
        return True
    except ValueError:
        return False
