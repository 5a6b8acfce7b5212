"""The port's command line, and the rule that it imports no JAX.

The CLI fit runs in a subprocess on the CPU (`-device cpu`, float64).  The
tree and model it writes are evaluated by the JAX package's likelihood in
float64, which must give the logged lnL; that lnL is also held against
the JAX CLI's optimum on the same input,

    python -m iqtree_tpu -s tests/data/example.phy -te tests/data/golden_tree_44.nwk \\
        -m GTR+G --f64
    -> Optimal log-likelihood: -13419.3853

a recorded number kept as a sanity bound (the JAX fit to convergence
takes 50 s on a CPU; the fit steps are compared live in
test_torch_optimize.py).
"""

import ast
import os
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest
import torch

from iqtree_tpu.engine.likelihood import ModelArrays as JModel
from iqtree_tpu.engine.likelihood import SiteData as JSite
from iqtree_tpu.engine.likelihood import TreeArrays as JTree
from iqtree_tpu.engine.likelihood import compute_loglik as jax_compute_loglik
from iqtree_tpu.io.alignment import read_alignment as jax_read_alignment
from iqtree_tpu.models.factory import parse_model_string as jax_parse_model
from iqtree_tpu.trees.tree import PhyloTree as JPhyloTree

from iqtree_torch.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
JAX_CLI_F64_LNL = -13419.3853


def run_cli(*args, cwd):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "iqtree_torch", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=600)


def jax_lnl(aln_path, nwk, model):
    """lnL of a written tree and model string by the JAX package, float64."""
    aln = jax_read_alignment(aln_path)
    subst, rate = jax_parse_model(model, aln)
    tree = JTree.from_tree(JPhyloTree.from_newick(nwk, aln.names), jnp.float64)
    lnl, _ = jax.jit(jax_compute_loglik)(
        tree, JModel.from_model(subst, rate, jnp.float64),
        JSite.from_alignment(aln, jnp.float64))
    return float(lnl)


def test_cli_fit_matches_jax_cli(tmp_path):
    prefix = str(tmp_path / "ex")
    aln_path = os.path.join(DATA, "example.phy")
    r = run_cli("-s", aln_path, "-te", os.path.join(DATA, "golden_tree_44.nwk"),
                "-m", "GTR+G", "-device", "cpu", "-pre", prefix, cwd=tmp_path)
    assert r.returncode == 0, r.stderr
    with open(prefix + ".log") as f:
        log = f.read()
    lnl = float(re.search(r"Optimal log-likelihood: (\S+)", log).group(1))
    model = re.search(r"Best-fit model parameters: (\S+)", log).group(1)
    with open(prefix + ".treefile") as f:
        nwk = f.read().strip()
    assert nwk.endswith(";") and nwk.count(",") == 43  # 44 taxa, unrooted
    assert "plain PyTorch twins" in log  # the banner names the CPU path
    # the written tree and model, evaluated by the JAX package: the logged
    # lnL to the rounding of the written numbers
    assert abs(jax_lnl(aln_path, nwk, model) - lnl) < 1e-3, (lnl, model)
    assert abs(lnl - JAX_CLI_F64_LNL) < 0.01, lnl


def test_cli_refuses_unported_flags():
    with pytest.raises(SystemExit, match="-alrt is not ported yet"):
        cli_main(["-s", os.path.join(DATA, "example.phy"), "-alrt", "1000"])


def test_cli_fit_with_bb_runs_the_fit_without_supports(tmp_path):
    """-te with -bb runs the fixed-topology fit and writes no supports, as
    the JAX CLI does (its fixed-topology path returns no bootstrap)."""
    common = ["-s", os.path.join(DATA, "example.phy"), "-te",
              os.path.join(DATA, "golden_tree_44.nwk"), "-m", "JC", "-device", "cpu"]
    out = {}
    for tag, extra in (("bb", ["-bb", "1000", "-wbt"]), ("plain", [])):
        prefix = str(tmp_path / tag)
        assert cli_main([*common, *extra, "-pre", prefix]) == 0
        with open(prefix + ".treefile") as f:
            out[tag] = f.read()
        for ext in (".ufboot", ".splits.nex", ".contree"):
            assert not os.path.exists(prefix + ext), ext
    assert out["bb"] == out["plain"]
    assert not re.search(r"\)\d", out["bb"])  # no support labels


def test_entry_points_need_cuda_unless_cpu_is_asked_for(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from iqtree_torch import resolve_device

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
    prefix = str(tmp_path / "ex")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_main(["-s", os.path.join(DATA, "example.phy"),
                  "-te", os.path.join(DATA, "golden_tree_44.nwk"), "-pre", prefix])
    assert not os.path.exists(prefix + ".treefile")


def test_import_leaves_jax_out():
    """A fresh interpreter importing every module of the port loads no jax
    (this test process has jax loaded by conftest.py)."""
    code = (
        "import importlib, pkgutil, sys, iqtree_torch\n"
        "for m in pkgutil.walk_packages(iqtree_torch.__path__, 'iqtree_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'iqtree_tpu'))]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr


def _port_files():
    for root, _, files in os.walk(os.path.join(REPO, "iqtree_torch")):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def test_no_module_imports_jax():
    """AST scan: no file of the port, nor chip_smoke.py, imports jax or the
    JAX package."""
    offenders = []
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                if n.split(".")[0] in ("jax", "jaxlib", "iqtree_tpu"):
                    offenders.append(f"{os.path.relpath(path, REPO)}: {n}")
    assert not offenders, offenders
