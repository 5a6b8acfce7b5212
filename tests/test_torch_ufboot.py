"""The port's ultrafast bootstrap and split machinery against the JAX package.

trees/splits.py against iqtree_tpu/trees/splits.py on random trees; the
port's UFBoot against the JAX package's, fed the same seed, the same
sequence of visited trees and the same float64 pattern log-likelihoods
(two whole searches part at parsimony below 34 taxa, ROADMAP Queue 3, so
the bootstrap is compared on the same visits); and -bb runs through the
CLI on the CPU, DNA and protein, and on an alignment with a duplicated row
beside the JAX CLI (in a subprocess: the JAX CLI pins a device mesh in the
process that runs it).
"""

import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from iqtree_tpu.io.alignment import Alignment as JAlignment
from iqtree_tpu.search.ufboot import UFBoot as JUFBoot
from iqtree_tpu.trees import splits as jsplits

from iqtree_torch.cli import main as cli_main
from iqtree_torch.io.alignment import Alignment
from iqtree_torch.search.ufboot import UFBoot
from iqtree_torch.trees import splits
from iqtree_torch.trees.tree import PhyloTree, random_tree

from test_torch_protein import PROT
from test_torch_search import jax_view, simulate_jc

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def nni_walk(n_taxa, n_trees, seed):
    """A random tree and n_trees - 1 random-NNI neighbours along a walk
    (trees that share most splits, as a search visits them)."""
    rng = np.random.default_rng(seed)
    t = random_tree(n_taxa, rng)
    out = [t.copy()]
    for _ in range(n_trees - 1):
        for _ in range(int(rng.integers(1, 4))):
            e = t.internal_edges()
            t.apply_nni(int(e[rng.integers(len(e))]), int(rng.integers(2)))
        out.append(t.copy())
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_splits_match_jax(seed):
    trees = nni_walk(13, 12, seed)
    jtrees = [jax_view(t) for t in trees]
    counter, jcounter = splits.SplitCounter(13), jsplits.SplitCounter(13)
    rng = np.random.default_rng(seed + 7)
    for t, j in zip(trees, jtrees):
        got, want = splits.tree_splits(t, with_nodes=True), \
            jsplits.tree_splits(j, with_nodes=True)
        assert got == want
        assert set(splits.tree_splits(t)) == t.splits_key()
        w = float(rng.integers(1, 5))
        counter.add_tree(t, w)
        jcounter.add_tree(j, w)
    assert counter.counts == jcounter.counts
    assert counter.total_weight == jcounter.total_weight
    for t, j in zip(trees, jtrees):
        assert splits.map_supports(t, counter) == jsplits.map_supports(j, jcounter)
    con = splits.consensus_tree(counter)
    jcon, _ = jsplits.consensus_tree(jcounter)
    con.check()
    assert con.robinson_foulds(jax_view(jcon)) == 0
    np.testing.assert_array_equal(con.children, jcon.children)
    assert splits.map_supports(con, counter) == jsplits.map_supports(jcon, jcounter)
    a, b = sorted(counter.counts)[:2]
    assert splits.splits_compatible(a, b, 13) == jsplits.splits_compatible(a, b, 13)


def test_ufboot_matches_jax():
    """The same seed, visits and float64 pattern lnLs: the same [B, P]
    resampling, per-sample best scores, tree ids, supports, consensus and
    convergence correlations.  The visits' pattern lnLs are close enough
    that the -beps tie rule (one uniform draw a visit) decides samples."""
    _, names, seqs = simulate_jc(n_taxa=11, n_sites=150, seed=4)
    aln = Alignment.from_sequences(names, seqs, "DNA")
    jaln = JAlignment.from_sequences(names, seqs, "DNA")
    B, P = 300, aln.n_patterns
    ours = UFBoot(aln, B, np.random.default_rng(5), CPU)
    theirs = JUFBoot(jaln, B, np.random.default_rng(5), dtype=jnp.float64)
    np.testing.assert_array_equal(ours.boot_freqs.numpy(), np.asarray(theirs.boot_freqs))
    rng = np.random.default_rng(9)
    base = -rng.uniform(2.0, 9.0, P)
    trees = nni_walk(11, 40, 3)
    corr, jcorr = [], []
    for i, t in enumerate(trees):
        lnl = base + rng.normal(0.0, 0.004, P)
        ours.save_tree(t, torch.as_tensor(lnl))
        theirs.save_tree(jax_view(t), lnl)
        np.testing.assert_allclose(ours.boot_logl, theirs.boot_logl, rtol=1e-12)
        np.testing.assert_array_equal(ours.boot_tree_id, theirs.boot_tree_id)
        np.testing.assert_array_equal(ours.boot_counts, theirs.boot_counts)
        if i % 10 == 9:
            corr.append(ours.check_convergence())
            jcorr.append(theirs.check_convergence())
    assert len(ours._trees) > 3 and (ours.boot_counts > 1).any()  # ties were taken
    np.testing.assert_allclose(corr, jcorr, rtol=1e-12)
    for t in trees[-3:]:
        assert ours.supports_for(t) == theirs.supports_for(jax_view(t))
    con, jcon = ours.consensus(), theirs.consensus()
    assert con.robinson_foulds(jax_view(jcon)) == 0
    np.testing.assert_array_equal(con.children, jcon.children)
    assert ours.supports_for(con) == theirs.supports_for(jcon)


def check_ufboot_outputs(prefix, n_taxa, B):
    """Every sample holds a tree, the .treefile carries N-3 supports in
    0-100, and .contree and .splits.nex are written."""
    with open(prefix + ".ufboot") as f:
        boot = f.read().splitlines()
    assert len(boot) == B and all(l.endswith(";") for l in boot)
    with open(prefix + ".treefile") as f:
        nwk = f.read().strip()
    labels = [int(x) for x in re.findall(r"\)(\d+):", nwk)]
    assert len(labels) == n_taxa - 3 and all(0 <= x <= 100 for x in labels)
    tree = PhyloTree.from_newick(nwk, sorted(re.findall(r"[(,]([^(),:]+):", nwk)))
    tree.check()
    for ext in (".contree", ".splits.nex"):
        assert os.path.getsize(prefix + ext) > 0, ext
    with open(prefix + ".splits.nex") as f:
        assert f.read().startswith("#nexus")
    with open(prefix + ".log") as f:
        log = f.read()
    assert "Ultrafast bootstrap: %d replicates" % B in log
    assert "Consensus tree:" in log and "Split support values:" in log


def test_cli_ufboot_dna_on_cpu(tmp_path):
    """Without -n the -bb search checks the split correlation every -nstep
    iterations and stops once it reaches -bcor and the stop rule agrees."""
    _, names, seqs = simulate_jc(n_taxa=9, seed=2)
    aln_path = str(tmp_path / "sim.phy")
    with open(aln_path, "w") as f:
        f.write(f"{len(names)} {len(seqs[0])}\n")
        f.writelines(f"{n} {s}\n" for n, s in zip(names, seqs))
    prefix = str(tmp_path / "sim")
    assert cli_main(["-s", aln_path, "-m", "HKY+G", "-bb", "100", "-nstep", "2",
                     "-bcor", "0.5", "-nstop", "3", "-ninit", "3", "-ntop", "1", "-wbt",
                     "-device", "cpu", "-pre", prefix]) == 0
    check_ufboot_outputs(prefix, 9, 100)
    with open(prefix + ".log") as f:
        corr = re.findall(r"UFBoot split correlation at iteration (\d+): (\S+)", f.read())
    assert [int(i) for i, _ in corr] == list(range(2, 2 * len(corr) + 1, 2))
    assert len(corr) >= 2 and float(corr[-1][1]) >= 0.5


def test_cli_ufboot_protein_on_cpu(tmp_path):
    prefix = str(tmp_path / "prot")
    assert cli_main(["-s", PROT, "-m", "LG+G", "-bb", "100", "-n", "2", "-ninit", "2",
                     "-ntop", "1", "-wbtl", "-device", "cpu", "-pre", prefix]) == 0
    check_ufboot_outputs(prefix, 27, 100)
    with open(prefix + ".ufboot") as f:
        assert re.search(r":[0-9.]+", f.readline())  # -wbtl writes the lengths


def leaf_names(nwk):
    return set(re.findall(r"[(,]([^(),:;]+)", nwk))


def nexus_taxa(path):
    with open(path) as f:
        return set(re.findall(r"^\[\d+\] '([^']+)'$", f.read(), re.M))


def test_cli_ufboot_keeps_identical_sequences(tmp_path):
    """Under -bb identical sequences stay in the analysis, as in the JAX
    CLI: the bootstrap trees, the split supports and the consensus cover
    every taxon, the duplicate included."""
    with open(os.path.join(REPO, "tests", "data", "example.phy")) as f:
        head, *rows = [l for l in f.read().splitlines() if l.strip()]
    n, n_sites = head.split()
    seq = rows[3].split(None, 1)[1]
    aln_path = str(tmp_path / "dup.phy")
    with open(aln_path, "w") as f:
        f.write(f"{int(n) + 1} {n_sites}\n" + "\n".join(rows + ["DUPTAXON " + seq]) + "\n")
    flags = ["-s", aln_path, "-m", "JC", "-bb", "100", "-n", "1", "-ninit", "2",
             "-ntop", "1", "-wbt", "-redo"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    jax_run = subprocess.Popen([sys.executable, "-m", "iqtree_tpu", *flags, "-pre",
                                str(tmp_path / "jx")], cwd=tmp_path, env=env,
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        prefix = str(tmp_path / "pt")
        assert cli_main([*flags, "-device", "cpu", "-pre", prefix]) == 0
    finally:
        jax_out, _ = jax_run.communicate(timeout=600)
    assert jax_run.returncode == 0, jax_out[-2000:]
    names = {r.split()[0] for r in rows} | {"DUPTAXON"}
    with open(prefix + ".log") as f:
        assert "identical sequences will be ignored" not in f.read()
    check_ufboot_outputs(prefix, len(names), 100)
    for pre in (prefix, str(tmp_path / "jx")):
        assert nexus_taxa(pre + ".splits.nex") == names
        for ext in (".contree", ".treefile"):
            with open(pre + ext) as f:
                assert leaf_names(f.read()) == names, (pre, ext)
        with open(pre + ".ufboot") as f:
            assert all(leaf_names(t) == names for t in f.read().splitlines())
