"""End to end: `python -m metacherchant_tpu_torch` against
`python -m metacherchant_tpu` (both run in-process through runner.main) on
the verify recipe's synthetic data. Outputs must be byte-identical.
"""
import os

import numpy as np
import pytest

from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.runner import main as port_main

OUTPUTS = ("graph.txt", "seqs.fasta", "graph.gfa", "tsvs/nodes.tsv",
           "tsvs/edges.tsv")


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    """The verify recipe: 500 reads of 60 bp from a 3 kbp genome, plus a
    second gene so that the per-gene thread pool runs."""
    tmp = tmp_path_factory.mktemp("recipe")
    rng = np.random.default_rng(11)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    (tmp / "reads.fastq").write_text("".join(
        f"@r{i}\n{g[s:s + 60]}\n+\n{'I' * 60}\n"
        for i, s in enumerate(rng.integers(0, 2940, size=500))))
    (tmp / "genes.fasta").write_text(
        f">geneA\n{g[1000:1120]}\n>geneB\n{g[2200:2300]}\n")
    return str(tmp / "reads.fastq"), str(tmp / "genes.fasta")


def _args(recipe, k, out, wd, *extra):
    reads, genes = recipe
    return ["-t", "environment-finder", "-k", str(k), "-i", reads,
            "--seq", genes, "-o", str(out), "--coverage", "3",
            "--maxradius", "100", "--work-dir", str(wd), *extra]


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _log(wd) -> str:
    with open(os.path.join(wd, "log")) as fh:
        return fh.read()


@pytest.mark.parametrize("k,extra", [
    (21, ()), (31, ()), (21, ("--bothdirs", "--trim")),
    (25, ("--merge", "--maxkmers", "60", "--chunklength", "30")),
], ids=["k21", "k31", "k21-bothdirs-trim", "k25-merge-maxkmers"])
def test_outputs_byte_identical_to_jax(recipe, k, extra, tmp_path,
                                       monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    assert jax_main(_args(recipe, k, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    assert port_main(_args(recipe, k, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    want, got = _tree(tmp_path / "oj"), _tree(tmp_path / "ot")
    dirs = ("merged",) if "--merge" in extra else ("geneA", "geneB")
    for d in dirs:
        for name in OUTPUTS:
            assert os.path.join(d, name) in got
        assert got[os.path.join(d, "graph.txt")]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


def test_python_oracle_paths_match_jax(recipe, tmp_path, monkeypatch):
    """The port with its Python readers and Python FIFO BFS (the native
    engines off) against the JAX package's default run."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    extra = ("--trim",)
    assert jax_main(_args(recipe, 21, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    monkeypatch.setenv("MC_NATIVE_IO", "0")
    monkeypatch.setenv("MC_NATIVE_BFS", "0")
    assert port_main(_args(recipe, 21, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    assert _tree(tmp_path / "ot") == _tree(tmp_path / "oj")


def test_continue_skips_finished_run(recipe, tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    args = _args(recipe, 21, tmp_path / "out", tmp_path / "wd")
    assert port_main(args) == 0
    assert os.path.exists(tmp_path / "wd" / "SUCCESS")
    assert port_main(args + ["--continue"]) == 0
    assert "already done, skipping" in _log(tmp_path / "wd")


@pytest.mark.parametrize("k,extra,env", [
    (55, (), {}),
    (21, ("--forcehash",), {}),
    (21, (), {"MC_DEVICE_BFS": "1"}),
    (21, (), {"MC_DEVICE_CONTRACT": "1"}),
    (21, (), {"MC_COUNT_ENGINE": "hash"}),
], ids=["k55", "forcehash", "device-bfs", "device-contract", "hash-engine"])
def test_unported_paths_fail_clearly(recipe, k, extra, env, tmp_path,
                                     monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    rc = port_main(_args(recipe, k, tmp_path / "out", tmp_path / "wd",
                         *extra))
    assert rc == 1
    assert "not yet ported" in _log(tmp_path / "wd")
    assert not os.path.exists(tmp_path / "wd" / "SUCCESS")


def test_unknown_tool(capsys):
    assert port_main(["-t", "kmer-counter"]) == 1
    assert "Unknown tool" in capsys.readouterr().err
