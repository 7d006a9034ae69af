"""End to end: `python -m metacherchant_tpu_torch` against
`python -m metacherchant_tpu` (both run in-process through runner.main) on
the verify recipe's synthetic data. Outputs must be byte-identical.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.runner import main as port_main

OUTPUTS = ("graph.txt", "seqs.fasta", "graph.gfa", "tsvs/nodes.tsv",
           "tsvs/edges.tsv")


@pytest.fixture
def no_group_left():
    """Destroys the process group the test formed (the sharded engine forms
    one of world size 1 in this process), so that no later test meets it."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


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


@pytest.fixture(scope="module")
def long_recipe(tmp_path_factory):
    """For k > 31: 400 reads of 150 bp (every 40th with an N) from a 3 kbp
    genome, the same two genes."""
    tmp = tmp_path_factory.mktemp("long_recipe")
    rng = np.random.default_rng(12)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    reads = []
    for i, s in enumerate(rng.integers(0, 2850, size=400)):
        r = g[s:s + 150]
        reads.append(r[:70] + "N" + r[71:] if i % 40 == 0 else r)
    (tmp / "reads.fastq").write_text("".join(
        f"@r{i}\n{r}\n+\n{'I' * 150}\n" for i, r in enumerate(reads)))
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


def _hash_lines(wd) -> list[str]:
    """The regime and graph-size log lines, without timestamps."""
    return [ln.split(": ", 1)[1] for ln in _log(wd).splitlines()
            if "hash" in ln or "Hashtable size" in ln]


@pytest.mark.parametrize("data,k,extra", [
    ("recipe", 21, ()), ("recipe", 31, ()),
    ("recipe", 21, ("--bothdirs", "--trim")),
    ("recipe", 25, ("--merge", "--maxkmers", "60", "--chunklength", "30")),
    ("long_recipe", 55, ()), ("long_recipe", 55, ("--hash", "fnv1a")),
    ("recipe", 21, ("--forcehash",)),
    ("long_recipe", 55, ("--bothdirs", "--trim")),
    ("long_recipe", 55, ("--merge", "--maxkmers", "60", "--chunklength",
                         "30")),
], ids=["k21", "k31", "k21-bothdirs-trim", "k25-merge-maxkmers",
        "k55-poly", "k55-fnv1a", "k21-forcehash", "k55-bothdirs-trim",
        "k55-merge-maxkmers"])
def test_outputs_byte_identical_to_jax(data, k, extra, tmp_path, request,
                                       monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    recipe = request.getfixturevalue(data)
    assert jax_main(_args(recipe, k, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    assert port_main(_args(recipe, k, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    want, got = _tree(tmp_path / "oj"), _tree(tmp_path / "ot")
    assert _hash_lines(tmp_path / "wt") == _hash_lines(tmp_path / "wj")
    dirs = ("merged",) if "--merge" in extra else ("geneA", "geneB")
    for d in dirs:
        for name in OUTPUTS:
            assert os.path.join(d, name) in got
        assert got[os.path.join(d, "graph.txt")]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("data,k,extra", [
    ("recipe", 21, ("--trim",)), ("long_recipe", 55, ("--trim",)),
    ("long_recipe", 55, ("--hash", "fnv1a")),
], ids=["k21-trim", "k55-poly-trim", "k55-fnv1a"])
def test_python_oracle_paths_match_jax(data, k, extra, tmp_path, request,
                                       monkeypatch):
    """The port with its Python readers and Python FIFO BFS (the native
    engines off) against the JAX package's default run."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    recipe = request.getfixturevalue(data)
    assert jax_main(_args(recipe, k, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    monkeypatch.setenv("MC_NATIVE_IO", "0")
    monkeypatch.setenv("MC_NATIVE_BFS", "0")
    assert port_main(_args(recipe, k, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    assert _tree(tmp_path / "ot") == _tree(tmp_path / "oj")
    assert _tree(tmp_path / "ot")


def test_continue_skips_finished_run(recipe, tmp_path, monkeypatch):
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    args = _args(recipe, 21, tmp_path / "out", tmp_path / "wd")
    assert port_main(args) == 0
    assert os.path.exists(tmp_path / "wd" / "SUCCESS")
    assert port_main(args + ["--continue"]) == 0
    assert "already done, skipping" in _log(tmp_path / "wd")


@pytest.mark.parametrize("data,k,extra,env", [
    ("recipe", 21, (), {"MC_DEVICE_CONTRACT": "1"}),
    ("recipe", 31, ("--bothdirs",), {"MC_DEVICE_CONTRACT": "1"}),
    ("recipe", 25, ("--merge", "--maxkmers", "60", "--chunklength", "30"),
     {"MC_DEVICE_CONTRACT": "1"}),
    ("recipe", 21, (), {"MC_DEVICE_CONTRACT_MIN": "10"}),
    ("long_recipe", 55, (), {"MC_DEVICE_CONTRACT": "1"}),
], ids=["device-contract", "k31-bothdirs", "k25-merge-maxkmers",
        "auto-min", "k55-host-route"])
def test_device_contract_byte_identical_to_jax(data, k, extra, env, tmp_path,
                                               request, monkeypatch):
    """environment-finder with the device contraction (on the CPU here)
    against the JAX package under the same switch; at k = 55 both take the
    host sweep."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    recipe = request.getfixturevalue(data)
    assert jax_main(_args(recipe, k, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    assert port_main(_args(recipe, k, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(want) and len(got) >= 5
    for name in want:
        assert got[name] == want[name], name


def test_scalar_poly_fifo_byte_identical_to_jax(long_recipe, tmp_path,
                                                monkeypatch):
    """MC_NATIVE_BFS=0 at k = 55 with the poly hash: both packages walk with
    their scalar sliding-poly FIFO (a spy on the port's own module sees each
    direction of each gene go through it, and never the layer FIFO); the
    files are byte-identical."""
    from metacherchant_tpu_torch.algo import environment_hashed as TH
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_NATIVE_BFS", "0")
    engines = []
    for name in ("_bfs_scalar_poly", "_bfs_layer_fifo"):
        def spy(*args, _real=getattr(TH, name), _name=name, **kw):
            engines.append(_name)
            return _real(*args, **kw)
        monkeypatch.setattr(TH, name, spy)
    assert jax_main(_args(long_recipe, 55, tmp_path / "oj",
                          tmp_path / "wj")) == 0
    assert port_main(_args(long_recipe, 55, tmp_path / "ot",
                           tmp_path / "wt")) == 0
    assert engines == ["_bfs_scalar_poly"] * 4   # 2 genes x 2 directions
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(want) and len(got) == 10
    assert got[os.path.join("geneA", "graph.txt")]
    for name in want:
        assert got[name] == want[name], name
    assert "scalar sliding-poly FIFO BFS" in _log(tmp_path / "wt")


@pytest.mark.parametrize("k,extra,env", [
    (21, (), {"MC_DEVICE_BFS": "1"}),
    (55, (), {"MC_DEVICE_BFS": "1"}),
    (21, (), {"MC_COUNT_ENGINE": "hash"}),
    (21, ("--bothdirs",), {"MC_DEVICE_BFS": "1",
                           "MC_DEVICE_BFS_ENGINE": "probe"}),
], ids=["device-bfs", "device-bfs-hashed", "hash-engine", "device-bfs-probe"])
def test_device_paths_byte_identical_to_jax(recipe, long_recipe, k, extra,
                                            env, tmp_path, monkeypatch):
    """The paths the port once refused (the device BFS engines in both
    regimes, the hash counting engine) now run: byte-identical to the JAX
    package under the same switches."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    data = long_recipe if k > 31 else recipe
    assert jax_main(_args(data, k, tmp_path / "oj", tmp_path / "wj",
                          *extra)) == 0
    assert port_main(_args(data, k, tmp_path / "ot", tmp_path / "wt",
                           *extra)) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(want) and len(got) == 10
    for name in want:
        assert got[name] == want[name], name
    assert "not yet ported" not in _log(tmp_path / "wt")
    assert os.path.exists(tmp_path / "wt" / "SUCCESS")


@pytest.mark.parametrize("engine", ["merge", "chunk", "sharded"])
def test_count_engines_byte_identical_to_jax(recipe, engine, tmp_path,
                                             monkeypatch, no_group_left):
    """The counting engines the port once refused now run the tool: files
    byte-identical to the JAX package's under the same MC_COUNT_ENGINE."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.setenv("MC_COUNT_ENGINE", engine)
    assert jax_main(_args(recipe, 21, tmp_path / "oj", tmp_path / "wj")) == 0
    assert port_main(_args(recipe, 21, tmp_path / "ot", tmp_path / "wt")) == 0
    got, want = _tree(tmp_path / "ot"), _tree(tmp_path / "oj")
    assert sorted(got) == sorted(want) and len(got) == 10
    for name in want:
        assert got[name] == want[name], name
    assert os.path.exists(tmp_path / "wt" / "SUCCESS")


def test_unknown_tool(capsys):
    assert port_main(["-t", "no-such-tool"]) == 1
    assert "Unknown tool" in capsys.readouterr().err


def test_tools_listing_matches_jax(capsys):
    """--tools lists the JAX package's eleven tools, with their
    descriptions."""
    assert jax_main(["--tools"]) == 0
    want = capsys.readouterr().out
    assert port_main(["--tools"]) == 0
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) == 12


_FMT_STEMS = ("settle", "not_settle", "stay", "gone", "came_from_donor",
              "came_from_baseline", "came_from_both", "came_itself")


@pytest.mark.parametrize("tool", ["environment-finder", "kmer-counter",
                                  "reads-classifier",
                                  "triple-reads-classifier", "seq-cov",
                                  "fmt-visualiser", "fmt-visualizer",
                                  "recipient-visualiser",
                                  "environment-finder-multi",
                                  "environment-assembler-finder",
                                  "hic-pipeline"])
def test_cuda_without_gpu_fails_clearly(recipe, tool, tmp_path, monkeypatch):
    """MC_PLATFORM=cuda where torch sees no GPU: rc 1 and the reason in the
    log, never a silent run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    monkeypatch.setenv("MC_PLATFORM", "cuda")
    reads, genes = recipe
    bins = tmp_path / "bins"
    bins.mkdir()
    for stem in _FMT_STEMS:
        for x in ("1", "2", "s"):
            (bins / f"{stem}_{x}.fastq").write_text(open(reads).read())
    out = ["-o", str(tmp_path / "out"), "--work-dir", str(tmp_path / "wd")]
    fmt = ["-k", "21", "-i", str(bins), "--ext", "fastq", "-after", reads,
           *out]
    env = tmp_path / "graph.txt"
    env.write_text("ACGTACGTACGTACGTACGTA 3\n")
    args = {"environment-finder": _args(recipe, 21, tmp_path / "out",
                                        tmp_path / "wd")[2:],
            "kmer-counter": ["-k", "21", "-i", reads, *out],
            "reads-classifier": ["-k", "21", "-i", reads, "-r", reads, *out],
            "triple-reads-classifier": ["-k", "21", "-k2", "33", "-i", reads,
                                        "-r", reads, *out],
            "seq-cov": ["-k", "21", "--from-donor", reads, "--from-before",
                        reads, "--from-both", reads, "--itself", reads,
                        "-r", genes, *out],
            "fmt-visualiser": ["-donor", reads, "-before", reads, *fmt],
            "fmt-visualizer": ["-donor", reads, "-before", reads, *fmt],
            "recipient-visualiser": ["--seq", genes, *fmt],
            "environment-finder-multi": ["-e", str(env), str(env),
                                         "--seq", genes, *out],
            "environment-assembler-finder": [
                "-k", "21", "-i", reads, "--seq", genes, "--maxradius", "100",
                "--assembler", "spades", "--assemblerpath", str(tmp_path),
                "-pf", "10", *out],
            "hic-pipeline": ["-k", "21", "-i", reads, "--seq", genes,
                             "--hi-c-r1", reads, "--hi-c-r2", reads,
                             "--work-dir", str(tmp_path / "wd")]}[tool]
    assert port_main(["-t", tool, *args]) == 1
    assert "no CUDA device" in _log(tmp_path / "wd")
    assert not os.path.exists(tmp_path / "wd" / "SUCCESS")
