"""The port runs where JAX is not installed, and stands on its own files.

A subprocess blocks `jax` and `metacherchant_tpu` in sys.modules, imports
every module of metacherchant_tpu_torch and chip_smoke.py, and runs the
port's CLI on the CPU: one or more command lines, separated by "::". An
audit hook fails it if the run opens, builds, loads or lists a path under
metacherchant_tpu/. The port's native sources are its own, built from its
own package; fastio.cpp is byte-equal to the JAX package's frozen one.
"""
import ast
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "metacherchant_tpu_torch"
JAX_PKG = REPO / "metacherchant_tpu"

SCRIPT = r"""
import importlib, os, pkgutil, sys
JAX_DIR = os.path.join(os.getcwd(), "metacherchant_tpu") + os.sep
touched = []


def _paths(args):
    for a in args:
        if isinstance(a, (list, tuple)):
            yield from _paths(a)
        elif isinstance(a, (str, bytes, os.PathLike)):
            yield os.path.abspath(os.fsdecode(a))


def audit(event, args):
    if event in ("open", "subprocess.Popen", "os.exec", "os.posix_spawn",
                 "ctypes.dlopen", "os.listdir", "os.scandir"):
        touched.extend(p for p in _paths(args) if p.startswith(JAX_DIR))


sys.addaudithook(audit)
sys.modules["jax"] = None
sys.modules["metacherchant_tpu"] = None
import metacherchant_tpu_torch
for m in pkgutil.walk_packages(metacherchant_tpu_torch.__path__,
                               "metacherchant_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
from metacherchant_tpu_torch.runner import main
argv, rc = sys.argv[1:] + ["::"], 0
while argv and not rc:
    cut = argv.index("::")
    rc, argv = main(argv[:cut]), argv[cut + 1:]
loaded = [n for n, m in sys.modules.items() if m is not None
          and (n.split(".")[0] in ("jax", "jaxlib", "metacherchant_tpu"))]
assert not loaded, loaded
assert not touched, touched
sys.exit(rc)
"""


def _reads(tmp_path):
    rng = np.random.default_rng(11)
    g = "".join(rng.choice(list("ACGT"), size=3000))
    reads = tmp_path / "reads.fastq"
    reads.write_text("".join(
        f"@r{i}\n{g[s:s + 60]}\n+\n{'I' * 60}\n"
        for i, s in enumerate(rng.integers(0, 2940, size=500))))
    return g, reads


def _run(args: list[str], env: dict[str, str] | None = None) -> None:
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT, *args], cwd=REPO,
        env={**os.environ, "MC_PLATFORM": "cpu", **(env or {})},
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


def test_port_runs_without_jax(tmp_path):
    g, reads = _reads(tmp_path)
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n")
    out = tmp_path / "out"
    _run(["-t", "environment-finder", "-k", "21", "-i", str(reads),
          "--seq", str(genes), "-o", str(out), "--coverage", "3",
          "--maxradius", "100", "--work-dir", str(tmp_path / "wd")])
    assert (out / "geneA" / "graph.txt").stat().st_size > 0


def test_classifier_tools_run_without_jax(tmp_path):
    """kmer-counter, then reads-classifier on its dump, the device coverage
    route included."""
    _, reads = _reads(tmp_path)
    kmers, out = tmp_path / "kmers", tmp_path / "out"
    _run(["-t", "kmer-counter", "-k", "21", "-i", str(reads),
          "-o", str(kmers), "--work-dir", str(tmp_path / "wk"), "::",
          "-t", "reads-classifier", "-k", "21",
          "-i", str(kmers / "reads.kmers.bin"), "-r", str(reads),
          "-o", str(out), "--work-dir", str(tmp_path / "wr")],
         env={"MC_DEVICE_CLASSIFY": "1"})
    assert (kmers / "reads.stat.txt").stat().st_size > 0
    assert (out / "found_s.fastq").read_text().count("\n+\n") == 500


def test_triple_seq_cov_and_fmt_tools_run_without_jax(tmp_path):
    """triple-reads-classifier (device coverage), seq-cov, fmt-visualiser
    (device contraction), fmt-visualizer and recipient-visualiser, with the
    recipe's reads as every metagenome and every bin."""
    g, reads = _reads(tmp_path)
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n>geneB\n{g[2000:2100]}\n")
    bins = tmp_path / "bins"
    bins.mkdir()
    for stem in ("settle", "not_settle", "stay", "gone", "came_from_donor",
                 "came_from_baseline", "came_from_both", "came_itself"):
        for x in ("1", "2", "s"):
            (bins / f"{stem}_{x}.fastq").write_text(reads.read_text())
    r, out = str(reads), tmp_path / "out"
    fmt = ["-k", "21", "-i", str(bins), "--ext", "fastq", "-after", r]
    _run(["-t", "triple-reads-classifier", "-k", "21", "-k2", "33",
          "-i", r, "-r", r, "-o", str(out / "triple"),
          "--work-dir", str(tmp_path / "w1"), "::",
          "-t", "seq-cov", "-k", "21", "--from-donor", r, "--from-before", r,
          "--from-both", r, "--itself", r, "-r", str(genes),
          "-o", str(out / "cov"), "--work-dir", str(tmp_path / "w2"), "::",
          "-t", "fmt-visualiser", "-donor", r, "-before", r, *fmt,
          "-o", str(out / "fmt"), "--work-dir", str(tmp_path / "w3"), "::",
          "-t", "fmt-visualizer", "-donor", r, "-before", r, *fmt,
          "-o", str(out / "comp"), "--work-dir", str(tmp_path / "w4"), "::",
          "-t", "recipient-visualiser", "--seq", str(genes), *fmt,
          "-o", str(out / "rec"), "--work-dir", str(tmp_path / "w5")],
         env={"MC_DEVICE_CLASSIFY": "1", "MC_DEVICE_CONTRACT": "1"})
    assert (out / "triple" / "found_s.fastq").read_text().count("\n+\n") \
        == 500
    assert len((out / "cov" / "seq_cov.csv").read_text().splitlines()) == 3
    for name in ("fmt/donor.gfa", "fmt/after.gfa", "comp/after/comp0.gfa",
                 "rec/after/comp_1.gfa"):
        assert "\tCL:Z:" in (out / name).read_text(), name


def test_device_engines_run_without_jax(tmp_path):
    """environment-finder under MC_DEVICE_BFS (dense engine at k = 21, the
    multiword engine at k = 33) with the hash counting engine, then under
    the probe engine."""
    g, reads = _reads(tmp_path)
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n")
    out = tmp_path / "out"

    def args(k: int, name: str) -> list[str]:
        return ["-t", "environment-finder", "-k", str(k), "-i", str(reads),
                "--seq", str(genes), "-o", str(out / name), "--coverage", "3",
                "--maxradius", "100", "--work-dir", str(tmp_path / name)]

    _run(args(21, "dense") + ["::"] + args(33, "multiword"),
         env={"MC_DEVICE_BFS": "1", "MC_COUNT_ENGINE": "hash"})
    _run(args(21, "probe"), env={"MC_DEVICE_BFS": "1",
                                 "MC_DEVICE_BFS_ENGINE": "probe"})
    for name in ("dense", "multiword", "probe"):
        assert (out / name / "geneA" / "graph.txt").stat().st_size > 0
    assert (out / "dense" / "geneA" / "graph.txt").read_bytes() == \
        (out / "probe" / "geneA" / "graph.txt").read_bytes()


def test_last_three_tools_run_without_jax(tmp_path):
    """environment-finder-multi on graph.txt files the port's
    environment-finder writes, environment-assembler-finder with a stub
    spades, and hic-pipeline with a stub bwa, then --first-pass-only: both
    passes run the port's own runner, so metacherchant_tpu stays out of
    sys.modules."""
    from test_hic_pipeline import BWA_STUB
    from test_torch_assembler import SPADES_STUB
    g, reads = _reads(tmp_path)
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n")
    (tmp_path / "spades").mkdir()
    (tmp_path / "spades" / "spades.py").write_text(SPADES_STUB)
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "bwa").write_text(BWA_STUB)
    (bindir / "samtools").write_text("#!/bin/sh\nexit 0\n")
    for name in ("bwa", "samtools"):
        (bindir / name).chmod(0o755)
    hic = [str(tmp_path / f"hic_{m}.fastq") for m in (1, 2)]
    for path in hic:
        with open(path, "w") as fh:
            fh.write("".join(f"@h{i}\n{g[i * 97:i * 97 + 50]}\n+\n{'I' * 50}\n"
                             for i in range(20)))
    out, r = tmp_path / "out", str(reads)

    def env_finder(cov: int) -> list[str]:
        return ["-t", "environment-finder", "-k", "21", "-i", r,
                "--seq", str(genes), "-o", str(out / f"c{cov}"),
                "--coverage", str(cov), "--maxradius", "100",
                "--work-dir", str(tmp_path / f"we{cov}"), "::"]

    hic_args = ["-t", "hic-pipeline", "-k", "21", "-i", r, "--seq",
                str(genes), "--hi-c-r1", hic[0], "--hi-c-r2", hic[1],
                "--coverage", "3", "--maxradius", "100"]
    _run([*env_finder(1), *env_finder(3),
          "-t", "environment-finder-multi",
          "-e", *(str(out / f"c{c}" / "geneA" / "graph.txt") for c in (1, 3)),
          "--seq", str(genes), "-o", str(out / "multi"),
          "--work-dir", str(tmp_path / "wm"), "::",
          "-t", "environment-assembler-finder", "-k", "21", "-i", r,
          "--seq", str(genes), "-o", str(out / "asm"), "--maxradius", "100",
          "--coverage", "3", "--assembler", "spades",
          "--assemblerpath", str(tmp_path / "spades"), "-pf", "50",
          "--work-dir", str(tmp_path / "wa"), "::",
          *hic_args, "--work-dir", str(tmp_path / "wh"), "::",
          *hic_args, "--work-dir", str(tmp_path / "wf"),
          "--first-pass-only", "true"],
         env={"PATH": f"{bindir}:{os.environ['PATH']}"})
    assert "0.00" in (out / "multi" / "Jacard_sym.txt").read_text()
    assert len((out / "asm" / "result" / "graph.txt").read_text()
               .split(" ", 1)[0]) == 55
    assert (tmp_path / "wh" / "2" / "hic_map.txt").read_text() \
        .startswith("v1\tv2\thic_w\n")
    assert (tmp_path / "wf" / "output" / "1" / "merged" / "seqs.fasta") \
        .stat().st_size > 0
    assert not (tmp_path / "wf" / "2").joinpath("hic_map.txt").exists()


def test_sharded_engine_runs_without_jax(tmp_path):
    """environment-finder under MC_COUNT_ENGINE=sharded (a process group of
    world size 1 on the CPU's gloo) and under `merge`: the same files."""
    g, reads = _reads(tmp_path)
    genes = tmp_path / "genes.fasta"
    genes.write_text(f">geneA\n{g[1000:1120]}\n")
    out = tmp_path / "out"
    for engine in ("sharded", "merge"):
        _run(["-t", "environment-finder", "-k", "21", "-i", str(reads),
              "--seq", str(genes), "-o", str(out / engine), "--coverage",
              "3", "--maxradius", "100", "--work-dir",
              str(tmp_path / engine)], env={"MC_COUNT_ENGINE": engine})
    got = (out / "sharded" / "geneA" / "graph.txt").read_bytes()
    assert got and got == (out / "merge" / "geneA" / "graph.txt").read_bytes()


def _code_strings(path: Path):
    """(line, value) of every string constant in a Python file that is not
    a docstring."""
    tree = ast.parse(path.read_text())
    docs = {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                                 ast.AsyncFunctionDef))
            and node.body and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Constant) and isinstance(node.value, str)
                and id(node) not in docs):
            yield node.lineno, node.value


def test_no_code_names_a_path_into_the_jax_package():
    """No string in the port's code or chip_smoke.py (docstrings aside)
    names metacherchant_tpu as a path component, so none builds or reads a
    file there. The one form allowed is a file:line reference to the TPU
    kernel a kernel replaces, which is printed, never opened."""
    names_jax = re.compile(r"(^|[^\w])metacherchant_tpu(?!_torch)($|[^\w])")
    reference = re.compile(r"^metacherchant_tpu/[\w/]+\.py:\d+$")
    found = [f"{path.relative_to(REPO)}:{line}: {value!r}"
             for path in [*sorted(PORT.rglob("*.py")), REPO / "chip_smoke.py"]
             for line, value in _code_strings(path)
             if names_jax.search(value) and not reference.match(value)]
    assert not found, found


def test_native_sources_are_the_ports_own(tmp_path, monkeypatch):
    """The host libraries build from csrc/ in the port's package: every g++
    command names sources there only, and fastio.cpp is byte-equal to the
    JAX package's source (frozen: drift fails here). bfs.cpp differs by
    design (its count lookups search the map's sorted keys);
    tests/test_torch_native_bfs.py holds it to the port's Python engines.
    readstream.cpp is the port's alone; tests/test_torch_native_reads.py
    holds it to the whole-file parse."""
    from metacherchant_tpu_torch import native
    from metacherchant_tpu_torch.ops import consolidate_cuda, extract_cuda
    assert (native.SRC_DIR / "fastio.cpp").read_bytes() == \
        (JAX_PKG / "native" / "fastio.cpp").read_bytes()
    assert extract_cuda.SOURCE.is_relative_to(PORT)
    assert consolidate_cuda.SOURCE.is_relative_to(PORT)
    assert consolidate_cuda.SOURCE.parent == native.SRC_DIR
    commands = []
    run = subprocess.run

    def spy(cmd, **kwargs):
        commands.append(cmd)
        return run(cmd, **kwargs)

    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.subprocess, "run", spy)
    libs = [native._load_fastio.__wrapped__(), native._load_bfs.__wrapped__(),
            native._load_readstream.__wrapped__()]
    assert len(commands) == 3
    for cmd in commands:
        sources = [Path(a) for a in cmd if a.endswith((".cpp", ".cu"))]
        assert len(sources) == 1 and sources[0].parent == native.SRC_DIR
        assert sources[0].resolve().is_relative_to(PORT)
    if all(lib is not None for lib in libs):  # g++ present: all built here
        assert sorted(p.name for p in tmp_path.glob("*.so")) == \
            ["libbfs.so", "libfastio.so", "libreadstream.so"]
