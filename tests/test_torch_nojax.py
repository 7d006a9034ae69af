"""The port runs where JAX is not installed.

A subprocess blocks `jax` and `metacherchant_tpu` in sys.modules, imports
every module of metacherchant_tpu_torch and chip_smoke.py, and runs the
port's CLI on the CPU: one or more command lines, separated by "::".
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
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
