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
