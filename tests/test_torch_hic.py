"""The port's Hi-C pipeline against the JAX package: the SAM flag filters
and the contact map on synthetic SAM, run_hic_pipeline end to end with a
stub bwa (the pipeline filters SAM flags itself, so samtools is an inert
stub), the hic-pipeline CLI with and without --first-pass-only, and the
error when bwa is missing. Inputs are made from a seed with numpy; outputs
are compared byte for byte (the tolerance is zero).
"""
import os
import re
from unittest import mock

import numpy as np
import pytest

from metacherchant_tpu.hic import pipeline as JP
from metacherchant_tpu_torch.dna import reverse_complement
from metacherchant_tpu_torch.hic import pipeline as TP
from metacherchant_tpu_torch.runner import main as port_main
from metacherchant_tpu_torch.tool import ExecutionFailedException

from test_hic_pipeline import BWA_STUB
from test_torch_assembler import jax_host_main


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


_STAMP = re.compile(r"log_\d{8}_\d{6}")


def _masked(root: str) -> dict[str, bytes]:
    """A pipeline's work tree: log files dropped (their names stamped, their
    lines timed), the run's root path masked in the rest."""
    return {n: b.replace(root.encode(), b"<root>")
            for n, b in _tree(root).items()
            if not (n == "log" or n.endswith("/log") or _STAMP.search(n))}


@pytest.fixture
def cpu(monkeypatch):
    """Both packages on the CPU, MC_HOST_COUNT unset: jax_host_main sets it
    for the JAX package's runs alone, so that the port counts on its device
    path."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_HOST_COUNT", raising=False)


def _sam_line(flag, rname, rnext, seq):
    return (f"q\t{flag}\t{rname}\t1\t60\t{len(seq)}M\t{rnext}\t1\t0\t"
            f"{seq}\tIIII\n")


@pytest.fixture
def sam(tmp_path):
    """Records that pass each filter, interleaved with decoys that one
    flag or contig rule rejects, over five contigs."""
    rng = np.random.default_rng(5)
    path = tmp_path / "all.sam"
    with open(path, "w") as f:
        f.write("@HD\tVN:1.6\n@SQ\tSN:c0\tLN:1000\n")
        for i in range(300):
            a, b = (f"c{int(x)}" for x in rng.integers(0, 5, 2))
            seq = "".join(rng.choice(list("ACGT"), 12))
            flag = int(rng.choice([0x0, 0x1, 0x5, 0x5 | 0x40, 0x5 | 0x100,
                                   0x5 | 0x800, 0x5 | 0x8, 0x1 | 0x4,
                                   0x1 | 0x800, 0x1 | 0x2, 0x41, 0x81]))
            rnext = "=" if i % 17 == 0 else b
            f.write(_sam_line(flag, a, rnext, seq))
    return str(path)


def test_select_mate_mapped_reads_matches_jax(sam, tmp_path):
    n_t = TP.select_mate_mapped_reads(sam, str(tmp_path / "t.fasta"))
    n_j = JP.select_mate_mapped_reads(sam, str(tmp_path / "j.fasta"))
    assert n_t == n_j > 0
    assert (tmp_path / "t.fasta").read_bytes() == \
        (tmp_path / "j.fasta").read_bytes()


def test_contact_map_matches_jax(sam, tmp_path):
    got = list(TP.different_contig_pairs(sam))
    assert got == list(JP.different_contig_pairs(sam))
    assert got and all(f[2] != f[6] and f[6] != "=" for f in got)
    TP.aggregate_contact_map(iter(got), str(tmp_path / "t.txt"))
    JP.aggregate_contact_map(iter(got), str(tmp_path / "j.txt"))
    text = (tmp_path / "t.txt").read_text()
    assert text == (tmp_path / "j.txt").read_text()
    assert text.startswith("v1\tv2\thic_w\n") and text.count("\n") > 2


@pytest.fixture
def stub_tools(tmp_path, monkeypatch):
    bindir = tmp_path / "bin"
    bindir.mkdir()
    (bindir / "bwa").write_text(BWA_STUB)
    (bindir / "samtools").write_text("#!/bin/sh\nexit 0\n")
    for name in ("bwa", "samtools"):
        (bindir / name).chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}:{os.environ['PATH']}")
    return bindir


@pytest.fixture(scope="module")
def hic_data(tmp_path_factory):
    """400 WGS reads of 60 bp from a 2 kbp genome (half reverse-
    complemented), a 120 bp gene, and 30 Hi-C pairs of 50 bp."""
    tmp = tmp_path_factory.mktemp("hic")
    rng = np.random.default_rng(13)
    g = "".join(rng.choice(list("ACGT"), 2000))
    with open(tmp / "wgs.fastq", "w") as f:
        for i in range(400):
            s = int(rng.integers(0, len(g) - 60))
            r = g[s:s + 60]
            if rng.random() < 0.5:
                r = reverse_complement(r)
            f.write(f"@r{i}\n{r}\n+\n{'I' * 60}\n")
    (tmp / "gene.fasta").write_text(f">gene\n{g[800:920]}\n")
    with open(tmp / "hic_1.fastq", "w") as f1, \
            open(tmp / "hic_2.fastq", "w") as f2:
        for i, s in enumerate(rng.integers(0, 1700, size=30)):
            f1.write(f"@h{i}\n{g[s:s + 50]}\n+\n{'I' * 50}\n")
            f2.write(f"@h{i}\n{reverse_complement(g[s + 200:s + 250])}\n+\n"
                     f"{'I' * 50}\n")
    return {n: str(tmp / n) for n in ("wgs.fastq", "gene.fasta",
                                      "hic_1.fastq", "hic_2.fastq")}


def _pipeline(mod, d: dict, wd: str, **kw) -> None:
    """One package's pipeline; the JAX package's counts on the host (as
    jax_host_main), the port's on its device path."""
    with mock.patch.dict(os.environ,
                         {"MC_HOST_COUNT": "1"} if mod is JP else {}):
        mod.run_hic_pipeline([d["wgs.fastq"]], d["gene.fasta"], wd,
                             d["hic_1.fastq"], d["hic_2.fastq"], k=21,
                             coverage=2, max_radius=1000, **kw)


def test_run_hic_pipeline_matches_jax(hic_data, stub_tools, tmp_path, cpu):
    _pipeline(JP, hic_data, str(tmp_path / "jax"))
    _pipeline(TP, hic_data, str(tmp_path / "port"))
    got = _masked(str(tmp_path / "port"))
    assert got == _masked(str(tmp_path / "jax"))
    for p in ("output/1/merged/graph.txt", "output/1/merged/seqs.fasta",
              "1/selected_reads.fasta", "output/2/merged/graph.txt",
              "2/hic_map.txt", "workDir/2/SUCCESS", "workDir/2/out.properties"):
        assert p in got, p
    lines = got["2/hic_map.txt"].decode().splitlines()
    assert lines[0] == "v1\tv2\thic_w" and len(lines) > 1
    assert got["1/selected_reads.fasta"].count(b">") == 10


@pytest.mark.parametrize("first_pass_only", [False, True])
def test_cli_matches_jax(first_pass_only, hic_data, stub_tools, tmp_path,
                         cpu):
    extra = ["--first-pass-only", "true"] if first_pass_only else []
    for name, main in (("jax", jax_host_main), ("port", port_main)):
        assert main(["-t", "hic-pipeline", "-k", "21",
                     "-i", hic_data["wgs.fastq"],
                     "--seq", hic_data["gene.fasta"],
                     "--hi-c-r1", hic_data["hic_1.fastq"],
                     "--hi-c-r2", hic_data["hic_2.fastq"],
                     "--coverage", "2", "--maxradius", "100",
                     "--work-dir", str(tmp_path / name), *extra]) == 0
    got = _masked(str(tmp_path / "port"))
    assert got == _masked(str(tmp_path / "jax"))
    assert got["out.properties"] == b"tool=hic-pipeline\n"
    assert "SUCCESS" in got and "output/1/merged/seqs.fasta" in got
    assert ("2/hic_map.txt" in got) != first_pass_only
    assert ("workDir/2/SUCCESS" in got) != first_pass_only


def test_missing_bwa_fails_like_jax(hic_data, tmp_path, cpu, monkeypatch):
    """Without bwa on PATH pass 1 runs, then both packages raise the same
    error; the CLI turns it into rc 1 without SUCCESS."""
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    errors = []
    for name, mod in (("jax", JP), ("port", TP)):
        wd = str(tmp_path / name)
        with pytest.raises(Exception) as e:
            _pipeline(mod, hic_data, wd)
        assert type(e.value).__name__ == "ExecutionFailedException"
        errors.append(str(e.value).replace(wd, "<root>"))
        assert os.path.exists(os.path.join(wd, "output/1/merged/seqs.fasta"))
    assert errors[0] == errors[1]
    assert errors[1].startswith("bwa/samtools not found on PATH")
    wd = tmp_path / "cli"
    assert port_main(["-t", "hic-pipeline", "-k", "21",
                      "-i", hic_data["wgs.fastq"],
                      "--seq", hic_data["gene.fasta"],
                      "--hi-c-r1", hic_data["hic_1.fastq"],
                      "--hi-c-r2", hic_data["hic_2.fastq"],
                      "--coverage", "2", "--maxradius", "100",
                      "--work-dir", str(wd)]) == 1
    assert not os.path.exists(wd / "SUCCESS")
    assert not os.path.exists(wd / "2" / "hic_map.txt")
    with pytest.raises(ExecutionFailedException):
        _pipeline(TP, hic_data, str(tmp_path / "again"))


def test_failed_pass_one_fails_like_jax(hic_data, tmp_path, cpu):
    """A missing WGS file fails pass 1 in both packages."""
    d = {**hic_data, "wgs.fastq": str(tmp_path / "nope.fastq")}
    for mod in (JP, TP):
        with pytest.raises(Exception, match="pass-1 environment-finder "
                                            "failed") as e:
            _pipeline(mod, d, str(tmp_path / mod.__name__))
        assert type(e.value).__name__ == "ExecutionFailedException"
