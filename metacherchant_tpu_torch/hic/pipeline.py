"""Hi-C pipeline: two-pass environment extraction with Hi-C read linkage.

Reimplements Hi-C_pipline/HiCEnvironmentFinder.sh:1-77 as a Python pipeline:

  pass 1: environment-finder (merge=true, chunklength=10) -> seqs.fasta
  bwa index + bwa mem (Hi-C read pairs vs seqs.fasta)
  samtools view -f 0x5 -F 0x908 -> selected_reads.fasta (mate-mapped reads)
  pass 2: environment-finder with --hicseq selected_reads.fasta
  bwa + samtools -f 1 -F 2060, keep different-contig pairs
  contact aggregation -> hic_map.txt (Hi-C_pipline/hic_map.py:9-21)

bwa/samtools are external dependencies (as in the reference); when absent the
pipeline stops after pass 1 with a clear message. Carried over from
metacherchant_tpu/hic/pipeline.py; both passes run this package's
environment-finder in-process.
"""
from __future__ import annotations

import os
import shutil
import subprocess

from ..tool import ExecutionFailedException


def have_external_tools() -> bool:
    return shutil.which("bwa") is not None and shutil.which("samtools") is not None


def run_env_pass(reads, seq, output, work_dir, k, coverage, max_radius,
                 hicseq=None) -> int:
    from ..runner import main as runner_main
    args = ["-t", "environment-finder", "-k", str(k),
            "--coverage", str(coverage), "--seq", seq,
            "-o", output, "--work-dir", work_dir,
            "--maxradius", str(max_radius), "--bothdirs", "False",
            "--chunklength", "10", "--merge", "true", "-i", *reads]
    if hicseq:
        args += ["--hicseq", hicseq]
    return runner_main(args)


def _run(cmd: list[str], **kw) -> subprocess.CompletedProcess:
    return subprocess.run(cmd, check=True, **kw)


def sam_records(path: str):
    for line in open(path):
        if line.startswith("@"):
            continue
        yield line.rstrip("\n").split("\t")


def select_mate_mapped_reads(sam_path: str, out_fasta: str) -> int:
    """samtools view -f 0x5 -F 0x908 | awk '>1\\nSEQ' equivalent
    (HiCEnvironmentFinder.sh:64-65): paired (0x1) + mate... flags: require
    0x5 (paired + ...), exclude 0x908 (secondary/supplementary/unmapped?)."""
    n = 0
    with open(out_fasta, "w") as out:
        for f in sam_records(sam_path):
            flag = int(f[1])
            if (flag & 0x5) == 0x5 and (flag & 0x908) == 0:
                out.write(f">1\n{f[9]}\n")
                n += 1
    return n


def different_contig_pairs(sam_path: str):
    """samtools view -f 1 -F 2060 + awk '($3!=$7 && $7!="=")'
    (HiCEnvironmentFinder.sh:73-74)."""
    for f in sam_records(sam_path):
        flag = int(f[1])
        if (flag & 1) == 1 and (flag & 2060) == 0 and f[2] != f[6] and f[6] != "=":
            yield f


def aggregate_contact_map(records, out_path: str) -> None:
    """hic_map.py:9-21: count contig pairs (sorted tuple), emit count // 2."""
    data: dict[tuple[str, str], int] = {}
    for f in records:
        key = tuple(sorted((f[2], f[6])))
        data[key] = data.get(key, 0) + 1
    with open(out_path, "w") as out:
        out.write("v1\tv2\thic_w\n")
        for (a, b), v in data.items():
            out.write(f"{a}\t{b}\t{v // 2}\n")


def run_hic_pipeline(reads: list[str], seq: str, work_dir: str,
                     hic_r1: str, hic_r2: str, k: int = 31, coverage: int = 5,
                     max_radius: int = 100000, threads: int = 12,
                     first_pass_only: bool = False) -> None:
    wd = work_dir.rstrip("/") + "/"
    os.makedirs(wd + "1", exist_ok=True)
    os.makedirs(wd + "2", exist_ok=True)

    rc = run_env_pass(reads, seq, wd + "output/1", wd + "workDir/1",
                      k, coverage, max_radius)
    if rc != 0:
        raise ExecutionFailedException("pass-1 environment-finder failed")
    seqs1 = wd + "output/1/merged/seqs.fasta"

    if first_pass_only:
        return

    if not have_external_tools():
        raise ExecutionFailedException(
            "bwa/samtools not found on PATH; pass 1 complete at "
            f"{seqs1} -- run the alignment steps externally "
            "(HiCEnvironmentFinder.sh:62-67) and re-invoke")

    _run(["bwa", "index", seqs1])
    with open(wd + "1/all_hic_reads.sam", "w") as out:
        _run(["bwa", "mem", "-t", str(threads), seqs1, hic_r1, hic_r2],
             stdout=out)
    select_mate_mapped_reads(wd + "1/all_hic_reads.sam",
                             wd + "1/selected_reads.fasta")

    rc = run_env_pass(reads, seq, wd + "output/2", wd + "workDir/2",
                      k, coverage, max_radius,
                      hicseq=wd + "1/selected_reads.fasta")
    if rc != 0:
        raise ExecutionFailedException("pass-2 environment-finder failed")
    seqs2 = wd + "output/2/merged/seqs.fasta"

    _run(["bwa", "index", seqs2])
    with open(wd + "2/filteredHiC_2.sam", "w") as out:
        _run(["bwa", "mem", "-t", str(threads), seqs2, hic_r1, hic_r2],
             stdout=out)
    aggregate_contact_map(
        different_contig_pairs(wd + "2/filteredHiC_2.sam"),
        wd + "2/hic_map.txt")
