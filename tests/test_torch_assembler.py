"""The port's read filter and environment-assembler-finder against the JAX
package.

filter_reads_file, which sweeps a batch of reads at a time, against the JAX
package's read-at-a-time form: reads of mixed lengths (shorter than k,
exactly k, k + 1, longer), N bases, -pf 1/50/100, the exact and both hashed
regimes, FASTQ (native parser) and FASTA (Python readers), and batches of
1, of 7 (ending mid-file) and the default. Then the tool end to end with a
stub assembler on disk (spades and megahit routes): output trees and
workDirs compared with the JAX package's, --start/--finish bounds, a
--continue resume, and the multi-record abort. Inputs are made from a seed
with numpy; the tolerance is zero.
"""
import os
import re
import sys
from unittest import mock

import numpy as np
import pytest

from metacherchant_tpu.algo import filter as JF
from metacherchant_tpu.dna import normalize
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.algo import filter as TF
from metacherchant_tpu_torch.runner import main as port_main


def _tree(root) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _genome(rng, n: int) -> str:
    return "".join(rng.choice(list("ACGT"), n))


@pytest.fixture(scope="module")
def filter_data(tmp_path_factory):
    """A 1 kbp genome, its k-mers over [300, 600) as the environment for k
    in (21, 33), and 400 reads: lengths k-3 .. 90 with k and k + 1 often,
    from the genome (half reverse-complemented) or random, one in six with
    an N."""
    tmp = tmp_path_factory.mktemp("filter")
    rng = np.random.default_rng(17)
    g = _genome(rng, 1000)
    reads = []
    for i in range(400):
        k = (21, 33)[i % 2]
        n = int(rng.choice([k - 3, k, k + 1, k + 2, 40, 60, 90]))
        if rng.random() < 0.8:
            s = int(rng.integers(200, 700 - n))
            r = g[s:s + n]
            if rng.random() < 0.5:
                r = r[::-1].translate(str.maketrans("ACGT", "TGCA"))
        else:
            r = _genome(rng, n)
        if i % 6 == 0:
            j = int(rng.integers(0, n))
            r = r[:j] + "N" + r[j + 1:]
        reads.append(r)
    fq = tmp / "reads.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    fa = tmp / "reads.fasta"
    fa.write_text("".join(f">r{i}\n{r}\n" for i, r in enumerate(reads)))
    envs = {k: sorted({normalize(g[j:j + k]) for j in range(300, 600 - k)})
            for k in (21, 33)}
    return {"fastq": str(fq), "fasta": str(fa)}, envs


@pytest.mark.parametrize("k,hasher", [(21, None), (21, "poly"),
                                      (33, "poly"), (33, "fnv1a")])
@pytest.mark.parametrize("pf", [1, 50, 100])
@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_filter_matches_jax(k, hasher, pf, fmt, filter_data, tmp_path):
    files, envs = filter_data
    tc = TF.SubgraphChecker(envs[k], k, hasher)
    jc = JF.SubgraphChecker(envs[k], k, hasher)
    assert np.array_equal(tc._keys, jc._keys)
    n_port = TF.filter_reads_file(files[fmt], tc, str(tmp_path / "t"), 3, pf)
    n_jax = JF.filter_reads_file(files[fmt], jc, str(tmp_path / "j"), 3, pf)
    got = (tmp_path / "t" / "cutReads3.fasta").read_bytes()
    assert n_port == n_jax and got == \
        (tmp_path / "j" / "cutReads3.fasta").read_bytes()
    # at -pf 100 a read needs n-k+1 hits among the n-k windows tested
    assert (0 < n_port < 400) if pf < 100 else n_port == 0
    headers = got.decode().splitlines()[::2]
    assert headers == [f">3|{i + 1}" for i in range(n_port)]


@pytest.mark.parametrize("batch", [1, 7, 64])
def test_filter_batch_boundaries(batch, filter_data, tmp_path, monkeypatch):
    """Batches of 1, and of 7 and 64 that end mid-file, give the bytes of
    the JAX package's read-at-a-time filter; so does the Python reader
    path (MC_NATIVE_IO=0)."""
    files, envs = filter_data
    jc = JF.SubgraphChecker(envs[21], 21, None)
    JF.filter_reads_file(files["fastq"], jc, str(tmp_path / "j"), 0, 10)
    want = (tmp_path / "j" / "cutReads0.fasta").read_bytes()
    tc = TF.SubgraphChecker(envs[21], 21, None)
    TF.filter_reads_file(files["fastq"], tc, str(tmp_path / "t"), 0, 10,
                         batch=batch)
    assert (tmp_path / "t" / "cutReads0.fasta").read_bytes() == want
    monkeypatch.setenv("MC_NATIVE_IO", "0")
    TF.filter_reads_file(files["fastq"], tc, str(tmp_path / "p"), 0, 10,
                         batch=batch)
    assert (tmp_path / "p" / "cutReads0.fasta").read_bytes() == want
    assert want.count(b">") > 10


def test_filter_edge_reads(tmp_path):
    """A read of exactly k bases is never kept (its one window is never
    tested), k + 1 bases with one hit is; shorter reads are skipped; N
    counts as A and is written as A; an empty environment keeps nothing."""
    k = 5
    env = ["ACGTA", "CCCCA"]
    reads = ["ACGTA", "ACGTAG", "ACG", "NCGTAT", "CCCCAT", "GGGGGG"]
    fq = tmp_path / "r.fastq"
    fq.write_text("".join(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n"
                          for i, r in enumerate(reads)))
    for mod, name in ((TF, "t"), (JF, "j")):
        mod.filter_reads_file(str(fq), mod.SubgraphChecker(env, k, None),
                              str(tmp_path / name), 0, 1)
        mod.filter_reads_file(str(fq), mod.SubgraphChecker([], k, None),
                              str(tmp_path / name / "empty"), 0, 1)
    got = (tmp_path / "t" / "cutReads0.fasta").read_text()
    assert got == (tmp_path / "j" / "cutReads0.fasta").read_text()
    assert got == ">0|1\nACGTAG\n>0|2\nACGTAT\n>0|3\nCCCCAT\n"
    assert (tmp_path / "t" / "empty" / "cutReads0.fasta").read_text() == ""
    assert (tmp_path / "j" / "empty" / "cutReads0.fasta").read_text() == ""


# ---------------------------------------------------------------------------
# the tool end to end
# ---------------------------------------------------------------------------

SPADES_STUB = (
    "import sys, os\n"
    "args = sys.argv[1:]\n"
    "cut = args[args.index('--12') + 1]\n"
    "out = args[args.index('-o') + 1]\n"
    "os.makedirs(out, exist_ok=True)\n"
    "data = open(cut).read()\n"
    "open(os.path.join(out, 'contigs.fasta'), 'w').write(data)\n"
    "print('stub spades done')\n")

MEGAHIT_STUB = (
    "import sys, os\n"
    "args = sys.argv[1:]\n"
    "cut = args[args.index('--12') + 1]\n"
    "out = args[args.index('-o') + 1]\n"
    "os.makedirs(out, exist_ok=True)\n"
    "data = open(cut).read()\n"
    "open(os.path.join(out, 'final.contigs.fa'), 'w').write(data)\n")


@pytest.fixture(scope="module")
def asm(tmp_path_factory):
    """300 reads of 150 bp from a 3 kbp genome in two files, a gene, a
    two-gene file, and both stub assemblers."""
    tmp = tmp_path_factory.mktemp("asm")
    rng = np.random.default_rng(11)
    g = _genome(rng, 3000)
    for part in range(2):
        with open(tmp / f"reads{part}.fastq", "w") as f:
            for i in range(150):
                s = int(rng.integers(0, 2850))
                f.write(f"@r{i}\n{g[s:s + 150]}\n+\n{'I' * 150}\n")
    (tmp / "gene.fasta").write_text(f">gene\n{g[500:700]}\n")
    (tmp / "genes.fasta").write_text(f">a\n{g[500:700]}\n>b\n{g[900:1000]}\n")
    (tmp / "spades").mkdir()
    (tmp / "spades" / "spades.py").write_text(SPADES_STUB)
    (tmp / "megahit").mkdir()
    stub = tmp / "megahit" / "megahit"
    stub.write_text(f"#!{sys.executable}\n" + MEGAHIT_STUB)
    stub.chmod(0o755)
    return tmp


def _asm_args(d, root: str, assembler: str = "spades",
              seq: str = "gene.fasta") -> list[str]:
    return ["-t", "environment-assembler-finder", "-k", "21",
            "-i", str(d / "reads0.fastq"), str(d / "reads1.fastq"),
            "--seq", str(d / seq), "-o", os.path.join(root, "out"),
            "--maxradius", "100", "--coverage", "2",
            "--assembler", assembler, "--assemblerpath", str(d / assembler),
            "-pf", "50", "--work-dir", os.path.join(root, "wd")]


_STAMP = re.compile(r"log_\d{8}_\d{6}")


def _outputs(root: str) -> tuple[dict[str, bytes], list[str], dict]:
    """The output tree, the workDir's file names (stamps masked) and its
    markers and properties (root masked)."""
    wd = _tree(os.path.join(root, "wd"))
    names = sorted({_STAMP.sub("log_<stamp>", n) for n in wd})
    kept = {n: b.replace(root.encode(), b"<root>") for n, b in wd.items()
            if n.startswith("SUCCESS") or n.endswith(".properties")}
    return _tree(os.path.join(root, "out")), names, kept


def jax_host_main(argv: list[str]) -> int:
    """The JAX package's CLI with MC_HOST_COUNT set for this run alone: it
    counts on the host, sparing its compile time on every input shape (the
    same maps), while the port's runs count on the port's device path."""
    with mock.patch.dict(os.environ, MC_HOST_COUNT="1"):
        return jax_main(argv)


def _both(tmp_path, *extra: str, **kw) -> dict:
    got = {}
    for name, main in (("jax", jax_host_main), ("port", port_main)):
        root = str(tmp_path / name)
        assert main(_asm_args(kw["d"], root, kw.get("assembler", "spades"),
                              kw.get("seq", "gene.fasta")) + list(extra)) == 0
        got[name] = _outputs(root)
    assert got["port"] == got["jax"]
    return got["port"]


@pytest.fixture
def cpu(monkeypatch):
    """Both packages on the CPU, MC_HOST_COUNT unset: jax_host_main sets it
    for the JAX package's runs alone, so that the port counts on its device
    path."""
    monkeypatch.setenv("MC_PLATFORM", "cpu")
    monkeypatch.delenv("MC_HOST_COUNT", raising=False)


@pytest.mark.parametrize("assembler", ["spades", "megahit"])
def test_cli_matches_jax(assembler, asm, tmp_path, cpu):
    out, names, kept = _both(tmp_path, d=asm, assembler=assembler)
    for i in (0, 1):
        assert out[f"cutReads{i}.fasta"].count(b">") > 0
        assert f"contigs{i}.fasta" in out
        assert f"result/cutReads{i}.fasta" in out
    assert len(out["result/graph.txt"].split(b"\n")[0].split()[0]) == 55
    assert "graph.txt" in out and "graph.gfa" in out
    for m in ("SUCCESS", "SUCCESS.environment", "SUCCESS.assembly",
              "SUCCESS.re-environment", "out.properties", "in.properties"):
        assert m in kept
    assert kept["out.properties"] == \
        b"tool=environment-assembler-finder\n"


def test_start_finish_and_continue_match_jax(asm, tmp_path, cpu):
    """--finish environment runs stage 1 alone; --start assembly then runs
    stages 2-3 and completes the run; --continue then skips it whole. A
    run stopped after --finish assembly resumes at stage 3 under
    --continue."""
    out, _, kept = _both(tmp_path, "--finish", "environment", d=asm)
    assert "cutReads0.fasta" in out and "contigs0.fasta" not in out
    assert "SUCCESS.environment" in kept and "SUCCESS" not in kept
    assert "SUCCESS.assembly" not in kept
    out, _, kept = _both(tmp_path, "--start", "assembly", d=asm)
    assert "result/graph.txt" in out and "SUCCESS" in kept
    _both(tmp_path, "--continue", d=asm)
    for name in ("jax", "port"):
        assert "Stage environment-assembler-finder already done" in \
            open(tmp_path / name / "wd" / "log").read()

    resume = tmp_path / "resume"
    out, _, kept = _both(resume, "--finish", "assembly", d=asm)
    assert "contigs0.fasta" in out and "result/graph.txt" not in out
    out, _, kept = _both(resume, "--continue", d=asm)
    assert "result/graph.txt" in out and "SUCCESS" in kept
    for name in ("jax", "port"):
        log = open(resume / name / "wd" / "log").read()
        assert "Stage environment already done" in log
        assert "Stage assembly already done" in log
        assert "Running stage re-environment" in log


def test_multi_record_aborts_like_jax(asm, tmp_path, cpu):
    out, _, kept = _both(tmp_path, d=asm, seq="genes.fasta")
    assert out == {}
    assert "SUCCESS" in kept
    for name in ("jax", "port"):
        assert "works only with one input sequence" in \
            open(tmp_path / name / "wd" / "log").read()


def test_failed_assembler_fails_stage_three_like_jax(asm, tmp_path, cpu):
    """An assembler path without the assembler: stage 2 logs and goes on,
    stage 3 finds no contigs and fails the run."""
    for name, main in (("jax", jax_host_main), ("port", port_main)):
        root = str(tmp_path / name)
        args = _asm_args(asm, root, "megahit")
        args[args.index("--assemblerpath") + 1] = str(tmp_path)
        assert main(args) == 1
        log = open(os.path.join(root, "wd", "log")).read()
        assert "Could not load reads from" in log
        assert os.path.exists(os.path.join(root, "wd", "SUCCESS.assembly"))
        assert not os.path.exists(os.path.join(root, "wd", "SUCCESS"))
    assert _tree(tmp_path / "port" / "out") == _tree(tmp_path / "jax" / "out")
