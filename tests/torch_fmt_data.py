"""Shared inputs of test_torch_fmt.py and test_torch_fmt_tools.py.

Seeded genomes and reads, the `fmt_data` fixture with the three FMT tools'
inputs, and run_both, which runs one tool through both packages'
runner.main and compares the outputs byte for byte. pytest collects no test
here; the test modules import the fixture by name.
"""
import os

import numpy as np
import pytest

from metacherchant_tpu.dna import reverse_complement
from metacherchant_tpu.runner import main as jax_main
from metacherchant_tpu_torch.runner import main as port_main

STEMS = ("settle", "not_settle", "stay", "gone", "came_from_donor",
         "came_from_baseline", "came_from_both", "came_itself")


def tree(root) -> dict[str, bytes]:
    """Every file under `root`, by relative path, with its bytes."""
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def random_genome(rng, n: int) -> str:
    """n random bases."""
    return "".join(rng.choice(list("ACGT"), n))


def sample_reads(rng, g: str, n: int, length: int) -> list[str]:
    """n reads of `length` from g, half of them reverse-complemented."""
    out = []
    for _ in range(n):
        i = int(rng.integers(0, len(g) - length))
        r = g[i:i + length]
        out.append(reverse_complement(r) if rng.random() < 0.5 else r)
    return out


def write_fastq(path, reads) -> str:
    with open(path, "w") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    return str(path)


@pytest.fixture(scope="module")
def fmt_data(tmp_path_factory):
    """Donor, before and after metagenomes (reads of 80 bp from 400 bp
    genomes, the after one sharing a piece with each of the others), the
    classified read bins of the FMT script and two sequences."""
    tmp = tmp_path_factory.mktemp("fmt")
    rng = np.random.default_rng(11)
    donor, before, new = (random_genome(rng, 400) for _ in range(3))
    after = donor[:150] + before[200:350] + new[:100]
    for name, g in (("donor", donor), ("before", before), ("after", after)):
        write_fastq(tmp / f"{name}.fastq", sample_reads(rng, g, 60, 80))
    src = {"settle": donor[:200], "not_settle": donor[200:],
           "stay": before[150:], "gone": before[:250],
           "came_from_donor": after[:150], "came_from_baseline": after[150:300],
           "came_from_both": after[100:200], "came_itself": after[300:]}
    bins = tmp / "bins"
    bins.mkdir()
    for stem in STEMS:
        for x in ("1", "2", "s"):
            write_fastq(bins / f"{stem}_{x}.fastq",
                        sample_reads(rng, src[stem], 8, 80))
    (tmp / "seqs.fasta").write_text(
        f">s0\n{after[20:130]}\n>s1\n{after[260:380]}\n>s2\n"
        f"{random_genome(rng, 90)}\n")
    return tmp


def fmt_args(data, tool: str, k: int, out, wd, *extra) -> list[str]:
    args = ["-t", tool, "-k", str(k), "-i", str(data / "bins"),
            "--ext", "fastq", "-o", str(out), "--work-dir", str(wd)]
    if tool == "recipient-visualiser":
        return args + ["-after", str(data / "after.fastq"),
                       "--seq", str(data / "seqs.fasta"), *extra]
    return args + ["-donor", str(data / "donor.fastq"),
                   "-before", str(data / "before.fastq"),
                   "-after", str(data / "after.fastq"), *extra]


def run_both(data, tool, k, tmp_path, *extra) -> dict[str, bytes]:
    """Run `tool` through the JAX package and the port; their outputs must
    be byte-identical. Returns the port's."""
    for main, tag in ((jax_main, "j"), (port_main, "t")):
        assert main(fmt_args(data, tool, k, tmp_path / f"o{tag}",
                             tmp_path / f"w{tag}", *extra)) == 0
    got, want = tree(tmp_path / "ot"), tree(tmp_path / "oj")
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name
    return got
