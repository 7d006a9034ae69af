"""Tests of the port that need a CUDA GPU: the extraction kernel against its
plain torch version on the card, and the main path on the card against the
host oracle and against the same run on the CPU.

They skip where torch sees no CUDA device. This file imports no JAX, so it
also runs on a machine without it (tests/conftest.py imports JAX, hence
--noconftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from metacherchant_tpu_torch.counting import (count_kmers_device,
                                              count_kmers_host)
from metacherchant_tpu_torch.ops import extract_cuda
from metacherchant_tpu_torch.ops.kmers import SENTINEL
from metacherchant_tpu_torch.ops.sortcount import append_codes
from metacherchant_tpu_torch.runner import main as port_main

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _codes(seed: int, rows: int, length: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (rows, length)).astype(np.int8)
    codes[rng.random((rows, length)) < 0.03] = -1
    tail = rng.integers(0, length + 1, rows)
    codes[np.arange(length)[None, :] >= tail[:, None]] = -1
    return codes


def _write_fastq(path, seed: int, n: int = 3000) -> None:
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), 20_000))
    with open(path, "w") as f:
        for i in range(n):
            ln = 300 if i % 97 == 0 else 150
            s = int(rng.integers(0, len(genome) - ln))
            r = genome[s:s + ln]
            if i % 11 == 0:
                p = int(rng.integers(0, ln - 2))
                r = r[:p] + "NN" + r[p + 2:]
            f.write(f"@r{i}\n{r}\n+\n{'I' * ln}\n")


@pytest.mark.parametrize("k", [1, 3, 15, 16, 17, 21, 31])
def test_kernel_matches_plain_on_card(cuda, k):
    """777 rows: not a multiple of the 128-thread block."""
    codes = _codes(k, 777, 300)
    n = 777 * (300 - k + 1)
    got = torch.empty(n, dtype=torch.int64, device=cuda)
    want = torch.empty_like(got)
    before = extract_cuda.LAUNCHES
    extract_cuda.extract_append(torch.from_numpy(codes).to(cuda), k, got)
    assert extract_cuda.LAUNCHES == before + 1
    extract_cuda.extract_append_plain(torch.from_numpy(codes).to(cuda), k,
                                      want)
    on_cpu = torch.empty(n, dtype=torch.int64)
    extract_cuda.extract_append(torch.from_numpy(codes), k, on_cpu)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), on_cpu)


def test_append_writes_only_its_lanes(cuda):
    k = 21
    codes = torch.from_numpy(_codes(5, 300, 100)).to(cuda)
    buf = torch.full((300 * 80 + 100,), 7, dtype=torch.int64, device=cuda)
    off = append_codes(buf, 40, codes, k)
    torch.cuda.synchronize()
    host = buf.cpu()
    assert off == 40 + 300 * 80
    assert torch.all(host[:40] == 7) and torch.all(host[off:] == 7)
    assert torch.any(host[40:off] == SENTINEL)


def test_count_on_card_matches_host(cuda, tmp_path):
    path = str(tmp_path / "reads.fastq")
    _write_fastq(path, 1)
    for k in (21, 31):
        got = count_kmers_device([path], k, batch=256, max_len=128,
                                 table_log2=12, device=cuda)
        want = count_kmers_host([path], k)
        assert np.array_equal(got.keys, want.keys)
        assert np.array_equal(got.counts, want.counts)


def test_cli_on_card_matches_cpu(cuda, tmp_path, monkeypatch):
    reads = str(tmp_path / "reads.fastq")
    _write_fastq(reads, 2)
    genes = tmp_path / "genes.fasta"
    with open(reads) as fh:
        fh.readline()
        seq = fh.readline().strip()
    genes.write_text(f">g1\n{seq.replace('N', 'A')}\n")
    trees = {}
    for platform in ("cuda", "cpu"):
        monkeypatch.setenv("MC_PLATFORM", platform)
        out = tmp_path / f"out_{platform}"
        assert port_main(["-t", "environment-finder", "-k", "31",
                          "-i", reads, "--seq", str(genes), "-o", str(out),
                          "--coverage", "2", "--maxradius", "300",
                          "--work-dir", str(tmp_path / f"wd_{platform}")]) == 0
        trees[platform] = {
            os.path.relpath(os.path.join(d, n), out): Path(d, n).read_bytes()
            for d, _, names in os.walk(out) for n in names}
    assert trees["cuda"] and trees["cuda"] == trees["cpu"]
