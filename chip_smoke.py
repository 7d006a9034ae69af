"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives metacherchant_tpu_torch's paths (environment-finder in the exact and
hashed regimes, kmer-counter -> reads-classifier, `sort` counting engine) at
a real data size and checks them:

  1. device         the card's name and power limit;
  2. build          the CUDA extraction kernel (nvcc, sm_90a) and the native
                    host libraries, all from this checkout's sources;
  3. kernel         the kernel's append against its plain torch version on
                    the card, bit for bit, with both times: counting's
                    batches for several k, and the classifier's 0-padded
                    (8192, 150) batch at k=31;
  4. oracle         count_kmers_device on the card against the host oracle
                    count_kmers_host, and a small environment-finder run on
                    the card against the same run on the CPU, byte for byte;
  5. slice          environment-finder at k=31 on a synthetic metagenome made
                    from --seed (20 genomes of 250 kbp, 150 bp reads at 20x
                    with 0.8% substitutions, three 1.5 kbp genes), counting
                    the kernel's launches during the run;
  6. hashed ops     hashed keys (poly, FNV-1a; k = 32, 55, 63) on the card
                    against the CPU, and KmerMap.lookup_device on the card
                    against the host get_many, bit for bit, with times;
  7. hashed oracle  k=55 counting on the card against the CPU and the host
                    oracle, and a small environment-finder -k 55 --hash fnv1a
                    run on the card against the same run on the CPU;
  8. hashed slice   environment-finder -k 55 on the data of phase 5;
  9. classify slice kmer-counter -k 31 on the data of phase 5, then
                    reads-classifier on its dump for 333,334 read pairs (half
                    from those genomes, half from 20 others), with the host
                    coverage and with MC_DEVICE_CLASSIFY, bins compared.

Every phase prints its own lines and its seconds; any failure exits
non-zero. The last two lines are the kernels' JSON record and the device
JSON record. Imports no JAX and nothing of the JAX package. Needs one CUDA
device: without one it exits 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

KERNEL_KS = (3, 16, 17, 21, 31)
MAIN_K = 31
BATCH, LEN = 4096, 256  # counting's default (B, L) batch
HASH_KS = (32, 55, 63)
HASH_K = 55
CLASSIFY_PAIRS = 333_334
CLASSIFY_BATCH = 8192   # tools/reads_classifier.py
READ_LEN = 150
LOOKUP_KEYS, LOOKUP_QUERIES = 20_000_000, 10_000_000


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def write_fastq(path: str, codes: np.ndarray) -> None:
    """(n, L) int8 codes (A=0,G=1,C=2,T=3, N=-1) -> FASTQ, one vectorized
    record matrix: '@r<i>' headers, quality 'I'."""
    n, L = codes.shape
    width = len(str(max(n - 1, 1)))
    pw = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    digits = (np.arange(n, dtype=np.int64)[:, None] // pw) % 10 + ord("0")
    rec = np.empty((n, 3 + width + L + 3 + L + 1), np.uint8)
    rec[:, 0], rec[:, 1] = ord("@"), ord("r")
    rec[:, 2:2 + width] = digits
    rec[:, 2 + width] = ord("\n")
    o = 3 + width
    rec[:, o:o + L] = np.frombuffer(b"NAGCT", np.uint8)[codes + 1]
    rec[:, o + L:o + L + 3] = np.frombuffer(b"\n+\n", np.uint8)
    rec[:, o + L + 3:o + 2 * L + 3] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)


def sample_reads(rng, genomes: np.ndarray, n: int, length: int,
                 sub_rate: float) -> np.ndarray:
    """n reads of `length` from random genomes and offsets, half reverse
    complemented, with uniform substitutions."""
    g = rng.integers(0, genomes.shape[0], n)
    s = rng.integers(0, genomes.shape[1] - length + 1, n)
    reads = genomes[g[:, None], s[:, None] + np.arange(length)]
    flip = rng.random(n) < 0.5
    reads[flip] = 3 - reads[flip, ::-1]
    sub = rng.random(reads.shape) < sub_rate
    reads[sub] = (reads[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
    return reads.astype(np.int8)


def write_genes(path: str, genes: list[np.ndarray]) -> None:
    with open(path, "w") as f:
        for i, g in enumerate(genes):
            seq = np.frombuffer(b"AGCT", np.uint8)[g].tobytes().decode()
            f.write(f">gene{i + 1}\n{seq}\n")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> None:
    from metacherchant_tpu_torch import native
    from metacherchant_tpu_torch.ops import extract_cuda
    t0 = time.perf_counter()
    log = extract_cuda.build()
    say("build", f"extraction kernel {extract_cuda.SOURCE.name} built in "
                 f"{time.perf_counter() - t0:.2f} s (nvcc "
                 f"{' '.join(extract_cuda.NVCC_FLAGS)})")
    for line in (log or "already up to date").strip().splitlines():
        say("build", "  " + line.strip())
    t0 = time.perf_counter()
    parser, bfs = native.available(), native.bfs_available()
    say("build", f"native host libraries in {time.perf_counter() - t0:.2f} s: "
                 f"native parser {'in use' if parser else 'NOT available'}, "
                 f"native BFS {'in use' if bfs else 'NOT available'}")


def _time_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def count_batch(rng, k: int) -> np.ndarray:
    """A (BATCH, LEN) int8 batch as counting packs it: N gaps, -1 padding."""
    codes = rng.integers(0, 4, (BATCH, LEN)).astype(np.int8)
    codes[rng.random((BATCH, LEN)) < 0.01] = -1          # N gaps
    tail = rng.integers(k, LEN + 1, BATCH)                # -1 padding
    codes[np.arange(LEN)[None, :] >= tail[:, None]] = -1
    return codes


def classify_batch(rng) -> np.ndarray:
    """A (CLASSIFY_BATCH, READ_LEN) int8 batch as the device classify route
    gives it to the kernel: N -> 0 and padded with 0, every window valid."""
    codes = rng.integers(0, 4, (CLASSIFY_BATCH, READ_LEN)).astype(np.int8)
    tail = rng.integers(1, READ_LEN + 1, CLASSIFY_BATCH)
    codes[np.arange(READ_LEN)[None, :] >= tail[:, None]] = 0
    return codes


def hold_kernel(codes: np.ndarray, k: int, what: str, card: str
                ) -> tuple[int, float, float]:
    """The kernel's append against its plain version on the card, bit for
    bit, on one batch; returns (max_abs_err, kernel ms, plain ms)."""
    from metacherchant_tpu_torch.ops import extract_cuda as ec
    d = torch.from_numpy(codes).to(torch.device("cuda"))
    B, L = codes.shape
    got = torch.empty(B * (L - k + 1), dtype=torch.int64, device=d.device)
    want = torch.empty_like(got)
    ec.extract_append(d, k, got)
    ec.extract_append_plain(d, k, want)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          f"kernel differs from its plain version at k={k} on {what} "
          f"(max_abs_err {err})")
    kern = lambda: ec.extract_append(d, k, got)          # noqa: E731
    plain = lambda: ec.extract_append_plain(d, k, want)  # noqa: E731
    for fn in (kern, plain):                             # warm-up
        fn()
    torch.cuda.synchronize()
    p1 = _time_ms(plain, 5)
    k1 = _time_ms(kern, 50)
    k2 = _time_ms(kern, 50)
    p2 = _time_ms(plain, 5)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    say("kernel", f"k={k:2d} ({B}x{L} int8 codes, {what}): bit-equal to the "
                  f"plain version; kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms ({card})")
    return err, ms, plain_ms


def phase_kernel(rng, card: str) -> dict:
    worst = 0
    timing = {}
    for k in KERNEL_KS:
        err, ms, plain_ms = hold_kernel(count_batch(rng, k), k,
                                        "counting batch, -1 padding", card)
        worst = max(worst, err)
        timing[k] = (ms, plain_ms)
    err, _, _ = hold_kernel(classify_batch(rng), MAIN_K,
                            "classify batch, 0 padding", card)
    worst = max(worst, err)
    ms, plain_ms = timing[MAIN_K]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def tree(root: str) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


class _Stamps(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[tuple[float, str]] = []

    def emit(self, record):
        self.records.append((time.perf_counter(), record.getMessage()))


class Run:
    """One drive of runner.main: seconds, kernel launches, log lines with
    their seconds from the start."""

    def __init__(self, seconds: float, launches: int,
                 log: list[tuple[float, str]]):
        self.seconds, self.launches, self.log = seconds, launches, log

    def line(self, prefix: str) -> tuple[float, str]:
        hits = [(t, m) for t, m in self.log if m.startswith(prefix)]
        check(len(hits) == 1, f"expected one {prefix!r} log line, got "
                              f"{len(hits)}")
        return hits[0]


def drive(argv: list[str], **env: str) -> Run:
    """runner.main(argv) with `env` set for the run only (MC_PLATFORM=cuda
    unless given), the extraction kernel's launch count set to 0 just before
    and read just after. Fails unless the run returns 0."""
    from metacherchant_tpu_torch.ops import extract_cuda
    from metacherchant_tpu_torch.runner import main as port_main
    env = {"MC_PLATFORM": "cuda", **env}
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    stamps = _Stamps()
    logging.getLogger().addHandler(stamps)
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc = port_main(argv)
    finally:
        seconds = time.perf_counter() - t0
        launches = extract_cuda.LAUNCHES
        logging.getLogger().removeHandler(stamps)
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value
    check(rc == 0, f"{' '.join(argv[:2])} rc={rc} ({env})")
    return Run(seconds, launches,
               [(t - t0, m) for t, m in stamps.records])


def phase_oracle(rng, genomes: np.ndarray, tmp: str) -> str:
    from metacherchant_tpu_torch.counting import (count_kmers_device,
                                                  count_kmers_host)
    reads = sample_reads(rng, genomes[:1], 20_000, 150, 0.008)
    reads[rng.random(reads.shape) < 0.002] = -1  # N runs split reads
    fq = os.path.join(tmp, "small.fastq")
    write_fastq(fq, reads)
    t0 = time.perf_counter()
    dev_map = count_kmers_device([fq], MAIN_K, device=torch.device("cuda"))
    t_dev = time.perf_counter() - t0
    host_map = count_kmers_host([fq], MAIN_K)
    check(np.array_equal(dev_map.keys, host_map.keys)
          and np.array_equal(dev_map.counts, host_map.counts),
          "count_kmers_device on CUDA differs from count_kmers_host")
    say("oracle", f"count_kmers_device(cuda) == count_kmers_host on 20000 "
                  f"reads: {len(dev_map)} distinct {MAIN_K}-mers "
                  f"(device counting {t_dev:.3f} s)")
    genes = os.path.join(tmp, "small_genes.fasta")
    write_genes(genes, [genomes[0, 50_000:50_500]])
    outs = small_run_on_both(tmp, fq, genes, MAIN_K, ())
    say("oracle", f"small environment-finder: {len(outs)} output "
                  f"files byte-identical between cuda and cpu")
    return fq


def small_run_on_both(tmp: str, fq: str, genes: str, k: int,
                      extra: tuple[str, ...]) -> dict[str, bytes]:
    """A small environment-finder run on the card and on the CPU; fails
    unless their outputs are byte-identical and not empty."""
    outs = {}
    for platform in ("cuda", "cpu"):
        out = os.path.join(tmp, f"small_out_{k}_{platform}")
        drive(["-t", "environment-finder", "-k", str(k), "-i", fq,
               "--seq", genes, "-o", out, "--coverage", "3",
               "--maxradius", "200", *extra,
               "--work-dir", os.path.join(tmp, f"wd_{k}_{platform}")],
              MC_PLATFORM=platform)
        outs[platform] = tree(out)
    check(outs["cuda"] == outs["cpu"] and bool(outs["cuda"]),
          f"environment-finder -k {k} outputs on CUDA differ from the CPU "
          f"run")
    return outs["cuda"]


def check_gene_outputs(phase: str, out: str) -> None:
    for i in (1, 2, 3):
        gdir = os.path.join(out, f"gene{i}")
        with open(os.path.join(gdir, "graph.txt")) as fh:
            n_env = sum(1 for _ in fh)
        check(n_env > 0, f"gene{i}: empty graph.txt")
        with open(os.path.join(gdir, "graph.gfa")) as fh:
            s_lines = [ln for ln in fh if ln.startswith("S\t")]
        check(bool(s_lines) and all("\tLN:i:" in ln and "\tKC:i:" in ln
                                    for ln in s_lines),
              f"gene{i}: GFA S-lines missing or without LN/KC tags")
        say(phase, f"gene{i}: {n_env} environment k-mers, "
                   f"{len(s_lines)} GFA segments")


def phase_slice(rng, genomes: np.ndarray, tmp: str, card: str
                ) -> tuple[int, str, str]:
    t0 = time.perf_counter()
    n_reads = 20 * genomes.size // 150
    fq = os.path.join(tmp, "reads.fastq")
    write_fastq(fq, sample_reads(rng, genomes, n_reads, 150, 0.008))
    genes = os.path.join(tmp, "genes.fasta")
    write_genes(genes, [genomes[i, 100_000:101_500] for i in (0, 7, 13)])
    say("slice", f"data: {genomes.shape[0]} genomes x {genomes.shape[1]} bp, "
                 f"{n_reads} reads of 150 bp ({os.path.getsize(fq)} bytes "
                 f"FASTQ), 3 genes of 1500 bp, written in "
                 f"{time.perf_counter() - t0:.1f} s")
    out, wd = os.path.join(tmp, "out"), os.path.join(tmp, "wd")
    torch.cuda.reset_peak_memory_stats()
    run = drive(["-t", "environment-finder", "-k", str(MAIN_K),
                 "-i", fq, "--seq", genes, "-o", out,
                 "--coverage", "5", "--maxradius", "1000", "--work-dir", wd])
    t_count, counted = run.line("Hashtable size")
    batches = -(-n_reads // BATCH)
    check(run.launches == batches,
          f"kernel launched {run.launches} times for {batches} batches")
    check_gene_outputs("slice", out)
    say("slice", f"{counted}; kernel launches {run.launches} = "
                 f"{batches} batches")
    say("slice", f"counting {t_count:.3f} s, total {run.seconds:.3f} s, "
                 f"peak device memory "
                 f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                 f"({card})")
    return run.launches, fq, genes


def phase_hashed_ops(rng, card: str) -> None:
    from metacherchant_tpu_torch.kmer_map import KmerMap
    from metacherchant_tpu_torch.ops.kmers import hash_canonical_kmers
    dev = torch.device("cuda")
    for k in HASH_KS:
        codes = torch.from_numpy(count_batch(rng, k))
        d = codes.to(dev)
        for hasher in ("poly", "fnv1a"):
            got, got_ok = hash_canonical_kmers(d, k, hasher)
            want, want_ok = hash_canonical_kmers(codes, k, hasher)
            check(torch.equal(got_ok.cpu(), want_ok)
                  and torch.equal(got.cpu(), want),
                  f"hashed keys on CUDA differ from the CPU: k={k} {hasher}")
            check(bool((want[want_ok] < 0).any()),
                  f"k={k} {hasher}: no key with the top bit set")
            fn = lambda: hash_canonical_kmers(d, k, hasher)  # noqa: E731
            fn()
            ms = min(_time_ms(fn, 10), _time_ms(fn, 10))
            say("hashed-ops", f"k={k} {hasher:5s} ({BATCH}x{LEN} int8 codes): "
                              f"bit-equal to the CPU; {ms:.4f} ms per batch "
                              f"on the card ({card})")
    t0 = time.perf_counter()
    keys = np.unique(rng.integers(np.iinfo(np.int64).min,
                                  np.iinfo(np.int64).max, LOOKUP_KEYS,
                                  dtype=np.int64))
    kmap = KmerMap(keys, rng.integers(1, 100, keys.size))
    half = LOOKUP_QUERIES // 2
    q = np.concatenate([rng.choice(keys, half),
                        rng.integers(np.iinfo(np.int64).min,
                                     np.iinfo(np.int64).max,
                                     LOOKUP_QUERIES - half, dtype=np.int64)])
    q = rng.permutation(q)
    say("hashed-ops", f"lookup data: {keys.size} keys ({int((keys < 0).sum())}"
                      f" with the top bit set), {q.size} queries, made in "
                      f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    want = kmap.get_many(q)
    t_host = time.perf_counter() - t0
    dq = torch.from_numpy(q).to(dev)
    got = kmap.lookup_device(dq)
    check(np.array_equal(got.cpu().numpy(), want),
          "lookup_device on CUDA differs from KmerMap.get_many")
    present = int((want >= 0).sum())
    check(present >= half * 0.99,
          f"only {present} of {q.size} queries found")
    fn = lambda: kmap.lookup_device(dq)  # noqa: E731
    ms = min(_time_ms(fn, 10), _time_ms(fn, 10))
    say("hashed-ops", f"lookup_device: bit-equal to get_many ({present} "
                      f"present); {ms:.4f} ms for {q.size} queries on the "
                      f"card ({card}); host get_many {t_host:.3f} s with its "
                      f"probe-table build")


def phase_hashed_oracle(rng, genomes: np.ndarray, tmp: str, small_fq: str,
                        card: str) -> None:
    from metacherchant_tpu_torch.counting import (count_kmers_device,
                                                  count_kmers_host)
    head = os.path.join(tmp, "small_head.fastq")
    with open(small_fq) as src, open(head, "w") as dst:
        for _ in range(4 * 1000):
            dst.write(src.readline())
    for hasher in ("poly", "fnv1a"):
        maps = {}
        for name in ("cuda", "cpu"):
            t0 = time.perf_counter()
            maps[name] = count_kmers_device([small_fq], HASH_K, hasher,
                                            device=torch.device(name))
            say("hashed-oracle", f"k={HASH_K} {hasher}: count_kmers_device"
                                 f"({name}) on 20000 reads in "
                                 f"{time.perf_counter() - t0:.3f} s "
                                 f"({card})")
        check(np.array_equal(maps["cuda"].keys, maps["cpu"].keys)
              and np.array_equal(maps["cuda"].counts, maps["cpu"].counts),
              f"k={HASH_K} {hasher}: counting on CUDA differs from the CPU")
        host = count_kmers_host([head], HASH_K, hasher)
        for name in ("cuda", "cpu"):
            m = count_kmers_device([head], HASH_K, hasher,
                                   device=torch.device(name))
            check(np.array_equal(m.keys, host.keys)
                  and np.array_equal(m.counts, host.counts),
                  f"k={HASH_K} {hasher}: count_kmers_device({name}) differs "
                  f"from count_kmers_host on 1000 reads")
        say("hashed-oracle", f"k={HASH_K} {hasher}: {len(maps['cuda'])} "
                             f"distinct keys, cuda == cpu; on the first 1000 "
                             f"reads cuda == cpu == host oracle "
                             f"({len(host)} keys)")
    genes = os.path.join(tmp, "small_genes.fasta")
    outs = small_run_on_both(tmp, small_fq, genes, HASH_K,
                             ("--hash", "fnv1a"))
    say("hashed-oracle", f"small environment-finder -k {HASH_K} --hash "
                         f"fnv1a: {len(outs)} output files byte-identical "
                         f"between cuda and cpu")


def phase_hashed_slice(fq: str, genes: str, tmp: str, card: str) -> int:
    out = os.path.join(tmp, "out55")
    torch.cuda.reset_peak_memory_stats()
    run = drive(["-t", "environment-finder", "-k", str(HASH_K),
                 "-i", fq, "--seq", genes, "-o", out,
                 "--coverage", "5", "--maxradius", "1000",
                 "--work-dir", os.path.join(tmp, "wd55")])
    t_count, counted = run.line("Hashtable size")
    run.line("Using default polynomial hash function")
    check(run.launches == 0,
          f"the hashed route launched the extraction kernel "
          f"{run.launches} times")
    check_gene_outputs("hashed-slice", out)
    say("hashed-slice", f"{counted}; extraction kernel launches "
                        f"{run.launches} (the hashed route does not use it)")
    say("hashed-slice", f"counting {t_count:.3f} s, total {run.seconds:.3f} "
                        f"s, peak device memory "
                        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB "
                        f"({card})")
    return run.launches


def sample_pairs(rng, genomes: np.ndarray, n: int, sub_rate: float
                 ) -> tuple[np.ndarray, np.ndarray]:
    """n pairs of 150 bp mates from 400 bp fragments (r2 reverse
    complemented), with uniform substitutions."""
    g = rng.integers(0, genomes.shape[0], n)
    s = rng.integers(0, genomes.shape[1] - 400 + 1, n)
    ar = np.arange(150)
    r1 = genomes[g[:, None], s[:, None] + ar]
    r2 = 3 - genomes[g[:, None], s[:, None] + 250 + ar][:, ::-1]
    out = []
    for r in (r1, r2):
        sub = rng.random(r.shape) < sub_rate
        r[sub] = (r[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        out.append(np.ascontiguousarray(r, np.int8))
    return out[0], out[1]


def read_set(codes: np.ndarray) -> list[bytes]:
    chars = np.frombuffer(b"AGCT", np.uint8)[codes]
    return [row.tobytes() for row in chars]


def phase_classify_slice(rng, genomes: np.ndarray, fq: str, tmp: str,
                         card: str) -> tuple[int, int]:
    """Returns the kernel launches of kmer-counter and of the device
    classify run."""
    n_reads = 20 * genomes.size // 150
    kmers = os.path.join(tmp, "kmers")
    run = drive(["-t", "kmer-counter", "-k", str(MAIN_K), "-i", fq,
                 "-o", kmers, "--work-dir", os.path.join(tmp, "wdk")])
    batches = -(-n_reads // BATCH)
    counter_launches = run.launches
    check(counter_launches == batches,
          f"kmer-counter launched the kernel {counter_launches} times for "
          f"{batches} batches")
    _, loaded = run.line("Reads loaded in")
    distinct = int(loaded.split(", ")[1].split()[0])
    kbin = os.path.join(kmers, "reads.kmers.bin")
    records = os.path.getsize(kbin) // 10
    check(os.path.getsize(kbin) % 10 == 0 and records == distinct,
          f"kmers.bin holds {records} records for {distinct} k-mers")
    check(os.path.getsize(os.path.join(kmers, "reads.stat.txt")) > 0,
          "empty reads.stat.txt")
    say("classify-slice", f"kmer-counter -k {MAIN_K}: {records} records = "
                          f"{distinct} distinct k-mers; kernel launches "
                          f"{run.launches} = {batches} batches; "
                          f"{run.seconds:.3f} s ({card})")
    t0 = time.perf_counter()
    genomes_b = rng.integers(0, 4, genomes.shape).astype(np.int8)
    n_a = CLASSIFY_PAIRS // 2
    a1, a2 = sample_pairs(rng, genomes, n_a, 0.001)
    b1, b2 = sample_pairs(rng, genomes_b, CLASSIFY_PAIRS - n_a, 0.001)
    order = rng.permutation(CLASSIFY_PAIRS)
    r1 = os.path.join(tmp, "r1.fastq")
    r2 = os.path.join(tmp, "r2.fastq")
    write_fastq(r1, np.concatenate([a1, b1])[order])
    write_fastq(r2, np.concatenate([a2, b2])[order])
    say("classify-slice", f"reads to classify: {CLASSIFY_PAIRS} pairs of "
                          f"150 bp, 0.1% substitutions, {n_a} from the "
                          f"graph's genomes, {CLASSIFY_PAIRS - n_a} from 20 "
                          f"other genomes; written in "
                          f"{time.perf_counter() - t0:.1f} s")
    bins = {}
    launches = {}
    for mode, env in (("host", {}), ("device", {"MC_DEVICE_CLASSIFY": "1"})):
        out = os.path.join(tmp, f"classified_{mode}")
        run = drive(["-t", "reads-classifier", "-k", str(MAIN_K),
                     "-i", kbin, "-r", r1, r2, "-o", out,
                     "--work-dir", os.path.join(tmp, f"wdc_{mode}")], **env)
        bins[mode] = tree(out)
        launches[mode] = run.launches
        t_loaded = run.line("Hashtable size")[0]
        t_search = run.line("Searching for")[0]
        t_done = run.line("Reads have been written")[0]
        say("classify-slice", f"reads-classifier ({mode} coverage): "
                              f"{run.seconds:.3f} s (graph loaded at "
                              f"{t_loaded:.3f} s, classification "
                              f"{t_done - t_search:.3f} s), "
                              f"{2 * CLASSIFY_PAIRS / run.seconds:.0f} "
                              f"classified reads/s, kernel launches "
                              f"{run.launches} ({card})")
    check(len(bins["host"]) == 6 and bins["host"] == bins["device"],
          "the six bins of the device classify run differ from the host run")
    want = 2 * -(-CLASSIFY_PAIRS // CLASSIFY_BATCH)
    check(launches["device"] == want and launches["host"] == 0,
          f"classify launches: device {launches['device']} (want {want}), "
          f"host {launches['host']} (want 0)")
    found = set()
    for name, blob in bins["host"].items():
        if name.startswith("found_"):
            found.update(blob.split(b"\n")[1::4])
    share = {}
    for label, mates in (("A", (a1, a2)), ("B", (b1, b2))):
        reads = read_set(mates[0]) + read_set(mates[1])
        share[label] = sum(r in found for r in reads) / len(reads)
    say("classify-slice", f"six bins byte-identical between host and device "
                          f"coverage; device launches {launches['device']} = "
                          f"2 x ceil({CLASSIFY_PAIRS} / {CLASSIFY_BATCH}); "
                          f"found: {share['A']:.4f} of the graph genomes' "
                          f"reads, {share['B']:.4f} of the others'")
    check(share["A"] >= 0.70 and share["B"] <= 0.01,
          f"found shares A {share['A']:.4f} (want >= 0.70), "
          f"B {share['B']:.4f} (want <= 0.01)")
    return counter_launches, launches["device"]


def timed(name: str, card: str, fn, *args):
    t0 = time.perf_counter()
    result = fn(*args)
    say(name, f"phase passed in {time.perf_counter() - t0:.1f} s ({card})")
    return result


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; nothing was run",
              file=sys.stderr)
        return 2
    import metacherchant_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = torch.cuda.get_device_name(0)
    smi = smi_line()
    say("device", f"{card}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    print(smi, flush=True)
    timed("build", smi, phase_build)
    rng = np.random.default_rng(args.seed)
    kernel = timed("kernel", smi, phase_kernel, rng, smi)
    genomes = rng.integers(0, 4, (20, 250_000)).astype(np.int8)
    with tempfile.TemporaryDirectory() as tmp:
        small_fq = timed("oracle", smi, phase_oracle, rng, genomes, tmp)
        launches, fq, genes = timed("slice", smi, phase_slice, rng, genomes,
                                    tmp, smi)
        timed("hashed-ops", smi, phase_hashed_ops, rng, smi)
        timed("hashed-oracle", smi, phase_hashed_oracle, rng, genomes, tmp,
              small_fq, smi)
        hashed = timed("hashed-slice", smi, phase_hashed_slice, fq, genes,
                       tmp, smi)
        counter, classify = timed("classify-slice", smi,
                                  phase_classify_slice, rng, genomes, fq,
                                  tmp, smi)
    print(json.dumps({"kernels": [{
        "name": "extract_append",
        "route": "cuda",
        "source": "metacherchant_tpu_torch/csrc/extract_kmers.cu",
        "replaces": "metacherchant_tpu/ops/pallas_kmers.py:45",
        "launches": launches,
        "launches_by_path": {
            f"environment-finder -k {MAIN_K}": launches,
            f"environment-finder -k {HASH_K} (hashed)": hashed,
            f"kmer-counter -k {MAIN_K}": counter,
            "reads-classifier MC_DEVICE_CLASSIFY=1": classify,
        },
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
    }]}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
