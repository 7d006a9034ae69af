"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives metacherchant_tpu_torch's main path (environment-finder, exact
regime, `sort` counting engine) once at a real data size and checks it:

  1. device    the card's name and power limit;
  2. build     the CUDA extraction kernel (nvcc, sm_90a) and the native host
               libraries, all from this checkout's sources;
  3. kernel    the kernel's append against its plain torch version on the
               card, bit for bit, for several k, with both times;
  4. oracle    count_kmers_device on the card against the host oracle
               count_kmers_host, and a small environment-finder run on the
               card against the same run on the CPU, byte for byte;
  5. slice     environment-finder at k=31 on a synthetic metagenome made from
               --seed (20 genomes of 250 kbp, 150 bp reads at 20x with 0.8%
               substitutions, three 1.5 kbp genes), counting the kernel's
               launches during the run.

Every phase prints its own lines; any failure exits non-zero. The last two
lines are the kernels' JSON record and the device JSON record. Imports no
JAX and nothing of the JAX package. Needs one CUDA device: without one it
exits 2 and prints no result.
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


def phase_kernel(rng, card: str) -> dict:
    from metacherchant_tpu_torch.ops import extract_cuda as ec
    dev = torch.device("cuda")
    worst = 0
    timing = {}
    for k in KERNEL_KS:
        codes = rng.integers(0, 4, (BATCH, LEN)).astype(np.int8)
        codes[rng.random((BATCH, LEN)) < 0.01] = -1          # N gaps
        tail = rng.integers(k, LEN + 1, BATCH)                # -1 padding
        codes[np.arange(LEN)[None, :] >= tail[:, None]] = -1
        d = torch.from_numpy(codes).to(dev)
        n = BATCH * (LEN - k + 1)
        got = torch.empty(n, dtype=torch.int64, device=dev)
        want = torch.empty_like(got)
        ec.extract_append(d, k, got)
        ec.extract_append_plain(d, k, want)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        worst = max(worst, err)
        check(torch.equal(got, want),
              f"kernel differs from its plain version at k={k} "
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
        timing[k] = (min(k1, k2), min(p1, p2))
        say("kernel", f"k={k:2d} ({BATCH}x{LEN} int8 codes): bit-equal to the "
                      f"plain version; kernel {timing[k][0]:.4f} ms, plain "
                      f"{timing[k][1]:.4f} ms ({card})")
    ms, plain_ms = timing[MAIN_K]
    return {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms}


def phase_oracle(rng, genomes: np.ndarray, tmp: str) -> None:
    from metacherchant_tpu_torch.counting import (count_kmers_device,
                                                  count_kmers_host)
    from metacherchant_tpu_torch.runner import main as port_main
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
    outs = {}
    saved = os.environ.get("MC_PLATFORM")
    for platform in ("cuda", "cpu"):
        os.environ["MC_PLATFORM"] = platform
        out = os.path.join(tmp, f"small_out_{platform}")
        rc = port_main(["-t", "environment-finder", "-k", str(MAIN_K),
                        "-i", fq, "--seq", genes, "-o", out,
                        "--coverage", "3", "--maxradius", "200",
                        "--work-dir", os.path.join(tmp, f"wd_{platform}")])
        check(rc == 0, f"small environment-finder run on {platform} rc={rc}")
        files = {}
        for root, _, names in os.walk(out):
            for name in names:
                p = os.path.join(root, name)
                with open(p, "rb") as fh:
                    files[os.path.relpath(p, out)] = fh.read()
        outs[platform] = files
    if saved is None:
        del os.environ["MC_PLATFORM"]
    else:
        os.environ["MC_PLATFORM"] = saved
    check(outs["cuda"] == outs["cpu"] and outs["cuda"],
          "environment-finder outputs on CUDA differ from the CPU run")
    say("oracle", f"small environment-finder: {len(outs['cuda'])} output "
                  f"files byte-identical between cuda and cpu")


class _Stamps(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list[tuple[float, str]] = []

    def emit(self, record):
        self.records.append((time.perf_counter(), record.getMessage()))


def phase_slice(rng, genomes: np.ndarray, tmp: str, card: str) -> int:
    from metacherchant_tpu_torch.ops import extract_cuda
    from metacherchant_tpu_torch.runner import main as port_main
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
    stamps = _Stamps()
    logging.getLogger().addHandler(stamps)
    torch.cuda.reset_peak_memory_stats()
    extract_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    try:
        rc = port_main(["-t", "environment-finder", "-k", str(MAIN_K),
                        "-i", fq, "--seq", genes, "-o", out,
                        "--coverage", "5", "--maxradius", "1000",
                        "--work-dir", wd])
    finally:
        t_total = time.perf_counter() - t0
        launches = extract_cuda.LAUNCHES
        logging.getLogger().removeHandler(stamps)
    check(rc == 0, f"environment-finder rc={rc}")
    counted = [(t, m) for t, m in stamps.records
               if m.startswith("Hashtable size")]
    check(len(counted) == 1, "no 'Hashtable size' log line")
    t_count = counted[0][0] - t0
    batches = -(-n_reads // BATCH)
    check(launches == batches,
          f"kernel launched {launches} times for {batches} batches")
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
        say("slice", f"gene{i}: {n_env} environment k-mers, "
                     f"{len(s_lines)} GFA segments")
    say("slice", f"{counted[0][1]}; kernel launches {launches} = "
                 f"{batches} batches")
    say("slice", f"counting {t_count:.3f} s, total {t_total:.3f} s, peak "
                 f"device memory {torch.cuda.max_memory_allocated() / 2**30:.3f}"
                 f" GiB ({card})")
    return launches


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
    phase_build()
    rng = np.random.default_rng(args.seed)
    kernel = phase_kernel(rng, f"{smi}")
    genomes = rng.integers(0, 4, (20, 250_000)).astype(np.int8)
    with tempfile.TemporaryDirectory() as tmp:
        phase_oracle(rng, genomes, tmp)
        launches = phase_slice(rng, genomes, tmp, smi)
    print(json.dumps({"kernels": [{
        "name": "extract_append",
        "route": "cuda",
        "source": "metacherchant_tpu_torch/csrc/extract_kmers.cu",
        "replaces": "metacherchant_tpu/ops/pallas_kmers.py:45",
        "launches": launches,
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
