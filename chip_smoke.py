"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Drives metacherchant_tpu_torch's paths (environment-finder in the exact and
hashed regimes, kmer-counter -> reads-classifier, triple-reads-classifier,
seq-cov, the three FMT tools, environment-assembler-finder, hic-pipeline,
environment-finder-multi, the device contraction, the device BFS engines,
the `sort` (each consolidation route), `merge`, `chunk`, `hash` and
`sharded` counting engines, the sharded BFS, the scalar sliding-poly FIFO)
at a real data size and checks them:

  1. device         the card's name and power limit;
  2. build          the CUDA extraction and merge kernels (nvcc, sm_90a)
                    and the native host libraries (g++), all from the
                    sources in metacherchant_tpu_torch/csrc/;
  3. kernel         both entries of the kernel against their plain torch
                    versions on the card, bit for bit, for several k, with
                    the kernel's, the plain version's and the bound's times
                    (bytes over 3.35 TB/s): a ragged counting launch (4096
                    reads of 150 codes, and 4096 chunks of random lengths at
                    odd starts), the classifier's 0-padded (8192, 150) batch
                    and a ragged launch of 131,072 reads (about 146 MB);
  4. oracle         count_kmers_device on the card against the host oracle
                    count_kmers_host, and a small environment-finder run on
                    the card against the same run on the CPU, byte for byte;
  5. slice          environment-finder at k=31 on a synthetic metagenome made
                    from --seed (20 genomes of 250 kbp, 150 bp reads at 20x
                    with 0.8% substitutions, three 1.5 kbp genes), counting
                    the kernel's launches during the run, then exact
                    counting's stages (parse, chunk table, and the device
                    time of the kernel, copies and consolidation under
                    torch.profiler);
  6. hashed ops     hashed keys (poly, FNV-1a; k = 32, 55, 63) on the card
                    against the CPU, and KmerMap.lookup_device on the card
                    against the host get_many, bit for bit, with times;
  7. hashed oracle  k=55 counting on the card against the CPU and the host
                    oracle, and a small environment-finder -k 55 --hash fnv1a
                    run on the card against the same run on the CPU;
  8. hashed slice   environment-finder -k 55 on the data of phase 5;
  9. device-bfs     the hash counting engine on the data of phase 5 against
                    the sort engine key for key, its table on the card
                    against the CPU's and its lookup against get_many on
                    10M queries; environment-finder -k 31 as in phase 5
                    under MC_DEVICE_BFS=1 (dense), with the probe engine and
                    with MC_COUNT_ENGINE=hash, and -k 55 as in phase 8 under
                    MC_DEVICE_BFS=1 (multiword), each byte-identical to the
                    host FIFO's files; a wide frontier (65,536 seeds on a
                    400 kbp genome, radius 50) with the host FIFO, dense and
                    probe; small runs on the card against the CPU; BFS
                    seconds and layers per direction, peak device memory;
 10. classify slice kmer-counter -k 31 on the data of phase 5, then
                    reads-classifier on its dump for 333,334 read pairs (half
                    from those genomes, half from 20 others) with
                    MC_DEVICE_CLASSIFY, and on a quarter of the pairs with
                    the host coverage and with MC_DEVICE_CLASSIFY, bins
                    compared;
 11. contract-ops   the device contraction (contract_codes_device) on about
                    400K canonical 31-mers (a 400 kbp genome, cycles, color
                    tags) on the card against the CPU, bit for bit, with the
                    card's ms and the host assembly's seconds; and a small
                    environment-finder under MC_DEVICE_CONTRACT=1 on the card
                    against the CPU;
 12. triple-slice   kmer-counter -k 55 on the data of phase 5, then
                    triple-reads-classifier -k 31 -k2 55 on the dumps for the
                    read pairs of phase 10 with device coverage, and on a
                    quarter of the pairs with host and device coverage, nine
                    bins compared;
 13. seq-cov        small bins on the card against the CPU, then four bins of
                    the reads of phase 5 against the three genes and three
                    pieces of the other genomes (breadth near 1 and 0);
 14. fmt            synthetic donor, before and after metagenomes of 400 kbp
                    (20x, 0.1% substitutions) and their classified bins:
                    fmt-visualiser -k 31 with MC_DEVICE_CONTRACT=1, and on
                    metagenomes of 100 kbp with the host sweep and with
                    MC_DEVICE_CONTRACT=1 (same unitigs and colors),
                    recipient-visualiser on three genes, and on a 10 kbp set
                    of error-free reads fmt-visualizer -k 31 and
                    fmt-visualiser -k 55 on the card against the CPU, byte
                    for byte;
 15. assembler      environment-assembler-finder -k 31 on the reads of phase
                    5 for the first gene, with a stub megahit: stage 1 alone
                    (--finish environment), then stages 2-3 (--start
                    assembly, stage 3 at k=55), then a --continue run that
                    skips; stage 1's graph.txt against the slice's; the read
                    filter alone over the reads, against the tool's
                    cutReads0.fasta; a small run on the card against the CPU;
 16. hic            hic-pipeline -k 31 on the reads of phase 5 for the first
                    gene with 3,000 Hi-C pairs of its genome, a stub bwa and
                    an inert samtools: pass 1 against a direct
                    environment-finder --merge run, the contact map, B1
                    launches per pass; a small run on the card against the
                    CPU;
 17. multi          environment-finder-multi on four and on two k=31
                    graph.txt files of the first gene that phases 5, 15 and
                    16 wrote: colors, Jaccard diagonals, k-mer coverage;
 18. sharded        in a torch.distributed group of world size 1 (NCCL):
                    count_kmers_device with MC_COUNT_ENGINE=sharded on the
                    reads of phase 5 at k=31 and k=55 against the sort
                    engine, key for key, with the kernel's launches, seconds,
                    peak memory and the collectives' device ms; a small
                    sharded count against count_kmers_host;
                    environment-finder -k 31 under MC_COUNT_ENGINE=sharded
                    against phase 5's files; run_sharded_bfs on phase 9's
                    wide frontier in every direction, both directions
                    against bfs_layered;
 19. count-engines  count_kmers_device on the reads of phase 5 at k=31 under
                    the sort engine's sort2 route, its default auto (merge-
                    split at 2^25 + 2^25 lanes), MC_SORT_COMPACTION=shift,
                    and the merge and chunk engines, and at k=55 under
                    sort2, merge and chunk, each key for key against sort2,
                    with consolidations by route, seconds, kernel launches
                    and peak memory; one consolidation by each route at the
                    slice's final geometry under torch.profiler (sort2,
                    shift and merge-split lane for lane equal); the chunk
                    engine's largest launch against the plain version with
                    its share of the byte bound; the merge route's kernel
                    (csrc/consolidate.cu) alone and with its sort at the
                    benchmark's largest merge-route calls against the plain
                    route on the card, key for key, with the byte bound and
                    peak memory, and its launches (one per merge-split
                    consolidation); environment-finder -k 31 under
                    MC_COUNT_ENGINE=merge and chunk against phase 5's
                    files;
 20. scalar-poly    build_environment_hashed for phase 8's three genes at
                    k=55 (poly) on the map of phase 5's reads, with the
                    native BFS off (MC_NATIVE_BFS=0), so that the scalar
                    sliding-poly FIFO walks: each gene's normalized
                    environment against phase 8's graph.txt (the native
                    FIFO's), with the key dict's build seconds, seconds and
                    visited states per direction.

Every phase prints its own lines and its seconds; any failure exits
non-zero. The last two lines are the kernels' JSON record and the device
JSON record. Imports no JAX and nothing of the JAX package. Needs one CUDA
device and the package beside it: without either it exits 2 and prints no
result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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
BATCH, LEN = 4096, 256  # counting's default chunks per launch, chunk length
LARGE_ROWS = 131_072    # a ragged launch of about 146 MB, well above the L2
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
HASH_KS = (32, 55, 63)
HASH_K = 55
CLASSIFY_PAIRS = 333_334
CLASSIFY_BATCH = 8192   # tools/reads_classifier.py
READ_LEN = 150
LOOKUP_KEYS, LOOKUP_QUERIES = 20_000_000, 10_000_000
CONTRACT_GENOME = 400_000
TRIPLE_K2 = 55
#: FMT genomes (kbp): settling and not settling donor strains, staying and
#: gone recipient strains, one shared by both, one new in the recipient
FMT_PARTS = {"settle": 150, "not_settle": 200, "stay": 150, "gone": 200,
             "shared": 50, "new": 50}
FMT_SMALL = 40  # the 10 kbp set: every part divided by this
#: the JAX package's device-BFS workload B (algo/environment.py:264-267)
WIDE_GENOME, WIDE_SEEDS, WIDE_RADIUS = 400_000, 65_536, 50
#: a hash table just below its growth load (0.643 of 2^25 slots), as the
#: hash engine holds it while counting the slice's 22.4M keys
PROBE_LOG2, PROBE_KEYS = 25, 21_560_000
#: the JAX package's DeviceHashTable insert-round bound (hashtable.py:63)
JAX_PROBE_ROUNDS = 128
#: environment-assembler-finder's stage 3 k (tools/environment_assembler_finder.py)
REENV_K = 55
ASM_PF = 10
#: Hi-C pairs of the first gene's genome; the stub bwa selects every third
HIC_PAIRS = 3000


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def _launches() -> int:
    """The extraction's launches since the process started (the port's
    counter extract.launches)."""
    from metacherchant_tpu_torch import trace
    return trace.counter("extract.launches")


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
    from metacherchant_tpu_torch.ops import consolidate_cuda, extract_cuda
    for what, mod in (("extraction", extract_cuda),
                      ("merge", consolidate_cuda)):
        t0 = time.perf_counter()
        log = mod.build()
        say("build", f"{what} kernel {mod.SOURCE.name} built in "
                     f"{time.perf_counter() - t0:.2f} s (nvcc "
                     f"{' '.join(extract_cuda.NVCC_FLAGS)})")
        for line in (log or "already up to date").strip().splitlines():
            say("build", "  " + line.strip())
    t0 = time.perf_counter()
    parser, bfs = native.available(), native.bfs_available()
    say("build", f"native host libraries from "
                 f"{native.SRC_DIR.relative_to(native.SRC_DIR.parents[1])}/"
                 f"{{fastio,bfs}}.cpp in {time.perf_counter() - t0:.2f} s: "
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
    """A (BATCH, LEN) int8 batch as the hashed regime packs it: N gaps, -1
    padding."""
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


def ragged_rows(rng, rows: int, k: int, layout: str
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(codes, starts, lens) of a ragged launch. 'reads': `rows` chunks of
    READ_LEN codes back to back, as counting hands 150 bp reads to the
    kernel, with 1% -1 codes; 'chunks': lengths in [k, LEN] at odd starts,
    with gaps and k-1 overlaps between neighbours."""
    if layout == "reads":
        lens = np.full(rows, READ_LEN, np.int64)
        starts = np.arange(rows, dtype=np.int64) * READ_LEN
    else:
        lens = rng.integers(k, LEN + 1, rows)
        step = lens[:-1] - np.where(rng.random(rows - 1) < 0.3, k - 1, 0)
        step += rng.integers(0, 9, rows - 1)
        starts = np.concatenate([[0], np.cumsum(step)]) | 1
    codes = rng.integers(0, 4, int((starts + lens).max())).astype(np.int8)
    codes[rng.random(codes.size) < 0.01] = -1
    return codes, starts, lens.astype(np.int32)


def _self_device_us(ev) -> float:
    """A key_averages() row's own device time in us (the attribute's name
    changed across torch versions)."""
    us = getattr(ev, "self_device_time_total", None)
    return us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)


def _kernel_device_ms(fn, reps: int) -> float | None:
    """Mean device time of the extraction kernel per call of `fn`, from
    torch.profiler (CUPTI); None when the profiler saw none."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(ev) for ev in prof.key_averages()
             if "extract_kernel" in ev.key)
    return us / reps / 1e3 if us else None


def _timed_pair(kern, plain) -> dict:
    """The kernel's device time per launch (profiler), the time per call of
    `kern` between CUDA events (the host's launch cost included where it is
    the longer), and the plain version's, each the best of two, in turns."""
    for fn in (kern, plain):  # warm-up
        fn()
    torch.cuda.synchronize()
    p1 = _time_ms(plain, 3)
    k1 = _time_ms(kern, 50)
    d1 = _kernel_device_ms(kern, 50)
    k2 = _time_ms(kern, 50)
    d2 = _kernel_device_ms(kern, 50)
    p2 = _time_ms(plain, 3)
    device = [d for d in (d1, d2) if d is not None]
    return {"device_ms": min(device) if device else None,
            "call_ms": min(k1, k2), "plain_ms": min(p1, p2)}


def _record(what: str, k: int, err: int, times: dict, nbytes: int,
            card: str, wrapper_ms: float | None = None) -> dict:
    """One shape's line and record. ms is the kernel's device time, or its
    time per call where the profiler saw no device time or less than the
    bound (it missed launches: no kernel beats the bound)."""
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if times["device_ms"] is not None and times["device_ms"] < bound_ms:
        times = {**times, "device_ms": None}
    ms = times["device_ms"] or times["call_ms"]
    rec = {"shape": what, "k": k, "max_abs_err": err, "ms": ms, **times,
           "wrapper_ms": wrapper_ms, "bytes": nbytes, "bound_ms": bound_ms,
           "share_of_bound": bound_ms / ms}
    dev = ("device time not measured (the profiler saw none, or less "
           "than the bound)" if times["device_ms"] is None
           else f"{times['device_ms']:.4f} ms on the device")
    wrap = ("" if wrapper_ms is None
            else f", {wrapper_ms:.4f} ms with the fault check")
    say("kernel", f"k={k:2d} {what}: bit-equal to the plain version; kernel "
                  f"{dev}, {times['call_ms']:.4f} ms per call{wrap}; plain "
                  f"{times['plain_ms']:.4f} ms; {nbytes} bytes, bound "
                  f"{bound_ms:.4f} ms, {100 * bound_ms / ms:.1f}% of the "
                  f"bound ({card})")
    return rec


def hold_ragged(codes: np.ndarray, starts: np.ndarray, lens: np.ndarray,
                k: int, what: str, card: str) -> dict:
    """The ragged entry against its plain version on the card, bit for bit,
    with the kernel's time alone, the wrapper's (zeroing the fault word and
    reading it back), and the plain version's."""
    from metacherchant_tpu_torch.ops import extract_cuda as ec
    dev = torch.device("cuda")
    offs = ec.row_offsets(lens, k)
    args = [torch.from_numpy(a).to(dev) for a in (codes, starts, lens, offs)]
    n = int((lens.astype(np.int64) - k + 1).sum())
    got = torch.empty(n, dtype=torch.int64, device=dev)
    want = torch.empty_like(got)
    ec.extract_append_ragged(*args, k, got)
    ec.extract_append_ragged_plain(*args, k, want)
    torch.cuda.synchronize()
    err = int((got - want).abs().max())
    check(torch.equal(got, want),
          f"ragged kernel differs from its plain version at k={k} on {what} "
          f"(max_abs_err {err})")
    faults = torch.zeros(1, dtype=torch.int32, device=dev)
    times = _timed_pair(
        lambda: ec._launch_ragged(*args, k, got, faults),
        lambda: ec.extract_append_ragged_plain(*args, k, want))
    check(int(faults) == 0, f"the kernel found faults {int(faults)} in the "
                            f"tables of {what}")
    wrapper_ms = min(_time_ms(lambda: ec.extract_append_ragged(*args, k, got),
                              20) for _ in range(2))
    nbytes = codes.size + 20 * lens.size + 8 * n
    return _record(what, k, err, times, nbytes, card, wrapper_ms)


def hold_dense(codes: np.ndarray, k: int, what: str, card: str) -> dict:
    """The dense entry against its plain version on the card, bit for bit."""
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
    times = _timed_pair(lambda: ec.extract_append(d, k, got),
                        lambda: ec.extract_append_plain(d, k, want))
    return _record(what, k, err, times, codes.size + 8 * got.numel(), card)


def phase_kernel(rng, card: str) -> dict:
    """Both entries against their plain versions for every k of KERNEL_KS on
    a counting launch (BATCH reads of 150 codes, and BATCH chunks of random
    lengths at odd starts), the classifier's dense batch and a ragged launch
    of LARGE_ROWS reads well above the L2. Returns the main path's record
    (the counting launch at MAIN_K) with every shape's at MAIN_K."""
    recs = []
    for k in KERNEL_KS:
        recs.append(hold_ragged(*ragged_rows(rng, BATCH, k, "reads"), k,
                                f"counting launch, {BATCH} reads of "
                                f"{READ_LEN}", card))
        recs.append(hold_ragged(*ragged_rows(rng, BATCH, k, "chunks"), k,
                                f"counting launch, {BATCH} chunks of "
                                f"{k}-{LEN} at odd starts", card))
        recs.append(hold_dense(classify_batch(rng), k,
                               f"classify batch {CLASSIFY_BATCH}x{READ_LEN}, "
                               f"0 padding", card))
        recs.append(hold_ragged(*ragged_rows(rng, LARGE_ROWS, k, "reads"), k,
                                f"large launch, {LARGE_ROWS} reads of "
                                f"{READ_LEN}", card))
    main = [r for r in recs if r["k"] == MAIN_K]
    return {**main[0], "max_abs_err": max(r["max_abs_err"] for r in recs),
            "shapes": main}


def tree(root: str) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(root):
        for name in names:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


class _Stamps(logging.Handler):
    """Each log record's time, message and the kernel's launch count."""

    def __init__(self):
        super().__init__()
        self.base = _launches()
        self.records: list[tuple[float, str, int]] = []

    def emit(self, record):
        self.records.append((time.perf_counter(), record.getMessage(),
                             _launches() - self.base))


class Run:
    """One drive of runner.main: seconds, kernel launches, log lines with
    their seconds from the start, the launches counted by each line, and
    the port's spans (trace.py) with their t0 and t1 in seconds from the
    start."""

    def __init__(self, seconds: float, launches: int,
                 log: list[tuple[float, str]], counts: list[int],
                 spans: list):
        self.seconds, self.launches, self.log = seconds, launches, log
        self.counts, self.spans = counts, spans

    def line(self, prefix: str) -> tuple[float, str]:
        hits = [(t, m) for t, m in self.log if m.startswith(prefix)]
        check(len(hits) == 1, f"expected one {prefix!r} log line, got "
                              f"{len(hits)}")
        return hits[0]

    def launches_at(self, prefix: str) -> list[int]:
        return [n for (_, m), n in zip(self.log, self.counts)
                if m.startswith(prefix)]


def bfs_lines(phase: str, run: Run) -> None:
    """Print a run's BFS directions (its bfs.direction spans: engine,
    direction, visited k-mers, seconds), then the device engines' lines
    (per direction: layers) and the dense adjacency's build, from its debug
    log."""
    for sp in sorted((sp for sp in run.spans if sp.name == "bfs.direction"),
                     key=lambda sp: sp.t0):
        a = sp.attrs
        say(phase, f"  at {sp.t0:.3f} s: {a['engine']} BFS, direction "
                   f"{a['direction']}: {a.get('visited')} visited in "
                   f"{sp.seconds:.3f} s ({sp.cpu_s:.3f} s CPU)")
    for t, m in run.log:
        if " BFS, direction " in m or m.startswith("DenseDBG"):
            say(phase, f"  at {t:.3f} s: {m}")


def drive(argv: list[str], **env: str) -> Run:
    """runner.main(argv) with `env` set for the run only (MC_PLATFORM=cuda
    unless given), inside a recording of the port's spans, with the
    extraction's launches counted from just before to just after. Fails
    unless the run returns 0."""
    from metacherchant_tpu_torch import trace
    from metacherchant_tpu_torch.runner import main as port_main
    env = {"MC_PLATFORM": "cuda", **env}
    saved = {name: os.environ.get(name) for name in env}
    os.environ.update(env)
    stamps = _Stamps()
    logging.getLogger().addHandler(stamps)
    # collect the cyclic garbage of earlier runs (the host sweep's Node
    # pairs) here, so that no run pays for the one before it
    gc.collect()
    before = _launches()
    t0 = time.perf_counter()
    try:
        with trace.recording() as rec:
            rc = port_main(argv)
    finally:
        seconds = time.perf_counter() - t0
        launches = _launches() - before
        logging.getLogger().removeHandler(stamps)
        for name, value in saved.items():
            if value is None:
                del os.environ[name]
            else:
                os.environ[name] = value
    check(rc == 0, f"{' '.join(argv[:2])} rc={rc} ({env})")
    spans = [dataclasses.replace(sp, t0=sp.t0 - t0, t1=sp.t1 - t0)
             for sp in rec.spans]
    return Run(seconds, launches,
               [(t - t0, m) for t, m, _ in stamps.records],
               [n for _, _, n in stamps.records], spans)


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
    outs, _ = small_run_on_both(tmp, fq, genes, MAIN_K, ())
    say("oracle", f"small environment-finder: {len(outs)} output "
                  f"files byte-identical between cuda and cpu")
    return fq


def small_run_on_both(tmp: str, fq: str, genes: str, k: int,
                      extra: tuple[str, ...], **env: str
                      ) -> tuple[dict[str, bytes], int]:
    """A small environment-finder run on the card and on the CPU, with
    `env` set; fails unless their outputs are byte-identical and not empty.
    Returns the outputs and the card run's kernel launches."""
    outs = {}
    tag = "_".join(f"{n}{v}" for n, v in env.items())
    for platform in ("cuda", "cpu"):
        out = os.path.join(tmp, f"small_out_{k}_{platform}{tag}")
        run = drive(["-t", "environment-finder", "-k", str(k), "-i", fq,
                     "--seq", genes, "-o", out, "--coverage", "3",
                     "--maxradius", "200", *extra,
                     "--work-dir", os.path.join(tmp, f"wd_{k}_{platform}{tag}")],
                    MC_PLATFORM=platform, **env)
        outs[platform] = tree(out)
        if platform == "cuda":
            launches = run.launches
    check(outs["cuda"] == outs["cpu"] and bool(outs["cuda"]),
          f"environment-finder -k {k} {env} outputs on CUDA differ from the "
          f"CPU run")
    return outs["cuda"], launches


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
                ) -> tuple[Run, str, str]:
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
    bfs_lines("slice", run)
    counting_breakdown(fq, card)
    return run, fq, genes


def counting_breakdown(fq: str, card: str) -> None:
    """Exact counting of the slice's reads by stage: the native parse and
    the chunk table on the host clock, then count_kmers_device whole under
    torch.profiler, its device time split into the kernel, host-to-device
    copies, device-to-host copies and the rest (consolidation sorts, scans
    and masks, the wrapper's table checks)."""
    from torch.profiler import ProfilerActivity, profile
    from metacherchant_tpu_torch import native
    from metacherchant_tpu_torch.counting import (_chunk_table,
                                                  count_kmers_device)
    t0 = time.perf_counter()
    _, offs = native.parse_fragments(fq, "fastq", 33)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, clen = _chunk_table(offs, MAIN_K, 0, LEN)
    t_table = time.perf_counter() - t0
    lanes = int((clen - MAIN_K + 1).sum())
    count_kmers_device([fq], MAIN_K, device=torch.device("cuda"))  # warm-up
    torch.cuda.synchronize()
    gc.collect()
    t0 = time.perf_counter()
    count_kmers_device([fq], MAIN_K, device=torch.device("cuda"))
    torch.cuda.synchronize()
    t_plain_run = time.perf_counter() - t0
    before = _launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        count_kmers_device([fq], MAIN_K, device=torch.device("cuda"))
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
    launches = _launches() - before
    parts = {"kernel": 0.0, "HtoD": 0.0, "DtoH": 0.0, "other": 0.0}
    for ev in prof.key_averages():
        us = _self_device_us(ev)
        if not us:
            continue
        name = ("kernel" if "extract_kernel" in ev.key else "HtoD"
                if "HtoD" in ev.key else "DtoH" if "DtoH" in ev.key
                else "other")
        parts[name] += us / 1e3
    busy = sum(parts.values())
    say("slice", f"counting breakdown, {clen.size} chunks, {lanes} windows "
                 f"appended (no padding): parse {t_parse:.3f} s, chunk table "
                 f"{t_table:.3f} s; count_kmers_device {t_plain_run:.3f} s "
                 f"({t_total:.3f} s under the profiler); device ms: "
                 + ", ".join(f"{n} {v:.3f}" for n, v in parts.items())
                 + f"; {launches} launches, kernel "
                 f"{parts['kernel'] / max(launches, 1):.4f} ms each"
                 + (f"; device busy {busy / (1e3 * t_total):.4f} of the "
                    f"profiled run" if busy else "; device time not "
                    "measured (the profiler saw none)") + f" ({card})")


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
    stamps = [time.perf_counter()]

    def any_int64(n: int) -> np.ndarray:
        """n uniform int64 values over the whole range (random bytes)."""
        return np.frombuffer(rng.bytes(8 * n), np.int64)

    keys = np.unique(any_int64(LOOKUP_KEYS))
    stamps.append(time.perf_counter())
    kmap = KmerMap(keys, rng.integers(1, 100, keys.size))
    stamps.append(time.perf_counter())
    half = LOOKUP_QUERIES // 2
    q = rng.permutation(np.concatenate([rng.choice(keys, half),
                                        any_int64(LOOKUP_QUERIES - half)]))
    stamps.append(time.perf_counter())
    say("hashed-ops", f"lookup data: {keys.size} keys ({int((keys < 0).sum())}"
                      f" with the top bit set), {q.size} queries, made in "
                      f"{stamps[-1] - stamps[0]:.1f} s (keys, map, queries: "
                      + ", ".join(f"{b - a:.1f}" for a, b in
                                  zip(stamps, stamps[1:])) + " s)")
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
    outs, _ = small_run_on_both(tmp, small_fq, genes, HASH_K,
                                ("--hash", "fnv1a"))
    say("hashed-oracle", f"small environment-finder -k {HASH_K} --hash "
                         f"fnv1a: {len(outs)} output files byte-identical "
                         f"between cuda and cpu")


def phase_hashed_slice(fq: str, genes: str, tmp: str, card: str) -> Run:
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
    bfs_lines("hashed-slice", run)
    return run


def _peak_gib() -> float:
    return torch.cuda.max_memory_allocated() / 2**30


def hash_engine_checks(rng, fq: str, small_fq: str, card: str) -> int:
    """MC_COUNT_ENGINE=hash on the slice's reads against the sort engine,
    key for key; on the small set the card's table against the CPU's; the
    table's lookup against KmerMap.get_many on LOOKUP_QUERIES queries.
    Returns the hash engine's kernel launches on the slice's reads."""
    from metacherchant_tpu_torch.counting import count_kmers_device
    from metacherchant_tpu_torch.ops.hashtable import DeviceHashTable
    from metacherchant_tpu_torch.ops.kmers import SENTINEL
    dev = torch.device("cuda")
    maps, secs, launches = {}, {}, {}
    for engine in ("sort", "hash"):
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        before = _launches()
        t0 = time.perf_counter()
        maps[engine] = count_kmers_device([fq], MAIN_K, device=dev,
                                          engine=engine)
        secs.setdefault(engine, []).append(time.perf_counter() - t0)
        launches[engine] = _launches() - before
        say("device-bfs", f"count_kmers_device(engine={engine!r}) on the "
                          f"slice's reads: {len(maps[engine])} distinct "
                          f"{MAIN_K}-mers in {secs[engine][-1]:.3f} s, "
                          f"kernel launches {launches[engine]}, peak device "
                          f"memory {_peak_gib():.3f} GiB ({card})")
    sort_map, hash_map = maps["sort"], maps["hash"]
    check(np.array_equal(hash_map.keys, sort_map.keys)
          and np.array_equal(hash_map.counts, sort_map.counts),
          "the hash engine's map differs from the sort engine's")
    check(launches["hash"] == launches["sort"] > 0,
          f"kernel launches: hash engine {launches['hash']}, sort engine "
          f"{launches['sort']}")
    small = {name: count_kmers_device([small_fq], MAIN_K,
                                      device=torch.device(name),
                                      engine="hash") for name in ("cuda",
                                                                   "cpu")}
    check(np.array_equal(small["cuda"].keys, small["cpu"].keys)
          and np.array_equal(small["cuda"].counts, small["cpu"].counts),
          "the hash engine's table on CUDA differs from the CPU's")
    say("device-bfs", f"hash engine == sort engine key for key "
                      f"({len(sort_map)} keys; sort {secs['sort'][0]:.3f} "
                      f"s, hash {secs['hash'][0]:.3f} s); "
                      f"small set: card items == CPU items "
                      f"({len(small['cpu'])} keys)")
    t0 = time.perf_counter()
    table = DeviceHashTable.from_kmer_map(sort_map, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    half = LOOKUP_QUERIES // 2
    q = rng.permutation(np.concatenate([
        rng.choice(sort_map.keys, half),
        rng.integers(0, 1 << (2 * MAIN_K), LOOKUP_QUERIES - half - 1),
        [SENTINEL]]))
    t0 = time.perf_counter()
    want = sort_map.get_many(q)
    t_host = time.perf_counter() - t0
    dq = torch.from_numpy(q).to(dev)
    got = table.lookup(dq)
    check(np.array_equal(got.cpu().numpy(), want),
          "DeviceHashTable.lookup differs from KmerMap.get_many")
    fn = lambda: table.lookup(dq)  # noqa: E731
    ms = min(_time_ms(fn, 3), _time_ms(fn, 3))
    say("device-bfs", f"DeviceHashTable.lookup == KmerMap.get_many on "
                      f"{q.size} queries ({int((want >= 0).sum())} present); "
                      f"table of {table.capacity} slots built in "
                      f"{t_build:.3f} s; lookup {ms:.3f} ms on the card; "
                      f"host get_many {t_host:.3f} s with its probe-table "
                      f"build ({card})")
    del table, dq, got
    probe_distances(card)
    return launches["hash"]


def probe_distances(card: str) -> None:
    """How far from its home slot each key lands in a table at load 0.643:
    a key d slots from home needs d + 1 insert rounds, and the JAX package
    bounds them at JAX_PROBE_ROUNDS."""
    from metacherchant_tpu_torch.ops.hashtable import (DeviceHashTable,
                                                        EMPTY, _mix64)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    keys = torch.unique(torch.randint(0, 1 << 62, (PROBE_KEYS,),
                                      generator=gen, device=dev))
    table = DeviceHashTable(dev, capacity_log2=PROBE_LOG2)
    t0 = time.perf_counter()
    table.insert_batch(keys)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    check(table.capacity == 1 << PROBE_LOG2 and table.size == keys.numel(),
          "probe-distance table grew or lost keys")
    slot = torch.nonzero(table.tkeys != EMPTY).squeeze(1)
    home = _mix64(table.tkeys[slot]) & (table.capacity - 1)
    dist = (slot - home) & (table.capacity - 1)
    past = int((dist >= JAX_PROBE_ROUNDS).sum())
    say("device-bfs", f"{keys.numel()} random keys in 2^{PROBE_LOG2} slots "
                      f"(load {keys.numel() / table.capacity:.3f}) inserted "
                      f"in {secs:.3f} s: the farthest {int(dist.max())} "
                      f"slots from home, {past} keys need more than "
                      f"{JAX_PROBE_ROUNDS} insert rounds ({card})")
    del table, keys, slot, home, dist


def wide_frontier(rng, tmp: str, card: str) -> dict[str, int]:
    """The JAX package's device-BFS workload B (algo/environment.py:264-267,
    scripts/profile_dense_bfs.py): a 400 kbp genome's 31-mers, count 1,
    65,536 seeds at distinct random positions, radius 50, both directions.
    environment-finder --merge takes the seeds as 31 bp sequences; the host
    FIFO, the dense and the probe engine must write the same files.
    Returns the kernel launches of each run."""
    genome = rng.integers(0, 4, WIDE_GENOME).astype(np.int8)
    reads = os.path.join(tmp, "wide.fasta")
    with open(reads, "w") as fh:
        fh.write(">wide\n" + np.frombuffer(b"AGCT", np.uint8)[genome]
                 .tobytes().decode() + "\n")
    pos = np.sort(rng.choice(WIDE_GENOME - MAIN_K + 1, WIDE_SEEDS,
                             replace=False))
    genes = os.path.join(tmp, "wide_seeds.fasta")
    write_genes(genes, [genome[p:p + MAIN_K] for p in pos])
    trees, launches = {}, {}
    for mode, env in (("host", {"MC_DEVICE_BFS": "0"}),
                      ("dense", {"MC_DEVICE_BFS": "1"}),
                      ("probe", {"MC_DEVICE_BFS": "1",
                                 "MC_DEVICE_BFS_ENGINE": "probe"})):
        out = os.path.join(tmp, f"wide_{mode}")
        torch.cuda.reset_peak_memory_stats()
        run = drive(["-t", "environment-finder", "-k", str(MAIN_K),
                     "-i", reads, "--seq", genes, "-o", out, "--merge",
                     "--bothdirs", "--coverage", "1", "--maxradius",
                     str(WIDE_RADIUS), "--work-dir",
                     os.path.join(tmp, f"wdw_{mode}")], **env)
        trees[mode], launches[mode] = tree(out), run.launches
        t_seeds = run.line("Finding single environment")[0]
        t_ext = run.line("Extending endings")[0]
        say("device-bfs", f"wide frontier ({WIDE_SEEDS} seeds, radius "
                          f"{WIDE_RADIUS}, {mode}): {run.seconds:.3f} s, "
                          f"seeding to written environment "
                          f"{t_ext - t_seeds:.3f} s, peak device memory "
                          f"{_peak_gib():.3f} GiB ({card})")
        bfs_lines("device-bfs", run)
    with open(os.path.join(tmp, "wide_host", "merged", "graph.txt")) as fh:
        n_env = sum(1 for _ in fh)
    check(trees["host"] == trees["dense"] == trees["probe"]
          and len(trees["host"]) == 5 and n_env > WIDE_SEEDS,
          "wide frontier: the device engines' files differ from the host "
          "FIFO's")
    say("device-bfs", f"wide frontier: {n_env} environment k-mers, the "
                      f"five files byte-identical for host FIFO, dense and "
                      f"probe")
    return launches


def phase_device_bfs(rng, tmp: str, slice_run: Run, fq: str, genes: str,
                     hashed_run: Run, small_fq: str, card: str) -> dict:
    """The hash counting engine and the MC_DEVICE_BFS engines at the
    slices' size and on the wide frontier, each held to its host
    counterpart byte for byte. Returns the kernel launches by path."""
    launches = {"hash-count": hash_engine_checks(rng, fq, small_fq, card)}
    slice_out = tree(os.path.join(tmp, "out"))
    say("device-bfs", f"host FIFO (slice phase): {slice_run.seconds:.3f} s")
    bfs_lines("device-bfs", slice_run)
    for label, env in (("dense", {"MC_DEVICE_BFS": "1"}),
                       ("probe", {"MC_DEVICE_BFS": "1",
                                  "MC_DEVICE_BFS_ENGINE": "probe"}),
                       ("hash", {"MC_COUNT_ENGINE": "hash"})):
        out = os.path.join(tmp, f"out_{label}")
        torch.cuda.reset_peak_memory_stats()
        run = drive(["-t", "environment-finder", "-k", str(MAIN_K),
                     "-i", fq, "--seq", genes, "-o", out,
                     "--coverage", "5", "--maxradius", "1000",
                     "--work-dir", os.path.join(tmp, f"wd_{label}")], **env)
        check(tree(out) == slice_out,
              f"environment-finder -k {MAIN_K} {env}: outputs differ from "
              f"the default run's")
        launches[label] = run.launches
        say("device-bfs", f"environment-finder -k {MAIN_K} {env}: "
                          f"{len(slice_out)} files byte-identical to the "
                          f"default run; {run.seconds:.3f} s, kernel "
                          f"launches {run.launches}, peak device memory "
                          f"{_peak_gib():.3f} GiB ({card})")
        bfs_lines("device-bfs", run)
    hashed_out = tree(os.path.join(tmp, "out55"))
    say("device-bfs", f"host FIFO (hashed-slice phase): "
                      f"{hashed_run.seconds:.3f} s")
    bfs_lines("device-bfs", hashed_run)
    out = os.path.join(tmp, "out55_device")
    torch.cuda.reset_peak_memory_stats()
    run = drive(["-t", "environment-finder", "-k", str(HASH_K), "-i", fq,
                 "--seq", genes, "-o", out, "--coverage", "5",
                 "--maxradius", "1000",
                 "--work-dir", os.path.join(tmp, "wd55_device")],
                MC_DEVICE_BFS="1")
    check(tree(out) == hashed_out, f"environment-finder -k {HASH_K} under "
                                   f"MC_DEVICE_BFS=1 differs from the "
                                   f"hashed slice")
    launches["multiword"] = run.launches
    say("device-bfs", f"environment-finder -k {HASH_K} MC_DEVICE_BFS=1: "
                      f"{len(hashed_out)} files byte-identical to the hashed "
                      f"slice; {run.seconds:.3f} s, kernel launches "
                      f"{run.launches}, peak device memory {_peak_gib():.3f} "
                      f"GiB ({card})")
    bfs_lines("device-bfs", run)
    wide = wide_frontier(rng, tmp, card)
    launches.update({f"wide-{m}": n for m, n in wide.items()})
    small_genes = os.path.join(tmp, "small_genes.fasta")
    for k, extra, env in ((MAIN_K, (), {"MC_DEVICE_BFS": "1"}),
                          (MAIN_K, (), {"MC_DEVICE_BFS": "1",
                                        "MC_DEVICE_BFS_ENGINE": "probe"}),
                          (HASH_K, ("--hash", "fnv1a"),
                           {"MC_DEVICE_BFS": "1"})):
        outs, _ = small_run_on_both(tmp, small_fq, small_genes, k, extra,
                                    **env)
        say("device-bfs", f"small environment-finder -k {k} {env}: "
                          f"{len(outs)} files byte-identical between cuda "
                          f"and cpu")
    return launches


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


def found_shares(bins: dict[str, bytes], mates: dict) -> dict[str, float]:
    """Share of each origin's reads that landed in a found_* bin."""
    found = set()
    for name, blob in bins.items():
        if name.startswith("found_"):
            found.update(blob.split(b"\n")[1::4])
    share = {}
    for label, (m1, m2) in mates.items():
        reads = read_set(m1) + read_set(m2)
        share[label] = sum(r in found for r in reads) / len(reads)
    return share


def phase_classify_slice(rng, genomes: np.ndarray, fq: str, tmp: str,
                         card: str) -> dict:
    """Returns the kernel launches of kmer-counter ("counter") and of the
    device classify run ("classify"), the dump ("kbin"), the read files
    ("r1", "r2"), the mates by origin ("mates") and the other genomes
    ("genomes_b")."""
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
    quarter = CLASSIFY_PAIRS // 4
    reads = {"all": [r1, r2],
             "quarter": [head_fastq(r, os.path.join(tmp, f"c{i}q.fastq"),
                                    quarter) for i, r in ((1, r1), (2, r2))]}
    pairs = {"all": CLASSIFY_PAIRS, "quarter": quarter}
    bins = {}
    launches = {}
    for mode, part, env in (("device", "all", {"MC_DEVICE_CLASSIFY": "1"}),
                            ("host", "quarter", {}),
                            ("device", "quarter", {"MC_DEVICE_CLASSIFY": "1"})):
        out = os.path.join(tmp, f"classified_{mode}_{part}")
        run = drive(["-t", "reads-classifier", "-k", str(MAIN_K),
                     "-i", kbin, "-r", *reads[part], "-o", out,
                     "--work-dir", os.path.join(tmp, f"wdc_{mode}_{part}")],
                    **env)
        bins[mode, part] = tree(out)
        launches[mode, part] = run.launches
        t_loaded = run.line("Hashtable size")[0]
        t_search = run.line("Searching for")[0]
        t_done = run.line("Reads have been written")[0]
        say("classify-slice", f"reads-classifier ({mode} coverage, "
                              f"{pairs[part]} pairs): {run.seconds:.3f} s "
                              f"(graph loaded at {t_loaded:.3f} s, "
                              f"classification {t_done - t_search:.3f} s), "
                              f"{2 * pairs[part] / run.seconds:.0f} "
                              f"classified reads/s, kernel launches "
                              f"{run.launches} ({card})")
    check(len(bins["host", "quarter"]) == 6
          and bins["host", "quarter"] == bins["device", "quarter"],
          "the six bins of the device classify run differ from the host run")
    want = {part: 2 * -(-n // CLASSIFY_BATCH) for part, n in pairs.items()}
    check(launches["device", "all"] == want["all"]
          and launches["device", "quarter"] == want["quarter"]
          and launches["host", "quarter"] == 0,
          f"classify launches: {launches} (want device {want}, host 0)")
    share = found_shares(bins["device", "all"],
                         {"A": (a1, a2), "B": (b1, b2)})
    say("classify-slice", f"six bins byte-identical between host and device "
                          f"coverage on {quarter} pairs; on all pairs device "
                          f"launches {launches['device', 'all']} = 2 x "
                          f"ceil({CLASSIFY_PAIRS} / {CLASSIFY_BATCH}); "
                          f"found: {share['A']:.4f} of the graph genomes' "
                          f"reads, {share['B']:.4f} of the others'")
    check(share["A"] >= 0.70 and share["B"] <= 0.01,
          f"found shares A {share['A']:.4f} (want >= 0.70), "
          f"B {share['B']:.4f} (want <= 0.01)")
    return {"counter": counter_launches,
            "classify": launches["device", "all"],
            "kbin": kbin, "r1": r1, "r2": r2,
            "mates": {"A": (a1, a2), "B": (b1, b2)}, "genomes_b": genomes_b}


def window_keys(codes: np.ndarray, k: int) -> np.ndarray:
    """Canonical exact keys min(fw, rc) of every k-window of one code
    sequence (codes 0..3)."""
    w = np.lib.stride_tricks.sliding_window_view(codes.astype(np.uint64), k)
    up = (2 * np.arange(k)).astype(np.uint64)
    fw = (w << up[::-1]).sum(axis=1, dtype=np.uint64)
    rc = ((np.uint64(3) - w) << up).sum(axis=1, dtype=np.uint64)
    return np.minimum(fw, rc).astype(np.int64)


def contract_end_to_end(keys: np.ndarray, card: str) -> None:
    """A picture's contraction end to end on the canonical k-mers of reads
    (20x, 0.1% substitutions, so tips and bubbles; no cycle, where the two
    routes may linearize differently): the host
    sweep (build_node_graph + do_merge) once against contract_device (tags,
    transfers, the card, host assembly) twice; fails unless their unitig
    sets agree."""
    from metacherchant_tpu_torch.algo.contraction import (build_node_graph,
                                                          do_merge)
    from metacherchant_tpu_torch.algo.environment import ascii_min_orient
    from metacherchant_tpu_torch.dna import codes_to_kmers_np, normalize
    from metacherchant_tpu_torch.ops.contraction_device import contract_device
    kmers = sorted(codes_to_kmers_np(ascii_min_orient(keys, MAIN_K), MAIN_K))

    def host():
        nodes = build_node_graph(kmers, MAIN_K)
        do_merge(nodes, MAIN_K)
        return nodes

    def device():
        return contract_device(kmers, MAIN_K)

    secs = {"host": [], "device": []}
    seqs = {}
    for name, fn in (("host", host), ("device", device), ("device", device)):
        gc.collect()
        t0 = time.perf_counter()
        nodes = fn()
        secs[name].append(time.perf_counter() - t0)
        seqs[name] = sorted(normalize(n.seq) for n in nodes if not n.deleted)
        del nodes
    check(seqs["host"] == seqs["device"],
          "contract_device's unitigs differ from the host sweep's")
    say("contract-ops", f"a picture of {len(kmers)} k-mers end to end: host "
                        f"sweep {secs['host'][0]:.3f} s, contract_device "
                        f"{min(secs['device']):.3f} s (runs: "
                        f"{secs['device'][0]:.3f}, "
                        f"{secs['device'][1]:.3f} s); the same "
                        f"{len(seqs['host']) // 2} unitigs ({card})")


def phase_contract_ops(rng, tmp: str, small_fq: str, card: str) -> int:
    """Returns the kernel launches of the small environment-finder run
    under MC_DEVICE_CONTRACT=1 on the card."""
    from metacherchant_tpu_torch.ops.contraction_device import (
        assemble_nodes, assemble_unitigs, contract_codes_device)
    genome = rng.integers(0, 4, CONTRACT_GENOME).astype(np.int8)
    keys = [window_keys(genome, MAIN_K)]
    tags = [(np.arange(keys[0].size) // 20_000 % 3).astype(np.int32)]
    for length in (1000, 5000, 20_000):  # pure cycles
        circ = rng.integers(0, 4, length).astype(np.int8)
        keys.append(window_keys(np.concatenate([circ, circ[:MAIN_K - 1]]),
                                MAIN_K))
        tags.append(np.full(length, 3, np.int32))
    keys, first = np.unique(np.concatenate(keys), return_index=True)
    tags = np.concatenate(tags)[first]
    codes, tag_t = torch.from_numpy(keys), torch.from_numpy(tags)
    dev = torch.device("cuda")
    dc, dt = codes.to(dev), tag_t.to(dev)
    got = contract_codes_device(dc, dt, MAIN_K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = contract_codes_device(codes, tag_t, MAIN_K)
    t_cpu = time.perf_counter() - t0
    for name, g, w in zip(("U", "utags", "head", "dist"), got, want):
        check(g.dtype == w.dtype and torch.equal(g.cpu(), w),
              f"contract_codes_device on CUDA differs from the CPU in {name}")
    fn = lambda: contract_codes_device(dc, dt, MAIN_K)  # noqa: E731
    ms = min(_time_ms(fn, 5), _time_ms(fn, 5))
    U, utags, head, dist = (t.cpu().numpy() for t in got)
    t0 = time.perf_counter()
    unitigs = assemble_unitigs(U, head, dist, MAIN_K)
    nodes = assemble_nodes([(seq, None) for seq, _ in unitigs], MAIN_K)
    t_asm = time.perf_counter() - t0
    covered = sum(len(seq) - MAIN_K + 1 for seq, _ in unitigs)
    check(covered == keys.size,
          f"the unitigs hold {covered} k-mers of {keys.size}")
    say("contract-ops", f"{keys.size} canonical {MAIN_K}-mers ({U.size} "
                        f"oriented nodes, {int(tags.max()) + 1} tags, 3 "
                        f"cycles): card == CPU for U, utags, head, dist; "
                        f"{len(unitigs)} unitigs, {len(nodes)} nodes, every "
                        f"k-mer in one unitig")
    say("contract-ops", f"contract_codes_device {ms:.3f} ms on the card, "
                        f"{t_cpu:.3f} s on the CPU; host assembly "
                        f"(assemble_unitigs + assemble_nodes) {t_asm:.3f} s "
                        f"({card})")
    from metacherchant_tpu_torch.algo.classify import rolling_keys_np
    reads = sample_reads(rng, genome[None, :], 20 * CONTRACT_GENOME // 150,
                         150, 0.001)
    contract_end_to_end(np.unique(rolling_keys_np(reads, MAIN_K, None)), card)
    genes = os.path.join(tmp, "small_genes.fasta")
    outs, launches = small_run_on_both(tmp, small_fq, genes, MAIN_K, (),
                                       MC_DEVICE_CONTRACT="1")
    check(launches > 0, "environment-finder under MC_DEVICE_CONTRACT=1 did "
                        "not launch the kernel")
    say("contract-ops", f"small environment-finder under "
                        f"MC_DEVICE_CONTRACT=1: {len(outs)} output files "
                        f"byte-identical between cuda and cpu; kernel "
                        f"launches {launches}")
    return launches


def head_fastq(src: str, dst: str, n: int) -> str:
    """The first n records of a FASTQ file, written to dst."""
    with open(src, "rb") as fh:
        lines = fh.readlines()[:4 * n]
    with open(dst, "wb") as fh:
        fh.writelines(lines)
    return dst


def phase_triple_slice(fq: str, cls: dict, tmp: str, card: str) -> int:
    """The device-coverage run on every pair; the host-coverage run, whose
    nine bins it must equal, on the first quarter of the pairs against a
    device run on the same quarter. Returns the kernel launches of the
    device-coverage run on every pair."""
    kmers55 = os.path.join(tmp, "kmers55")
    run = drive(["-t", "kmer-counter", "-k", str(TRIPLE_K2), "-i", fq,
                 "-o", kmers55, "--work-dir", os.path.join(tmp, "wdk55")])
    check(run.launches == 0, f"kmer-counter -k {TRIPLE_K2} launched the "
                             f"kernel {run.launches} times")
    kbin55 = os.path.join(kmers55, "reads.kmers.bin")
    say("triple-slice", f"kmer-counter -k {TRIPLE_K2}: "
                        f"{os.path.getsize(kbin55) // 10} records; "
                        f"{run.seconds:.3f} s ({card})")
    quarter = CLASSIFY_PAIRS // 4
    reads = {"all": [cls["r1"], cls["r2"]],
             "quarter": [head_fastq(cls[r], os.path.join(tmp, f"{r}q.fastq"),
                                    quarter) for r in ("r1", "r2")]}
    pairs = {"all": CLASSIFY_PAIRS, "quarter": quarter}
    bins, launches = {}, {}
    for mode, part, env in (("device", "all", {"MC_DEVICE_CLASSIFY": "1"}),
                            ("host", "quarter", {}),
                            ("device", "quarter", {"MC_DEVICE_CLASSIFY": "1"})):
        out = os.path.join(tmp, f"triple_{mode}_{part}")
        run = drive(["-t", "triple-reads-classifier", "-k", str(MAIN_K),
                     "-k2", str(TRIPLE_K2), "-ik1", cls["kbin"],
                     "-ik2", kbin55, "-r", *reads[part], "-o", out,
                     "--work-dir", os.path.join(tmp, f"wdt_{mode}_{part}")],
                    **env)
        bins[mode, part] = tree(out)
        launches[mode, part] = run.launches
        t_pass2 = [t for t, m in run.log
                   if m.startswith(f"Building graph with k = {TRIPLE_K2}")]
        say("triple-slice", f"triple-reads-classifier ({mode} coverage, "
                            f"{pairs[part]} pairs): {run.seconds:.3f} s "
                            f"(pass 1 ended at {t_pass2[0]:.3f} s), "
                            f"{2 * pairs[part] / run.seconds:.0f} "
                            f"classified reads/s, kernel launches "
                            f"{run.launches} ({card})")
    check(len(bins["host", "quarter"]) == 9
          and bins["host", "quarter"] == bins["device", "quarter"],
          "the nine bins of the device triple run differ from the host run")
    want = {part: 4 * -(-n // CLASSIFY_BATCH) for part, n in pairs.items()}
    check(launches["device", "all"] == want["all"]
          and launches["device", "quarter"] == want["quarter"]
          and launches["host", "quarter"] == 0,
          f"triple launches: {launches} (want device {want}, host 0)")
    share = found_shares(bins["device", "all"], cls["mates"])
    sizes = {n[:-6]: b.count(b"\n+\n")
             for n, b in sorted(bins["device", "all"].items())}
    say("triple-slice", f"nine bins byte-identical between host and device "
                        f"coverage on {quarter} pairs; on all pairs "
                        f"{sizes}, device launches {launches['device', 'all']}"
                        f" = 4 x ceil({CLASSIFY_PAIRS} / {CLASSIFY_BATCH}) "
                        f"in pass 1, none at k2; found: "
                        f"{share['A']:.4f} of the graph genomes' reads, "
                        f"{share['B']:.4f} of the others'")
    check(share["A"] >= 0.70 and share["B"] <= 0.01,
          f"triple found shares A {share['A']:.4f} (want >= 0.70), "
          f"B {share['B']:.4f} (want <= 0.01)")
    return launches["device", "all"]


def split_fastq(src: str, paths: list[str]) -> list[int]:
    """Deal the records of a FASTQ round-robin into len(paths) files;
    returns the record count of each."""
    with open(src, "rb") as fh:
        lines = fh.read().split(b"\n")[:-1]
    recs = np.array(lines, dtype=object).reshape(-1, 4)
    sizes = []
    for i, path in enumerate(paths):
        part = recs[i::len(paths)]
        sizes.append(part.shape[0])
        with open(path, "wb") as fh:
            fh.write(b"\n".join(part.ravel().tolist()) + b"\n")
    return sizes


def seq_cov_args(bins: list[str], seqs: str, out: str, wd: str) -> list[str]:
    return ["-t", "seq-cov", "-k", str(MAIN_K), "--from-donor", bins[0],
            "--from-before", bins[1], "--from-both", bins[2],
            "--itself", bins[3], "-r", seqs, "-o", out, "--work-dir", wd]


def phase_seq_cov(rng, fq: str, genes: str, small_fq: str,
                  genomes_b: np.ndarray, tmp: str, card: str) -> int:
    """Returns the kernel launches of the full-size run."""
    small_seqs = os.path.join(tmp, "small_seqs.fasta")
    with open(os.path.join(tmp, "small_genes.fasta")) as fh:
        small_gene = fh.read()
    with open(small_seqs, "w") as fh:
        fh.write(small_gene + ">random\n" + "".join(
            "AGCT"[c] for c in rng.integers(0, 4, 400)) + "\n")
    csv = {}
    for platform in ("cuda", "cpu"):
        out = os.path.join(tmp, f"cov_small_{platform}")
        drive(seq_cov_args([small_fq] * 4, small_seqs, out,
                           os.path.join(tmp, f"wdcov_{platform}")),
              MC_PLATFORM=platform)
        csv[platform] = tree(out)
    check(csv["cuda"] == csv["cpu"] and len(csv["cuda"]) == 1,
          "seq-cov on CUDA differs from the CPU run")
    say("seq-cov", "small seq_cov.csv byte-identical between cuda and cpu")
    t0 = time.perf_counter()
    bins = [os.path.join(tmp, f"cov_bin{i}.fastq") for i in range(4)]
    sizes = split_fastq(fq, bins)
    seqs = os.path.join(tmp, "cov_seqs.fasta")
    with open(genes) as fh:
        gene_text = fh.read()
    pieces = [genomes_b[i, 100_000:101_500] for i in (0, 7, 13)]
    with open(seqs, "w") as fh:
        fh.write(gene_text + "".join(
            f">other{i + 1}\n" + np.frombuffer(b"AGCT", np.uint8)[p]
            .tobytes().decode() + "\n" for i, p in enumerate(pieces)))
    say("seq-cov", f"four bins of the slice's reads and six sequences "
                   f"written in {time.perf_counter() - t0:.1f} s")
    out = os.path.join(tmp, "cov_full")
    run = drive(seq_cov_args(bins, seqs, out, os.path.join(tmp, "wdcov")))
    with open(os.path.join(out, "seq_cov.csv")) as fh:
        rows = [ln.rstrip("\n").split(", ") for ln in fh][1:]
    check(len(rows) == 6, f"seq_cov.csv holds {len(rows)} rows, want 6")
    breadth = [[float(x) for x in r[2::2]] for r in rows]
    # each bin holds a quarter of the reads (5x): about 0.95 expected
    check(all(min(b) >= 0.75 for b in breadth[:3]),
          f"gene breadths {breadth[:3]} (want >= 0.75 in every bin)")
    check(all(max(b) == 0.0 for b in breadth[3:]),
          f"other genomes' breadths {breadth[3:]} (want 0)")
    batches = sum(-(-n // BATCH) for n in sizes)
    check(run.launches == batches,
          f"seq-cov launched the kernel {run.launches} times for {batches} "
          f"batches")
    say("seq-cov", f"seq-cov -k {MAIN_K} on four bins: {run.seconds:.3f} s, "
                   f"kernel launches {run.launches}; breadth of the genes "
                   f"{[min(b) for b in breadth[:3]]} (least over the bins), "
                   f"of the other genomes' pieces "
                   f"{[max(b) for b in breadth[3:]]} ({card})")
    return run.launches


def fmt_data(rng, tmp: str, scale: int, sub_rate: float
             ) -> tuple[str, dict[str, str]]:
    """Donor, before and after metagenomes from FMT_PARTS / scale (20x,
    150 bp reads, `sub_rate` substitutions), the eight classified bins
    (<stem>_{1,2,s}.fastq, reads dealt by origin) and three genes of the
    after metagenome. Returns (bins dir, {name: path})."""
    parts = {name: rng.integers(0, 4, (1, kbp * 1000 // scale)).astype(
        np.int8) for name, kbp in FMT_PARTS.items()}

    def reads_of(name: str) -> np.ndarray:
        g = parts[name]
        return sample_reads(rng, g, 20 * g.shape[1] // 150, 150, sub_rate)

    metas = {"donor": ("settle", "not_settle", "shared"),
             "before": ("stay", "gone", "shared"),
             "after": ("settle", "stay", "shared", "new")}
    bin_of = {("donor", "settle"): "settle",
              ("donor", "not_settle"): "not_settle",
              ("before", "stay"): "stay", ("before", "gone"): "gone",
              ("after", "settle"): "came_from_donor",
              ("after", "stay"): "came_from_baseline",
              ("after", "shared"): "came_from_both",
              ("after", "new"): "came_itself"}
    root = os.path.join(tmp, f"fmt{scale}")
    bins = os.path.join(root, "bins")
    os.makedirs(bins)
    paths = {}
    for meta, names in metas.items():
        sets = {name: reads_of(name) for name in names}
        paths[meta] = os.path.join(root, f"{meta}.fastq")
        write_fastq(paths[meta], np.concatenate(list(sets.values())))
        for name, reads in sets.items():
            stem = bin_of.get((meta, name))
            if stem is not None:
                for i, x in enumerate(("1", "2", "s")):
                    write_fastq(os.path.join(bins, f"{stem}_{x}.fastq"),
                                reads[i::3])
    paths["genes"] = os.path.join(root, "genes.fasta")
    write_genes(paths["genes"], [parts[n][0, 1000:1000 + 1500 // scale]
                                 for n in ("settle", "stay", "new")])
    return bins, paths


def fmt_args(tool: str, k: int, bins: str, paths: dict[str, str], out: str,
             wd: str) -> list[str]:
    args = ["-t", tool, "-k", str(k), "-i", bins, "--ext", "fastq",
            "-after", paths["after"], "-o", out, "--work-dir", wd]
    if tool == "recipient-visualiser":
        return args + ["--seq", paths["genes"]]
    return args + ["-donor", paths["donor"], "-before", paths["before"]]


def segments(gfa: bytes) -> list[tuple[str, str]]:
    """(normalized sequence, color) of every S line of a GFA file."""
    from metacherchant_tpu_torch.dna import normalize
    out = []
    for ln in gfa.decode().splitlines():
        if ln.startswith("S\t"):
            f = ln.split("\t")
            out.append((normalize(f[2]), f[5][len("CL:Z:"):]))
    return sorted(out)


def phase_fmt(rng, tmp: str, card: str) -> tuple[int, int]:
    """fmt-visualiser with the device contraction on the 400 kbp
    metagenomes, and with the host sweep against it on metagenomes of a
    quarter of that size. Returns the kernel launches of fmt-visualiser
    (device contraction, 400 kbp) and of recipient-visualiser."""
    from collections import Counter
    t0 = time.perf_counter()
    data = {1: fmt_data(rng, tmp, 1, 0.001), 4: fmt_data(rng, tmp, 4, 0.001)}
    bins, paths = data[1]
    say("fmt", f"data: {sum(FMT_PARTS.values())} kbp in 6 genomes; donor, "
               f"before, after of 400 kbp at 20x (0.1% substitutions), 24 "
               f"bin files; the same at a quarter of the size; written in "
               f"{time.perf_counter() - t0:.1f} s")
    pics, launches = {}, {}
    for mode, flag, scale in (("device", "1", 1), ("host", "0", 4),
                              ("device", "1", 4)):
        out = os.path.join(tmp, f"fmt_{mode}{scale}")
        run = drive(fmt_args("fmt-visualiser", MAIN_K, *data[scale], out,
                             os.path.join(tmp, f"wdf_{mode}{scale}")),
                    MC_DEVICE_CONTRACT=flag)
        pics[mode, scale] = tree(out)
        launches[mode, scale] = run.launches
        stamps = {m.split()[1]: t for t, m in run.log
                  if m.startswith("Creating ") and m.endswith(" image ...")}
        say("fmt", f"fmt-visualiser -k {MAIN_K} ({mode} contraction, "
                   f"{400 // scale} kbp): {run.seconds:.3f} s (images begin "
                   f"at {', '.join(f'{n} {t:.3f} s' for n, t in stamps.items())}"
                   f"), kernel launches {run.launches} ({card})")
    check(len(pics["device", 1]) == 6
          and sorted(pics["host", 4]) == sorted(pics["device", 4])
          and len(pics["host", 4]) == 6, "fmt-visualiser output files differ")
    for name in ("donor", "before", "after"):
        host = segments(pics["host", 4][f"{name}.gfa"])
        dev = segments(pics["device", 4][f"{name}.gfa"])
        check(host == dev, f"{name}.gfa: the device contraction's unitigs "
                           f"or colors differ from the host sweep's")
        full = segments(pics["device", 1][f"{name}.gfa"])
        colors = Counter(c for _, c in full)
        say("fmt", f"{name}.gfa: {len(full)} unitigs at 400 kbp, colors "
                   f"{dict(colors)}; at 100 kbp {len(host)} unitigs, the "
                   f"same set and colors with either contraction")
    check(launches["host", 4] == launches["device", 4] > 0
          and launches["device", 1] > 0,
          f"fmt-visualiser launches {launches}")
    out = os.path.join(tmp, "recipient")
    run = drive(fmt_args("recipient-visualiser", MAIN_K, bins, paths, out,
                         os.path.join(tmp, "wdr")))
    got = tree(out)
    check(sorted(got) == sorted(f"after/comp_{i}{s}" for i in range(3)
                                for s in (".gfa", "_seqs.fasta")),
          f"recipient-visualiser wrote {sorted(got)}")
    check(all(b"_start" in got[f"after/comp_{i}_seqs.fasta"]
              for i in range(3)), "a recipient picture has no gene node")
    recipient = run.launches
    check(recipient > 0, "recipient-visualiser did not launch the kernel")
    say("fmt", f"recipient-visualiser on 3 genes: "
               f"{[len(segments(got[f'after/comp_{i}.gfa'])) for i in range(3)]}"
               f" unitigs, {run.seconds:.3f} s, kernel launches "
               f"{recipient} ({card})")
    # error-free reads: fmt-visualizer's flood admits duplicates as the
    # reference does, and their number doubles at every bubble that
    # substitutions make along a component
    bins, paths = fmt_data(rng, tmp, FMT_SMALL, 0.0)
    for tool, k in (("fmt-visualizer", MAIN_K), ("fmt-visualiser", HASH_K)):
        outs, secs = {}, {}
        for platform in ("cuda", "cpu"):
            out = os.path.join(tmp, f"{tool}{k}_{platform}")
            run = drive(fmt_args(tool, k, bins, paths, out,
                                 os.path.join(tmp, f"wd{tool}{k}{platform}")),
                        MC_PLATFORM=platform)
            outs[platform], secs[platform] = tree(out), run.seconds
        check(outs["cuda"] == outs["cpu"] and len(outs["cuda"]) >= 6,
              f"{tool} -k {k} on CUDA differs from the CPU run")
        say("fmt", f"{tool} -k {k} on the {400 // FMT_SMALL} kbp "
                   f"metagenomes: {len(outs['cuda'])} files byte-identical "
                   f"between cuda ({secs['cuda']:.3f} s) and cpu "
                   f"({secs['cpu']:.3f} s)")
    return launches["device", 1], recipient


# the stub bwa of tests/test_hic_pipeline.py: 'index' is a no-op, 'mem'
# maps mate pairs to alternating contigs of the reference, every third pair
# with its first mate unmapped
BWA_STUB = r'''#!/usr/bin/env python3
"""Stub bwa: 'index' is a no-op; 'mem' emits a deterministic SAM that maps
each mate pair to alternating reference contigs (by FASTA order)."""
import sys

def contigs(path):
    names = []
    for line in open(path):
        if line.startswith(">"):
            names.append(line[1:].split()[0].strip())
    return names

if sys.argv[1] == "index":
    sys.exit(0)
assert sys.argv[1] == "mem"
args = [a for a in sys.argv[2:] if a != "-t" and not a.isdigit()]
ref, r1, r2 = args[0], args[1], args[2]
names = contigs(ref) or ["c0"]

def reads(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return [(lines[i][1:], lines[i + 1]) for i in range(0, len(lines), 4)]

print("@HD\tVN:1.6")
for n in names:
    print(f"@SQ\tSN:{n}\tLN:1000")
pairs = list(zip(reads(r1), reads(r2)))
for i, ((n1, s1), (n2, s2)) in enumerate(pairs):
    c1 = names[i % len(names)]
    c2 = names[(i + 1) % len(names)]
    if i % 3 == 0:
        # first mate UNMAPPED with mapped mate (0x1|0x4|0x40 = 69): the
        # -f 0x5 -F 0x908 selection target; second carries mate-unmapped
        print(f"{n1}\t69\t*\t0\t0\t*\t{c2}\t1\t0\t{s1}\t*")
        print(f"{n2}\t137\t{c2}\t1\t60\t{len(s2)}M\t*\t0\t0\t{s2}\t*")
    else:
        # both mates mapped to DIFFERENT contigs (contact-map rows)
        print(f"{n1}\t65\t{c1}\t1\t60\t{len(s1)}M\t{c2}\t1\t0\t{s1}\t*")
        print(f"{n2}\t129\t{c2}\t1\t60\t{len(s2)}M\t{c1}\t1\t0\t{s2}\t*")
'''

#: a stub megahit: copies its --12 reads to <-o>/final.contigs.fa
MEGAHIT_STUB = """
import os, shutil, sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
os.makedirs(out, exist_ok=True)
shutil.copyfile(args[args.index("--12") + 1],
                os.path.join(out, "final.contigs.fa"))
"""


def write_stub(path: str, text: str) -> None:
    with open(path, "w") as fh:
        fh.write(text)
    os.chmod(path, 0o755)


def first_gene(genes: str, tmp: str) -> str:
    """A FASTA of the first gene of phase 5's genes."""
    path = os.path.join(tmp, "gene1.fasta")
    if not os.path.exists(path):
        with open(genes) as fh:
            header, seq = fh.readline(), fh.readline()
        with open(path, "w") as fh:
            fh.write(header + seq)
    return path


def work_tree(root: str) -> dict[str, bytes]:
    """A work directory's files without its log files, its own path masked
    (in.properties names it)."""
    return {n: b.replace(root.encode(), b"<root>")
            for n, b in tree(root).items()
            if not os.path.basename(n).startswith("log")}


def assembler_args(reads: str, gene: str, out: str, wd: str, stubs: str,
                   coverage: int, radius: int) -> list[str]:
    return ["-t", "environment-assembler-finder", "-k", str(MAIN_K),
            "-i", reads, "--seq", gene, "--coverage", str(coverage),
            "--maxradius", str(radius), "-pf", str(ASM_PF),
            "--assembler", "megahit", "--assemblerpath", stubs, "-o", out,
            "--work-dir", wd]


def phase_assembler(fq: str, genes: str, small_fq: str, n_reads: int,
                    tmp: str, card: str) -> dict[str, int]:
    """The card takes the megahit route: the spades route runs `python` by
    name, which the card's machine may lack. Returns the kernel launches of
    stage 1 and of stages 2-3."""
    from metacherchant_tpu_torch.algo.filter import (SubgraphChecker,
                                                     filter_reads_file)
    from metacherchant_tpu_torch.io.writers import load_graph_txt
    stubs = os.path.join(tmp, "assembler")
    os.makedirs(stubs)
    write_stub(os.path.join(stubs, "megahit"),
               f"#!{sys.executable}" + MEGAHIT_STUB)
    gene = first_gene(genes, tmp)
    out, wd = os.path.join(tmp, "asm"), os.path.join(tmp, "wda")
    args = assembler_args(fq, gene, out, wd, stubs, 5, 1000)
    stage1 = drive(args + ["--finish", "environment"])
    later = drive(args + ["--start", "assembly"])
    for name in ("SUCCESS.environment", "SUCCESS.assembly",
                 "SUCCESS.re-environment", "SUCCESS", "out.properties"):
        check(os.path.exists(os.path.join(wd, name)),
              f"environment-assembler-finder left no {name}")
    cut = os.path.join(out, "cutReads0.fasta")
    with open(cut, "rb") as fh:
        cut_bytes = fh.read()
    kept = cut_bytes.count(b">")
    check(kept > 0, "environment-assembler-finder: empty cutReads0.fasta")
    with open(os.path.join(out, "result", "graph.txt")) as fh:
        rows = [ln.split() for ln in fh]
    check(bool(rows) and all(len(r[0]) == REENV_K for r in rows),
          f"result/graph.txt does not hold {REENV_K}-mers")
    with open(os.path.join(out, "graph.txt"), "rb") as fh:
        env = fh.read()
    with open(os.path.join(tmp, "out", "gene1", "graph.txt"), "rb") as fh:
        check(env == fh.read(), "stage 1's graph.txt differs from the "
                                "slice's gene1/graph.txt")
    batches = -(-n_reads // BATCH)
    check(stage1.launches == batches and later.launches == 0,
          f"assembler launches: stage 1 {stage1.launches} (want {batches}), "
          f"stages 2-3 {later.launches} (want 0)")
    t_asm = later.line("Running stage assembly")[0]
    t_re = later.line("Running stage re-environment")[0]
    say("assembler", f"stage 1 (environment, filter) {stage1.seconds:.3f} s, "
                     f"kernel launches {stage1.launches}; stage 2 (stub "
                     f"megahit) {t_re - t_asm:.3f} s; stage 3 (k={REENV_K}, "
                     f"coverage 0, {len(rows)} k-mers) "
                     f"{later.seconds - t_re:.3f} s, kernel launches "
                     f"{later.launches}; {kept} reads kept ({card})")
    again = drive(args + ["--continue"])
    again.line("Stage environment-assembler-finder already done")
    check(again.launches == 0, "the --continue run launched the kernel")
    say("assembler", f"stage 1's graph.txt byte-identical to the slice's "
                     f"gene1; the --continue run skipped all three stages "
                     f"in {again.seconds:.3f} s")
    checker = SubgraphChecker(list(load_graph_txt(os.path.join(out,
                                                               "graph.txt"))),
                              MAIN_K, None)
    t0 = time.perf_counter()
    n = filter_reads_file(fq, checker, os.path.join(tmp, "asm_filter"), 0,
                          ASM_PF)
    secs = time.perf_counter() - t0
    with open(os.path.join(tmp, "asm_filter", "cutReads0.fasta"), "rb") as fh:
        check(n == kept and fh.read() == cut_bytes,
              "filter_reads_file alone differs from the tool's cutReads0")
    say("assembler", f"read filter alone over {n_reads} reads "
                     f"({len(checker._keys)} environment k-mers): "
                     f"{secs:.3f} s, {n_reads / secs:.0f} reads/s (the "
                     f"host) ({card})")
    small_genes = os.path.join(tmp, "small_genes.fasta")
    outs = {}
    for platform in ("cuda", "cpu"):
        o = os.path.join(tmp, f"asm_small_{platform}")
        drive(assembler_args(small_fq, small_genes, o,
                             os.path.join(tmp, f"wdas_{platform}"), stubs,
                             3, 200), MC_PLATFORM=platform)
        outs[platform] = tree(o)
    check(outs["cuda"] == outs["cpu"] and "result/graph.txt" in outs["cuda"],
          "small environment-assembler-finder on CUDA differs from the CPU")
    say("assembler", f"small environment-assembler-finder: "
                     f"{len(outs['cuda'])} files byte-identical between cuda "
                     f"and cpu")
    return {"stage1": stage1.launches, "stage3": later.launches}


def hic_args(reads: str, gene: str, mates: list[str], wd: str,
             coverage: int, radius: int) -> list[str]:
    return ["-t", "hic-pipeline", "-k", str(MAIN_K), "-i", reads,
            "--seq", gene, "--hi-c-r1", mates[0], "--hi-c-r2", mates[1],
            "--coverage", str(coverage), "--maxradius", str(radius),
            "--work-dir", wd]


def phase_hic(rng, genomes: np.ndarray, fq: str, genes: str, small_fq: str,
              n_reads: int, tmp: str, card: str) -> dict[str, int]:
    """Returns the kernel launches of each pass."""
    bindir = os.path.join(tmp, "bin")
    os.makedirs(bindir)
    write_stub(os.path.join(bindir, "bwa"), BWA_STUB)
    write_stub(os.path.join(bindir, "samtools"), "#!/bin/sh\nexit 0\n")
    path = f"{bindir}:{os.environ.get('PATH', '')}"
    mates = [os.path.join(tmp, f"hic_{m}.fastq") for m in (1, 2)]
    for p, m in zip(mates, sample_pairs(rng, genomes[:1], HIC_PAIRS, 0.001)):
        write_fastq(p, m)
    gene = first_gene(genes, tmp)
    wd = os.path.join(tmp, "hic")
    run = drive(hic_args(fq, gene, mates, wd, 5, 1000), PATH=path)
    for name in ("output/1/merged/seqs.fasta", "1/selected_reads.fasta",
                 "output/2/merged/graph.txt", "2/hic_map.txt", "SUCCESS"):
        check(os.path.exists(os.path.join(wd, name)),
              f"hic-pipeline left no {name}")
    with open(os.path.join(wd, "2", "hic_map.txt")) as fh:
        rows = fh.read().splitlines()
    check(rows[0] == "v1\tv2\thic_w" and len(rows) > 1,
          f"hic_map.txt: header {rows[0]!r}, {len(rows) - 1} contact rows")
    with open(os.path.join(wd, "1", "selected_reads.fasta")) as fh:
        selected = fh.read().count(">")
    counted = run.launches_at("Hashtable size")
    done = [i for i, (_, m) in enumerate(run.log)
            if m.startswith("Finished processing all sequences")]
    check(len(counted) == 2 and len(done) == 2,
          "hic-pipeline did not run two passes")
    launches = {"pass1": counted[0], "pass2": counted[1] - counted[0]}
    batches = -(-n_reads // BATCH)
    check(launches["pass1"] == launches["pass2"] == batches
          and run.launches == counted[1],
          f"hic-pipeline launches {launches}, total {run.launches} (want "
          f"{batches} a pass)")
    t1, t2 = run.log[done[0]][0], run.log[done[1]][0]
    t2_start = run.log[done[0] + 1][0]
    with open(os.path.join(wd, "output", "2", "merged", "graph.txt")) as fh:
        n_env2 = sum(1 for _ in fh)
    say("hic", f"hic-pipeline -k {MAIN_K}: pass 1 {t1:.3f} s, kernel "
               f"launches {launches['pass1']}; stub alignment and selection "
               f"of {selected} reads {t2_start - t1:.3f} s; pass 2 "
               f"{t2 - t2_start:.3f} s ({n_env2} k-mers), kernel launches "
               f"{launches['pass2']}; contact map {run.seconds - t2:.3f} s "
               f"({len(rows) - 1} rows); total {run.seconds:.3f} s ({card})")
    direct = os.path.join(tmp, "hic_direct")
    drive(["-t", "environment-finder", "-k", str(MAIN_K), "-i", fq,
           "--seq", gene, "-o", direct, "--coverage", "5", "--maxradius",
           "1000", "--bothdirs", "False", "--chunklength", "10", "--merge",
           "true", "--work-dir", os.path.join(tmp, "wdhd")])
    check(tree(direct) == tree(os.path.join(wd, "output", "1")),
          "hic-pipeline pass 1 differs from a direct environment-finder run")
    small_mates = [os.path.join(tmp, f"hic_small_{m}.fastq") for m in (1, 2)]
    for p, m in zip(small_mates, sample_pairs(rng, genomes[:1], 300, 0.001)):
        write_fastq(p, m)
    small_genes = os.path.join(tmp, "small_genes.fasta")
    outs = {}
    for platform in ("cuda", "cpu"):
        root = os.path.join(tmp, f"hic_small_{platform}")
        drive(hic_args(small_fq, small_genes, small_mates, root, 3, 200),
              MC_PLATFORM=platform, PATH=path)
        outs[platform] = work_tree(root)
    check(outs["cuda"] == outs["cpu"] and "2/hic_map.txt" in outs["cuda"],
          "small hic-pipeline on CUDA differs from the CPU")
    say("hic", f"pass 1 byte-identical to a direct environment-finder "
               f"--merge run; small hic-pipeline: {len(outs['cuda'])} files "
               f"byte-identical between cuda and cpu")
    return launches


def multi_palette(n: int) -> set[str]:
    """GFAWriterMulti's colors for n graphs (n = 2 or n > 3), membership 1
    to n, and the gene nodes' green."""
    if n == 2:
        return {"#ff0000", "#0000ff", "#00ff00"}
    return {"#" + f"{256 * m // n:02X}" * 3 for m in range(1, n + 1)} | {
        "#00ff00"}


def phase_multi(tmp: str, card: str) -> int:
    """Returns the kernel launches of its runs (none: multi runs on the
    host)."""
    from metacherchant_tpu_torch.dna import normalize
    from metacherchant_tpu_torch.io.writers import load_graph_txt
    files = [os.path.join(tmp, *p) for p in (
        ("out", "gene1", "graph.txt"), ("asm", "graph.txt"),
        ("hic", "output", "1", "merged", "graph.txt"),
        ("hic", "output", "2", "merged", "graph.txt"))]
    gene = os.path.join(tmp, "gene1.fasta")
    launches = 0
    for chosen in (files, [files[0], files[3]]):
        n = len(chosen)
        out = os.path.join(tmp, f"multi{n}")
        run = drive(["-t", "environment-finder-multi", "-e", *chosen,
                     "--seq", gene, "-o", out,
                     "--work-dir", os.path.join(tmp, f"wdm{n}")])
        check(run.launches == 0, "environment-finder-multi launched B1")
        launches += run.launches
        with open(os.path.join(out, "graph.gfa")) as fh:
            colors = [ln.split("\t")[5][len("CL:Z:"):] for ln in fh
                      if ln.startswith("S\t")]
        check(bool(colors) and set(colors) <= multi_palette(n),
              f"{n} graphs: colors {sorted(set(colors))} outside the palette")
        for name in ("Jacard_sym.txt", "Jacard_alt.txt"):
            with open(os.path.join(out, name)) as fh:
                rows = fh.read().splitlines()[2:]
            diag = [row[len(f):].split()[i]
                    for i, (row, f) in enumerate(zip(rows, chosen))]
            check(len(rows) == n and diag == ["0.00"] * n,
                  f"{name}: diagonal {diag}")
        wanted = set()
        for f in chosen:
            wanted.update(load_graph_txt(f))
        have = set()
        with open(os.path.join(out, "seqs.fasta")) as fh:
            for ln in fh:
                if not ln.startswith(">"):
                    seq = ln.strip()
                    have.update(normalize(seq[i:i + MAIN_K])
                                for i in range(len(seq) - MAIN_K + 1))
        check(wanted <= have, f"{n} graphs: seqs.fasta misses "
                              f"{len(wanted - have)} input k-mers")
        say("multi", f"environment-finder-multi on {n} graphs "
                     f"({len(wanted)} k-mers in all): {run.seconds:.3f} s, "
                     f"{len(colors)} segments in {len(set(colors))} colors, "
                     f"Jaccard diagonals 0.00, every input k-mer in "
                     f"seqs.fasta ({card})")
    return launches


class CollectiveCalls:
    """Counts the torch.distributed collectives called inside the block and
    times each on the card: CUDA events on the current stream just before
    and just after the call (a blocking NCCL call makes the current stream
    wait for its work), summed per collective once the block ends."""

    NAMES = ("all_to_all_single", "all_reduce", "all_gather")

    def __enter__(self):
        import torch.distributed as dist
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.events = {n: [] for n in self.NAMES}
        self.saved = {n: getattr(dist, n) for n in self.NAMES}

        def counted(name):
            def call(*args, **kw):
                self.calls[name] += 1
                pair = (torch.cuda.Event(enable_timing=True),
                        torch.cuda.Event(enable_timing=True))
                pair[0].record()
                out = self.saved[name](*args, **kw)
                pair[1].record()
                self.events[name].append(pair)
                return out
            return call
        for name in self.NAMES:
            setattr(dist, name, counted(name))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist
        for name, fn in self.saved.items():
            setattr(dist, name, fn)
        torch.cuda.synchronize()
        self.ms = {n: sum(a.elapsed_time(b) for a, b in pairs)
                   for n, pairs in self.events.items()}
        return False

    def summary(self) -> str:
        return ", ".join(f"{n} {self.calls[n]} calls {self.ms[n]:.3f} ms"
                         for n in self.NAMES)


def sharded_bfs_checks(tmp: str, card: str) -> None:
    """run_sharded_bfs on the wide frontier's data (phase 9: 400 kbp,
    65,536 seeds, radius 50) in every direction: both directions (0)
    against bfs_layered, and each single direction's set holding the seeds
    inside that one (bfs_layered's numpy layers take 10-15 s a
    direction)."""
    from metacherchant_tpu_torch.algo.environment import (
        bfs_layered, seed_codes_of_sequences)
    from metacherchant_tpu_torch.counting import count_kmers_device
    from metacherchant_tpu_torch.parallel.sharded_bfs import run_sharded_bfs
    dev = torch.device("cuda")
    kmap = count_kmers_device([os.path.join(tmp, "wide.fasta")], MAIN_K,
                              device=dev)
    with open(os.path.join(tmp, "wide_seeds.fasta")) as fh:
        seqs = fh.read().splitlines()[1::2]
    seeds = np.asarray(seed_codes_of_sequences(seqs, MAIN_K, kmap, 1),
                       np.int64)
    check(seeds.size == WIDE_SEEDS, f"{seeds.size} wide-frontier seeds")
    t0 = time.perf_counter()
    both = bfs_layered(seeds, kmap, MAIN_K, 1, 0, WIDE_RADIUS).visited
    t_host = time.perf_counter() - t0
    say("sharded", f"bfs_layered on the wide frontier, both directions: "
                   f"{both.size} visited in {t_host:.3f} s (host)")
    for direction in (0, -1, 1):
        torch.cuda.reset_peak_memory_stats()
        stamps = _Stamps()
        log = logging.getLogger("metacherchant")
        level = log.level
        log.addHandler(stamps)
        log.setLevel(logging.DEBUG)
        t0 = time.perf_counter()
        try:
            with CollectiveCalls() as coll:
                got = run_sharded_bfs(seeds, kmap, MAIN_K, 1, direction,
                                      WIDE_RADIUS, device=dev)
        finally:
            t_dev = time.perf_counter() - t0
            log.removeHandler(stamps)
            log.setLevel(level)
        layers = [m for _, m, _ in stamps.records if "sharded BFS" in m]
        check(len(layers) == 1, f"{len(layers)} sharded BFS log lines")
        if direction == 0:
            check(np.array_equal(got, both), "run_sharded_bfs direction 0 "
                                             "differs from bfs_layered")
            holds = "equal to bfs_layered"
        else:
            check(np.isin(seeds, got).all() and np.isin(got, both).all(),
                  f"run_sharded_bfs direction {direction}: not the seeds "
                  f"and a part of both directions' set")
            holds = "the seeds and a part of direction 0's set"
        say("sharded", f"run_sharded_bfs on the wide frontier ({len(kmap)} "
                       f"k-mers, {WIDE_SEEDS} seeds, radius {WIDE_RADIUS}), "
                       f"direction {direction:2d}: {got.size} visited, "
                       f"{holds}; {t_dev:.3f} s on the card ({layers[0]}), "
                       f"peak device memory {_peak_gib():.3f} GiB; "
                       f"collectives: "
                       f"{coll.summary()} ({card})")


def phase_sharded(rng, fq: str, small_fq: str, tmp: str, card: str) -> dict:
    """MC_COUNT_ENGINE=sharded at world size 1 on the card (an NCCL group of
    one, destroyed at the end) against the sort engine, and the sharded
    BFS. Returns the kernel launches by path."""
    import torch.distributed as dist
    from metacherchant_tpu_torch.counting import (count_kmers_device,
                                                  count_kmers_host)
    from metacherchant_tpu_torch.parallel.distributed import (
        initialize_distributed)
    dev = torch.device("cuda")
    initialize_distributed(device=dev)
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"group {dist.get_backend()} of {dist.get_world_size()}")
    launches = {}
    try:
        for k in (MAIN_K, HASH_K):
            hasher = None if k <= 31 else "poly"
            maps = {}
            for engine in ("sort", "sharded"):
                gc.collect()
                torch.cuda.reset_peak_memory_stats()
                before = _launches()
                t0 = time.perf_counter()
                with CollectiveCalls() as coll:
                    maps[engine] = count_kmers_device(
                        [fq], k, hasher, device=dev, engine=engine)
                secs = time.perf_counter() - t0
                launches[(engine, k)] = _launches() - before
                say("sharded", f"count_kmers_device(engine={engine!r}) k={k} "
                               f"on the slice's reads: {len(maps[engine])} "
                               f"distinct keys in {secs:.3f} s, kernel "
                               f"launches {launches[(engine, k)]}, peak "
                               f"device memory {_peak_gib():.3f} GiB; "
                               f"collectives: {coll.summary()} ({card})")
                check((coll.calls["all_to_all_single"] > 0)
                      == (engine == "sharded"),
                      f"engine {engine} k={k}: {coll.calls}")
                check(np.array_equal(maps[engine].keys, maps["sort"].keys)
                      and np.array_equal(maps[engine].counts,
                                         maps["sort"].counts),
                      f"engine {engine} k={k}: map differs from sort's")
                check(launches[(engine, k)] == launches[("sort", k)]
                      and (launches[(engine, k)] > 0) == (k <= 31),
                      f"engine {engine} k={k}: {launches[(engine, k)]} "
                      f"launches, sort {launches[('sort', k)]}")
            say("sharded", f"k={k}: sharded == sort key for key")
            del maps
        small = count_kmers_device([small_fq], MAIN_K, device=dev,
                                   engine="sharded")
        host = count_kmers_host([small_fq], MAIN_K)
        check(np.array_equal(small.keys, host.keys)
              and np.array_equal(small.counts, host.counts),
              "sharded count on the card differs from count_kmers_host")
        say("sharded", f"small set: sharded engine == count_kmers_host "
                       f"({len(host)} keys)")
        out = os.path.join(tmp, "out_sharded")
        torch.cuda.reset_peak_memory_stats()
        run = drive(["-t", "environment-finder", "-k", str(MAIN_K),
                     "-i", fq, "--seq", os.path.join(tmp, "genes.fasta"),
                     "-o", out, "--coverage", "5", "--maxradius", "1000",
                     "--work-dir", os.path.join(tmp, "wd_sharded")],
                    MC_COUNT_ENGINE="sharded")
        check(tree(out) == tree(os.path.join(tmp, "out")),
              "environment-finder under MC_COUNT_ENGINE=sharded differs from "
              "the slice's files")
        launches["cli"] = run.launches
        say("sharded", f"environment-finder -k {MAIN_K} "
                       f"MC_COUNT_ENGINE=sharded: files byte-identical to the "
                       f"slice's; {run.seconds:.3f} s, counting "
                       f"{run.line('Hashtable size')[0]:.3f} s, kernel "
                       f"launches {run.launches}, peak device memory "
                       f"{_peak_gib():.3f} GiB ({card})")
        sharded_bfs_checks(tmp, card)
    finally:
        dist.destroy_process_group()
    return launches


class ConsolidationRoutes:
    """Counts the consolidations made inside the block by route, with their
    lane totals: the sort engine's sort2 (ops/sortcount.consolidate, or
    _consolidate_full_split under MC_SORT_COMPACTION=shift) and merge-split
    routes (ops/consolidate_cuda.merge_into_store: the kernel on the card),
    and the merge engine's merge_rle_compact."""

    def __enter__(self):
        from metacherchant_tpu_torch.ops import mergecount, sortcount
        self.made = {"sort2": [], "shift": [], "merge-split": [],
                     "merge_rle_compact": []}
        targets = ((sortcount, "consolidate", "sort2"),
                   (sortcount, "_consolidate_full_split", "shift"),
                   (sortcount, "merge_into_store", "merge-split"),
                   (mergecount, "merge_rle_compact", "merge_rle_compact"))
        self.saved = [(mod, name, getattr(mod, name))
                      for mod, name, _ in targets]

        def counted(fn, route):
            def call(*args, **kw):
                # lanes in: the store's (merge-split: its store_cap, as
                # the JAX engine pads it) and the buffer's (or run's)
                store = args[4] if route == "merge-split" else args[0].numel()
                self.made[route].append(store + args[2].numel())
                return fn(*args, **kw)
            return call
        for (mod, name, fn), (_, _, route) in zip(self.saved, targets):
            setattr(mod, name, counted(fn, route))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)
        return False

    def summary(self) -> str:
        return ", ".join(
            f"{route} {len(n)} (lanes {min(n)}-{max(n)})"
            for route, n in self.made.items() if n) or "none"


@contextlib.contextmanager
def sort2_at_any_size():
    """The sort engine's 'auto' mode consolidates by sort2 at every size
    inside the block (the port's StreamCounter ceiling raised), so that
    count_kmers_device runs the sort2 route at the slice's size."""
    from metacherchant_tpu_torch.ops.sortcount import StreamCounter
    ceiling = StreamCounter.SORT2_LANE_CEILING
    StreamCounter.SORT2_LANE_CEILING = 1 << 62
    try:
        yield
    finally:
        StreamCounter.SORT2_LANE_CEILING = ceiling


def _device_ms(fn, reps: int = 3) -> tuple[float | None, float]:
    """(device ms of every kernel one call of `fn` runs, from torch.profiler
    over `reps` calls, or None when it saw none; ms per call between CUDA
    events), warm."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(ev) for ev in prof.key_averages())
    return (us / 1e3 / reps if us else None), _time_ms(fn, reps)


def consolidation_ms(keys: np.ndarray, cnts: np.ndarray, card: str) -> dict:
    """One consolidation by each route at the slice's final geometry: the
    distinct 31-mers as a 2^25-lane store and a full 2^25-lane buffer of
    their keys (90%) and new ones, and the merge engine's 2^25-lane store
    with a run of 4 x 2^20 lanes. sort2, shift and merge-split return the
    same full-length result, checked here; device ms by route."""
    from metacherchant_tpu_torch.ops import bitonic, sortcount
    from metacherchant_tpu_torch.ops.kmers import SENTINEL
    dev = torch.device("cuda")
    rng = np.random.default_rng(19)
    lanes = 1 << 25
    store = torch.full((lanes,), SENTINEL, dtype=torch.int64, device=dev)
    store_c = torch.zeros(lanes, dtype=torch.int32, device=dev)
    store[:keys.size] = torch.from_numpy(keys).to(dev)
    store_c[:keys.size] = torch.from_numpy(cnts).to(dev)
    pick = rng.integers(0, keys.size, lanes)
    new = rng.random(lanes) < 0.1
    buf = torch.from_numpy(np.where(new, rng.integers(0, 1 << 62, lanes),
                                    keys[pick])).to(dev)
    run = torch.sort(buf[:1 << 22]).values
    routes = {
        "sort2": lambda: sortcount._consolidate_full_split(
            store, store_c, buf, lanes),
        "shift": lambda: sortcount._consolidate_full_split(
            store, store_c, buf, lanes),
        "merge-split": lambda: sortcount._consolidate_merge_split(
            store, store_c, buf, lanes),
        "merge_rle_compact": lambda: bitonic.merge_rle_compact(
            store, store_c, run),
    }
    out, results = {}, {}
    for route, fn in routes.items():
        env = {"MC_SORT_COMPACTION": "shift"} if route == "shift" else {}
        os.environ.update(env)
        try:
            gc.collect()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            results[route] = [t.cpu() for t in fn()]
            dev_ms, ev_ms = _device_ms(fn)
            peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        finally:
            for name in env:
                del os.environ[name]
        out[route] = {"device_ms": dev_ms, "event_ms": ev_ms,
                      "lanes": results[route][0].numel(), "peak_gib": peak}
        say("count-engines", f"one consolidation by {route}: "
                             f"{results[route][0].numel()} lanes out, "
                             f"{int(results[route][2])} distinct; device "
                             + (f"{dev_ms:.3f} ms" if dev_ms is not None
                                else "time not measured")
                             + f", {ev_ms:.3f} ms between events, "
                             f"{peak:.3f} GiB above the inputs ({card})")
    for route in ("shift", "merge-split"):
        check(all(torch.equal(a, b) for a, b in
                  zip(results[route], results["sort2"], strict=True)),
              f"the {route} consolidation differs from sort2's, lane for lane")
    say("count-engines", "sort2, shift and merge-split: the same full-length "
                         "result, lane for lane")
    return out


#: the largest merge-route consolidation of each counting cell of the
#: benchmark (store keys in, buffer lanes filled, the store's and the
#: buffer's capacities), from its count.consolidate spans on seed 3000000021
MERGE_SHAPES = {"fmt-k31.count": (118_420_347, 134_184_960, 1 << 27,
                                  1 << 27),
                "envfinder-k31.genes3": (15_468_052, 16_711_680, 1 << 24,
                                         1 << 24)}


def merge_kernel_ms(card: str) -> dict:
    """The merge route's kernel (ops/consolidate_cuda) at the counting
    cells' largest call shapes: a store of random distinct keys and a
    buffer of 90% store keys and 10% new ones, filled to the call's lanes. Times between CUDA events of
    the kernel alone (on the sorted lanes), of the whole new consolidation
    (torch.sort of the lanes, then the kernel) and of the plain route on
    the card (the JAX package's merge-split at the padded total), beside
    the bound: peaks.consolidate_bytes over 3.35 TB/s. The kernel's store
    equals the plain route's, key for key."""
    from benchmark import peaks
    from metacherchant_tpu_torch.ops import consolidate_cuda as cc
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    out = {}
    for cell, (store_in, lanes, store_cap, buffer_cap) in \
            MERGE_SHAPES.items():
        gen.manual_seed(store_in)
        keys = torch.unique(torch.randint(0, 1 << 62, (store_in + store_in
                                                       // 64,),
                                          generator=gen, device=dev))
        keys = keys[torch.randperm(keys.numel(), generator=gen,
                                   device=dev)[:store_in]].sort().values
        cnts = torch.randint(1, 50, (store_in,), generator=gen, device=dev,
                             dtype=torch.int32)
        pick = torch.randint(0, store_in, (buffer_cap,), generator=gen,
                             device=dev)
        fresh = torch.randint(0, 1 << 62, (buffer_cap,), generator=gen,
                              device=dev)
        buf = torch.where(torch.rand(buffer_cap, generator=gen,
                                     device=dev) < 0.9, keys[pick], fresh)
        del pick, fresh
        run = torch.sort(buf[:lanes]).values
        got = cc._merge_sorted_run(keys, cnts, run)
        nbytes = peaks.consolidate_bytes(store_in, lanes, got[0].numel())
        kernel = _time_ms(lambda: cc._merge_sorted_run(keys, cnts, run), 3)
        del run
        whole = _time_ms(lambda: cc.merge_into_store(keys, cnts, buf, lanes,
                                                     store_cap), 3)
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        want = cc.merge_into_store_plain(keys, cnts, buf, lanes, store_cap)
        plain_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        plain = _time_ms(lambda: cc.merge_into_store_plain(
            keys, cnts, buf, lanes, store_cap), 1)
        check(all(torch.equal(a, b) for a, b in zip(got, want, strict=True)),
              f"{cell}: the merge kernel's store differs from the plain "
              f"route's")
        del want
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        cc.merge_into_store(keys, cnts, buf, lanes, store_cap)
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        bound = peaks.bound_s(nbytes) * 1e3
        out[cell] = {"store_in": store_in, "lanes": lanes,
                     "store_out": got[0].numel(), "bytes": nbytes,
                     "bound_ms": bound, "kernel_ms": kernel,
                     "whole_ms": whole, "plain_ms": plain,
                     "kernel_share": bound / kernel,
                     "whole_share": bound / whole,
                     "whole_peak_gib": peak, "plain_peak_gib": plain_peak}
        say("count-engines", f"merge kernel at {cell}'s largest call (store "
                             f"{store_in} keys, {lanes} lanes, "
                             f"{got[0].numel()} out, {nbytes} bytes, bound "
                             f"{bound:.3f} ms): kernel {kernel:.3f} ms "
                             f"({100 * bound / kernel:.1f}%), sort + kernel "
                             f"{whole:.3f} ms ({100 * bound / whole:.2f}%, "
                             f"{peak:.3f} GiB above the inputs), plain route "
                             f"{plain:.3f} ms ({plain_peak:.3f} GiB); key "
                             f"for key equal ({card})")
        del keys, cnts, buf, got
        gc.collect()
    return out


def phase_count_engines(fq: str, genes: str, tmp: str, card: str) -> dict:
    """count_kmers_device on the slice's reads under the sort engine's
    routes and the merge and chunk engines, each key for key against
    sort2, with consolidations by route, seconds, kernel launches and peak
    memory; one consolidation's device ms by route at the slice's final
    geometry; the chunk engine's largest launch against the plain version
    with its share of the byte bound; environment-finder -k 31 under
    MC_COUNT_ENGINE=merge and chunk against the slice's files. Returns the
    launches by path, the chunk launch's record and the consolidations'
    device ms."""
    from metacherchant_tpu_torch import trace
    from metacherchant_tpu_torch.counting import count_kmers_device
    from metacherchant_tpu_torch.ops import sortcount
    dev = torch.device("cuda")
    launches, maps = {}, {}
    chunk_calls = []
    append = sortcount.append_ragged

    def captured(buf, offset, codes, starts, lens, offs, n, k):
        chunk_calls.append((n, codes.clone(), starts.clone(), lens.clone()))
        return append(buf, offset, codes, starts, lens, offs, n, k)

    runs = ((MAIN_K, "sort2", "sort"), (MAIN_K, "auto", "sort"),
            (MAIN_K, "shift", "sort"), (MAIN_K, "merge", "merge"),
            (MAIN_K, "chunk", "chunk"), (HASH_K, "sort2", "sort"),
            (HASH_K, "merge", "merge"), (HASH_K, "chunk", "chunk"))
    for k, label, engine in runs:
        hasher = None if k <= 31 else "poly"
        gc.collect()
        torch.cuda.reset_peak_memory_stats()
        if label == "shift":
            os.environ["MC_SORT_COMPACTION"] = "shift"
        if label == "chunk" and k == MAIN_K:
            sortcount.append_ragged = captured
        try:
            with contextlib.ExitStack() as stack:
                if label in ("sort2", "shift"):
                    stack.enter_context(sort2_at_any_size())
                routes = stack.enter_context(ConsolidationRoutes())
                before = _launches()
                merges_before = trace.counter("consolidate.launches")
                t0 = time.perf_counter()
                got = count_kmers_device([fq], k, hasher, device=dev,
                                         engine=engine)
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                launches[label, k] = _launches() - before
                merges = trace.counter("consolidate.launches") - merges_before
        finally:
            os.environ.pop("MC_SORT_COMPACTION", None)
            sortcount.append_ragged = append
        if label == "sort2":
            maps[k] = got
        else:
            check(np.array_equal(got.keys, maps[k].keys)
                  and np.array_equal(got.counts, maps[k].counts),
                  f"k={k} {label}: the map differs from sort2's")
        say("count-engines", f"count_kmers_device k={k} {label} (engine "
                             f"{engine}): {len(got)} distinct keys"
                             + ("" if label == "sort2" else
                                ", key for key equal to sort2's")
                             + f"; {secs:.3f} s, kernel launches "
                             f"{launches[label, k]}, peak device memory "
                             f"{_peak_gib():.3f} GiB; consolidations: "
                             f"{routes.summary()}; merge kernel launches "
                             f"{merges} ({card})")
        made = {r: len(n) for r, n in routes.made.items()}
        check(merges == made["merge-split"],
              f"k={k} {label}: {merges} merge kernel launches for "
              f"{made['merge-split']} merge-split consolidations")
        if label == "auto":
            merge_launches = merges
        if label in ("sort2", "shift"):
            check(made["merge-split"] == 0 and made["merge_rle_compact"] == 0,
                  f"k={k} {label} took another route: {made}")
        if label == "shift":
            check(made["shift"] > 0, f"no shift compaction: {made}")
        if label == "auto":
            check(max(routes.made["merge-split"], default=0) == 1 << 26,
                  f"auto never consolidated by merge-split at 2^25 + 2^25 "
                  f"lanes: {routes.summary()}")
        if engine == "merge":
            check(made["merge_rle_compact"] > 0
                  and made["sort2"] + made["merge-split"] == 0,
                  f"merge engine's consolidations: {made}")
        if k == MAIN_K and engine != "chunk":
            check(launches[label, k] == launches["sort2", k] > 0,
                  f"k={k} {label}: {launches[label, k]} launches, sort2 "
                  f"{launches['sort2', k]}")
        if k > 31:
            check(launches[label, k] == 0, f"k={k} {label}: "
                                           f"{launches[label, k]} launches")
    n_chunks = len(chunk_calls)
    check(0 < launches["chunk", MAIN_K] == n_chunks
          < launches["sort2", MAIN_K] // 4,
          f"chunk engine: {launches['chunk', MAIN_K]} launches, "
          f"{n_chunks} appends, sort {launches['sort2', MAIN_K]}")
    say("count-engines", f"chunk engine k={MAIN_K}: {n_chunks} launches "
                         f"for the sort engine's {launches['sort2', MAIN_K]}"
                         f", windows per launch "
                         f"{[c[0] for c in chunk_calls]}")
    n, codes, starts, lens = max(chunk_calls, key=lambda c: c[0])
    del chunk_calls
    chunk_rec = hold_ragged(codes.cpu().numpy(), starts.cpu().numpy(),
                            lens.cpu().numpy(), MAIN_K,
                            f"chunk engine's largest launch, {lens.numel()} "
                            f"chunks, {n} windows", card)
    chunk_rec["launches"] = n_chunks
    del codes, starts, lens
    cons = consolidation_ms(maps[MAIN_K].keys, maps[MAIN_K].counts, card)
    del maps
    merge_kernel = merge_kernel_ms(card)
    slice_out = tree(os.path.join(tmp, "out"))
    for engine in ("merge", "chunk"):
        out = os.path.join(tmp, f"out_{engine}")
        torch.cuda.reset_peak_memory_stats()
        run = drive(["-t", "environment-finder", "-k", str(MAIN_K),
                     "-i", fq, "--seq", genes, "-o", out,
                     "--coverage", "5", "--maxradius", "1000",
                     "--work-dir", os.path.join(tmp, f"wd_{engine}")],
                    MC_COUNT_ENGINE=engine)
        check(tree(out) == slice_out,
              f"environment-finder under MC_COUNT_ENGINE={engine} differs "
              f"from the slice's files")
        launches["cli", engine] = run.launches
        check(run.launches == launches[engine, MAIN_K],
              f"environment-finder MC_COUNT_ENGINE={engine}: "
              f"{run.launches} launches, count {launches[engine, MAIN_K]}")
        say("count-engines", f"environment-finder -k {MAIN_K} "
                             f"MC_COUNT_ENGINE={engine}: {len(slice_out)} "
                             f"files byte-identical to the slice's; "
                             f"{run.seconds:.3f} s, counting "
                             f"{run.line('Hashtable size')[0]:.3f} s, kernel "
                             f"launches {run.launches}, peak device memory "
                             f"{_peak_gib():.3f} GiB ({card})")
    paths = {(f"environment-finder -k {MAIN_K} MC_COUNT_ENGINE={k}"
              if label == "cli" else f"count_kmers_device -k {k} {label}"
              + ("" if label in ("merge", "chunk") else " (sort engine)")): n
             for (label, k), n in launches.items()}
    return {"launches": paths, "chunk": chunk_rec, "consolidation": cons,
            "merge_kernel": merge_kernel, "merge_launches": merge_launches}


def phase_scalar_poly(fq: str, genes: str, tmp: str, card: str) -> None:
    """Phase 8's environments again, walked by the scalar sliding-poly FIFO
    (the host engine of poly-hashed BFS where the native library is off)."""
    from metacherchant_tpu_torch.algo.environment_hashed import (
        build_environment_hashed)
    from metacherchant_tpu_torch.counting import count_kmers_device
    from metacherchant_tpu_torch.io.readers import read_rich_fasta
    from metacherchant_tpu_torch.io.writers import load_graph_txt
    t0 = time.perf_counter()
    kmap = count_kmers_device([fq], HASH_K, "poly",
                              device=torch.device("cuda"))
    say("scalar-poly", f"k={HASH_K} poly map of phase 5's reads: {len(kmap)} "
                       f"distinct keys, counted in "
                       f"{time.perf_counter() - t0:.3f} s ({card})")
    stamps = _Stamps()
    log = logging.getLogger("metacherchant")
    level, native_bfs = log.level, os.environ.get("MC_NATIVE_BFS")
    log.addHandler(stamps)
    log.setLevel(logging.DEBUG)
    os.environ["MC_NATIVE_BFS"] = "0"
    try:
        for rec in read_rich_fasta(genes):
            t0 = time.perf_counter()
            env = build_environment_hashed(
                [rec.seq], HASH_K, kmap, 5, "poly", both_directions=False,
                max_radius=1000, max_kmers=None, trim=False)
            seconds = time.perf_counter() - t0
            want = load_graph_txt(os.path.join(tmp, "out55", rec.comment,
                                               "graph.txt"))
            check(not env.fail and env.as_dict() == want,
                  f"{rec.comment}: the scalar sliding-poly FIFO's "
                  f"environment differs from the native FIFO's")
            say("scalar-poly", f"{rec.comment}: {len(want)} normalized "
                               f"k-mers equal to phase 8's graph.txt; "
                               f"{seconds:.3f} s ({card})")
    finally:
        log.removeHandler(stamps)
        log.setLevel(level)
        if native_bfs is None:
            del os.environ["MC_NATIVE_BFS"]
        else:
            os.environ["MC_NATIVE_BFS"] = native_bfs
    lines = [m for _, m, _ in stamps.records if m.startswith("scalar")]
    check(len(lines) == 7 and "key dict" in lines[0],
          f"expected the key dict's line and six scalar sliding-poly FIFO "
          f"directions, got {lines}")
    for m in lines:
        say("scalar-poly", f"  {m}")


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
    try:
        import metacherchant_tpu_torch  # noqa: F401
    except ModuleNotFoundError:
        print("chip_smoke: metacherchant_tpu_torch not found; run it from "
              "the root of a checkout; nothing was run", file=sys.stderr)
        return 2

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
        slice_run, fq, genes = timed("slice", smi, phase_slice, rng,
                                     genomes, tmp, smi)
        launches = slice_run.launches
        timed("hashed-ops", smi, phase_hashed_ops, rng, smi)
        timed("hashed-oracle", smi, phase_hashed_oracle, rng, genomes, tmp,
              small_fq, smi)
        hashed_run = timed("hashed-slice", smi, phase_hashed_slice, fq,
                           genes, tmp, smi)
        hashed = hashed_run.launches
        dbfs = timed("device-bfs", smi, phase_device_bfs, rng, tmp,
                     slice_run, fq, genes, hashed_run, small_fq, smi)
        cls = timed("classify-slice", smi, phase_classify_slice, rng,
                    genomes, fq, tmp, smi)
        contract = timed("contract-ops", smi, phase_contract_ops, rng, tmp,
                         small_fq, smi)
        triple = timed("triple-slice", smi, phase_triple_slice, fq, cls, tmp,
                       smi)
        cov = timed("seq-cov", smi, phase_seq_cov, rng, fq, genes, small_fq,
                    cls["genomes_b"], tmp, smi)
        fmt, recipient = timed("fmt", smi, phase_fmt, rng, tmp, smi)
        n_reads = 20 * genomes.size // 150
        asm = timed("assembler", smi, phase_assembler, fq, genes, small_fq,
                    n_reads, tmp, smi)
        hic = timed("hic", smi, phase_hic, rng, genomes, fq, genes, small_fq,
                    n_reads, tmp, smi)
        multi = timed("multi", smi, phase_multi, tmp, smi)
        sharded = timed("sharded", smi, phase_sharded, rng, fq, small_fq,
                        tmp, smi)
        engines = timed("count-engines", smi, phase_count_engines, fq,
                        genes, tmp, smi)
        timed("scalar-poly", smi, phase_scalar_poly, fq, genes, tmp, smi)
    print(json.dumps({"kernels": [{
        "name": "extract_append",
        "route": "cuda",
        "source": "metacherchant_tpu_torch/csrc/extract_kmers.cu",
        "replaces": "metacherchant_tpu/ops/pallas_kmers.py:45",
        "launches": launches,
        "launches_by_path": {
            f"environment-finder -k {MAIN_K}": launches,
            f"environment-finder -k {HASH_K} (hashed)": hashed,
            f"kmer-counter -k {MAIN_K}": cls["counter"],
            "reads-classifier MC_DEVICE_CLASSIFY=1": cls["classify"],
            f"triple-reads-classifier -k {MAIN_K} -k2 {TRIPLE_K2} "
            "MC_DEVICE_CLASSIFY=1": triple,
            f"seq-cov -k {MAIN_K}": cov,
            f"fmt-visualiser -k {MAIN_K} MC_DEVICE_CONTRACT=1": fmt,
            f"recipient-visualiser -k {MAIN_K}": recipient,
            f"environment-finder -k {MAIN_K} MC_DEVICE_CONTRACT=1 (small)":
                contract,
            f"count_kmers_device -k {MAIN_K} MC_COUNT_ENGINE=hash":
                dbfs["hash-count"],
            f"environment-finder -k {MAIN_K} MC_COUNT_ENGINE=hash":
                dbfs["hash"],
            f"environment-finder -k {MAIN_K} MC_DEVICE_BFS=1 (dense)":
                dbfs["dense"],
            f"environment-finder -k {MAIN_K} MC_DEVICE_BFS=1 "
            "MC_DEVICE_BFS_ENGINE=probe": dbfs["probe"],
            f"environment-finder -k {HASH_K} MC_DEVICE_BFS=1 (multiword)":
                dbfs["multiword"],
            **{f"environment-finder -k {MAIN_K} wide frontier ({mode})":
               dbfs[f"wide-{mode}"] for mode in ("host", "dense", "probe")},
            f"environment-assembler-finder -k {MAIN_K} (stage 1)":
                asm["stage1"],
            f"environment-assembler-finder stage 3 -k {REENV_K}":
                asm["stage3"],
            "hic-pipeline pass 1": hic["pass1"],
            "hic-pipeline pass 2": hic["pass2"],
            "environment-finder-multi": multi,
            f"count_kmers_device -k {MAIN_K} MC_COUNT_ENGINE=sharded":
                sharded[("sharded", MAIN_K)],
            f"count_kmers_device -k {HASH_K} MC_COUNT_ENGINE=sharded "
            "(hashed)": sharded[("sharded", HASH_K)],
            f"environment-finder -k {MAIN_K} MC_COUNT_ENGINE=sharded":
                sharded["cli"],
            **engines["launches"],
        },
        "max_abs_err": kernel["max_abs_err"],
        "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"],
        "bound_ms": kernel["bound_ms"],
        "bound_by": "bytes",
        "share_of_bound": kernel["share_of_bound"],
        "library_ms": None,
        "chunk_launch": {key: engines["chunk"][key] for key in (
            "launches", "ms", "plain_ms", "bound_ms", "share_of_bound")},
        "consolidation_ms": {
            route: {key: c[key] for key in ("device_ms", "event_ms")}
            for route, c in engines["consolidation"].items()},
        "shapes": kernel["shapes"] + [engines["chunk"]],
    }, {
        "name": "merge_into_store",
        "route": "cuda",
        "source": "metacherchant_tpu_torch/csrc/consolidate.cu",
        "replaces": None,
        "launches": {f"count_kmers_device -k {MAIN_K} auto (sort engine)":
                     engines["merge_launches"]},
        "bound_by": "bytes",
        "library_ms": None,
        "shapes": engines["merge_kernel"],
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
