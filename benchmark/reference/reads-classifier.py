"""Plain reference of reads-classifier in the exact regime (k <= 31).

What MetaCherchant's reads-classifier writes (src/tools/ReadsClassifier.java
:95-223, src/algo/ReadsFinderInGraph.java:37-140), worked out again from the
input hook's files, the donor's dump (files["dump"]) and the recipient's
mates (files["mate1"], files["mate2"]). Plain torch and numpy; nothing of
the program.

- The dump, read by its own parser: a big-endian int64 key and an int16
  count per record, the records with a count above 0 kept (loadGraph).
- The mates: recount.read_fastq_codes for the bases, the quality lines
  beside them, in the format ReadersUtils decides (Phred+33 where a quality
  of the first 1,000 reads lies below '@' or above '~', else Phred+64).
- Every window's canonical key (recount.canonical_keys: A=0, G=1, C=2, T=3,
  the first base in the high bits) looked up in the dump, 0 where absent
  (getWithZero); in blocks of reads on the device given.
- ReadsFinderInGraph's arithmetic in float64, on the host: mean = (the
  windows' counts + the last window's count x (k - 1)) / len, breadth the
  same over windows with a count; theory = 1 - e^-mean, std =
  z sqrt(e^-mean (1 - e^-mean) / len); accepted where breadth == 1, or
  breadth != 0 and |breadth - theory| <= std; found where breadth >=
  found_threshold / 100 and accepted; a read shorter than k never found.
- Each pair to its bins: both mates found to found_1 and found_2, neither
  to not_found_1 and not_found_2, one of them to found_s (the found mate)
  and not_found_s (the other).
- Qualities written as WritersUtils does: Phred+64, clamped at 62.

Departures from the Java code:
- Records are compared as multisets, a pair bin's records as pairs of the
  two files' records at one line position: Java's concurrent queues fix no
  order within a bin, and its writers number the records.
- The mates have one length (read_fastq_codes refuses others) and hold only
  A, C, G and T (it refuses others): no N, no empty mate (PairFinder's
  single-end convention), as the benchmark writes them.
- No --correction (the cell runs without it) and no hashed regime (k > 31).

key_bits merges the dump's counts under that many low bits of each key (a
table that keeps only those bits), which gives the control: a window then
counts every dump key that shares its low bits.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from benchmark.reference import recount

#: each bin's multiset and the number that counts its wrong records
WRONG = {"found": "found_pairs_wrong", "not_found": "not_found_pairs_wrong",
         "found_s": "found_s_wrong", "not_found_s": "not_found_s_wrong"}
LIMITS = dict.fromkeys(WRONG.values(), 0)
BINS = ("found_1", "found_2", "not_found_1", "not_found_2", "found_s",
        "not_found_s")
MATES = ("mate1", "mate2")
RECORD = np.dtype([("k", ">i8"), ("c", ">i2")])
ROWS_PER_BLOCK = 1 << 16
#: quality formats are told apart on this many reads (ReadersUtils)
QUALITY_HEAD = 1000


def read_dump(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(keys, counts) of a kmers.bin's records with a count above 0."""
    rec = np.fromfile(path, RECORD)
    keep = rec["c"] > 0
    return (rec["k"][keep].astype(np.int64),
            rec["c"][keep].astype(np.int64))


def read_mates(path: str) -> tuple[np.ndarray, list[bytes]]:
    """The (n, L) codes of a FASTQ file and each record as written to a
    bin: its bases and its qualities in Phred+64, clamped at 62."""
    codes = recount.read_fastq_codes(path)
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    seqs, quals = lines[1::4][:len(codes)], lines[3::4][:len(codes)]
    head = b"".join(quals[:QUALITY_HEAD])
    sanger = bool(head) and (min(head) < 64 or max(head) > 126)
    offset = 33 if sanger else 64
    table = bytes((min(q - offset, 62) + 64) & 0xFF for q in range(256))
    return codes, [s + b"\n" + q.translate(table)
                   for s, q in zip(seqs, quals)]


def _table(keys: np.ndarray, counts: np.ndarray, key_bits: int | None,
           device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """The dump as sorted distinct keys (or their low key_bits bits) and
    their summed, saturated counts on the device."""
    k = torch.from_numpy(keys).to(device)
    if key_bits is not None:
        k = k & ((1 << key_bits) - 1)
    uniq, inverse = torch.unique(k, sorted=True, return_inverse=True)
    summed = torch.zeros(uniq.numel(), dtype=torch.int64, device=device)
    summed.index_add_(0, inverse, torch.from_numpy(counts).to(device))
    return uniq, summed.clamp_max(recount.SATURATION)


def found_reads(codes: np.ndarray, table, cfg: dict, device: torch.device,
                key_bits: int | None = None) -> np.ndarray:
    """Whether each read of (n, L) codes is found in the dump's table."""
    k = cfg["k"]
    n, length = codes.shape
    if length < k:
        return np.zeros(n, bool)
    keys, counts = table
    total = np.zeros(n, np.int64)
    hits = np.zeros(n, np.int64)
    last = np.zeros(n, np.int64)
    for r0 in range(0, n, ROWS_PER_BLOCK):
        block = torch.from_numpy(codes[r0:r0 + ROWS_PER_BLOCK]).to(device)
        q = recount.canonical_keys(block, k).reshape(block.shape[0], -1)
        if key_bits is not None:
            q = q & ((1 << key_bits) - 1)
        if keys.numel() == 0:
            continue
        pos = torch.searchsorted(keys, q).clamp_max_(keys.numel() - 1)
        cov = torch.where(keys[pos] == q, counts[pos], 0)
        r1 = r0 + block.shape[0]
        total[r0:r1] = cov.sum(1).cpu().numpy()
        hits[r0:r1] = (cov > 0).sum(1).cpu().numpy()
        last[r0:r1] = cov[:, -1].cpu().numpy()
    mean = (total + last * (k - 1)) / float(length)
    breadth = (hits + (last > 0) * (k - 1)) / float(length)
    p = np.exp(-mean)
    theory = 1.0 - p
    std = cfg["z"] * np.sqrt(p * (1 - p) / float(length))
    accept = (breadth == 1) | ((breadth != 0)
                               & (np.abs(breadth - theory) <= std))
    return (breadth >= cfg["found_threshold"] / 100.0) & accept


def _bins(records: list[list[bytes]], found: list[np.ndarray]) -> dict:
    """The bins of pairs whose mates are `found`, as multisets."""
    (r1, r2), (f1, f2) = records, found
    both = np.flatnonzero(f1 & f2).tolist()
    neither = np.flatnonzero(~f1 & ~f2).tolist()
    first = np.flatnonzero(f1 & ~f2).tolist()
    second = np.flatnonzero(~f1 & f2).tolist()
    return {
        "found": Counter((r1[i], r2[i]) for i in both),
        "not_found": Counter((r1[i], r2[i]) for i in neither),
        "found_s": Counter([r1[i] for i in first] + [r2[i] for i in second]),
        "not_found_s": Counter([r2[i] for i in first]
                               + [r1[i] for i in second])}


def solve(cfg: dict, reads: str, genes: list, device: torch.device,
          key_bits: int | None = None, files: dict | None = None
          ) -> list[dict]:
    """The expected bins, the same for every job of the list."""
    table = _table(*read_dump(files["dump"]), key_bits, device)
    records, found = [], []
    for m in MATES:
        codes, recs = read_mates(files[m])
        records.append(recs)
        found.append(found_reads(codes, table, cfg, device, key_bits))
    return [_bins(records, found)] * len(genes)


def _records(path: str) -> list[bytes]:
    """Each FASTQ record of a bin as its bases and qualities."""
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    n = len(lines) // 4
    return [s + b"\n" + q for s, q in zip(lines[1:4 * n:4], lines[3:4 * n:4])]


def _pairs(a: list[bytes], b: list[bytes]) -> Counter:
    n = max(len(a), len(b))
    a, b = a + [b""] * (n - len(a)), b + [b""] * (n - len(b))
    return Counter(zip(a, b))


def read_outputs(cfg: dict, job) -> dict | None:
    """The bins the program wrote for the job (its out_dir), as multisets;
    None where a bin is missing."""
    try:
        got = {b: _records(os.path.join(job.out_dir, b + ".fastq"))
               for b in BINS}
    except OSError:
        return None
    return {"found": _pairs(got["found_1"], got["found_2"]),
            "not_found": _pairs(got["not_found_1"], got["not_found_2"]),
            "found_s": Counter(got["found_s"]),
            "not_found_s": Counter(got["not_found_s"])}


def compare(want: dict, got: dict | None) -> dict[str, int]:
    """Records in one multiset and not the other, per bin."""
    out = {}
    for name, wrong in WRONG.items():
        a, b = want[name], Counter() if got is None else got[name]
        out[wrong] = sum(((a - b) + (b - a)).values())
    return out
