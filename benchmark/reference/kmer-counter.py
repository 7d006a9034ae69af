"""Plain reference of kmer-counter in the exact regime (k <= 31).

What MetaCherchant's kmer-counter writes (KmersCounter, IOUtils.printKmers),
worked out again from the reads: <reads>.kmers.bin holds one record per
canonical k-mer whose count exceeds -b, a big-endian int64 key and an int16
count; <reads>.stat.txt the histogram of every distinct k-mer's count,
'count<TAB>k-mers' ascending under a header, then an empty line. Records
are compared as a set, so their order is the program's affair.
"""
from __future__ import annotations

import os
from collections import Counter

import numpy as np
import torch

from benchmark.reference import recount

LIMITS = {"kmer_records_wrong": 0, "stat_lines_wrong": 0}
RECORD = np.dtype([("k", ">i8"), ("c", ">i2")])


def _stem(reads: str) -> str:
    return os.path.splitext(os.path.basename(reads))[0]


def solve(cfg: dict, reads: str, genes: list, device: torch.device,
          key_bits: int | None = None) -> list[dict]:
    """The expected outputs, the same for every job of the list."""
    keys, counts = recount.count(recount.read_fastq_codes(reads), cfg["k"],
                                 device, key_bits)
    keep = counts > cfg["threshold"]
    nums = np.bincount(counts)
    freqs = np.flatnonzero(nums)
    stat = ["# k-mer frequency\tnumber of such k-mers"]
    stat += [f"{f}\t{n}" for f, n in zip(freqs.tolist(),
                                         nums[freqs].tolist())]
    want = {"keys": keys[keep], "counts": counts[keep], "stat": stat + [""]}
    return [want] * len(genes)


def read_outputs(cfg: dict, job) -> dict | None:
    """What the program wrote for the job (its out_dir and reads); None
    where a file is missing."""
    stem = os.path.join(job.out_dir, _stem(job.reads))
    try:
        rec = np.fromfile(stem + ".kmers.bin", RECORD)
        with open(stem + ".stat.txt") as fh:
            stat = fh.read().split("\n")[:-1]
    except OSError:
        return None
    return {"keys": rec["k"].astype(np.int64),
            "counts": rec["c"].astype(np.int64), "stat": stat}


def compare(want: dict, got: dict | None) -> dict[str, int]:
    if got is None:
        return {"kmer_records_wrong": int(want["keys"].size),
                "stat_lines_wrong": len(want["stat"])}
    wk, wc, gk, gc = want["keys"], want["counts"], got["keys"], got["counts"]
    if np.array_equal(wk, gk) and np.array_equal(wc, gc):
        records = 0
    else:
        _, iw, ig = np.intersect1d(wk, gk, return_indices=True)
        records = (wk.size - iw.size) + (gk.size - ig.size) \
            + int(np.count_nonzero(wc[iw] != gc[ig]))
    a, b = Counter(want["stat"]), Counter(got["stat"])
    return {"kmer_records_wrong": int(records),
            "stat_lines_wrong": sum(((a - b) + (b - a)).values())}
