"""Plain reference of the stand-in kmer-counter-pairs: what kmer-counter
writes (reference/kmer-counter.py, whose reading of the outputs and
comparison it takes) for the k-mers of both mate files together, in files
named after mate 1, the tool's first input."""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.reference import recount

_spec = importlib.util.spec_from_file_location(
    "benchmark_reference_kmer_counter_of_pairs",
    Path(__file__).with_name("kmer-counter.py"))
_counter = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_counter)

LIMITS, compare = _counter.LIMITS, _counter.compare


def solve(cfg: dict, reads: str, genes: list, device: torch.device,
          key_bits: int | None = None, files: dict | None = None
          ) -> list[dict]:
    codes = np.concatenate([recount.read_fastq_codes(files[m])
                            for m in ("mate1", "mate2")])
    keys, counts = recount.count(codes, cfg["k"], device, key_bits)
    keep = counts > cfg["threshold"]
    nums = np.bincount(counts)
    freqs = np.flatnonzero(nums)
    stat = ["# k-mer frequency\tnumber of such k-mers"]
    stat += [f"{f}\t{n}" for f, n in zip(freqs.tolist(),
                                         nums[freqs].tolist())]
    want = {"keys": keys[keep], "counts": counts[keep], "stat": stat + [""]}
    return [want] * len(genes)


def read_outputs(cfg: dict, job) -> dict | None:
    return _counter.read_outputs(cfg, SimpleNamespace(
        out_dir=job.out_dir, reads=job.files["mate1"]))
