"""kmer-counter: standalone counting -> kmers.bin + frequency histogram.

Reimplements src/tools/KmersCounter.java: count reads, dump records with count
> threshold as 10-byte binary records plus a k-mer frequency spectrum, with
the reference's sanity warnings (:108-118). Carried over from
metacherchant_tpu/tools/kmer_counter.py; counting runs on the device of
device.py.
"""
from __future__ import annotations

import os
import time

from .. import trace
from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..counting import count_kmers
from ..io.writers import write_kmers_bin


class KmersCounter(Tool):
    NAME = "kmer-counter"
    DESCRIPTION = "Count k-mers in given reads with ArrayLong2IntHashMap"

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.input_files = self.add_parameter(Parameter(
            "reads", str, short="i", multi=True, mandatory=True,
            description="list of reads files from single environment. "
                        "FASTQ, BINQ, FASTA"))
        self.max_size = self.add_parameter(Parameter(
            "threshold", int, short="b", default=0,
            description="maximal frequency for a k-mer to be assumed erroneous"))
        self.force_hashing = self.add_parameter(Parameter(
            "forcehash", bool, default=False,
            description="force k-mer hashing (even for k <= 31)"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))
        self.output_dir = self.add_parameter(Parameter(
            "output", str, short="o", description="output directory",
            lazy_default=lambda t: os.path.join(t.work_dir.get(t), "kmers")))

    def run_impl(self) -> None:
        k = self.k.get(self)
        hasher = None
        if k > 31 or self.force_hashing.get(self):
            hasher = ("fnv1a" if self.hash_function.get(self).lower() == "fnv1a"
                      else "poly")
        files = self.input_files.get(self)
        for f in files:
            if not os.path.exists(f):
                raise ExecutionFailedException(f"Could not load reads from {f}")
        dev = tool_device()
        t0 = time.time()
        # minSeqLen = k (KmersCounter passes k, src/tools/KmersCounter.java:57-68)
        kmap = count_kmers(files, k, hasher, min_len=k, device=dev)
        self.info("Reads loaded in %.1f s, %d distinct k-mers", time.time() - t0, len(kmap))
        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        # output file named after the first input (KmersCounter.java:87-101)
        base = os.path.basename(str(files[0]))
        for ext in (".gz", ".bz2"):
            if base.endswith(ext):
                base = base[: -len(ext)]
        base = os.path.splitext(base)[0]
        bin_path = os.path.join(out, base + ".kmers.bin")
        stat_path = os.path.join(out, base + ".stat.txt")
        threshold = self.max_size.get(self)
        with trace.span("dump") as sp:
            good = write_kmers_bin(bin_path, stat_path, kmap.keys,
                                   kmap.counts, threshold)
            sp.set(records=good)
        self.info("%d k-mers with frequency > %d dumped to %s", good,
                  threshold, bin_path)
        # sanity warnings (KmersCounter.java:108-118)
        total = len(kmap)
        if total and good == total:
            self.warn("All k-mers found in reads have frequency > %d!", threshold)
            self.warn("Consider increasing k-mer frequency threshold")
        if total and good < 0.05 * total:
            self.warn("Too few good k-mers were found (%d of %d)!", good, total)
            self.warn("Consider decreasing k-mer frequency threshold")
