"""triple-reads-classifier: two-pass classification with k then k2 > k.

Reimplements src/tools/TripleReadsClassifier.java: pass 1 (k) records
FOUND/HALF_FOUND/NOT_FOUND per read, the graph is rebuilt at k2, pass 2
combines verdicts (TripleFinder2 rules) and routes the 9 outcome combinations
into found/half_found/not_found x 1/2/s fastq bins. Carried over from
metacherchant_tpu/tools/triple_reads_classifier.py; graphs are counted on the
device of device.py, and the coverage runs there under MC_DEVICE_CLASSIFY.
"""
from __future__ import annotations

import os

import numpy as np

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..algo.classify import (
    device_classify, find_reads, batch_widths, iter_read_batch_pairs,
    triple_verdict_pass1, triple_verdict_pass2, FOUND, HALF_FOUND, NOT_FOUND)
from ..io.writers import FastqWriter
from ..progress import Progress
from .reads_classifier import (
    load_classifier_graph, check_reads_files, prepare_lookups, CLASSIFY_BATCH,
    _mix_rows)


class TripleReadsClassifier(Tool):
    NAME = "triple-reads-classifier"
    DESCRIPTION = ("classifies reads based on weighted De Bruijn graph with "
                   "two values of k-mers and splits them into three categories")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.k2 = self.add_parameter(Parameter(
            "k2", int, short="k2", mandatory=True,
            description="second k-mer size. k2 > k"))
        self.input_files = self.add_parameter(Parameter(
            "input-files", str, short="i", multi=True,
            description="file with paired input reads for De Bruijn graph"))
        self.input_kmers_1 = self.add_parameter(Parameter(
            "input-kmers-1", str, short="ik1", multi=True,
            description="file with k-mers in binary format for De Bruijn graph"))
        self.input_kmers_2 = self.add_parameter(Parameter(
            "input-kmers-2", str, short="ik2", multi=True,
            description="file with k-mers in binary format for De Bruijn graph"))
        self.reads_files = self.add_parameter(Parameter(
            "read-files", str, short="r", multi=True, mandatory=True,
            description="files with paired reads to classify"))
        self.output_dir = self.add_parameter(Parameter(
            "output-dir", str, short="o",
            lazy_default=lambda t: os.path.join(t.work_dir.get(t),
                                                "reads_classifier"),
            description="directory to output found reads"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))
        self.do_correction = self.add_parameter(Parameter(
            "correction", bool, short="corr", default=False,
            description="Do replacement of nucleotide in read with one low "
                        "quality position"))
        self.interval95 = self.add_parameter(Parameter(
            "interval95", bool, default=False,
            description="Set the interval width to probability 0.95"))
        self.found_threshold = self.add_parameter(Parameter(
            "found-threshold", int, short="found", default=90,
            description="Minimum coverage breadth for class `found` [0 - 100 %]"))
        self.half_threshold = self.add_parameter(Parameter(
            "half-threshold", int, short="half", default=40,
            description="Minimum coverage breadth for class `half-found` [0 - 100 %]"))

    def _load(self, k: int, kmers_param):
        kmers = kmers_param.get(self)
        if kmers and kmers[0].lower().endswith("kmers.bin"):
            return load_classifier_graph(self, kmers, k,
                                         self.hash_function.get(self))
        inputs = self.input_files.get(self)
        if not inputs:
            raise ExecutionFailedException(
                "Either --input-files or binary k-mer dumps must be given")
        return load_classifier_graph(self, inputs, k,
                                     self.hash_function.get(self))

    def run_impl(self) -> None:
        k, k2 = self.k.get(self), self.k2.get(self)
        if k >= k2:
            raise ExecutionFailedException(
                f"k2 should be greater than k, given: {k} {k2}")
        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        if device_classify():
            tool_device()

        self.info("Loading reads...")
        files = self.reads_files.get(self)
        check_reads_files(files)

        z = 1.96 if self.interval95.get(self) else 1.0
        thr = self.found_threshold.get(self) / 100.0
        half = self.half_threshold.get(self) / 100.0
        corr = self.do_correction.get(self)

        # Pass 1 streams the read pairs and keeps ONLY the per-read verdicts
        # (2 int8 per pair) between passes -- the reference keys a
        # ConcurrentHashMap by read string (TripleReadsClassifier.java:183-227),
        # which is far heavier; read index is the equivalent join key here
        # because both passes stream the files in the same order.
        self.info("Building graph with k = %d ...", k)
        kmap1, hasher1 = self._load(k, self.input_kmers_1)
        prepare_lookups(kmap1)
        self.info("Searching for%s reads in graph...", " corrected" if corr else "")
        v1_parts_1: list[np.ndarray] = []
        v1_parts_2: list[np.ndarray] = []
        for b1, b2 in iter_read_batch_pairs(files, CLASSIFY_BATCH):
            f1 = find_reads(b1, kmap1, k, hasher1, z, thr, corr)
            f2 = find_reads(b2, kmap1, k, hasher1, z, thr, corr)
            f2 = np.where(b2.lengths == 0, ~f1, f2)
            w1 = batch_widths(b1, kmap1, k, hasher1)
            w2 = batch_widths(b2, kmap1, k, hasher1)
            v1_parts_1.append(
                triple_verdict_pass1(f1, w1, half).astype(np.int8))
            v1_parts_2.append(
                triple_verdict_pass1(f2, w2, half).astype(np.int8))
        del kmap1
        v1_1 = np.concatenate(v1_parts_1) if v1_parts_1 else np.empty(0, np.int8)
        v1_2 = np.concatenate(v1_parts_2) if v1_parts_2 else np.empty(0, np.int8)

        self.info("Building graph with k = %d ...", k2)
        kmap2, hasher2 = self._load(k2, self.input_kmers_2)
        prepare_lookups(kmap2)
        self.info("Searching for%s reads in graph...", " corrected" if corr else "")

        bins = ("found_1", "found_2", "half_found_1", "half_found_2",
                "not_found_1", "not_found_2", "found_s", "half_found_s",
                "not_found_s")
        writers = {name: FastqWriter(os.path.join(out, name + ".fastq"))
                   for name in bins}
        n_both = {FOUND: 0, HALF_FOUND: 0, NOT_FOUND: 0}
        n_single = {FOUND: 0, HALF_FOUND: 0, NOT_FOUND: 0}
        pair_bin = {FOUND: "found", HALF_FOUND: "half_found",
                    NOT_FOUND: "not_found"}
        # pass 1 fixed the total pair count -> exact ETA in pass 2
        progress = Progress(total=int(v1_1.size) or None,
                            label="pairs", log_every=500_000)
        try:
            offset = 0
            for b1, b2 in iter_read_batch_pairs(files, CLASSIFY_BATCH):
                progress.update(int(b1.lengths.size))
                f1 = find_reads(b1, kmap2, k2, hasher2, z, thr, corr)
                f2 = find_reads(b2, kmap2, k2, hasher2, z, thr, corr)
                f2 = np.where(b2.lengths == 0, ~f1, f2)
                w1 = batch_widths(b1, kmap2, k2, hasher2)
                w2 = batch_widths(b2, kmap2, k2, hasher2)
                nb = int(b1.lengths.size)
                sl = slice(offset, offset + nb)
                r1 = triple_verdict_pass2(f1, w1, v1_1[sl], half)
                r2 = triple_verdict_pass2(f2, w2, v1_2[sl], half)
                offset += nb
                # route the 9 combinations (TripleFinder2.java:83-107),
                # partitioned with numpy; flatnonzero keeps batch order so
                # each bin file matches the sequential reference loop
                same = r1 == r2
                for v, base in pair_bin.items():
                    idx = np.flatnonzero(same & (r1 == v))
                    n_both[v] += idx.size
                    # found_[12] write even empty mates (matches pass-2
                    # routing of the reference); half/not skip empties.
                    i1 = idx if v == FOUND else idx[b1.lengths[idx] > 0]
                    i2 = idx if v == FOUND else idx[b2.lengths[idx] > 0]
                    writers[base + "_1"].write_batch(
                        b1.codes, b1.phred, b1.lengths, i1)
                    writers[base + "_2"].write_batch(
                        b2.codes, b2.phred, b2.lengths, i2)
                single = np.flatnonzero(~same)
                # interleave (read1, read2) of every discordant pair in
                # batch order, then slice per verdict -- identical file
                # order to the reference's sequential per-pair loop
                ns = single.size
                rows2 = np.repeat(single, 2)
                use1 = np.tile(np.array([True, False]), ns)
                ic, ip, il = _mix_rows(b1, b2, rows2, use1)
                vi = np.empty(2 * ns, np.int8)
                vi[0::2] = r1[single]
                vi[1::2] = r2[single]
                for v, base in pair_bin.items():
                    n_single[v] += int(np.count_nonzero(vi == v))
                    writers[base + "_s"].write_batch(
                        ic, ip, il, np.flatnonzero((vi == v) & (il > 0)))
        finally:
            for w in writers.values():
                w.close()

        paired = 2 * sum(n_both.values())
        stats_total = paired + sum(n_single.values())
        self.info("|\tTotal: %d reads", stats_total)
        self.info("|\tPaired: %d reads", paired)
        self.info("|\tFound: %d reads", 2 * n_both[FOUND] + n_single[FOUND])
        self.info("|\tHalf found: %d reads",
                  2 * n_both[HALF_FOUND] + n_single[HALF_FOUND])
        self.info("|\tNot found: %d reads",
                  2 * n_both[NOT_FOUND] + n_single[NOT_FOUND])
        self.info("Reads have been written. Finishing...")
