"""seq-cov: per-sequence depth/breadth vs four metagenomic bins.

Reimplements src/tools/SequenceCoverage.java: load 4 read-set graphs
(donor/before/both/itself), then for each input sequence print depth and
breadth against each bin to seq_cov.csv (:126-160, printSeqBin:162-185).
Carried over from metacherchant_tpu/tools/seq_cov.py; the bins are counted on
the device of device.py, the coverage of each sequence is looked up on the
host.
"""
from __future__ import annotations

import os

import numpy as np

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..counting import count_kmers_device
from ..io.readers import iter_dnaq
from ..algo.classify import rolling_keys_np


class SequenceCoverage(Tool):
    NAME = "seq-cov"
    DESCRIPTION = "Calculates coverage of sequences by k-mers from metagenomic bins"

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.before_files = self.add_parameter(Parameter(
            "from-before", str, multi=True, mandatory=True,
            description="file with paired input reads for came_from_before bin"))
        self.donor_files = self.add_parameter(Parameter(
            "from-donor", str, multi=True, mandatory=True,
            description="file with paired input reads for came_from_donor bin"))
        self.both_files = self.add_parameter(Parameter(
            "from-both", str, multi=True, mandatory=True,
            description="file with paired input reads for came_from_both bin"))
        self.itself_files = self.add_parameter(Parameter(
            "itself", str, multi=True, mandatory=True,
            description="file with paired input reads for came_itself bin"))
        self.seq_file = self.add_parameter(Parameter(
            "read-file", str, short="r", mandatory=True,
            description="file with sequences to classify"))
        self.output_dir = self.add_parameter(Parameter(
            "output-dir", str, short="o",
            lazy_default=lambda t: os.path.join(t.work_dir.get(t),
                                                "sequence_coverage"),
            description="directory to output found reads"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))

    def _load(self, files, k, hasher):
        for f in files:
            if not os.path.exists(f):
                raise ExecutionFailedException(f"Could not load reads from {f}")
        kmap = count_kmers_device(files, k, hasher, device=tool_device())
        self.info("Hashtable size: %d kmers", len(kmap))
        return kmap

    def run_impl(self) -> None:
        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        k = self.k.get(self)
        hasher = None
        if k > 31:
            self.info("Reading hashes of k-mers instead")
            hasher = ("fnv1a" if self.hash_function.get(self).lower() == "fnv1a"
                      else "poly")
        self.info("Loading bins ...")
        donor = self._load(self.donor_files.get(self), k, hasher)
        before = self._load(self.before_files.get(self), k, hasher)
        both = self._load(self.both_files.get(self), k, hasher)
        itself = self._load(self.itself_files.get(self), k, hasher)

        self.info("Calculating sequence coverage...")
        with open(os.path.join(out, "seq_cov.csv"), "w") as fh:
            fh.write("name, from_donor_depth, from_donor_breadth, "
                     "from_before_depth, from_before_breadth, from_both_depth, "
                     "from_both_breadth, itself_depth, itself_breadth\n")
            for d in iter_dnaq(self.seq_file.get(self)):
                seq = d.to_string()
                fh.write(seq)
                codes = d.codes.astype(np.int32)[None, :]
                keys = rolling_keys_np(codes, k, hasher)
                for kmap in (donor, before, both, itself):
                    if keys.size:
                        cov = np.maximum(kmap.get_many(keys[0]), 0)
                        depth = int(cov.sum())
                        breadth = int((cov > 0).sum())
                    else:
                        depth = breadth = 0
                    # printSeqBin's denominator is len - k + 1 (:183-184),
                    # kept as the JAX package has it: a sequence of k - 1
                    # bases raises ZeroDivisionError where the Java
                    # reference prints NaN, and a shorter one writes -0.0
                    denom = len(seq) - k + 1
                    fh.write(f", {depth * 1.0 / denom}, {breadth * 1.0 / denom}")
                fh.write("\n")
        self.info("Processed all sequences...")
