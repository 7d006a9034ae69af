"""environment-finder: the primary workload.

Reimplements src/tools/EnvironmentFinderMain.java: count k-mers from reads on
the device (exactly for k <= 31, by hash for k > 31 or --forcehash), then one
BFS environment per gene sequence (or one merged environment), with per-gene
output directories named by the FASTA comment (:245-249). Carried over from
metacherchant_tpu/tools/environment_finder.py.
"""
from __future__ import annotations

import os

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..io.readers import read_rich_fasta
from ..counting import count_kmers
from ..algo.calculator import run_one_sequence


class EnvironmentFinderMain(Tool):
    NAME = "environment-finder"
    DESCRIPTION = ("Finds graphic environment for many genomic sequences "
                   "in given metagenomic reads")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.reads_files = self.add_parameter(Parameter(
            "reads", str, short="i", multi=True, default=[],
            description="FASTQ, BINQ, FASTA reads"))
        self.seqs_file = self.add_parameter(Parameter(
            "seq", str, mandatory=True,
            description="FASTA file with sequences"))
        self.hic_seqs_file = self.add_parameter(Parameter(
            "hicseq", str, description="FASTA file with Hi-C sequences"))
        self.output_dir = self.add_parameter(Parameter(
            "output", str, short="o", mandatory=True,
            description="output directory"))
        self.max_kmers = self.add_parameter(Parameter(
            "maxkmers", int,
            description="maximum number of k-mers in created subgraph"))
        self.max_radius = self.add_parameter(Parameter(
            "maxradius", int,
            description="maximum distance in k-mers from starting gene"))
        self.min_coverage = self.add_parameter(Parameter(
            "coverage", int, default=1,
            description="minimum depth of k-mers to consider"))
        self.both_directions = self.add_parameter(Parameter(
            "bothdirs", bool, default=False,
            description="run graph search in both directions from starting sequence"))
        self.chunk_length = self.add_parameter(Parameter(
            "chunklength", int, default=1,
            description="minimum node length for BLAST search"))
        self.force_hashing = self.add_parameter(Parameter(
            "forcehash", bool, default=False,
            description="force k-mer hashing (even for k <= 31)"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))
        self.trim_paths = self.add_parameter(Parameter(
            "trim", bool, default=False,
            description="trim all not maximal paths?"))
        self.do_merge = self.add_parameter(Parameter(
            "merge", bool, default=False,
            description="Draw single environment for multiple input sequences?"))

    def determine_hash_function(self) -> str | None:
        """src/tools/EnvironmentFinderMain.java:157-169."""
        if self.k.get(self) <= 31 and not self.force_hashing.get(self):
            return None
        name = self.hash_function.get(self).lower()
        if name == "fnv1a":
            self.info("Using FNV1a hash function")
            return "fnv1a"
        self.info("Using default polynomial hash function")
        return "poly"

    def check_termination(self) -> None:
        """getTerminationMode (:171-183)."""
        if self.max_kmers.get(self) is None and self.max_radius.get(self) is None:
            raise ExecutionFailedException(
                "At least one of --maxkmers and --maxradius parameters should be set")

    def load_input(self):
        hasher = self.determine_hash_function()
        if hasher is not None:
            self.info("Reading hashes of k-mers instead")
        dev = tool_device()
        for f in self.reads_files.get(self) or []:
            if not os.path.exists(f):
                raise ExecutionFailedException(f"Could not load reads from {f}")
        kmap = count_kmers(self.reads_files.get(self) or [],
                           self.k.get(self), hasher, device=dev)
        self.info("Hashtable size: %d kmers", len(kmap))
        try:
            records = read_rich_fasta(self.seqs_file.get(self))
        except OSError:
            raise ExecutionFailedException(
                f"Could not load sequences from {self.seqs_file.get(self)}")
        if not records:
            raise ExecutionFailedException(
                f"Could not load sequences from {self.seqs_file.get(self)}")
        hic_records = []
        hic = self.hic_seqs_file.get(self)
        if hic is not None:
            try:
                hic_records = read_rich_fasta(hic)
            except OSError:
                raise ExecutionFailedException(
                    f"Could not load Hi-C sequences from {hic}")
        return kmap, records, hic_records, hasher

    def run_impl(self) -> None:
        self.check_termination()
        kmap, records, hic_records, hasher = self.load_input()
        out = self.output_dir.get(self)
        common = dict(
            k=self.k.get(self), kmap=kmap,
            min_occ=self.min_coverage.get(self),
            both_directions=self.both_directions.get(self),
            chunk_length=self.chunk_length.get(self),
            max_radius=self.max_radius.get(self),
            max_kmers=self.max_kmers.get(self),
            trim=self.trim_paths.get(self), hasher=hasher)
        if not self.do_merge.get(self):
            # one calculator per gene, task-parallel like the reference's
            # ExecutorService (src/tools/EnvironmentFinderMain.java:218-233);
            # the shared kmap is read-only, and the native BFS releases the GIL
            workers = max(1, min(self.available_processors.get(self),
                                 len(records)))
            if workers == 1:
                for rec in records:
                    # per-gene dir named by FASTA comment (:245-249)
                    run_one_sequence([rec.seq],
                                     output_prefix=os.path.join(out, rec.comment),
                                     merged=False, **common)
            else:
                from concurrent.futures import ThreadPoolExecutor
                with ThreadPoolExecutor(max_workers=workers) as ex:
                    futs = [
                        ex.submit(run_one_sequence, [rec.seq],
                                  output_prefix=os.path.join(out, rec.comment),
                                  merged=False, **common)
                        for rec in records]
                    for f in futs:
                        f.result()
        else:
            self.info("hicSequences = %d", len(hic_records))
            run_one_sequence([r.seq for r in records],
                             output_prefix=os.path.join(out, "merged"),
                             merged=True,
                             hic_sequences=[r.seq for r in hic_records],
                             **common)
        self.info("Finished processing all sequences!")
