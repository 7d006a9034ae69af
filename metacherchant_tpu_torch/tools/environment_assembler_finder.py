"""environment-assembler-finder: 3-stage env -> assemble -> re-env.

Reimplements src/tools/EnvironmentAssemblerFinder.java: (1) environment BFS +
per-file read filtration, (2) external SPAdes/MEGAHIT assembly of the
extracted reads, (3) re-run the environment on assembled contigs with k=55
and coverage=0 into output/result (:175-240). Single-sequence only (:179-182).

Reference quirks preserved: the assembler is pointed at cutReads<i> files
(the reference passes a .fastq name while its filter writes .fasta -- a latent
upstream bug; we pass the .fasta that actually exists and note the
divergence); assembler failures are logged, not fatal, and stage 3 then fails
on the missing contigs like the reference would. Carried over from
metacherchant_tpu/tools/environment_assembler_finder.py; both stages count
with counting.count_kmers (the device of device.py, or the host under
MC_HOST_COUNT).
"""
from __future__ import annotations

import os
import shutil
import subprocess

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..io.readers import read_rich_fasta
from ..counting import count_kmers
from ..algo.calculator import run_one_sequence
from ..algo.filter import SubgraphChecker, filter_reads_file


class EnvironmentAssemblerFinder(Tool):
    NAME = "environment-assembler-finder"
    DESCRIPTION = ("Finds graphic environment for many genomic sequences in "
                   "given metagenomic reads in 3 stages using assembler")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", default=21, description="k-mer size"))
        self.reads_files = self.add_parameter(Parameter(
            "reads", str, short="i", multi=True, default=[],
            description="FASTQ, BINQ, FASTA reads"))
        self.seqs_file = self.add_parameter(Parameter(
            "seq", str, mandatory=True, description="FASTA file with sequences"))
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
        self.max_threads = self.add_parameter(Parameter(
            "threads", int, default=32,
            description="how many worker threads to use"))
        self.trim_paths = self.add_parameter(Parameter(
            "trim", bool, default=False,
            description="trim all not maximal paths?"))
        self.percent_filtration = self.add_parameter(Parameter(
            "procfiltration", int, short="pf", default=1, mandatory=True,
            description="filtration percent // [1 .. 100]"))
        self.assembler = self.add_parameter(Parameter(
            "assembler", str, mandatory=True,
            description="assembler which you want to use"))
        self.assembler_path = self.add_parameter(Parameter(
            "assemblerpath", str, mandatory=True,
            description="path of the assembler"))
        # the reference's 3 stages (:175-240) as checkpointed steps: each gets
        # its own SUCCESS.<step> marker, --continue resumes mid-pipeline, and
        # --start/--finish bound which stages execute (Tool.java:94-101)
        self._aborted = False
        self.add_step("environment", self._step_environment)
        self.add_step("assembly", self._step_assembly)
        self.add_step("re-environment", self._step_reenvironment)

    def _hasher(self, k: int) -> str | None:
        if k <= 31 and not self.force_hashing.get(self):
            return None
        name = self.hash_function.get(self).lower()
        return "fnv1a" if name == "fnv1a" else "poly"

    def check_termination(self):
        if self.max_kmers.get(self) is None and self.max_radius.get(self) is None:
            raise ExecutionFailedException(
                "At least one of --maxkmers and --maxradius parameters should be set")

    def _run_env(self, reads_files, k, coverage, output_prefix):
        hasher = self._hasher(k)
        if hasher is not None:
            self.info("Reading hashes of k-mers instead")
        dev = tool_device()
        for f in reads_files:
            if not os.path.exists(f):
                raise ExecutionFailedException(f"Could not load reads from {f}")
        kmap = count_kmers(reads_files, k, hasher, device=dev)
        self.info("Hashtable size: %d kmers", len(kmap))
        records = read_rich_fasta(self.seqs_file.get(self))
        if not records:
            raise ExecutionFailedException(
                f"Could not load sequences from {self.seqs_file.get(self)}")
        if len(records) > 1:
            self.info("EnvironmentAssemblerFinder works only with one input sequence!")
            return None, None
        env = run_one_sequence(
            [records[0].seq], k=k, kmap=kmap, min_occ=coverage,
            output_prefix=output_prefix, both_directions=self.both_directions.get(self),
            chunk_length=self.chunk_length.get(self),
            max_radius=self.max_radius.get(self),
            max_kmers=self.max_kmers.get(self),
            trim=self.trim_paths.get(self), merged=False, hasher=hasher)
        return env, hasher

    def _run_assembler(self, output_prefix: str, i: int) -> None:
        """AssemblerCalculator (src/algo/AssemblerCalculator.java:28-98)."""
        name = self.assembler.get(self)
        path = self.assembler_path.get(self)
        cut = os.path.join(output_prefix, f"cutReads{i}.fasta")
        if name == "spades":
            cmd = ["python", os.path.join(path, "spades.py"), "--12", cut,
                   "-o", os.path.join(output_prefix, f"out_spades{i}")]
            produced = os.path.join(output_prefix, f"out_spades{i}", "contigs.fasta")
        elif name == "megahit":
            cmd = [os.path.join(path, "megahit"), "--12", cut,
                   "-o", os.path.join(output_prefix, f"out_megahit{i}")]
            produced = os.path.join(output_prefix, f"out_megahit{i}",
                                    "final.contigs.fa")
        else:
            self.info("Unknown assembler %s; skipping", name)
            return
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
            for line in (proc.stdout or "").splitlines():
                self.info("%s", line)
            if os.path.exists(produced):
                shutil.move(produced,
                            os.path.join(output_prefix, f"contigs{i}.fasta"))
        except OSError as e:
            self.info("%s", e)

    def _step_environment(self) -> None:
        """Stage 1: env BFS + per-file read filtration (:186-200)."""
        self.check_termination()
        out = self.output_dir.get(self)
        output_prefix = out + "/"
        reads_files = self.reads_files.get(self) or []
        env, hasher = self._run_env(reads_files, self.k.get(self),
                                    self.min_coverage.get(self), output_prefix)
        if env is None:
            self._aborted = True
            return
        checker = SubgraphChecker(env.normalized_strings(), self.k.get(self), hasher)
        for i, f in enumerate(reads_files):
            kept = filter_reads_file(f, checker, output_prefix, i,
                                     self.percent_filtration.get(self))
            self.debug("cutReads%d.fasta: %d reads", i, kept)
        self.info("Filtration done!")
        self.info("Finished processing all sequences!")

    def _step_assembly(self) -> None:
        """Stage 2: external SPAdes/MEGAHIT over extracted reads (:204-214)."""
        if self._aborted:
            return
        output_prefix = self.output_dir.get(self) + "/"
        for i in range(len(self.reads_files.get(self) or [])):
            self._run_assembler(output_prefix, i)
        self.info("Finished assembling all sequences!")

    def _step_reenvironment(self) -> None:
        """Stage 3: re-run env on assembled contigs, k=55, coverage=0 (:216-239)."""
        if self._aborted:
            return
        out = self.output_dir.get(self)
        output_prefix = out + "/"
        contig_files = [os.path.join(output_prefix, f"contigs{i}.fasta")
                        for i in range(len(self.reads_files.get(self) or []))]
        result_prefix = os.path.join(out, "result") + "/"
        env2, hasher2 = self._run_env(contig_files, 55, 0, result_prefix)
        if env2 is None:
            return
        checker2 = SubgraphChecker(env2.normalized_strings(), 55, hasher2)
        for i, f in enumerate(contig_files):
            filter_reads_file(f, checker2, result_prefix, i,
                              self.percent_filtration.get(self))
        self.info("Filtration done!")
        self.info("Finished processing all sequences!")
