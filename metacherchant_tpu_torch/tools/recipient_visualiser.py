"""recipient-visualiser: colored environments of the post-FMT metagenome.

Reimplements src/tools/RecipientVisualiser.java: one SeqEnvCalculator per
input sequence against the after-metagenome graph, colored by the four-bin
after predicate; outputs comp_<i>_seqs.fasta / comp_<i>.gfa under after/.
Default maxradius = 1000 (:65-68). Carried over from
metacherchant_tpu/tools/recipient_visualiser.py; the maps are counted on the
device of device.py.
"""
from __future__ import annotations

import os

from ..tool import Parameter, ExecutionFailedException
from ..io.readers import read_rich_fasta
from ..algo.fmt import seq_env_subgraph, build_colored_picture, four_bin_color
from ..algo.calculator import shorten_label
from .fmt_visualiser import FMTTool


class RecipientVisualiser(FMTTool):
    NAME = "recipient-visualiser"
    DESCRIPTION = ("Finds graphic environment for many genomic sequences in "
                   "recipient after FMT")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.after_files = self.add_parameter(Parameter(
            "after-files", str, short="after", multi=True, mandatory=True,
            description="file with paired post-FMT recipient metagenomic reads"))
        self.seqs_file = self.add_parameter(Parameter(
            "seq", str, short="seq", mandatory=True,
            description="FASTA file with sequences"))
        self.max_kmers = self.add_parameter(Parameter(
            "maxkmers", int,
            description="maximum number of k-mers in created subgraph"))
        self.max_radius = self.add_parameter(Parameter(
            "maxradius", int, default=1000,
            description="maximum distance in k-mers from starting gene"))
        self.hash_function = self.add_parameter(Parameter(
            "hash", str, default="poly",
            description="hash function to use: poly or fnv1a"))
        self.output_dir = self.add_parameter(Parameter(
            "output-dir", str, short="o",
            lazy_default=lambda t: os.path.join(t.work_dir.get(t), "graph"),
            description="directory to output found reads"))
        self.input_dir = self.add_parameter(Parameter(
            "input-dir", str, short="i", mandatory=True,
            description="directory containing output of reads_classifier.sh "
                        "FMT classification script"))
        self.extension = self.add_parameter(Parameter(
            "ext", str, short="ext", mandatory=True,
            description="extension of output files of reads_classifier.sh FMT "
                        "classification script"))

    def run_impl(self) -> None:
        k = self.k.get(self)
        hasher = self._hasher()
        if hasher is not None:
            self.info("Reading hashes of k-mers instead")
        out = os.path.join(self.output_dir.get(self), "after")

        self.info("Loading after reads ...")
        graph = self._count(self.after_files.get(self), hasher)
        from_donor = self._count(self._bin_files("came_from_donor"), hasher)
        from_before = self._count(self._bin_files("came_from_baseline"), hasher)
        from_both = self._count(self._bin_files("came_from_both"), hasher)
        itself = self._count(self._bin_files("came_itself"), hasher)
        try:
            records = read_rich_fasta(self.seqs_file.get(self))
        except OSError:
            raise ExecutionFailedException(
                f"Could not load sequences from {self.seqs_file.get(self)}")

        color = four_bin_color(k, hasher, from_donor, from_before, from_both,
                               itself)
        self.info("Creating after images ...")
        for i, rec in enumerate(records):
            self.info("Finding environment for sequence %s",
                      shorten_label(rec.seq, k))
            sub = seq_env_subgraph(rec.seq, k, graph, hasher,
                                   self.max_radius.get(self),
                                   self.max_kmers.get(self))
            if sub is None:
                self.info("Could not find any k-mers of the target gene in "
                          "the input, halting.")
                continue
            build_colored_picture(sub, k, color, out, f"comp_{i}",
                                  gene_sequence=rec.seq, merge_on_gene=True,
                                  seq_id_mode="min")
        self.info("Finished processing all sequences!")
