"""environment-finder-multi: differential display of multiple environments.

Reimplements src/tools/EnvironmentFinderMultiMain.java: load N graph.txt/env.txt
files, infer k from k-mer length, join via the multi calculator, write
gene.fasta and the two pairwise Jaccard-distance matrices. Host only. Carried
over from metacherchant_tpu/tools/environment_finder_multi.py.
"""
from __future__ import annotations

import os

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..io.readers import read_rich_fasta
from ..io.writers import load_graph_txt
from ..algo.multi import (
    build_multi_node_graph, multi_merge, write_gfa_multi,
    write_seqs_fasta_multi, write_jaccard)
from ..algo.calculator import shorten_label

MAX_ENVIRONMENTS = 256


class EnvironmentFinderMultiMain(Tool):
    NAME = "environment-finder-multi"
    DESCRIPTION = "Displays difference between multiple genomic environments"

    def __init__(self):
        super().__init__()
        self.env_files = self.add_parameter(Parameter(
            "env", str, short="e", multi=True, mandatory=True,
            description="environment files to build difference for"))
        self.seq_file = self.add_parameter(Parameter(
            "seq", str, mandatory=True,
            description=".fasta file with nucleotide sequence[s]"))
        self.output_dir = self.add_parameter(Parameter(
            "output", str, short="o", mandatory=True,
            description="output directory to write results to"))
        self.gene_id = self.add_parameter(Parameter(
            "geneid", int, short="g", default=1,
            description="gene id from .fasta file"))

    def run_impl(self) -> None:
        # the join runs on the host, but a platform that cannot be had fails
        # this tool as it fails every other (MC_PLATFORM, device.py)
        tool_device()
        files = self.env_files.get(self)
        graphs = []
        for f in files:
            try:
                graphs.append(load_graph_txt(f))
            except OSError:
                raise ExecutionFailedException(
                    f"Couldn't load graph from file {f}")
        if not graphs:
            raise ExecutionFailedException("Zero environments given")
        if len(graphs) > MAX_ENVIRONMENTS:
            self.warn("Found more than 256 environments. "
                      "Grayscale graph may be not accurate.")
        k = len(next(iter(graphs[0])))
        for g in graphs:
            for kmer in g:
                if len(kmer) != k:
                    raise ExecutionFailedException(
                        f"K-mers of different lengths encountered: {k} and {len(kmer)}")
        try:
            records = read_rich_fasta(self.seq_file.get(self))
            rec = records[self.gene_id.get(self) - 1]
        except (OSError, IndexError):
            raise ExecutionFailedException("Could not load sequence file")

        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        self.info("Combining environments for sequence %s",
                  shorten_label(rec.seq, k))
        nodes = build_multi_node_graph(graphs, k, rec.seq)
        multi_merge(nodes, k)
        write_seqs_fasta_multi(os.path.join(out, "seqs.fasta"), nodes)
        write_gfa_multi(os.path.join(out, "graph.gfa"), nodes, k, graphs)
        with open(os.path.join(out, "gene.fasta"), "w") as fh:
            fh.write(f">{rec.comment}\n{rec.seq}\n")
        write_jaccard(out, files, graphs)
        self.info("Finished processing!")
