"""fmt-visualizer: per-connected-component colored pictures.

Reimplements src/tools/FMTVisualizer.java: for every k-mer of the metagenome
reads still present in the (destructively consumed) graph, flood its connected
component with KmerEnvCalculator producing comp<i> outputs under
donor/ before/ after/ subdirectories (:224-316). Carried over from
metacherchant_tpu/tools/fmt_visualizer.py; the maps are counted on the device
of device.py, and the flood runs on the host.
"""
from __future__ import annotations

import os

from ..tool import Parameter
from ..io.readers import iter_dnaq
from ..ops.kmers import hash_str
from ..algo.fmt import (
    MutableKmerView, kmer_env_subgraph, build_colored_picture,
    two_bin_color, four_bin_color)
from .fmt_visualiser import FMTTool


class FMTVisualizer(FMTTool):
    NAME = "fmt-visualizer"
    DESCRIPTION = ("Outputs graphs in .gfa format showing the results of FMT "
                   "classification, persisting connected components")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", mandatory=True, description="k-mer size"))
        self.donor_files = self.add_parameter(Parameter(
            "donor-files", str, short="donor", multi=True, mandatory=True,
            description="file with paired donor metagenomic reads"))
        self.before_files = self.add_parameter(Parameter(
            "before-files", str, short="before", multi=True, mandatory=True,
            description="file with paired pre-FMT recipient metagenomic reads"))
        self.after_files = self.add_parameter(Parameter(
            "after-files", str, short="after", multi=True, mandatory=True,
            description="file with paired post-FMT recipient metagenomic reads"))
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

    def _flood_components(self, meta_files, color, subdir) -> None:
        """Serial destructive component enumeration (FMTVisualizer.java:240-255)."""
        k = self.k.get(self)
        hasher = self._hasher()
        graph = MutableKmerView(self._count(meta_files, hasher))
        out = os.path.join(self.output_dir.get(self), subdir)
        comp = 0
        for f in meta_files:
            for dnaq in iter_dnaq(f):
                seq = dnaq.to_string()
                for i in range(len(seq) - k + 1):
                    kmer = seq[i:i + k]
                    if graph.get(hash_str(kmer, hasher)) > 0:
                        sub = kmer_env_subgraph(kmer, k, graph, hasher)
                        build_colored_picture(sub, k, color, out, f"comp{comp}")
                        comp += 1
        self.info("%s: %d components", subdir, comp)

    def run_impl(self) -> None:
        os.makedirs(self.output_dir.get(self), exist_ok=True)
        hasher = self._hasher()
        k = self.k.get(self)

        self.info("Loading donor reads ...")
        settle = self._count(self._bin_files("settle"), hasher)
        not_settle = self._count(self._bin_files("not_settle"), hasher)
        self.info("Creating donor image ...")
        self._flood_components(self.donor_files.get(self),
                               two_bin_color(k, hasher, settle, not_settle),
                               "donor")
        del settle, not_settle

        self.info("Loading before reads ...")
        stay = self._count(self._bin_files("stay"), hasher)
        gone = self._count(self._bin_files("gone"), hasher)
        self.info("Creating before image ...")
        self._flood_components(self.before_files.get(self),
                               two_bin_color(k, hasher, stay, gone), "before")
        del stay, gone

        self.info("Loading after reads ...")
        from_donor = self._count(self._bin_files("came_from_donor"), hasher)
        from_before = self._count(self._bin_files("came_from_baseline"), hasher)
        from_both = self._count(self._bin_files("came_from_both"), hasher)
        itself = self._count(self._bin_files("came_itself"), hasher)
        self.info("Creating after image ...")
        self._flood_components(
            self.after_files.get(self),
            four_bin_color(k, hasher, from_donor, from_before, from_both, itself),
            "after")
