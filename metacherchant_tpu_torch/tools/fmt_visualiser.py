"""fmt-visualiser: whole-graph colored pictures for donor/before/after.

Reimplements src/tools/FMTVisualiser.java: for each of the three metagenomes,
load the full k-mer map + the classified read-bin maps, color every k-mer by
bin membership, contract with the color barrier, and emit <name>_seqs.fasta +
<name>.gfa. Carried over from metacherchant_tpu/tools/fmt_visualiser.py; the
maps are counted on the device of device.py, and the contraction runs there
under MC_DEVICE_CONTRACT.
"""
from __future__ import annotations

import os

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..counting import count_kmers, load_present_kmer_strings
from ..dna import codes_to_kmers_np
from ..algo.environment import ascii_min_orient
from ..algo.fmt import build_colored_picture, two_bin_color, four_bin_color


class FMTTool(Tool):
    """What the three FMT tools share: the hash choice, the classified read
    bins <input-dir>/<stem>_{1,2,s}.<ext>, and counting on the tool's
    device. Each tool declares its own parameters, k, hash, input-dir and ext
    among them."""

    def _hasher(self) -> str | None:
        if self.k.get(self) <= 31:
            return None
        name = self.hash_function.get(self).lower()
        return "fnv1a" if name == "fnv1a" else "poly"

    def _bin_files(self, stem: str) -> list[str]:
        pre = self.input_dir.get(self)
        ext = self.extension.get(self)
        files = [os.path.join(pre, f"{stem}_{x}.{ext}") for x in ("1", "2", "s")]
        missing = [f for f in files if not os.path.exists(f)]
        if missing:
            raise ExecutionFailedException(
                f"Could not load reads from {missing[0]}")
        return files

    def _count(self, files, hasher):
        return count_kmers(files, self.k.get(self), hasher,
                           device=tool_device())


class FMTVisualiser(FMTTool):
    NAME = "fmt-visualiser"
    DESCRIPTION = ("Outputs graphs in .gfa format showing the results of FMT "
                   "classification")

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

    def _subgraph_of(self, kmap, files) -> dict[str, int]:
        """Materialize normalized-string -> count view of a whole metagenome
        map (FMTVisualiser.toStr:199-206 for k<=31; for k>31 re-stream the
        metagenome's reads to reconstruct strings, LargeKmerLoader semantics,
        FMTVisualiser.java:109,129,149)."""
        k = self.k.get(self)
        if self._hasher() is None:
            strings = codes_to_kmers_np(ascii_min_orient(kmap.keys, k), k)
            return dict(zip(strings, kmap.counts.tolist()))
        return load_present_kmer_strings(files, k, self._hasher(), kmap)

    def run_impl(self) -> None:
        out = self.output_dir.get(self)
        os.makedirs(out, exist_ok=True)
        k = self.k.get(self)
        hasher = self._hasher()

        self.info("Loading donor reads ...")
        donor = self._count(self.donor_files.get(self), hasher)
        settle = self._count(self._bin_files("settle"), hasher)
        not_settle = self._count(self._bin_files("not_settle"), hasher)
        self.info("Creating donor image ...")
        build_colored_picture(self._subgraph_of(donor, self.donor_files.get(self)), k,
                              two_bin_color(k, hasher, settle, not_settle),
                              out, "donor")
        del donor, settle, not_settle

        self.info("Loading before reads ...")
        before = self._count(self.before_files.get(self), hasher)
        stay = self._count(self._bin_files("stay"), hasher)
        gone = self._count(self._bin_files("gone"), hasher)
        self.info("Creating before image ...")
        build_colored_picture(self._subgraph_of(before, self.before_files.get(self)), k,
                              two_bin_color(k, hasher, stay, gone),
                              out, "before")
        del before, stay, gone

        self.info("Loading after reads ...")
        after = self._count(self.after_files.get(self), hasher)
        from_donor = self._count(self._bin_files("came_from_donor"), hasher)
        from_before = self._count(self._bin_files("came_from_baseline"), hasher)
        from_both = self._count(self._bin_files("came_from_both"), hasher)
        itself = self._count(self._bin_files("came_itself"), hasher)
        self.info("Creating after image ...")
        build_colored_picture(
            self._subgraph_of(after, self.after_files.get(self)), k,
            four_bin_color(k, hasher, from_donor, from_before, from_both, itself),
            out, "after")
