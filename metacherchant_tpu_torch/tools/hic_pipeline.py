"""hic-pipeline: the Hi-C two-pass environment pipeline as a CLI tool.

The reference ships this as a bash script around the jar + bwa + samtools
(Hi-C_pipline/HiCEnvironmentFinder.sh:1-77); here it is a registered tool with
the same parameter surface so `metacherchant -t hic-pipeline ...` runs the
whole flow: pass-1 merged environment, Hi-C read selection (bwa mem + SAM flag
filter 0x5/~0x908, HiCEnvironmentFinder.sh:62-65), pass-2 environment with the
selected reads as extra seeds, pair filter (flags 1/~2060, different contigs,
:73-74) and the contact-map aggregation (hic_map.py:9-21) -> hic_map.txt.
Carried over from metacherchant_tpu/tools/hic_pipeline.py.
"""
from __future__ import annotations

from ..tool import Tool, Parameter, ExecutionFailedException, tool_device
from ..hic.pipeline import run_hic_pipeline


class HiCPipeline(Tool):
    NAME = "hic-pipeline"
    DESCRIPTION = ("finds environments enriched with Hi-C linkage "
                   "(two MetaCherchant passes + bwa/samtools)")

    def __init__(self):
        super().__init__()
        self.k = self.add_parameter(Parameter(
            "k", int, short="k", default=31, description="k-mer size"))
        self.reads = self.add_parameter(Parameter(
            "reads", str, short="i", multi=True, mandatory=True,
            description="WGS read files for the de Bruijn graph"))
        self.seq = self.add_parameter(Parameter(
            "seq", str, mandatory=True,
            description="FASTA file with the target gene sequence"))
        self.hic_r1 = self.add_parameter(Parameter(
            "hi-c-r1", str, mandatory=True,
            description="Hi-C read file, first mates"))
        self.hic_r2 = self.add_parameter(Parameter(
            "hi-c-r2", str, mandatory=True,
            description="Hi-C read file, second mates"))
        self.coverage = self.add_parameter(Parameter(
            "coverage", int, default=5,
            description="minimum k-mer coverage for the environment"))
        self.max_radius = self.add_parameter(Parameter(
            "maxradius", int, default=100000,
            description="maximum BFS radius"))
        self.threads = self.add_parameter(Parameter(
            "threads", int, default=12,
            description="threads for bwa mem"))
        self.first_pass_only = self.add_parameter(Parameter(
            "first-pass-only", bool, default=False,
            description="stop after pass-1 environment (no bwa/samtools "
                        "needed); alignment steps can then run externally"))

    def run_impl(self) -> None:
        # both passes count on the MC_PLATFORM device: fail before pass 1
        # when it cannot be had
        tool_device()
        try:
            run_hic_pipeline(
                reads=self.reads.get(self),
                seq=self.seq.get(self),
                work_dir=self.work_dir.get(self),
                hic_r1=self.hic_r1.get(self),
                hic_r2=self.hic_r2.get(self),
                k=self.k.get(self),
                coverage=self.coverage.get(self),
                max_radius=self.max_radius.get(self),
                threads=self.threads.get(self),
                first_pass_only=self.first_pass_only.get(self))
        except ExecutionFailedException:
            raise
        except Exception as e:  # subprocess failures -> tool failure
            raise ExecutionFailedException(str(e)) from e
