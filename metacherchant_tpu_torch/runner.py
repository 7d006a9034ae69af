"""CLI runner: tool registry + dispatch (src/Runner.java, itmo:Runner.java).

Default tool is environment-finder (src/Runner.java:14-18). The registry
holds the same eleven tools as metacherchant_tpu/runner.py.
"""
from __future__ import annotations

import sys

from . import __version__
from .tool import Tool


def _registry() -> dict[str, type[Tool]]:
    from .tools.environment_assembler_finder import EnvironmentAssemblerFinder
    from .tools.environment_finder import EnvironmentFinderMain
    from .tools.environment_finder_multi import EnvironmentFinderMultiMain
    from .tools.fmt_visualiser import FMTVisualiser
    from .tools.fmt_visualizer import FMTVisualizer
    from .tools.hic_pipeline import HiCPipeline
    from .tools.kmer_counter import KmersCounter
    from .tools.reads_classifier import ReadsClassifier
    from .tools.recipient_visualiser import RecipientVisualiser
    from .tools.seq_cov import SequenceCoverage
    from .tools.triple_reads_classifier import TripleReadsClassifier
    return {cls.NAME: cls for cls in
            (EnvironmentFinderMain, KmersCounter, EnvironmentFinderMultiMain,
             ReadsClassifier, TripleReadsClassifier, SequenceCoverage,
             EnvironmentAssemblerFinder, FMTVisualiser, FMTVisualizer,
             RecipientVisualiser, HiCPipeline)}


DEFAULT_TOOL = "environment-finder"

_HEADER = """metacherchant-torch: PyTorch/CUDA genomic environment engine
Usage: metacherchant-torch [-t <tool>] [tool options]
"""


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reg = _registry()
    tool_name = DEFAULT_TOOL
    explicit_tool = False
    if argv and argv[0] in ("-t", "--tool"):
        if len(argv) < 2:
            print("Option --tool requires a value", file=sys.stderr)
            return 1
        tool_name = argv[1]
        explicit_tool = True
        argv = argv[2:]
    if tool_name not in reg:
        print(f"Unknown tool {tool_name!r}; use --tools to list", file=sys.stderr)
        return 1
    if argv and argv[0] in ("-ts", "--tools"):
        print("Available tools:")
        for name, cls in sorted(reg.items()):
            print(f"  {name:32s} {cls.DESCRIPTION}")
        return 0
    if argv and argv[0] in ("--version",):
        print(f"metacherchant-torch {__version__}")
        return 0
    if (argv and argv[0] in ("-h", "--help")) or (not argv and not explicit_tool):
        print(_HEADER)
        print("Tools (select with -t):")
        for name, cls in sorted(reg.items()):
            print(f"  {name:32s} {cls.DESCRIPTION}")
        return 0
    return reg[tool_name]().main(argv)


if __name__ == "__main__":
    sys.exit(main())
