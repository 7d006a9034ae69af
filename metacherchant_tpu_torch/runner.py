"""CLI runner: tool registry + dispatch (src/Runner.java, itmo:Runner.java).

Default tool is environment-finder (src/Runner.java:14-18). The registry
holds the tools ported so far; the others of metacherchant_tpu give the
usual unknown-tool error.
"""
from __future__ import annotations

import sys

from . import __version__
from .tool import Tool


def _registry() -> dict[str, type[Tool]]:
    from .tools.environment_finder import EnvironmentFinderMain
    return {EnvironmentFinderMain.NAME: EnvironmentFinderMain}


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
