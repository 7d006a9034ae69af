"""dump_s: seconds a job spends in the port's span dump (kmer-counter's
kmers.bin records and stat.txt histogram), averaged over the window's
jobs."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "dump")
