"""bins_s: seconds a job spends in the port's span write.bins (one batch
pair routed and written to reads-classifier's six FASTQ bins), summed over
the job's batch pairs, averaged over the window's jobs."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "write.bins")
