"""classify_parse_s: seconds a job spends in the port's span classify.parse
(reads-classifier's read side: the native parse of a batch of each mate
file and its packing into (B, L) arrays, on the main thread), summed over
a job's batch pairs, averaged over the window's jobs."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "classify.parse")
