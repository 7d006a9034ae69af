"""graph_load_s: seconds a job spends in the port's span classify.load
(reads-classifier's graph: the dump read, the map built and copied to the
card), averaged over the window's jobs."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "classify.load")
