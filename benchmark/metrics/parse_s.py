"""parse_s: seconds a job spends in the port's span count.parse (the
native parse of a reads file and its chunk table, before the first
launch), averaged over the window's jobs."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "count.parse")
