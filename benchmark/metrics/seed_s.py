"""seed_s: seconds of the port's span env.seed (the gene's seed k-mers
looked up in the map, the first lookup building the map's probe table),
summed over a job's genes, averaged over the window's jobs. The genes run
in threads, so this busy time may exceed the job's wall time."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "env.seed")
