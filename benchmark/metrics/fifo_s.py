"""fifo_s: seconds of the port's span bfs.direction (one BFS direction:
the native FIFO's table of the whole map and its walk), summed over a
job's genes and directions, averaged over the window's jobs. The genes
run in threads, so this busy time may exceed the job's wall time."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "bfs.direction")
