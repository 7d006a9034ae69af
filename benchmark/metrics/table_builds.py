"""table_builds: host tables of the whole k-mer map a job builds, from the
port's counters: the map's probe tables (tables.probe) and the native
FIFO's table on each call (tables.fifo), averaged over the window's
jobs."""
from benchmark.port_spans import TOOL_MAIN, counter_delta

WRAPS = (TOOL_MAIN,)


def read(trace):
    return counter_delta(trace, "tables.probe", "tables.fifo")
