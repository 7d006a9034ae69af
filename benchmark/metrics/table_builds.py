"""table_builds: host tables of the whole k-mer map a job builds, from the
port's counters, averaged over the window's jobs. Only the map's probe
tables (tables.probe) are counted: the bulk callers build one (the
classifiers, load_present_kmer_strings), while the environment-finder's BFS
and its native FIFO search the sorted map and build none, so that path reads
0. The port no longer moves tables.fifo, once a FIFO table on each call; it
is still summed, and adds 0."""
from benchmark.port_spans import TOOL_MAIN, counter_delta

WRAPS = (TOOL_MAIN,)


def read(trace):
    return counter_delta(trace, "tables.probe", "tables.fifo")
