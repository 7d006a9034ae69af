"""find_s: seconds of the port's span classify.find (one mate batch's
coverage and Poisson-interval test), summed over a job's batches and the
workers that ran them, averaged over the window's jobs. The workers run in
threads, so this busy time may exceed the job's wall time."""
from benchmark.port_spans import TOOL_MAIN, span_seconds

WRAPS = (TOOL_MAIN,)


def read(trace):
    return span_seconds(trace, "classify.find")
