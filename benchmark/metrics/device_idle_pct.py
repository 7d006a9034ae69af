"""device_idle_pct: the share of the window in which no kernel, copy or
memset ran on the card, from the profiler's trace of the window."""

WRAPS = ()


def read(trace):
    busy = trace.busy_s
    if not busy:
        return None
    return 100.0 * (1.0 - busy / trace.window_s)
