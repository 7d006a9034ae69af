"""The port's own spans and counters (metacherchant_tpu_torch/trace.py),
read per job.

TOOL_MAIN wraps the port's Tool.main as the span `tool_main`: its before
hook opens the port's recording, its after hook closes it and keeps the
job's port spans and counter deltas in the span's info, under "port". The
hooks make it a wrap of traced runs only, so the runs that measure the
end-to-end metrics keep the port's recording off. Every metric that reads
the port lists this one Wrap, which the harness installs once. Where the
port has no recorder, the hooks keep nothing and those metrics find
nothing to read.
"""
from __future__ import annotations

from benchmark.tracing import Wrap

#: recordings opened by a before hook whose call has not returned; a call
#: that raised leaves its own, which the next call closes
_open: list = []


def _before(args, kwargs) -> dict:
    try:
        from metacherchant_tpu_torch import trace
    except ImportError:
        return {}
    while _open:
        _open.pop().stop()
    rec = trace.recording().start()
    _open.append(rec)
    return {"recording": rec}


def _after(info, args, kwargs, result) -> None:
    rec = info.pop("recording", None)
    if rec is None:
        return
    rec.stop()
    if rec in _open:
        _open.remove(rec)
    info["port"] = {"spans": rec.spans, "counters": rec.counters}


TOOL_MAIN = Wrap("metacherchant_tpu_torch.tool", "Tool.main", "tool_main",
                 before=_before, after=_after)


def _ports(trace) -> list[dict]:
    """The port's records of the window's completed jobs."""
    return [s.info["port"] for s in trace.spans("tool_main")
            if "port" in s.info]


def span_seconds(trace, name: str) -> float | None:
    """Seconds of the port's spans `name` summed within each job, averaged
    over the window's jobs. Spans of threads that overlap add up (busy
    time). None where no job recorded such a span."""
    spans = [sp for port in _ports(trace) for sp in port["spans"]
             if sp.name == name]
    if not spans or not trace.jobs:
        return None
    return sum(sp.t1 - sp.t0 for sp in spans) / len(trace.jobs)


def counter_delta(trace, *names: str) -> float | None:
    """The port's counters `names` moved by each job, summed, averaged over
    the window's jobs. None where no job recorded the port's counters."""
    ports = _ports(trace)
    if not ports or not trace.jobs:
        return None
    return sum(port["counters"].get(n, 0) for port in ports
               for n in names) / len(trace.jobs)
