"""Spans around the port's functions, and the device trace of the window.

A per-layer metric names the port functions it reads (Wrap). In a traced run
the harness wraps each one in place for the window only: every call becomes
a Span with its host-clock start and end, the job it ran in, what the
metric's hooks noted of its arguments, and, where asked, CUDA events around
it. A name the port no longer has is reported and left unwrapped; the
metrics that read it then find nothing and stay out of the result.

Trace is what a metric's reader gets: the window's spans, its jobs, and the
device's kernel and copy intervals from torch.profiler, on the host clock.
"""
from __future__ import annotations

import importlib
import json
import math
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable

import torch


@dataclass(frozen=True)
class Wrap:
    """A port function to wrap: `attr` in module `module` (dotted for a
    method, as "StreamCounter._consolidate"); calls become spans named
    `span`. before(args, kwargs) returns a dict kept in the span's info;
    after(info, args, kwargs, result) may add to it."""
    module: str
    attr: str
    span: str
    before: Callable[..., dict] | None = None
    after: Callable[..., None] | None = None
    cuda_events: bool = False

    @property
    def plain(self) -> bool:
        """A span with no hooks and no device events: cheap enough for
        every run."""
        return self.before is None and self.after is None \
            and not self.cuda_events


@dataclass
class Span:
    name: str
    job: int | None
    t0: float
    t1: float = 0.0
    info: dict = field(default_factory=dict)
    events: tuple | None = None
    device_s: float | None = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class Tracer:
    """Installs wraps, records their spans and the jobs' spans."""

    def __init__(self):
        self.spans: list[Span] = []
        self.notes: list[str] = []
        self.job: int | None = None
        self._undo: list[tuple[Any, str, Any]] = []
        self._lock = threading.Lock()

    def install(self, wraps: list[Wrap]) -> None:
        """Wrap each target once; a target the port lacks is noted."""
        done = set()
        for w in wraps:
            if (w.module, w.attr, w.span) in done:
                continue
            done.add((w.module, w.attr, w.span))
            try:
                owner = importlib.import_module(w.module)
                *path, name = w.attr.split(".")
                for part in path:
                    owner = getattr(owner, part)
                orig = owner.__dict__[name] if isinstance(owner, type) \
                    else getattr(owner, name)
            except (ImportError, AttributeError, KeyError):
                self.notes.append(f"span {w.span}: {w.module}.{w.attr} not "
                                  f"found in the port; not installed")
                continue
            setattr(owner, name, self._wrapped(w, orig))
            self._undo.append((owner, name, orig))

    def uninstall(self) -> None:
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()

    def _hook(self, w: Wrap, fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # a hook never breaks the port's call
            with self._lock:
                if len(self.notes) < 50:
                    self.notes.append(f"span {w.span}: hook failed: {e!r}")
            return None

    def _wrapped(self, w: Wrap, orig):
        tracer = self

        def wrapper(*args, **kwargs):
            span = Span(w.span, tracer.job, 0.0)
            if w.before is not None:
                span.info = tracer._hook(w, w.before, args, kwargs) or {}
            if w.cuda_events and torch.cuda.is_available():
                span.events = (torch.cuda.Event(enable_timing=True),
                               torch.cuda.Event(enable_timing=True))
                span.events[0].record()
            span.t0 = time.perf_counter()
            try:
                result = orig(*args, **kwargs)
            finally:
                span.t1 = time.perf_counter()
                if span.events is not None:
                    span.events[1].record()
                tracer.spans.append(span)
            if w.after is not None:
                tracer._hook(w, w.after, span.info, args, kwargs, result)
            return result

        return wrapper

    def job_span(self, job: int) -> Span:
        span = Span("job", job, time.perf_counter())
        self.spans.append(span)
        return span

    def resolve_events(self) -> None:
        """Device seconds of every span timed by CUDA events (after the
        window, once the device has finished)."""
        if any(s.events for s in self.spans):
            torch.cuda.synchronize()
        for s in self.spans:
            if s.events is not None:
                s.device_s = s.events[0].elapsed_time(s.events[1]) / 1e3
                s.events = None


#: chrome-trace categories of device work
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_MARK = "benchmark_window"


def device_intervals(trace_path: str, t0: float
                     ) -> list[tuple[str, float, float]] | None:
    """The device's kernels and copies from a torch.profiler chrome trace,
    as (name, start, end) on the host's perf_counter clock, aligned by the
    WINDOW_MARK annotation that opened at perf_counter `t0`. None when the
    trace holds no device work or no mark."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    mark = [e for e in events if e.get("name") == WINDOW_MARK
            and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    if not mark or not dev:
        return None
    base = float(mark[0]["ts"])
    return [(e["name"], t0 + (float(e["ts"]) - base) / 1e6,
             t0 + (float(e["ts"]) + float(e.get("dur", 0.0)) - base) / 1e6)
            for e in dev]


def busy_union(intervals: list[tuple[float, float]], lo: float, hi: float
               ) -> list[tuple[float, float]]:
    """The union of intervals, clipped to [lo, hi], merged and sorted."""
    merged: list[list[float]] = []
    for a, b in sorted((max(a, lo), min(b, hi)) for a, b in intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def job_split(spans: list[Span], job: int) -> str:
    """Each span name's seconds in job `job`: summed (busy) and as the
    union of its calls (wall), which differ where calls overlap in
    threads."""
    names = sorted({s.name for s in spans if s.job == job} - {"job"})
    parts = []
    for name in names:
        ab = [(s.t0, s.t1) for s in spans if s.job == job and s.name == name]
        busy = sum(b - a for a, b in ab)
        wall = sum(b - a for a, b in busy_union(ab, -math.inf, math.inf))
        parts.append(f"{name} {busy:.3f} s busy, {wall:.3f} s wall")
    return "; ".join(parts) or "no spans"


class Trace:
    """What the window left for the per-layer readers."""

    def __init__(self, spans: list[Span], jobs: list[int], t0: float,
                 t1: float, device: list[tuple[str, float, float]] | None):
        self.t0, self.t1 = t0, t1
        self.jobs = jobs
        self._spans = spans
        self.device = device
        if device is None:
            self.busy = None
        else:
            self.busy = busy_union([(a, b) for _, a, b in device], t0, t1)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def busy_s(self) -> float | None:
        return None if self.busy is None else sum(b - a for a, b in self.busy)

    def spans(self, name: str) -> list[Span]:
        return [s for s in self._spans
                if s.name == name and s.job in self.jobs]

    def mean_per_job(self, name: str) -> float | None:
        """Seconds of `name`'s spans summed within each job, averaged over
        the window's jobs; None when no call was recorded."""
        spans = self.spans(name)
        if not spans or not self.jobs:
            return None
        return sum(s.seconds for s in spans) / len(self.jobs)

    def kernels(self, substring: str) -> list[tuple[str, float, float]]:
        if self.device is None:
            return []
        return [d for d in self.device if substring in d[0]
                and d[1] >= self.t0 and d[2] <= self.t1]

    def _open_at(self, t: float) -> str:
        """The innermost span open at time t, as 'job i: name'."""
        open_ = [s for s in self._spans if s.t0 <= t <= s.t1]
        if not open_:
            return "between jobs"
        s = min(open_, key=lambda s: s.seconds)
        return f"job {s.job}: {s.name}"

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took the most time, by name, and the
        longest idle gaps of the device, each named by the innermost spans
        open where it starts, at its middle and where it ends."""
        if self.device is None:
            return {}
        by_name: dict[str, float] = {}
        for name, a, b in self.device:
            a, b = max(a, self.t0), min(b, self.t1)
            if b > a:
                by_name[name[:160]] = by_name.get(name[:160], 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2])
                       if b > a), reverse=True)[:top]
        named = []
        for length, a, b in gaps:
            labels = [self._open_at(t) for t in (a, (a + b) / 2, b)]
            labels = [x for i, x in enumerate(labels)
                      if i == 0 or x != labels[i - 1]]
            named.append([" -> ".join(labels), length])
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}
