"""The port's spans and counters.

One recorder, with no option and no environment variable:

- span(name, **attrs), a context manager, and traced(name), a decorator,
  mark a stage of the work. A recorded span keeps its name, an id, its
  parent's id, the id of its root span (the `tool` span of Tool.main, so
  every span of one job shares it), the thread, t0 and t1 on the
  time.perf_counter clock, the thread's CPU seconds in between
  (time.thread_time; wall time minus CPU time is time spent waiting, on
  the GIL among others) and the counts given as attrs or added by set().
- A span opened in a worker thread names the span that submitted the work
  as its parent when the work is submitted through submit(), which runs it
  in a copy of the submitter's context.
- count(name, n) adds n to a named counter: always on, one add under a
  lock, at the granularity of a launch, a table or a file.
- recording() turns span recording on for a block and hands over the
  spans that closed in it and the counters' deltas at its end; spans are
  kept in memory meanwhile, never written per call.

With no recording open, span() returns one shared no-op object: one read
of a global, no clock read, no allocation of its own, no profiler call.
With one open, each span is also a torch.profiler.record_function range,
so that under a profiler the spans lie on the card's timeline beside its
kernels and copies; their t0 and t1 are on the host's perf_counter clock.
No span goes below one launch: none per read, per k-mer or per BFS step.
"""
from __future__ import annotations

import contextvars
import functools
import itertools
import threading
import time
from dataclasses import dataclass, field

#: the open recordings, or None when none is open
_sinks: tuple["Recording", ...] | None = None
_sinks_lock = threading.Lock()
#: the innermost open span of the running context
_current: contextvars.ContextVar = contextvars.ContextVar(
    "metacherchant_span", default=None)
_ids = itertools.count(1)
_counts: dict[str, int] = {}
_counts_lock = threading.Lock()
#: torch.profiler.record_function, imported when a recording first opens
_record_function = None


@dataclass(slots=True)
class SpanRecord:
    """A span that closed under a recording."""
    name: str
    id: int
    parent: int | None
    root: int
    thread: int
    t0: float
    t1: float
    cpu_s: float
    attrs: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


class _NoSpan:
    """The shared span of an unrecorded stage: does nothing."""
    __slots__ = ()

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "attrs", "sinks", "id", "parent", "root", "t0",
                 "c0", "_token", "_range")

    def __init__(self, name: str, attrs: dict,
                 sinks: tuple["Recording", ...]):
        self.name, self.attrs, self.sinks = name, attrs, sinks

    def set(self, **attrs) -> None:
        """Add counts known only once the stage has run."""
        self.attrs.update(attrs)

    def __enter__(self) -> "_Span":
        parent = _current.get()
        self.id = next(_ids)
        self.parent = None if parent is None else parent.id
        self.root = self.id if parent is None else parent.root
        self._token = _current.set(self)
        self._range = _record_function(self.name)
        self._range.__enter__()
        self.c0 = time.thread_time()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        c1 = time.thread_time()
        self._range.__exit__(None, None, None)
        _current.reset(self._token)
        rec = SpanRecord(self.name, self.id, self.parent, self.root,
                         threading.get_ident(), self.t0, t1, c1 - self.c0,
                         self.attrs)
        for sink in self.sinks:
            if sink.open:
                sink.spans.append(rec)
        return False


def span(name: str, /, **attrs):
    """A span of the stage `name` for a `with` block; attrs are counts
    known when it opens (set() adds more). The shared no-op when no
    recording is open."""
    sinks = _sinks
    if sinks is None:
        return NO_SPAN
    return _Span(name, attrs, sinks)


def current():
    """The innermost open span of the running context, to add counts to;
    the shared no-op when no recording is open or no span is."""
    if _sinks is None:
        return NO_SPAN
    return _current.get() or NO_SPAN


def traced(name: str):
    """Decorator: every call of the function is a span named `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            sinks = _sinks
            if sinks is None:
                return fn(*args, **kwargs)
            with _Span(name, {}, sinks):
                return fn(*args, **kwargs)
        return wrapper
    return deco


def submit(executor, fn, /, *args, **kwargs):
    """executor.submit(fn, *args, **kwargs), run in a copy of the caller's
    context, so that the spans fn opens name the caller's open span as
    their parent."""
    return executor.submit(contextvars.copy_context().run, fn, *args,
                           **kwargs)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counter(name: str) -> int:
    """The counter `name` since the process started."""
    with _counts_lock:
        return _counts.get(name, 0)


def counters() -> dict[str, int]:
    """Every counter since the process started."""
    with _counts_lock:
        return dict(_counts)


class Recording:
    """Span recording for a block (`with recording() as rec:`), or from
    start() to stop(). Afterwards `spans` holds the spans that opened and
    closed in it, in the order they closed, and `counters` each counter
    that moved, by how much."""

    def __init__(self):
        self.spans: list[SpanRecord] = []
        self.counters: dict[str, int] = {}
        self.open = False
        self._start: dict[str, int] = {}

    def start(self) -> "Recording":
        global _sinks, _record_function
        if _record_function is None:
            from torch.profiler import record_function
            _record_function = record_function
        with _sinks_lock:
            self._start = counters()
            self.open = True
            _sinks = (_sinks or ()) + (self,)
        return self

    def stop(self) -> "Recording":
        global _sinks
        with _sinks_lock:
            if not self.open:
                return self
            self.open = False
            rest = tuple(s for s in _sinks or () if s is not self)
            _sinks = rest or None
            now = counters()
        self.counters = {k: v - self._start.get(k, 0) for k, v in now.items()
                         if v != self._start.get(k, 0)}
        return self

    def __enter__(self) -> "Recording":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False


def recording() -> Recording:
    """Span recording for a `with` block; see Recording."""
    return Recording()


def all_threads():
    """torch.profiler's experimental config that profiles every thread, so
    that a profile holds the spans of worker threads too; None where the
    installed torch lacks it (a profile then holds the spans of the thread
    that started it)."""
    try:
        from torch._C._profiler import _ExperimentalConfig
        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None
