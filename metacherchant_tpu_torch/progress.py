"""Progress/ETA reporting.

Ports the reference's progress subsystem semantics: the periodic progress
line "Progress: X.X%, remaining time: T" rendered by the Tool framework's
progress-bar thread (itmo:utils/tool/Progress.java:126-146 createProgressBar,
remaining time = elapsed/progress - elapsed, ProcessTimer.java:26-33) and the
exact Java time formatters (itmo:statistics/Timer.java:17-55
timeToString/timeToStringWithoutMs). Carried over from
metacherchant_tpu/progress.py.

Totals come from input-file byte sizes (the reference's lazy Sources expose
progress() as the fraction of bytes consumed, itmo:io/sources/); counting and
classification loops advance the byte cursor per file/batch.
"""
from __future__ import annotations

import logging
import time

logger = logging.getLogger("metacherchant")


def time_to_string(ms: int) -> str:
    """itmo:statistics/Timer.java:17-41 exact."""
    ms = int(ms)
    msr = ms % 1000
    s = ms // 1000
    if s == 0:
        return f"{msr} ms"
    m = s // 60
    s %= 60
    if m == 0:
        return f"{s} s {msr} ms"
    h = m // 60
    m %= 60
    if h == 0:
        return f"{m} min {s} s"
    d = h // 24
    h %= 24
    if d == 0:
        return f"{h} h {m} min"
    return f"{d} day{'s' if d > 1 else ''} {h} h"


def time_to_string_without_ms(ms: float) -> str:
    """itmo:statistics/Timer.java:43-50 exact (Java Math.round = half-up)."""
    s = int(ms / 1000.0 + 0.5)
    if s < 60:
        return f"{s} s"
    return time_to_string(s * 1000)


class Progress:
    """Streaming progress: periodic count lines, plus reference-format
    'Progress: X.X%, remaining time: T' when a total is known.

    total / total_bytes give the denominator; update() advances the item
    count (reads), advance_bytes() the byte cursor (input files consumed).
    """

    def __init__(self, total: int | None = None, label: str = "",
                 log_every: int = 2_500_000, total_bytes: int | None = None):
        self.total = total
        self.total_bytes = total_bytes
        self.label = label
        self.done = 0
        self.bytes_done = 0
        self.log_every = log_every
        self._next = log_every
        self.t0 = time.time()

    def _fraction(self) -> float | None:
        if self.total:
            return min(1.0, self.done / self.total)
        if self.total_bytes:
            return min(1.0, self.bytes_done / self.total_bytes)
        return None

    def update(self, n: int = 1) -> None:
        self.done += n
        if self.done >= self._next:
            self._next += self.log_every
            self.show()

    def advance_bytes(self, nbytes: int) -> None:
        self.bytes_done += nbytes

    def eta_string(self) -> str:
        """Remaining time a la ProcessTimer.getRemainingTimeUS: total
        estimate = elapsed / progress; remaining = estimate - elapsed."""
        frac = self._fraction()
        if not frac:
            return ""
        elapsed_ms = (time.time() - self.t0) * 1000.0
        return time_to_string_without_ms(max(0.0, elapsed_ms / frac
                                             - elapsed_ms))

    def show(self) -> None:
        elapsed = time.time() - self.t0
        frac = self._fraction()
        if frac is not None:
            # reference progress-bar line (Progress.java:133-139)
            line = f"Progress: {frac * 100.0:.1f}%"
            rem = self.eta_string()
            if rem:
                line += f", remaining time: {rem}"
            logger.info("%s: %d done. %s", self.label, self.done, line)
        else:
            rate = self.done / elapsed if elapsed > 0 else 0
            logger.info("%s: %d done (%.0f/s)", self.label, self.done, rate)
