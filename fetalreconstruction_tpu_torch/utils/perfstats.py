"""Named-phase wall-clock performance sampler, with spans and counters
filed under its phases.

A copy of fetalreconstruction_tpu/utils/perfstats.py (the reference's
PerfStats, include/perfstats.h:44-105): phases are sampled around every
pipeline stage and printed as a table; the SVR CLI writes it to
performance_<date>.txt (reconstruction.cc:1282-1295).  On a CUDA device
every sample is taken after a synchronise, so each phase holds the device
time it spent (a handful of samples per outer iteration).

Inside `with stats.recording():` the program's spans
(`utils.tracing.annotate`) and counters (`count`) report to `stats`.  At
each `sample(phase)` what they gathered since the previous sample is
filed as rows `<phase>/<span>` (seconds) and `<phase>/<counter> #` (a
count), one entry per occurrence of the phase, so code shared by several
phases is filed under the phase that ran it.  Spans and counters never
synchronise and never touch a tensor; outside a recording they cost one
context-variable read.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from collections import OrderedDict
from typing import List, NamedTuple, Optional

import torch

COUNT = " #"  # the suffix of a count row


class Scope(NamedTuple):
    """Where spans and counters report: a PerfStats (or None), and whether
    spans also open torch.profiler ranges (inside `utils.tracing.trace`)."""
    stats: Optional["PerfStats"]
    ranges: bool


_SCOPE: "contextvars.ContextVar[Optional[Scope]]" = contextvars.ContextVar(
    "perfstats_scope", default=None)


def current() -> Optional[Scope]:
    """The scope that spans and counters report to, or None."""
    return _SCOPE.get()


@contextlib.contextmanager
def scope(stats: Optional["PerfStats"] = None,
          ranges: Optional[bool] = None):
    """Within the block, spans and counters report to `stats` and open
    ranges if `ranges`; either left None keeps the enclosing scope's."""
    outer = _SCOPE.get()
    if stats is None and outer is not None:
        stats = outer.stats
    if ranges is None:
        ranges = outer is not None and outer.ranges
    token = _SCOPE.set(Scope(stats, ranges))
    try:
        yield
    finally:
        _SCOPE.reset(token)


def count(name: str, n: int = 1) -> None:
    """Add n to the active PerfStats' counter `name` (nothing outside a
    recording)."""
    s = _SCOPE.get()
    if s is not None and s.stats is not None:
        s.stats.count(name, n)


class PerfStats:
    def __init__(self, device: Optional[torch.device] = None):
        self._device = torch.device(device) if device is not None else None
        self._samples: "OrderedDict[str, List[float]]" = OrderedDict()
        self._spans: "OrderedDict[str, float]" = OrderedDict()
        self._counts: "OrderedDict[str, int]" = OrderedDict()
        self._last = time.perf_counter()
        self._start = self._last

    def start(self):
        self._last = time.perf_counter()
        self._start = self._last

    def recording(self):
        """Context manager: the block's spans and counters report here."""
        return scope(stats=self)

    def sample(self, name: str):
        """Record the time since the previous sample under `name`, and
        file the spans and counters gathered since then under it."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        now = time.perf_counter()
        self._samples.setdefault(name, []).append(now - self._last)
        self._last = now
        self._file(name)

    def close_span(self, name: str, start_ns: int, end_ns: int):
        """A span `name` ran from start_ns to end_ns (time.time_ns()): its
        seconds count towards the next sample.  Every span closes here."""
        self._spans[name] = (self._spans.get(name, 0.0)
                             + (end_ns - start_ns) * 1e-9)

    def count(self, name: str, n: int = 1):
        """Add n to the counter `name` until the next sample."""
        self._counts[name] = self._counts.get(name, 0) + n

    def _file(self, phase: str):
        """Close the gathered spans and counters into rows of `phase`:
        every row of the phase gets one entry for this occurrence (0 where
        nothing reported), a row new at a later occurrence 0 for each
        earlier one."""
        prefix = phase + "/"
        got = {prefix + k: v for k, v in self._spans.items()}
        got.update((prefix + k + COUNT, v) for k, v in self._counts.items())
        self._spans.clear()
        self._counts.clear()
        n = len(self._samples[phase])
        for row in [r for r in self._samples if r.startswith(prefix)] + [
                r for r in got if r not in self._samples]:
            zero = 0 if row.endswith(COUNT) else 0.0
            vals = self._samples.setdefault(row, [zero] * (n - 1))
            vals.append(got.get(row, zero))

    def samples(self, name: str) -> List[float]:
        """The times (or counts) recorded under `name`, in order."""
        return list(self._samples.get(name, []))

    def total(self) -> float:
        return time.perf_counter() - self._start

    def table(self) -> str:
        """Phases in the order first sampled, each followed by its span
        and count rows, indented."""
        rows = ["%-28s %10s %8s %10s" % ("phase", "total[s]", "count",
                                         "mean[s]")]
        for name, vals in self._samples.items():
            if "/" in name:
                continue
            rows.append("%-28s %10.3f %8d %10.3f"
                        % (name, sum(vals), len(vals),
                           sum(vals) / max(len(vals), 1)))
            for sub, svals in self._samples.items():
                if not sub.startswith(name + "/"):
                    continue
                fmt = ("%-28s %10d %8d %10.1f" if sub.endswith(COUNT)
                       else "%-28s %10.3f %8d %10.3f")
                rows.append(fmt % ("  " + sub[len(name) + 1:], sum(svals),
                                   len(svals),
                                   sum(svals) / max(len(svals), 1)))
        rows.append("%-28s %10.3f" % ("TOTAL", self.total()))
        return "\n".join(rows)

    def print(self):
        print(self.table())

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(self.table() + "\n")
