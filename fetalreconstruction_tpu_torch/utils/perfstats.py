"""Named-phase wall-clock performance sampler.

A copy of fetalreconstruction_tpu/utils/perfstats.py (the reference's
PerfStats, include/perfstats.h:44-105): phases are sampled around every
pipeline stage and printed as a table; the SVR CLI writes it to
performance_<date>.txt (reconstruction.cc:1282-1295).  On a CUDA device
every sample is taken after a synchronise, so each phase holds the device
time it spent (a handful of samples per outer iteration).
"""
from __future__ import annotations

import time
from collections import OrderedDict
from typing import List, Optional

import torch


class PerfStats:
    def __init__(self, device: Optional[torch.device] = None):
        self._device = torch.device(device) if device is not None else None
        self._samples: "OrderedDict[str, List[float]]" = OrderedDict()
        self._last = time.perf_counter()
        self._start = self._last

    def start(self):
        self._last = time.perf_counter()
        self._start = self._last

    def sample(self, name: str):
        """Record the time since the previous sample under `name`."""
        if self._device is not None and self._device.type == "cuda":
            torch.cuda.synchronize(self._device)
        now = time.perf_counter()
        self._samples.setdefault(name, []).append(now - self._last)
        self._last = now

    def samples(self, name: str) -> List[float]:
        """The times recorded under `name`, in order."""
        return list(self._samples.get(name, []))

    def total(self) -> float:
        return time.perf_counter() - self._start

    def table(self) -> str:
        rows = ["%-28s %10s %8s %10s" % ("phase", "total[s]", "count",
                                         "mean[s]")]
        for name, vals in self._samples.items():
            rows.append("%-28s %10.3f %8d %10.3f"
                        % (name, sum(vals), len(vals),
                           sum(vals) / max(len(vals), 1)))
        rows.append("%-28s %10.3f" % ("TOTAL", self.total()))
        return "\n".join(rows)

    def print(self):
        print(self.table())

    def write(self, path: str):
        with open(path, "w") as f:
            f.write(self.table() + "\n")
