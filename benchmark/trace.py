"""Device trace of one span of work: torch.profiler's CUDA activity, read
as kernel events on the host's wall clock.

    with DeviceSpan(device) as span:
        work()
    summary = span.summary(marks)

The span synchronises at both ends, so its length is the work's wall time.
Kineto stamps device events on the host's realtime clock (ns), so host
marks taken with time.time_ns() (a phase's end) label what the host was
doing in each idle gap.
"""
from __future__ import annotations

import sys
import time
from typing import List, Optional, Sequence, Tuple

import torch

TOP = 10  # entries of each breakdown list


class DeviceSpan:
    def __init__(self, device):
        self.device = torch.device(device)
        self.events: List[Tuple[str, int, int]] = []
        self.t0 = self.t1 = 0
        self._prof = None

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        if self.device.type == "cuda":
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self._sync()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.t1 = time.time_ns()
        if self._prof is None:
            return False
        t = time.perf_counter()
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() != DeviceType.CUDA:
                continue
            self.events.append((e.name(), int(e.start_ns()),
                                int(e.duration_ns())))
        self._prof = None
        print(f"trace: {len(self.events)} device events read in "
              f"{time.perf_counter() - t:.1f} s", file=sys.stderr, flush=True)
        return False

    def summary(self, marks: Optional[Sequence[Tuple[str, int]]] = None):
        """Busy and wall seconds, the sum of the device's operation times,
        the kernel count (every event but copies and fills), time by kernel
        name, and the idle gaps, each labelled with the host phase in which
        it fell (marks: (phase, end time ns) in order; the span's last
        stretch is "tail").  None off the card, which has no trace."""
        if self.device.type != "cuda":
            return None
        evs = [(n, max(s, self.t0), min(s + d, self.t1))
               for n, s, d in self.events if s + d > self.t0
               and s < self.t1]
        by_name, count = {}, {}
        for n, s, e in evs:
            by_name[n] = by_name.get(n, 0) + (e - s)
            count[n] = count.get(n, 0) + 1
        merged = []
        for _, s, e in sorted(evs, key=lambda v: v[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        busy = sum(e - s for s, e in merged)
        edges = [self.t0] + [v for iv in merged for v in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        labelled = []
        for s, e in gaps:
            mid = (s + e) // 2
            phase = next((p for p, t in (marks or ()) if t >= mid), "tail")
            labelled.append((phase, (e - s) / 1e9))
        labelled.sort(key=lambda v: -v[1])
        top_ops = sorted(by_name.items(), key=lambda v: -v[1])[:TOP]
        return dict(
            window_s=(self.t1 - self.t0) / 1e9, busy_s=busy / 1e9,
            device_sum_s=sum(e - s for _, s, e in evs) / 1e9,
            kernels=sum(1 for n, _, _ in evs
                        if not n.startswith(("Memcpy", "Memset"))),
            events=len(evs),
            by_name={n: v / 1e9 for n, v in by_name.items()},
            count_by_name=count,
            device_ops=[[n[:160], v / 1e9] for n, v in top_ops],
            idle_gaps=[[p, v] for p, v in labelled[:TOP]])
