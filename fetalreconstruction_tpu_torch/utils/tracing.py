"""Profiling, tracing and numerical guards.

Port of fetalreconstruction_tpu/utils/tracing.py on torch.profiler: a
device trace around a block (one Chrome trace per rank, viewable in
Perfetto or chrome://tracing), the program's named spans, and the NaN
guard that run_svr's --debug path runs between phases.

A span (`annotate`) adds its host seconds to the active PerfStats (see
utils/perfstats.py) and, inside `trace`, also opens a torch.profiler
range, so the trace's kernels fall under the program's layers.  Outside
both it costs one context-variable read.
"""
from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from . import perfstats


@contextlib.contextmanager
def trace(logdir: str, rank: int = 0):
    """Profile the block's CPU and CUDA activity and write it to
    logdir/trace_rank<rank>.json, also when the block raises:

        with tracing.trace("/tmp/trace"):
            run_svr(cfg, device="cuda")
    """
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    try:
        with prof, perfstats.scope(ranges=True):
            yield
    finally:
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace_rank{rank}.json"))


class _Span:
    __slots__ = ("name", "scope", "t0", "range")

    def __init__(self, name: str, scope: perfstats.Scope):
        self.name, self.scope, self.range = name, scope, None

    def __enter__(self):
        if self.scope.ranges:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        if self.scope.stats is not None:
            self.scope.stats.close_span(self.name, self.t0, t1)
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


_IDLE = contextlib.nullcontext()


def annotate(name: str):
    """A named span, as a context manager: its host seconds (stamped with
    time.time_ns(), the clock of torch.profiler's device events) go to the
    active PerfStats, and inside `trace` it is a record_function range.
    Outside both it does nothing."""
    scope = perfstats.current()
    return _IDLE if scope is None else _Span(name, scope)


def _leaves(tree):
    """Leaves in JAX's tree order: sequences in order, dicts by key."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def check_finite(tree, name: str = "state") -> None:
    """Raise FloatingPointError if a floating-point leaf of `tree` (tensors
    or arrays in tuples, lists, named tuples or dicts) holds NaN or Inf."""
    for i, leaf in enumerate(_leaves(tree)):
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                bad = int((~torch.isfinite(leaf)).sum())
                raise FloatingPointError(
                    f"{name}: leaf {i} has {bad} non-finite values")
            continue
        arr = np.asarray(leaf)
        if arr.dtype.kind == "f" and not np.all(np.isfinite(arr)):
            bad = int((~np.isfinite(arr)).sum())
            raise FloatingPointError(
                f"{name}: leaf {i} has {bad} non-finite values")
