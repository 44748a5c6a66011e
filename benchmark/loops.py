"""What every loop shares.

A traffic file (`benchmark/traffic/<mix>.json`) names its loop, whose
driver is `benchmark/traffic/<loop>.py`, and gives its parameters; a
configuration file (`benchmark/configs/<config>.json`) gives the program's
entry, its settings and the case's sizes.  A driver is a module with a
function `run(run: Run) -> Outcome` and a dict `FAULTS` of the faults that
its cells can have (name: (what is replaced, how)).  It builds its case
from the seed, drives the program (the package
`fetalreconstruction_tpu_torch`, through its public entry points only),
warms up, measures the window, and then, with the window closed and the
peak memory read, checks the window's outputs against the plain reference
(`benchmark/reference/`), computing only the numbers that the cell's
limits name (`run.compare`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

PROGRAM = "fetalreconstruction_tpu_torch"
GIB = 2.0 ** 30


@dataclasses.dataclass
class Run:
    """What a loop is given."""
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float            # perf_counter at process start
    faults: tuple = ()        # names of faults to plant (tests, control)
    control: bool = False     # also read the TF32 reference's numbers
    compare: tuple = ()       # the numbers that the cell's limits name


@dataclasses.dataclass
class Outcome:
    end_to_end: Dict[str, float]
    records: dict             # what per-layer readers read
    checks: Dict[str, float]  # numbers compared, by name
    attempted: int
    failed: int
    peak_bytes: int
    breakdown: Optional[dict] = None
    control: Optional[dict] = None  # the TF32 reference's numbers


def program(path: str):
    """`module.attr` (or a module) of the program, by its dotted name."""
    mod, _, attr = path.rpartition(".")
    try:
        return getattr(importlib.import_module(f"{PROGRAM}.{mod}"), attr)
    except (ImportError, AttributeError):
        return importlib.import_module(f"{PROGRAM}.{path}")


@contextlib.contextmanager
def patched(path: str, make: Callable):
    """Replace `owner.attr` of the program (owner a module, or a class in
    one) by make(the original) for the duration."""
    owner, _, attr = path.rpartition(".")
    obj = program(owner)
    orig = getattr(obj, attr)
    setattr(obj, attr, make(orig))
    try:
        yield
    finally:
        setattr(obj, attr, orig)


def planted(faults, own: dict) -> contextlib.ExitStack:
    """The named faults planted in the program: a driver's own (`own`)
    and those of every loop (FAULTS)."""
    stack = contextlib.ExitStack()
    for f in faults:
        stack.enter_context(patched(*{**FAULTS, **own}[f]))
    return stack


def counters() -> Dict[str, int]:
    """The program's launch counters as they stand (ops.scatter.LAUNCHES);
    a driver keeps their change over its window for the readers."""
    return dict(program("ops.scatter.LAUNCHES"))


def counted_since(before: Dict[str, int]) -> Dict[str, int]:
    now = counters()
    return {k: now[k] - before.get(k, 0) for k in now}


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev):
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)


def read_peak(dev) -> int:
    return (int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda"
            else 0)


def rel_gap(a, b, keep=None) -> float:
    """max |a - b| over max |b|, where keep (all if None)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if keep is not None:
        a, b = a[keep], b[keep]
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def rms_gap(a, b, keep) -> float:
    """Root mean square of a - b over that of b, where keep."""
    a = np.asarray(a, np.float64)[keep]
    b = np.asarray(b, np.float64)[keep]
    return float(np.sqrt(np.mean((a - b) ** 2) / max(np.mean(b * b), 1e-30)))


def abs_gap(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def say(msg: str):
    print(msg, file=sys.stderr, flush=True)


def keep_trace(records, summary):
    """Store a span's summary for the readers; returns the breakdown."""
    if summary is None:
        return None
    records["trace"] = summary
    return {k: summary[k] for k in ("device_ops", "idle_gaps")}


# ----- faults that any loop's cells can have --------------------------------

def _unchanged_inner(orig):
    """An inner iteration that returns its state unchanged."""
    def f(ctx, geom, sume, slices, valid, em, sim_state, recon, *a, **k):
        return em, sim_state, recon
    return f


def _half_batch(orig):
    """The SR step sees the first half of the slices only."""
    def f(ctx, geom, sume, slices, valid, *a, **k):
        keep = torch.zeros_like(valid)
        keep[:valid.shape[0] // 2] = True
        return orig(ctx, geom, sume, slices, valid & keep, *a, **k)
    return f


def _altered_volume(orig):
    """The SR step's volume altered where it is produced: its brightest
    voxel half as bright again."""
    def f(*a, **k):
        recon, cmap = orig(*a, **k)
        recon = recon.clone()
        recon.view(-1)[recon.argmax()] *= 1.5
        return recon, cmap
    return f


FAULTS = {  # name: (what is replaced, how)
    "unchanged_step": ("pipeline.svr_core.inner_iteration", _unchanged_inner),
    "half_batch": ("pipeline.svr_core.superresolution_step", _half_batch),
    "altered_volume": ("pipeline.svr_core.superresolution_step",
                       _altered_volume)}
