"""Profiling, tracing and numerical guards.

Port of fetalreconstruction_tpu/utils/tracing.py on torch.profiler: a
device trace around a block (one Chrome trace per rank, viewable in
Perfetto or chrome://tracing), named regions inside it, device-memory
telemetry (the reference's checkGPUMemory) and the NaN guard that
run_svr's --debug path runs between phases.
"""
from __future__ import annotations

import contextlib
import os

import numpy as np
import torch


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
        with prof:
            yield
    finally:
        prof.export_chrome_trace(os.path.join(logdir,
                                              f"trace_rank{rank}.json"))


def annotate(name: str):
    """Named region inside a trace (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)


def device_memory_stats(device=None) -> dict:
    """torch.cuda.memory_stats of a CUDA device (the current one by
    default); {} for the CPU or without CUDA (the reference's
    checkGPUMemory, reconstruction_cuda2.cu:72-87)."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    return torch.cuda.memory_stats(device)


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
