"""Run one cell of BENCHMARK.json and build its result line.

Everything a cell needs is found by name: its configuration in the file
that BENCHMARK.json gives, its traffic mix in `benchmark/traffic/<mix>.json`
(whose `loop` names its driver, `benchmark/traffic/<loop>.py`), the limits
of its comparison in `benchmark/limits/<cell>.json`, and each per-layer
metric's reader in `benchmark/metrics/<metric>.py` (a function
`read(records)` that returns the number, or None where it finds nothing
to read).
"""
from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from typing import Dict, Optional

import torch

from . import loops

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "fetalreconstruction_tpu")


def load_manifest(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_of(manifest: dict, root: Path, name: str) -> dict:
    for c in manifest["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic_of(name: str, base: Path = HERE) -> dict:
    return json.loads((base / "traffic" / f"{name}.json").read_text())


def limits_of(cell: str, base: Path = HERE) -> dict:
    return json.loads((base / "limits" / f"{cell}.json").read_text())


def _by_path(path: Path, name: str):
    """The module in a file (names may hold dots, so it is loaded by its
    path)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, base: Path = HERE):
    """The read() of benchmark/metrics/<metric>.py."""
    return _by_path(base / "metrics" / f"{metric}.py",
                    f"benchmark_metric_{metric.replace('.', '_')}").read


def driver(loop: str, base: Path = HERE):
    """The module benchmark/traffic/<loop>.py (under base, else beside this
    file): its run(Run) -> Outcome and its FAULTS."""
    path = base / "traffic" / f"{loop}.py"
    if not path.exists():
        path = HERE / "traffic" / f"{loop}.py"
    return _by_path(path, f"benchmark_loop_{loop.replace('.', '_')}")


def reported(metrics: list, cell: str) -> list:
    """The metrics that a cell reports: those that list it, and those that
    list no cells."""
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def within(value: float, limit: dict) -> bool:
    if value is None or not math.isfinite(value):
        return False
    return (("max" not in limit or value <= limit["max"])
            and ("min" not in limit or value >= limit["min"]))


def judge(checks: Dict[str, float], limits: dict) -> Dict[str, dict]:
    """Each limited number beside its limit."""
    out = {}
    for name, limit in limits.items():
        v = checks.get(name)
        out[name] = dict(value=v, limit=limit, ok=within(v, limit))
    return out


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def run_cell(root: Path, cell_name: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, faults=(),
             control: bool = False, manifest: Optional[dict] = None,
             config: Optional[dict] = None, base: Path = HERE):
    """Run a cell; returns (result line, judged checks, the loop's
    Outcome).  faults and control serve the harness's tests and
    benchmark/control.py, never a benchmark run."""
    manifest = manifest or load_manifest(root)
    cell = cell_of(manifest, cell_name)
    config = config or config_of(manifest, root, cell["config"])
    limits = limits_of(cell_name, base)
    run = loops.Run(config=config, traffic=traffic_of(cell["traffic"], base),
                    seed=int(seed), seconds=float(seconds), trace=bool(trace),
                    device=device, t_start=t_start, faults=tuple(faults),
                    control=control, compare=tuple(limits))
    out = driver(run.traffic["loop"], base).run(run)
    judged = judge(out.checks, limits)
    metrics = {}
    if trace:
        for m in reported(manifest["per_layer"], cell_name):
            v = reader(m["name"], base)(out.records)
            if v is not None:
                metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    else:
        for m in reported(manifest["end_to_end"], cell_name):
            if m["name"] in out.end_to_end:
                metrics[m["name"]] = dict(value=float(out.end_to_end[
                    m["name"]]), unit=m["unit"])
    dev = dict(platform="gpu" if device.type == "cuda" else device.type,
               kind=(torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
               count=1, memory_peak_bytes=out.peak_bytes)
    if trace and "trace" in out.records:
        dev.update(busy_s=out.records["trace"]["busy_s"],
                   window_s=out.records["trace"]["window_s"])
    correct = (out.failed == 0 and out.attempted > 0
               and all(j["ok"] for j in judged.values()))
    result = dict(correct=bool(correct), attempted=out.attempted,
                  failed=out.failed, metrics=metrics, device=dev)
    if trace and out.breakdown:
        result["breakdown"] = out.breakdown
    result["checks"] = {k: dict(value=(j["value"] if j["value"] is not None
                                       and math.isfinite(j["value"])
                                       else None), limit=j["limit"])
                        for k, j in judged.items()}
    return result, judged, out
