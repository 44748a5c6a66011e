"""Tiny sizes of the benchmark's cells, for the harness's tests on the CPU
(the cells themselves run on the card at their full sizes)."""
from __future__ import annotations

import time
from pathlib import Path

import torch

from benchmark import harness, loops

ROOT = Path(__file__).resolve().parents[2]
# numbers held against the case's truth, which mean something at the
# cells' own sizes only
TRUTH = ("reg_gain_mm",)
CPU = torch.device("cpu")
SEED = 2147483647 + 12
MANIFEST = harness.load_manifest(ROOT)
# every cell of BENCHMARK.json, and those whose traffic drives the recon loop
CELLS = [w["name"] for w in MANIFEST["workloads"]]
RECON = [w["name"] for w in MANIFEST["workloads"]
         if harness.traffic_of(w["traffic"])["loop"] == "recon"]


def config(cell: str) -> dict:
    """The cell's configuration cut to a CPU test's size."""
    man = harness.load_manifest(ROOT)
    cfg = harness.config_of(man, ROOT, harness.cell_of(man, cell)["config"])
    cfg["case"].update(hw=40, gn=40, motion_t=1.5, motion_r=1.5)
    cfg["run"].update(iterations=2, rec_iterations_first=2,
                      rec_iterations_last=3, reg_levels=1, reg_iterations=3)
    if "patch_size" in cfg["run"]:
        cfg["run"].update(patch_size=8, patch_stride=4)
    if "canonical" in cfg:
        cfg["canonical"].update(stack_slices=6, hw=24, vol=28)
    return cfg


def reference_numbers_ok(judged) -> bool:
    """Whether every number held against the reference is within its
    limit."""
    return all(j["ok"] for k, j in judged.items() if k not in TRUTH)


def run(cell: str, seed: int = SEED, trace: bool = False, **kw):
    """run_cell on the CPU at the tiny size, a window of one
    reconstruction or block."""
    return harness.run_cell(ROOT, cell, seed, 0.0, trace, CPU,
                            time.perf_counter(), config=config(cell), **kw)


def recon_window(cell: str, seed: int = SEED):
    """A recon cell's window of one reconstruction at the tiny size, with
    no warm-up, for tests of its comparison: (the loop's check, the Run,
    the case, the window's (result, batch) pairs)."""
    w = harness.cell_of(MANIFEST, cell)
    traffic = dict(harness.traffic_of(w["traffic"]), warmup=None)
    drv = harness.driver(traffic["loop"])
    run = loops.Run(config=config(cell), traffic=traffic, seed=seed,
                    seconds=0.0, trace=False, device=CPU,
                    t_start=time.perf_counter(),
                    compare=tuple(harness.limits_of(cell)))
    check, seen = drv.check, {}
    drv.check = lambda run, case, done: (
        seen.update(case=case, done=list(done)) or (None, {}, None))
    drv.run(run)
    return check, run, seen["case"], seen["done"]
