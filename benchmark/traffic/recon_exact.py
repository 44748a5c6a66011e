"""The loop `recon_exact`: the loop `recon` (benchmark/traffic/recon.py:
whole reconstructions back to back, one at a time, the same window, the
same end-to-end metrics and the same numbers compared) for a
configuration on the exact PSF engine, held against the exact engine's
plain reference (`reference/exact_engine.py`) in place of the fast
engine's.

It runs recon.py's own functions, in a copy of that module whose
reference and device span it replaces:

- the reference's last stage, its bands and its TF32 control are
  exact_engine's, at the support that the configuration's run states
  (`quality_factor`, `max_psf_support`): the control rounds every PSF
  weight and every payload or volume value to TF32 at each pixel-offset
  pair;
- the traced reconstruction synchronises the device at both ends of each
  of the program's three exact transfers (`ops.psf.psf_sums`,
  `psf_scatter`, `psf_gather`) and stamps them on the host's clock, the
  clock of the profiler's device events, so that the device time of the
  operations each launched can be read (records["trace"]["psf"]); a
  record_function range would not do: under the benchmark's CUDA-only
  profiler it leaves no event.  The window's reconstructions run
  untouched;
- besides recon's faults, `coarse_offsets`: each of the three transfers
  is given only the offsets that `ops.psf.prune_offsets` keeps at eps
  1e-2 for its slices, in place of the whole support.

Traffic parameters: recon's (`warmup`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib.util
import time
import types
from pathlib import Path

import numpy as np

from benchmark import loops
from benchmark.reference import exact_engine
from benchmark.trace import DeviceSpan

COARSE_EPS = 1e-2  # the offsets a coarse support keeps: weight >= this
# the program's exact transfers: stamped in the traced reconstruction, and
# given a coarse support by `coarse_offsets`
TRANSFERS = ("ops.psf.psf_sums", "ops.psf.psf_scatter", "ops.psf.psf_gather")


def _recon_loop():
    """benchmark/traffic/recon.py as a module of this loop's own."""
    spec = importlib.util.spec_from_file_location(
        "benchmark_loop_recon_of_recon_exact",
        Path(__file__).with_name("recon.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TransferSpan(DeviceSpan):
    """A DeviceSpan in which each exact transfer is synchronised at both
    ends and stamped; its summary adds `psf`: the transfers' count, their
    host seconds, and the device seconds and count of the device
    operations that started inside them."""

    def __enter__(self):
        self.ranges = []
        self._patches = contextlib.ExitStack()
        for path in TRANSFERS:
            self._patches.enter_context(loops.patched(path, self._stamped))
        return super().__enter__()

    def __exit__(self, *exc):
        self._patches.close()
        return super().__exit__(*exc)

    def _stamped(self, orig):
        def f(*a, **k):
            loops.sync(self.device)
            t0 = time.time_ns()
            out = orig(*a, **k)
            loops.sync(self.device)
            self.ranges.append((t0, time.time_ns()))
            return out
        return f

    def summary(self, marks=None):
        s = super().summary(marks)
        if s is None:
            return None
        lo = np.array([r[0] for r in self.ranges], np.int64)
        hi = np.array([r[1] for r in self.ranges], np.int64)
        start = np.array([e[1] for e in self.events], np.int64)
        dur = np.array([e[2] for e in self.events], np.int64)
        k = np.searchsorted(lo, start, side="right") - 1
        inside = (k >= 0) & (start < hi[np.maximum(k, 0)]) if len(lo) else \
            np.zeros(len(start), bool)
        s["psf"] = dict(calls=len(self.ranges),
                        host_s=float((hi - lo).sum()) / 1e9,
                        device_s=float(dur[inside].sum()) / 1e9,
                        events=int(inside.sum()))
        return s


def _coarse_offsets(orig):
    """A transfer given the offsets that prune_offsets keeps at
    COARSE_EPS for its slices."""
    prune = loops.program("ops.psf.prune_offsets")

    def f(geom, offsets, *a, **k):
        kept = prune(np.asarray(offsets), geom.a3.cpu().numpy(),
                     geom.slice_dim.cpu().numpy(), eps=COARSE_EPS)
        return orig(geom, kept, *a, **k)
    return f


def reference(cfg_run: dict):
    """exact_engine at the support of the configuration's run."""
    return types.SimpleNamespace(
        CUT_BAND=exact_engine.CUT_BAND, SUME_BAND=exact_engine.SUME_BAND,
        last_stage=functools.partial(
            exact_engine.last_stage, quality=cfg_run["quality_factor"],
            max_support=cfg_run["max_psf_support"]))


def run(r: loops.Run) -> loops.Outcome:
    """recon's run against the exact reference; `coarse_offsets`, a
    fault of three transfers, is planted here (recon plants one patch a
    fault)."""
    _loop.ref = reference(r.config["run"])
    with contextlib.ExitStack() as coarse:
        if "coarse_offsets" in r.faults:
            for path in TRANSFERS:
                coarse.enter_context(loops.patched(path, _coarse_offsets))
            r = dataclasses.replace(r, faults=tuple(
                f for f in r.faults if f != "coarse_offsets"))
        return _loop.run(r)


_loop = _recon_loop()
_loop.DeviceSpan = TransferSpan
