"""The program's spans and counters (utils/tracing.annotate,
utils/perfstats.count), filed in run_svr's PerfStats, on the CPU.

test_torch_svr_pipeline's phantom (svr_parity's problem) through run_svr
with the stepped "coord" registration, and through run_pvr with 10 / 5
patches; each is run three times: with the cost functions and sweeps
counted by wrappers, with every span and counter patched to a no-op, and
under `tracing.trace`.  They check that

- the phases' rows keep their names and order, and the span and count
  rows sit under them, one entry per occurrence of the phase;
- the count rows equal the calls that the wrappers counted;
- the outputs are bitwise equal with the spans on and patched away;
- no torch.profiler range opens outside `tracing.trace`, and inside it
  the Chrome trace holds the spans' ranges;
- a span or counter outside any recording PerfStats records nothing.
"""
import contextlib
import dataclasses
import json
import sys

import numpy as np
import pytest

import torch

from fetalreconstruction_tpu_torch.pipeline import pvr, svr
from fetalreconstruction_tpu_torch.register import slice2vol, volume
from fetalreconstruction_tpu_torch.utils import perfstats, tracing
from fetalreconstruction_tpu_torch.utils.convert import (config_from,
                                                         image_from)
from fetalreconstruction_tpu_torch.utils.perfstats import PerfStats

from svr_parity import make_problem, svr_cfg
from torch_threads import one_torch_thread  # noqa: F401

KINDS = ["svr", "pvr"]
# run_svr's phase rows, in order, as they were before the spans
PHASES = ["load", "template+mask", "stack registration",
          "intensity matching", "create slices", "device setup",
          "gaussian reconstruction", "simulate+estep",
          "superresolution loop", "iteration tail", "registration prep",
          "registration", "restore+scale"]
SPAN_ROWS = {
    "svr": ["stack registration/pyramid", "stack registration/cost eval",
            "registration/cost eval", "registration/generate",
            "registration/blur", "registration/similarity",
            "registration/wait"],
}
SPAN_ROWS["pvr"] = SPAN_ROWS["svr"] + ["create slices/patch extraction"]
# count row: what the wrappers count
COUNTED = {"registration/cost eval #": "s2v cost",
           "registration/rows evaluated #": "s2v rows",
           "registration/sweep #": "s2v sweep",
           "stack registration/cost eval #": "vol cost",
           "stack registration/sweep #": "vol sweep"}


def _config(kind, **kw):
    cfg = config_from(svr_cfg(**dict(dict(reg_optimizer="coord",
                                          reg_levels=2, reg_iterations=2),
                                     **kw)))
    if kind == "svr":
        return cfg
    return pvr.PVRConfig(**dict(dataclasses.asdict(cfg), patch_size=10,
                                patch_stride=5))


def _run(kind, stacks, mask, **kw):
    entry = svr.run_svr if kind == "svr" else pvr.run_pvr
    return entry(_config(kind, **kw), stacks=stacks, mask=mask, device="cpu")


@contextlib.contextmanager
def _counted(calls):
    """Count the registration cost calls, their rows and the sweeps."""
    def bump(key, n=1):
        calls[key] = calls.get(key, 0) + n

    make_cost_fn, vol_cost = slice2vol.make_cost_fn, volume._vol_cost
    sweeps = {m: m.coord_sweep for m in (slice2vol, volume)}

    def counted_make_cost_fn(*a, **k):
        cost = make_cost_fn(*a, **k)

        def f(params):
            bump("s2v cost")
            bump("s2v rows", params.shape[0])
            return cost(params)
        return f

    def counted_vol_cost(*a, **k):
        bump("vol cost")
        return vol_cost(*a, **k)

    def counted_sweep(tag, sweep):
        def f(*a, **k):
            bump(tag)
            return sweep(*a, **k)
        return f

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(slice2vol, "make_cost_fn", counted_make_cost_fn)
        mp.setattr(volume, "_vol_cost", counted_vol_cost)
        mp.setattr(slice2vol, "coord_sweep",
                   counted_sweep("s2v sweep", sweeps[slice2vol]))
        mp.setattr(volume, "coord_sweep",
                   counted_sweep("vol sweep", sweeps[volume]))
        yield


@contextlib.contextmanager
def _no_spans():
    """Every span and counter of the program patched to a no-op."""
    annotate, count = tracing.annotate, perfstats.count
    with pytest.MonkeyPatch.context() as mp:
        for name, mod in list(sys.modules.items()):
            if not name.startswith("fetalreconstruction_tpu_torch."):
                continue
            if getattr(mod, "annotate", None) is annotate:
                mp.setattr(mod, "annotate",
                           lambda name: contextlib.nullcontext())
            if getattr(mod, "count", None) is count:
                mp.setattr(mod, "count", lambda name, n=1: None)
        yield


@pytest.fixture(scope="module")
def problem():
    _, stacks, mask = make_problem()
    return [image_from(s) for s in stacks], image_from(mask)


@pytest.fixture(scope="module")
def runs(problem, tmp_path_factory):
    """Each kind's three runs, lazily."""
    stacks, mask = problem
    cache = {}

    def get(kind):
        if kind in cache:
            return cache[kind]
        calls, ranges = {}, []
        record_function = torch.profiler.record_function

        def opened(name, *a, **k):
            ranges.append(name)
            return record_function(name, *a, **k)

        with _counted(calls), pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.profiler, "record_function", opened)
            on = _run(kind, stacks, mask)
        with _no_spans():
            off = _run(kind, stacks, mask)
        # the trace holds every op on the CPU: one stack (no stack
        # registration) and one registration sweep a step keep it small
        logdir = tmp_path_factory.mktemp(f"trace_{kind}")
        with tracing.trace(str(logdir)):
            traced = _run(kind, stacks[:1], mask, reg_levels=1,
                          reg_iterations=1, rec_iterations_first=1,
                          rec_iterations_last=1)
        with open(logdir / "trace_rank0.json") as f:
            names = {e.get("name") for e in json.load(f)["traceEvents"]}
        cache[kind] = dict(on=on, off=off, traced=traced, calls=calls,
                           ranges=ranges, names=names)
        return cache[kind]

    return get


def _phase_rows(stats):
    return [r for r in stats._samples if "/" not in r]


@pytest.mark.parametrize("kind", KINDS)
def test_phase_rows_keep_their_names_and_order(runs, kind):
    r = runs(kind)
    for res in (r["on"], r["off"], r["traced"]):
        assert _phase_rows(res.stats) == PHASES
    assert list(r["off"].stats._samples) == PHASES


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("row", list(COUNTED))
def test_count_rows_equal_the_calls(runs, kind, row):
    r = runs(kind)
    got = r["on"].stats.samples(row)
    assert got and all(isinstance(v, int) for v in got)
    assert sum(got) == r["calls"][COUNTED[row]] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_span_rows_one_entry_per_phase_occurrence(runs, kind):
    stats = runs(kind)["on"].stats
    nested = [r for r in stats._samples if "/" in r]
    assert set(SPAN_ROWS[kind]) | set(COUNTED) == set(nested)
    for row in nested:
        phase = row.split("/")[0]
        assert len(stats.samples(row)) == len(stats.samples(phase))
        if row in COUNTED:
            continue
        for span, whole in zip(stats.samples(row), stats.samples(phase)):
            assert 0.0 < span <= whole, row
    reg = stats.samples("registration")
    assert sum(stats.samples("registration/generate")) < sum(reg)
    assert sum(stats.samples("registration/cost eval")) < sum(reg)


@pytest.mark.parametrize("kind", KINDS)
def test_outputs_bitwise_equal_without_spans(runs, kind):
    r = runs(kind)
    on, off = r["on"], r["off"]
    np.testing.assert_array_equal(on.reconstructed.data,
                                  off.reconstructed.data)
    np.testing.assert_array_equal(on.transforms, off.transforms)
    np.testing.assert_array_equal(on.slice_weights, off.slice_weights)


@pytest.mark.parametrize("kind", KINDS)
def test_ranges_only_inside_trace(runs, kind):
    r = runs(kind)
    assert r["ranges"] == []
    want = {"cost eval", "generate", "blur", "similarity", "wait"}
    if kind == "pvr":
        want.add("patch extraction")
    assert want <= r["names"]
    stats = r["traced"].stats
    assert stats.samples("registration/cost eval #") == [52]


def test_spans_and_counters_outside_a_recording_record_nothing():
    stats = PerfStats()
    assert perfstats.current() is None
    with tracing.annotate("outside"):
        perfstats.count("outside")
    stats.sample("a")
    with stats.recording():
        with tracing.annotate("inside"):
            perfstats.count("inside", 3)
    with tracing.annotate("after"):
        perfstats.count("after")
    stats.sample("a")
    assert list(stats._samples) == ["a", "a/inside", "a/inside #"]
    assert stats.samples("a/inside #") == [0, 3]
    assert stats.samples("a/inside")[0] == 0.0 < stats.samples(
        "a/inside")[1]
    rows = stats.table().splitlines()
    assert [r.split()[0] for r in rows[1:]] == ["a", "inside", "inside",
                                                "TOTAL"]
    assert rows[3].startswith("  inside #") and rows[3].split()[2] == "3"
