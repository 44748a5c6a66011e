"""BENCHMARK.json against the benchmark's contract, and every file that it
names found by name."""
import json
import re

import pytest

from benchmark import harness
from tiny import ROOT

MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in MAN["workloads"]]
METRICS = MAN["end_to_end"] + MAN["per_layer"]


def test_keys_and_sizes():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert MAN["command"][:3] == ["python3", "-m", "benchmark.run"]
    for p in MAN["paths"]:
        assert (ROOT / p).is_dir() and not p.endswith("_torch")


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_are_unique_and_well_formed(kind):
    names = [e["name"] for e in MAN[kind]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if metric in MAN["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0 < metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert "\n" not in metric["layer"] and metric["layer"]
    for c in metric.get("workloads", []):
        assert c in CELLS


@pytest.mark.parametrize("metric", MAN["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    moved = next(m for m in MAN["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric.get("workloads", CELLS):
        assert moved in harness.reported(MAN["end_to_end"], cell)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_and_finds_its_files(cell):
    e2e = [m["name"] for m in harness.reported(MAN["end_to_end"], cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.reported(MAN["per_layer"], cell)
    w = harness.cell_of(MAN, cell)
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert harness.config_of(MAN, ROOT, w["config"])["name"] == w["config"]
    assert harness.traffic_of(w["traffic"])["loop"]
    assert harness.limits_of(cell)
    for m in harness.reported(MAN["per_layer"], cell):
        assert callable(harness.reader(m["name"]))


def test_configs_state_their_reductions():
    for c in MAN["configs"]:
        data = json.loads((ROOT / c["file"]).read_text())
        assert sorted(data["reduced"]) == sorted(c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
