"""The readers of the program's span and counter rows: their values on
hand-built PerfStats rows, None on the rows of a program without spans,
and their lines in a traced run of each recon cell at the tiny size."""
import pytest

import tiny
from benchmark import harness

# two reconstructions' rows, as benchmark/traffic/recon.py keeps them
PHASES = [
    {"create slices": [0.5], "create slices/patch extraction": [0.4],
     "stack registration": [2.0], "stack registration/pyramid": [0.1],
     "stack registration/cost eval": [1.5],
     "stack registration/cost eval #": [400],
     "registration": [3.0, 5.0], "registration/generate": [1.0, 2.0],
     "registration/cost eval #": [300, 500]},
    {"create slices": [0.7], "create slices/patch extraction": [0.6],
     "stack registration": [4.0], "stack registration/cost eval #": [400],
     "registration": [4.0], "registration/generate": [1.5],
     "registration/cost eval #": [400]},
]
# the same reconstructions without the span and counter rows
PARENT = [{k: v for k, v in p.items() if "/" not in k} for p in PHASES]

EXPECTED = {
    "registration_cost_evals_per_round": (300 + 500 + 400) / 3,
    "registration_ms_per_cost_eval": 1e3 * 12.0 / 1200,
    "registration_generate_ms_per_eval": 1e3 * 4.5 / 1200,
    "stack_registration_ms_per_cost_eval": 1e3 * 6.0 / 800,
    "patch_extraction_s": 0.5,
}


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_on_span_rows(metric):
    got = harness.reader(metric)({"phases": PHASES, "counters": {}})
    assert got == pytest.approx(EXPECTED[metric], rel=1e-12)


@pytest.mark.parametrize("metric", list(EXPECTED))
def test_reader_on_parent_rows_is_none(metric):
    read = harness.reader(metric)
    assert read({"phases": PARENT, "counters": {}}) is None
    assert read({}) is None


@pytest.mark.parametrize("cell", tiny.RECON)
def test_traced_recon_reports_the_span_metrics(cell):
    """Each span metric that BENCHMARK.json lists for the cell reads above
    0, and no other has a line."""
    result = tiny.run(cell, trace=True)[0]
    listed = {m["name"] for m in harness.reported(
        tiny.MANIFEST["per_layer"], cell)}
    for m in EXPECTED:
        if m in listed:
            assert result["metrics"][m]["value"] > 0, m
        else:
            assert m not in result["metrics"], m
