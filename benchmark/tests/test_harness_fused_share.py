"""The reader of registration_fused_share: its value on hand-built
PerfStats rows, None on the rows of a program without the fused counter,
and no line for it in a traced recon run on the CPU, where the fused
kernel does not run."""
import pytest

import tiny
from benchmark import harness

METRIC = "registration_fused_share"
# two reconstructions' rows, as benchmark/traffic/recon.py keeps them
FUSED = [
    {"registration": [3.0, 5.0], "registration/cost eval #": [300, 500],
     "registration/fused cost eval #": [300, 500]},
    {"registration": [4.0], "registration/cost eval #": [400],
     "registration/fused cost eval #": [100]},
]
# the same without the fused row, and with no cost eval at all
TORCH_PATH = [{k: v for k, v in p.items() if "fused" not in k}
              for p in FUSED]
NO_EVALS = [{"registration": [1.0]}]


def test_reader_on_fused_rows():
    read = harness.reader(METRIC)
    got = read({"phases": FUSED, "counters": {}})
    assert got == pytest.approx(900 / 1200, rel=1e-12)
    assert read({"phases": FUSED[:1], "counters": {}}) == 1.0
    # a reconstruction without the row counts as no fused evals
    mixed = [FUSED[0], TORCH_PATH[1]]
    assert read({"phases": mixed}) == pytest.approx(800 / 1200, rel=1e-12)


@pytest.mark.parametrize("phases", [TORCH_PATH, NO_EVALS, []])
def test_reader_without_the_row_is_none(phases):
    read = harness.reader(METRIC)
    assert read({"phases": phases, "counters": {}}) is None
    assert read({}) is None


def test_traced_recon_on_the_cpu_leaves_it_out():
    result = tiny.run("svr-4stack-1mm.recon", trace=True)[0]
    assert "registration_ms_per_cost_eval" in result["metrics"]
    assert METRIC not in result["metrics"]
