"""The result line's keys, and the plain reference against the port at a
tiny size on the CPU."""
import json

import pytest

import tiny

RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def srloop_runs():
    return {t: tiny.run("svr-4stack-1mm.srloop", trace=t)
            for t in (False, True)}


def test_last_line_keys(srloop_runs):
    for trace, (result, judged, _) in srloop_runs.items():
        keys = list(result)
        assert keys[:5] == RESULT_KEYS and keys[-1] == "checks"
        assert set(keys) <= set(RESULT_KEYS + ["breakdown", "checks"])
        assert set(result["device"]) >= {"platform", "kind", "count",
                                         "memory_peak_bytes"}
        for name, c in result["checks"].items():
            assert set(c) == {"value", "limit"} and name in judged
        json.loads(json.dumps(result))


def test_end_to_end_metrics_untraced(srloop_runs):
    result = srloop_runs[False][0]
    assert set(result["metrics"]) == {"setup_s", "sr_iter_ms",
                                      "peak_mem_gib"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"}


def test_no_device_metric_off_the_card(srloop_runs):
    """A CPU run reads no trace: the device metrics stay out of the line."""
    result = srloop_runs[True][0]
    assert "splat_roofline" not in result["metrics"]
    assert "busy_s" not in result["device"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_reference_agrees_with_the_port(cell):
    _, judged, out = tiny.run(cell)
    assert out.failed == 0 and out.attempted >= 1
    assert tiny.reference_numbers_ok(judged), judged
    for name in tiny.TRUTH:
        if name in out.checks:
            assert -100 < out.checks[name] < 100
