"""A new configuration, traffic mix, per-layer metric and cell take new
files and entries only: a throwaway set of each, in a directory of its
own, is found by name and run."""
import json
import shutil

from benchmark import harness
import tiny

READER = '''
def read(records):
    t = records.get("splat")
    return None if not t else t["slots"]
'''


def test_new_entries_are_found_by_name(tmp_path):
    base = tmp_path / "bench"
    for d in ("configs", "traffic", "limits", "metrics"):
        (base / d).mkdir(parents=True)
    cfg = tiny.config("svr-4stack-1mm.srloop")
    cfg["name"] = "svr-new"
    (base / "configs" / "svr-new.json").write_text(json.dumps(cfg))
    traffic = harness.traffic_of("srloop")
    traffic["block"] = 2
    (base / "traffic" / "short-blocks.json").write_text(json.dumps(traffic))
    shutil.copy(harness.HERE / "limits" / "svr-4stack-1mm.srloop.json",
                base / "limits" / "svr-new.short-blocks.json")
    (base / "metrics" / "splat_slots.py").write_text(READER)
    man = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    man["configs"].append(dict(name="svr-new", source="x",
                               file="bench/configs/svr-new.json", reduced=[],
                               why="x"))
    man["workloads"].append(dict(name="svr-new.short-blocks",
                                 config="svr-new", traffic="short-blocks",
                                 chips=1, why="x"))
    man["per_layer"] = [dict(name="splat_slots", unit="slots",
                             better="higher", source="program_counter",
                             layer="splat kernel", moves="sr_iter_ms")]
    for m in man["end_to_end"]:
        if "workloads" in m and "svr-4stack-1mm.srloop" in m["workloads"]:
            m["workloads"].append("svr-new.short-blocks")
    result, _, out = harness.run_cell(tmp_path, "svr-new.short-blocks", 5,
                                      0.0, True, tiny.CPU, 0.0,
                                      manifest=man, base=base)
    assert out.attempted == 1
    assert result["metrics"]["splat_slots"]["unit"] == "slots"
    assert result["metrics"]["splat_slots"]["value"] > 0


DRIVER = '''
from benchmark.loops import Outcome


def run(run):
    n = int(run.traffic["units"])
    return Outcome(dict(setup_s=0.5, sr_iter_ms=2.0, peak_mem_gib=0.0),
                   dict(units=n), dict(echo_gap=0.0), n, 0, 0)


FAULTS = {}
'''


def test_new_loop_is_found_by_name(tmp_path):
    """A traffic mix that names a loop of its own brings its driver as a
    file beside it: benchmark/traffic/<loop>.py."""
    base = tmp_path / "bench"
    for d in ("traffic", "limits"):
        (base / d).mkdir(parents=True)
    (base / "traffic" / "echo.py").write_text(DRIVER)
    (base / "traffic" / "echo-mix.json").write_text(
        json.dumps(dict(loop="echo", units=3)))
    (base / "limits" / "svr-4stack-1mm.echo-mix.json").write_text(
        json.dumps(dict(echo_gap=dict(max=0.0))))
    man = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    man["workloads"].append(dict(name="svr-4stack-1mm.echo-mix",
                                 config="svr-4stack-1mm", traffic="echo-mix",
                                 chips=1, why="x"))
    for m in man["end_to_end"]:
        if "workloads" in m and "svr-4stack-1mm.srloop" in m["workloads"]:
            m["workloads"].append("svr-4stack-1mm.echo-mix")
    result, judged, out = harness.run_cell(
        tiny.ROOT, "svr-4stack-1mm.echo-mix", 5, 0.0, False, tiny.CPU, 0.0,
        manifest=man, base=base)
    assert out.attempted == 3 and result["correct"] is True
    assert result["metrics"]["sr_iter_ms"]["value"] == 2.0
    assert judged["echo_gap"]["ok"]
