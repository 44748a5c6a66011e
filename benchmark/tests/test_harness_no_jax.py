"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names; the reference imports neither package."""
import ast
import json
import os
import shutil
import subprocess
import sys
import types

from benchmark import harness
import tiny

BENCH = tiny.ROOT / "benchmark"
JAX_NAMES = {"jax", "jaxlib", "flax", "fetalreconstruction_tpu"}


def imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    for path in BENCH.rglob("*.py"):
        assert not imported_top_names(path) & JAX_NAMES, path


def test_reference_imports_neither_package():
    for path in (BENCH / "reference").rglob("*.py"):
        text = path.read_text()
        assert not imported_top_names(path) & (
            JAX_NAMES | {"fetalreconstruction_tpu_torch"}), path
        assert "fetalreconstruction" not in text, path


def test_whole_name_comparison(monkeypatch):
    monkeypatch.setitem(sys.modules, "fetalreconstruction_tpu_torch_x",
                        types.ModuleType("fetalreconstruction_tpu_torch_x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    code = ("import sys, json; sys.path[:0] = [%r, %r]; import tiny; "
            "tiny.run('svr-4stack-1mm.srloop'); "
            "from benchmark import harness; "
            "print(json.dumps(harness.forbidden_modules()))"
            % (str(tiny.ROOT), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=tiny.ROOT, timeout=600,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def run_cli(cwd):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "svr-4stack-1mm.srloop", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, cwd=cwd,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_no_card_no_result():
    out = run_cli(tiny.ROOT)
    assert out.returncode != 0
    assert not any(line.startswith("{") for line in out.stdout.splitlines())


def test_benchmark_alone_is_refused(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program, no
    result."""
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    for p in json.loads((tiny.ROOT / "BENCHMARK.json").read_text())["paths"]:
        shutil.copytree(tiny.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = run_cli(tmp_path)
    assert out.returncode != 0 and "{" not in out.stdout
