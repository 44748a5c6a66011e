"""The port never needs JAX, and its smoke run refuses a machine without
a GPU.  Both run in subprocesses so that the test process's own JAX import
cannot hide a dependency."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
import fetalreconstruction_tpu_torch as pkg
names = [m.name for m in
         pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from fetalreconstruction_tpu_torch.cli.svr_main import main
from fetalreconstruction_tpu_torch.cli.pvr_main import main, build_parser
from fetalreconstruction_tpu_torch.pipeline.svr import run_svr
from fetalreconstruction_tpu_torch.pipeline.pvr import PVRConfig, run_pvr
from fetalreconstruction_tpu_torch.em.bias import bias_step
from fetalreconstruction_tpu_torch.evaluation import metrics, pvr_eval
build_parser().parse_args(["-i", "a.nii.gz"])
assert sys.modules["jax"] is None
print(len(names))
"""


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_and_smoke_import_without_jax():
    res = _run(["-c", _IMPORT_ALL])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 34  # every module of the port


def test_chip_smoke_imports_only_the_port():
    """The smoke run reaches the JAX package's numpy host modules only
    through the port, never by importing them itself."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert "fetalreconstruction_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "fetalreconstruction_tpu"}, mods


def test_chip_smoke_fails_without_cuda():
    # hide any card, so the claim is tested on every machine
    res = _run(["chip_smoke.py"],
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
