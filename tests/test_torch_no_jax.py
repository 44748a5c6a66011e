"""The port never needs JAX or the JAX package, and its smoke run refuses
a machine without a GPU.  Both run in subprocesses so that the test
process's own imports cannot hide a dependency; an AST scan of the port's
sources catches an import on a path that no test drives."""
import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None   # any `import jax` now raises ImportError
sys.modules["fetalreconstruction_tpu"] = None   # and so does the JAX package
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
from fetalreconstruction_tpu_torch.cli import evaluate_main, recon_eval_main
from fetalreconstruction_tpu_torch.ops.psf import psf_gather, psf_scatter
build_parser().parse_args(["-i", "a.nii.gz"])
assert sys.modules["jax"] is None
assert sys.modules["fetalreconstruction_tpu"] is None
assert not [m for m in sys.modules if m.startswith("fetalreconstruction_tpu.")]
print(len(names))
"""


def _run(args, **kw):
    return subprocess.run([sys.executable, *args], cwd=ROOT,
                          capture_output=True, text=True, timeout=300, **kw)


def test_port_and_smoke_import_without_jax():
    res = _run(["-c", _IMPORT_ALL])
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 52  # every module of the port


def _imported_roots(path: Path):
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.add(node.module)
    return {m.split(".")[0] for m in mods}


def test_port_sources_never_name_jax_or_its_package():
    """Every import statement in the port, lazy ones included."""
    files = sorted((ROOT / "fetalreconstruction_tpu_torch").rglob("*.py"))
    assert len(files) >= 50
    bad = {str(f.relative_to(ROOT)): r for f in files
           if (r := _imported_roots(f)
               & {"jax", "jaxlib", "fetalreconstruction_tpu"})}
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    """The smoke run imports the port, and nothing of JAX or the JAX
    package."""
    roots = _imported_roots(ROOT / "chip_smoke.py")
    assert "fetalreconstruction_tpu_torch" in roots
    assert not roots & {"jax", "jaxlib", "fetalreconstruction_tpu"}, roots


def test_chip_smoke_fails_without_cuda():
    # hide any card, so the claim is tested on every machine
    res = _run(["chip_smoke.py"],
               env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
