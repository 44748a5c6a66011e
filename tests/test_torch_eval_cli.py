"""The port's evaluation CLIs (`fetalrecon-evaluate-torch`,
`fetalrecon-recon-eval-torch`) against the JAX package's, mirroring
test_eval_slic_checkpoint.py's CLI tests: each package runs in its own
working directory on the same files, and their written volumes, .dof and
printed metric rows agree to 1e-4 relative."""
import contextlib
import io
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from fetalreconstruction_tpu.cli import evaluate_main as jeval
from fetalreconstruction_tpu.cli import recon_eval_main as jre
from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.io.dof import read_dof
from fetalreconstruction_tpu.io.nifti import read_nifti, write_nifti
from fetalreconstruction_tpu.ops.sampling import resample_to_grid
from fetalreconstruction_tpu_torch.cli import evaluate_main, recon_eval_main

from phantom import make_ground_truth
from torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-4


def _run(main, argv, cwd):
    buf = io.StringIO()
    here = os.getcwd()
    os.chdir(cwd)
    try:
        with contextlib.redirect_stdout(buf):
            assert main(argv) == 0
    finally:
        os.chdir(here)
    return buf.getvalue()


def _rows(text):
    """{name: value} of the printed 'NAME: value' metric rows."""
    out = {}
    for line in text.splitlines():
        k, sep, v = line.partition(": ")
        if sep and k.isupper():
            out[k] = float(v)
    return out


def _close_dicts(a, b):
    assert a.keys() == b.keys() and a
    for k in a:
        assert abs(a[k] - b[k]) <= TOL * max(abs(b[k]), 1.0), (k, a[k], b[k])


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """test_evaluate_border_flag's gt and noisy copy, as files."""
    d = tmp_path_factory.mktemp("eval")
    gt = make_ground_truth(n=16, spacing=2.0)
    noisy = Image(gt.data + np.random.default_rng(0).normal(
        0, 5, gt.data.shape).astype(np.float32), gt.attr.copy())
    write_nifti(gt, str(d / "t.nii"))
    write_nifti(noisy, str(d / "s.nii"))
    return d, gt


@pytest.mark.parametrize("flags", [[], ["--border", "3"]])
def test_evaluate_matches_jax(pair, flags, tmp_path):
    d, _ = pair
    argv = [str(d / "t.nii"), str(d / "s.nii"), "--json", *flags]
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    ref = json.loads(_run(jeval.main, argv, tmp_path / "j"))
    out = json.loads(_run(evaluate_main.main, argv + ["--useCPU"],
                          tmp_path / "t"))
    _close_dicts(out, ref)
    rows = argv[:2] + flags  # the printed row, without --json
    _close_dicts(_rows(_run(evaluate_main.main, rows + ["--useCPU"],
                            tmp_path / "t")),
                 _rows(_run(jeval.main, rows, tmp_path / "j")))


def test_evaluate_refuses_without_a_card(monkeypatch, pair):
    """Without --useCPU the metric battery samples on a CUDA device: no
    fallback."""
    import torch
    d, _ = pair
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate_main.main([str(d / "t.nii"), str(d / "s.nii")])


def test_volume_wo_border_matches_jax(pair, tmp_path):
    d, gt = pair
    src = tmp_path / "in"
    src.mkdir()
    write_nifti(gt, str(src / "vol1.nii.gz"))
    for sub in ("j", "t"):
        (tmp_path / sub).mkdir()
    argv = ["--volume-wo-border", str(src)]
    assert _run(jeval.main, argv, tmp_path / "j") == \
        _run(evaluate_main.main, argv, tmp_path / "t")
    assert (tmp_path / "j" / "volumeMeasures.txt").read_text() == \
        (tmp_path / "t" / "volumeMeasures.txt").read_text()
    a = read_nifti(str(tmp_path / "j" / "c_vol1.nii.gz"))
    b = read_nifti(str(tmp_path / "t" / "c_vol1.nii.gz"))
    np.testing.assert_array_equal(b.data, a.data)
    assert np.allclose(b.attr.i2w(), a.attr.i2w())


@pytest.fixture(scope="module")
def recon_eval(tmp_path_factory):
    """test_recon_eval_harness's problem: gt against a shifted copy; each
    package runs the harness in its own directory."""
    d = tmp_path_factory.mktemp("recon_eval")
    gt = make_ground_truth(n=24, spacing=2.0)
    t_true = rigid_matrix([1.0, -0.5, 0.5, 0, 0, 0])
    moved = np.asarray(resample_to_grid(
        jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i() @ t_true,
                                          jnp.float32),
        gt.attr.shape_zyx, jnp.asarray(gt.attr.i2w(), jnp.float32),
        interp="linear", padding=0.0))
    write_nifti(gt, str(d / "t.nii"))
    write_nifti(Image(moved.astype(np.float32), gt.attr.copy()),
                str(d / "s.nii"))
    argv = [str(d / "t.nii"), str(d / "s.nii"), "out.nii", "diff.nii",
            "mask.nii", "ref.dof.gz"]
    for sub in ("j", "t"):
        (d / sub).mkdir()
    ref = _run(jre.main, argv, d / "j")
    out = _run(recon_eval_main.main, argv + ["--useCPU"], d / "t")
    return d, ref, out


def test_recon_eval_metrics_match_jax(recon_eval):
    _, ref, out = recon_eval
    assert "Crop Image ... done" in out and "PSNR:" in out
    _close_dicts(_rows(out), _rows(ref))


@pytest.mark.parametrize("name", ["out.nii", "diff.nii", "mask.nii"])
def test_recon_eval_volumes_match_jax(recon_eval, name):
    d, _, _ = recon_eval
    a = read_nifti(str(d / "j" / name))
    b = read_nifti(str(d / "t" / name))
    assert np.allclose(b.attr.i2w(), a.attr.i2w())
    np.testing.assert_array_equal(b.data, a.data)


def test_recon_eval_transform_matches_jax(recon_eval):
    d, _, _ = recon_eval
    a = read_dof(str(d / "j" / "ref.dof.gz"))
    b = read_dof(str(d / "t" / "ref.dof.gz"))
    assert b.shape == (4, 4)
    np.testing.assert_allclose(b, a, atol=TOL)


def test_recon_eval_refuses_without_a_card(monkeypatch, recon_eval):
    """Without --useCPU the harness needs a CUDA device: no fallback."""
    import torch
    d, _, _ = recon_eval
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        recon_eval_main.main([str(d / "t.nii"), str(d / "s.nii"), "o", "d",
                              "m", "x.dof"])
