"""The port's run_svr end to end vs the JAX package, and its CLI.

svr_parity's problem and config (test_svr_pipeline's phantom, two noisy
stacks, the second rigidly moved; 2 outer iterations, one registration
level) through both packages' run_svr on the CPU, held at svr_parity's
limits.  The port's own features (the reference-volume seed, checkpoint /
resume, the evaluation log, the refused options and machines) and
`svr-reconstruct-torch --useCPU` on NIfTI stacks run on the port alone;
test_torch_svr_options*.py hold the options against JAX.  Bias
correction and the patch modes are held against JAX in test_torch_bias.py
and test_torch_pvr.py.
"""
import os

import numpy as np
import pytest

import torch

from fetalreconstruction_tpu.core.geometry import (matrix_to_params,
                                                   rigid_matrix)
from fetalreconstruction_tpu.io.nifti import read_nifti, write_nifti
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu_torch.cli import svr_main
from fetalreconstruction_tpu_torch.parallel import sharded
from fetalreconstruction_tpu_torch.pipeline import svr

from svr_parity import (make_problem, PARAM_TOL, psnr_vs_truth as _psnr,
                        PSNR_TOL, REC_TOL, svr_cfg as _cfg)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return make_problem()


@pytest.fixture(scope="module")
def both(data):
    gt, stacks, mask_img = data
    ref = jsvr.run_svr(_cfg(), stacks=stacks, mask=mask_img)
    out = svr.run_svr(_cfg(), stacks=stacks, mask=mask_img, device="cpu")
    return ref, out


def test_reconstruction_matches_jax(both):
    ref, out = both
    a, b = out.reconstructed, ref.reconstructed
    assert a.attr == b.attr and a.data.shape == b.data.shape
    assert np.isfinite(a.data).all()
    err = np.abs(a.data - b.data).max() / np.abs(b.data).max()
    assert err <= REC_TOL, err


def test_transforms_match_jax(both):
    ref, out = both
    assert out.transforms.shape == ref.transforms.shape
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(out.transforms, ref.transforms))
    assert d <= PARAM_TOL, d


def test_psnr_matches_jax(data, both):
    gt = data[0]
    ref, out = both
    p_out, p_ref = _psnr(gt, out.reconstructed), _psnr(gt, ref.reconstructed)
    assert abs(p_out - p_ref) <= PSNR_TOL, (p_out, p_ref)
    assert p_out > 14.0  # test_svr_pipeline's own bar


def test_em_outputs_match_jax(both):
    ref, out = both
    np.testing.assert_allclose(out.stack_factors, ref.stack_factors,
                               rtol=1e-6)
    np.testing.assert_allclose(out.slice_weights, ref.slice_weights,
                               atol=1e-3)
    assert out.excluded_slices == ref.excluded_slices
    np.testing.assert_array_equal(out.slice_inside, ref.slice_inside)
    assert out.inclusion_report() == ref.inclusion_report()


def test_dataclass_fields_match_jax():
    import dataclasses as dc
    assert [f.name for f in dc.fields(svr.SVRResult)] == \
        [f.name for f in dc.fields(jsvr.SVRResult)]


def test_host_helpers_match_jax(data):
    """Mask prep, crop, template and intensity matching on the problem."""
    gt, stacks, mask_img = data
    t = rigid_matrix([1.0, -1.0, 0.5, 2.0, 0.0, -1.0])
    a = svr.transform_mask(stacks[1], mask_img, t, device="cpu")
    b = jsvr.transform_mask(stacks[1], mask_img, t)
    np.testing.assert_array_equal(a.data, b.data)
    ra = svr.create_template(svr.crop_image(stacks[0], a), 1.5)
    assert ra == jsvr.create_template(jsvr.crop_image(stacks[0], b), 1.5)
    ma = svr.set_mask(mask_img, ra, 2.0, device="cpu")
    mb = jsvr.set_mask(mask_img, ra, 2.0)
    np.testing.assert_array_equal(ma.data, mb.data)
    ov = svr.create_mask_from_overlap(stacks)
    np.testing.assert_array_equal(ov.data,
                                  jsvr.create_mask_from_overlap(stacks).data)
    s1 = [s.copy() for s in stacks]
    s2 = [s.copy() for s in stacks]
    tr = np.tile(np.eye(4), (2, 1, 1))
    fa = svr.match_stack_intensities(s1, tr, ma, 700.0)
    fb = jsvr.match_stack_intensities(s2, tr, mb, 700.0)
    np.testing.assert_array_equal(fa, fb)


def test_reference_seed_checkpoint_and_log(data, tmp_path):
    """A reference volume seeds the reconstruction (registration then runs
    at iteration 0); checkpoints are written each outer iteration and a
    resume continues from the last; the evaluation log lists each
    iteration's slices."""
    gt, stacks, mask_img = data
    ck = str(tmp_path / "ck")
    cfg = _cfg(checkpoint_dir=ck, no_log=False,
               log_prefix=str(tmp_path / "run_"))
    seen = []
    res = svr.run_svr(cfg, stacks=stacks, mask=mask_img,
                      reference_volume=gt, device="cpu",
                      iteration_hook=lambda it, img, t: seen.append(it))
    assert seen == [0, 1]
    assert "registration" in res.stats._samples
    assert len(res.stats._samples["registration"]) == 2  # iterations 0, 1
    assert sorted(os.listdir(ck)) == ["checkpoint_iter000.npz",
                                      "checkpoint_iter001.npz"]
    log = (tmp_path / "run_log-evaluation.txt").read_text()
    assert log.count("Iteration ") == 2 and "Included slices:" in log
    seen.clear()
    again = svr.run_svr(_cfg(checkpoint_dir=ck, resume=True), stacks=stacks,
                        mask=mask_img, device="cpu",
                        iteration_hook=lambda it, img, t: seen.append(it))
    assert seen == [1]  # the completed run redoes its last iteration
    assert np.isfinite(again.reconstructed.data).all()


_RANK = sharded.Mesh(None, 0, 2, torch.device("cpu"))


@pytest.mark.parametrize("kw,match", [
    # the z-slab modes run the fast engine alone, as in the JAX package,
    # and refuse --manualMask, on which the JAX package's slab modes fail
    pytest.param(dict(mode="volume", cfg=dict(engine="exact")),
                 "requires engine='fast'", id="volume-exact-engine"),
    pytest.param(dict(mode="grid", cfg=dict(manual_mask="m.nii.gz")),
                 "--manualMask", id="grid-manual-mask"),
])
def test_slab_modes_refuse_what_jax_cannot_run(data, kw, match):
    _, stacks, mask_img = data
    cfg = _cfg(**kw["cfg"])
    with pytest.raises(ValueError, match=match):
        svr.run_svr(cfg, stacks=stacks, mask=mask_img, device="cpu",
                    mesh=_RANK, mesh_mode=kw["mode"])


def _write_inputs(data, tmp_path):
    gt, stacks, mask_img = data
    paths = []
    for i, st in enumerate(stacks):
        paths.append(str(tmp_path / f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    write_nifti(mask_img, str(tmp_path / "mask.nii.gz"))
    return paths, str(tmp_path / "mask.nii.gz")


def test_cli_use_cpu(data, tmp_path):
    paths, mask = _write_inputs(data, tmp_path)
    out = str(tmp_path / "recon.nii.gz")
    rc = svr_main.main(["-o", out, "-i", *paths, "-m", mask, "--useCPU",
                        "--iterations", "2", "--resolution", "1.5",
                        "--smooth_mask", "2.0", "--rec_iterations_first",
                        "2", "--rec_iterations_last", "2", "--no_log",
                        "--log_prefix", str(tmp_path / "p_")])
    assert rc == 0
    img = read_nifti(out)
    assert img.data.ndim == 3 and np.isfinite(img.data).all()
    assert img.data.max() > 0
    assert any(f.startswith("p_performance_") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("flags,exc,match", [
    # the z-slab modes run, and need a card as every mode does
    pytest.param(["--mesh", "2", "--mesh-mode", "volume"], RuntimeError,
                 "no CUDA device", id="volume-needs-card"),
    pytest.param(["--distributed", "--mesh-mode", "grid"], RuntimeError,
                 "no CUDA device", id="distributed-grid-needs-card"),
    (["--trace", "t"], RuntimeError, "no CUDA device"),
    ([], RuntimeError, "no CUDA device"),
    (["--mesh", "2"], RuntimeError, "no CUDA device"),
    (["--distributed"], RuntimeError, "no CUDA device"),
])
def test_cli_refusals(monkeypatch, flags, exc, match):
    # the CLI never falls back to the CPU: without --useCPU it needs a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        svr_main.main(["-i", "missing.nii.gz", *flags])
