"""The exact PSF engine, --manualMask and --bspline in the port vs the JAX
package, on the CPU.

- The reconstruction core with fast=None: one outer iteration of
  run_svr's body with 3 inner iterations on __graft_entry__._tiny_problem
  (a mask with a zero slab), plain and with bias + normalise-bias; 1e-4
  relative as in test_torch_svr_core.py.
- run_svr(engine="exact") with normalise-bias on a make_ground_truth(n=24)
  phantom, at test_torch_svr_pipeline.py's tolerances.
- The manual-mask volume of both engines: equal to JAX's except at voxels
  whose scattered fraction lies within 1e-5 of the 0.5 threshold.
- bspline_reconstruct within 1e-5 relative, and run_svr's --bspline
  volume at the pipeline tolerance.
- svr-reconstruct-torch --engine exact --manualMask --bspline --useCPU
  writes the three volumes that svr-reconstruct writes.
"""
import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.cli import svr_main as jcli
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.io.nifti import read_nifti, write_nifti
from fetalreconstruction_tpu.ops import manual_mask as jmm
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu.sr import bspline as jbs
from fetalreconstruction_tpu_torch.cli import svr_main
from fetalreconstruction_tpu_torch.ops import manual_mask
from fetalreconstruction_tpu_torch.pipeline import svr, svr_core
from fetalreconstruction_tpu_torch.sr import bspline
from fetalreconstruction_tpu_torch.sr.superresolution import (
    mask_volume, smoothing_parameters)
from fetalreconstruction_tpu_torch.utils import convert

from phantom import make_ground_truth, simulate_stacks
from test_torch_svr_core import _close, _exclusion, _field
from test_torch_svr_pipeline import (PARAM_TOL, PSNR_TOL, REC_TOL, _cfg,
                                     _psnr)
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402

INNER = 3


def _same_grid(a, b):
    """Image attributes equal across the packages' ImageAttributes."""
    assert dataclasses.astuple(a.attr) == dataclasses.astuple(b.attr)


def _t(a, dt=None):
    return torch.as_tensor(np.array(a), dtype=dt)


def _core_jax(ctx, p, mask_flat, alpha, lam, mx, mn, bias):
    geom, sume = jcore.build_geometry(
        ctx, jnp.asarray(p["recon_attr"].w2i(), jnp.float32),
        p["transforms"], jnp.asarray(p["i2w"], jnp.float32),
        jnp.asarray(p["dims"]), p["valid"])
    mask = mask_flat.reshape(ctx.vol_shape)
    em = jcore.init_em_state(p["slices"].shape[0], p["valid"])
    recon, vw, vc = jcore.gaussian_reconstruction(
        ctx, geom, sume, p["slices"], p["valid"], em.bias, em.scale,
        mask_flat)
    excluded = jnp.asarray(_exclusion(vc))
    ss = jcore.simulate(ctx, geom, sume, recon, mask_flat)
    em = jcore.initialize_robust_statistics(ctx, p["slices"], p["valid"], ss,
                                            em, mx, mn, excluded)
    em, _ = jcore.estep(ctx, p["slices"], p["valid"], sume, ss, em, excluded)
    for it in range(INNER):
        em, ss, recon = jcore.inner_iteration(
            ctx, geom, sume, p["slices"], p["valid"], em, ss, recon, vw,
            mask, mask_flat, excluded, jnp.float32(alpha), jnp.float32(lam),
            jnp.float32(mn), jnp.float32(mx), jnp.int32(it + 1),
            do_bias=bias, do_normalise_bias=bias)
    return em, ss, jcore.sr.mask_volume(recon, mask), vc


def _core_torch(tctx, p, mask_flat, alpha, lam, mx, mn, bias):
    slices, valid = _t(p["slices"]), _t(p["valid"])
    geom, sume = svr_core.build_geometry(
        tctx, _t(p["recon_attr"].w2i()), _t(p["transforms"]), _t(p["i2w"]),
        valid, slice_dims=_t(p["dims"]))
    mask = mask_flat.reshape(tctx.vol_shape)
    em = svr_core.init_em_state(slices.shape[0], valid)
    recon, vw, vc = svr_core.gaussian_reconstruction(
        tctx, geom, sume, slices, valid, em.bias, em.scale, mask_flat)
    excluded = torch.from_numpy(_exclusion(vc.numpy()))
    ss = svr_core.simulate(tctx, geom, sume, recon, mask_flat)
    em = svr_core.initialize_robust_statistics(tctx, slices, valid, ss, em,
                                               mx, mn, excluded)
    em, _ = svr_core.estep(tctx, slices, valid, sume, ss, em, excluded)
    for it in range(INNER):
        em, ss, recon = svr_core.inner_iteration(
            tctx, geom, sume, slices, valid, em, ss, recon, vw, mask,
            mask_flat, excluded, alpha, lam, mn, mx, it + 1, do_bias=bias,
            do_normalise_bias=bias)
    return em, ss, mask_volume(recon, mask), vc


def _tiny(bias):
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=False,
                              n_stacks=2)
    ctx = dataclasses.replace(ctx, disable_bias=not bias)
    mask = np.ones(ctx.vol_shape, np.float32)
    mask[:, :3, :] = 0.0  # part of the volume outside the mask
    tctx = svr_core.SVRContext(
        vol_shape=ctx.vol_shape, vol_spacing=ctx.vol_spacing,
        slice_spacing_xy=ctx.slice_spacing_xy, disable_bias=not bias,
        offsets=ctx.offsets)
    return ctx, tctx, p, mask.reshape(-1)


@pytest.fixture(scope="module", params=["plain", "bias"])
def core(request):
    bias = request.param == "bias"
    ctx, tctx, p, mask = _tiny(bias)
    alpha, lam = smoothing_parameters(150.0, 0.08)
    s = np.asarray(p["slices"])
    mx, mn = float(s[s > 0].max()), float(s[s > 0].min())
    return (_core_jax(ctx, p, jnp.asarray(mask), alpha, lam, mx, mn, bias),
            _core_torch(tctx, p, torch.as_tensor(mask), alpha, lam, mx, mn,
                        bias))


@pytest.mark.parametrize("name", ["recon", "sim", "simw", "weights", "bias",
                                  "scale", "slice_weight", "sigma2", "mix",
                                  "m", "voxel_count"])
def test_exact_core_matches_jax(core, name):
    ref, out = core
    o = _field(out, name)
    assert bool(torch.isfinite(o.float()).all())
    _close(o, _field(ref, name))


def test_exact_core_is_live(core):
    _, (em, ss, recon, _) = core
    assert float(recon.max()) > 0 and float(recon.std()) > 0
    assert bool(ss.slice_inside.any()) and float(em.sigma2) > 0


def test_context_needs_an_engine():
    with pytest.raises(ValueError, match="needs offsets"):
        svr_core.SVRContext(vol_shape=(4, 4, 4), vol_spacing=(1.0,) * 3,
                            slice_spacing_xy=(1.0, 1.0))


# ---------------------------------------------------------------------------
# the manual mask at the function level, both engines on one geometry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["fast", "exact"])
def test_transform_manual_mask_matches_jax(engine):
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12,
                              fast=engine == "fast", n_stacks=2)
    rng = np.random.default_rng(7)
    ms = (rng.uniform(size=p["slices"].shape) > 0.4).astype(np.float32)
    mask = np.asarray(p["mask_flat"])
    valid = np.asarray(p["valid"]).copy()
    valid[4:] = False  # only the first stack carries the manual mask
    ref = jmm.transform_manual_mask(ctx, p["geom"], p["sume"],
                                    jnp.asarray(ms), jnp.asarray(valid),
                                    p["mask_flat"])
    near = np.asarray(jmm.transform_manual_mask(
        ctx, p["geom"], p["sume"], jnp.asarray(ms), jnp.asarray(valid),
        p["mask_flat"], threshold=0.5 - 1e-5)) != np.asarray(
        jmm.transform_manual_mask(
            ctx, p["geom"], p["sume"], jnp.asarray(ms), jnp.asarray(valid),
            p["mask_flat"], threshold=0.5 + 1e-5))
    if engine == "fast":
        g = p["geom"]
        tctx = svr_core.SVRContext(
            vol_shape=ctx.vol_shape, vol_spacing=ctx.vol_spacing,
            slice_spacing_xy=ctx.slice_spacing_xy,
            fast=convert.fast_psf(ctx.fast.terms, ctx.fast.ranges,
                                  ctx.fast.support))
        geom = convert.fast_geom(g.xp, g.valid, g.sume, g.sid, g.den,
                                 ctx.vol_shape, len(ctx.fast.terms), "cpu")
        sume = geom.sume
    else:
        tctx = svr_core.SVRContext(
            vol_shape=ctx.vol_shape, vol_spacing=ctx.vol_spacing,
            slice_spacing_xy=ctx.slice_spacing_xy, offsets=ctx.offsets)
        geom, sume = svr_core.build_geometry(
            tctx, _t(p["recon_attr"].w2i()), _t(p["transforms"]),
            _t(p["i2w"]), _t(p["valid"]), slice_dims=_t(p["dims"]))
    out = manual_mask.transform_manual_mask(
        tctx, geom, sume, torch.as_tensor(ms), torch.as_tensor(valid),
        torch.as_tensor(mask.copy())).numpy()
    ref = np.asarray(ref)
    assert out.dtype == np.float32 and 0 < out.sum() < out.size
    np.testing.assert_array_equal(out[~near], ref[~near])


# ---------------------------------------------------------------------------
# B-spline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("points", ["scattered", "slab"])
def test_bspline_reconstruct_matches_jax(points):
    """test_eval_slic_checkpoint.py's smooth field from 4000 scattered
    samples, to 1e-5; and from a slice-like slab of samples 4.2e-4 voxels
    above a lattice plane, to REC_TOL: its far control points are reached
    only by weights at the float32 underflow boundary, which XLA flushes
    (without the flush the port is 0.16 off), and their ratio of near-
    underflow sums then depends on the compiler's operation order."""
    rng = np.random.default_rng(5)
    shape = (16, 18, 20)
    zs, ys, xs = shape
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    gt = (30 + 20 * np.sin(x / 5.0) + 10 * np.cos(y / 4.0)
          + 5 * np.sin(z / 3.0)).astype(np.float32)
    if points == "scattered":
        m = 4000
        pts = np.stack([rng.uniform(0, xs - 1, m), rng.uniform(0, ys - 1, m),
                        rng.uniform(0, zs - 1, m)], -1)
    else:
        py, px = np.meshgrid(np.arange(ys), np.arange(xs), indexing="ij")
        pts = np.stack([px.ravel(), py.ravel(),
                        np.full(px.size, 10.00042)], -1)
    from scipy.ndimage import map_coordinates
    vals = map_coordinates(gt, pts[:, ::-1].T, order=1)
    ref = np.asarray(jbs.bspline_reconstruct(pts, vals, shape, levels=4))
    out = bspline.bspline_reconstruct(pts, vals, shape, levels=4,
                                      device="cpu").numpy()
    assert out.shape == shape and out.dtype == np.float32
    _close(torch.as_tensor(out), ref,
           tol=1e-5 if points == "scattered" else REC_TOL)
    if points == "scattered":
        err = np.abs(out[2:-2, 2:-2, 2:-2] - gt[2:-2, 2:-2, 2:-2])
        assert err.mean() < 1.5  # the JAX test's own bar


# ---------------------------------------------------------------------------
# run_svr end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A make_ground_truth(n=24) phantom, two stacks, and a manual mask of
    the first stack: its own voxels above the truth's mean."""
    gt = make_ground_truth(n=24, spacing=1.5)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.0, dz=3.0,
                                noise=1.0)
    mask_img = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    d = tmp_path_factory.mktemp("manual")
    s0 = stacks[0]
    manual = Image((s0.data > s0.data[s0.data > 0].mean()).astype(
        np.float32), s0.attr.copy())
    write_nifti(manual, str(d / "manual.nii.gz"))
    return gt, stacks, mask_img, str(d / "manual.nii.gz")


def _kw(**kw):
    base = dict(iterations=2, rec_iterations_first=2, rec_iterations_last=3)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def exact_runs(data):
    """run_svr(engine="exact") with normalise-bias, --manualMask and
    --bspline, in both packages."""
    gt, stacks, mask_img, manual = data
    kw = _kw(engine="exact", disable_bias_correction=False,
             manual_mask=manual, bspline=True)
    ref = jsvr.run_svr(_cfg(**kw), stacks=stacks, mask=mask_img)
    out = svr.run_svr(convert.config_from(_cfg(**kw)),
                      stacks=[convert.image_from(s) for s in stacks],
                      mask=convert.image_from(mask_img), device="cpu")
    return ref, out


def test_exact_run_svr_matches_jax(data, exact_runs):
    gt = data[0]
    ref, out = exact_runs
    a, b = out.reconstructed, ref.reconstructed
    _same_grid(a, b)
    assert np.isfinite(a.data).all()
    err = np.abs(a.data - b.data).max() / np.abs(b.data).max()
    assert err <= REC_TOL, err
    from fetalreconstruction_tpu.core.geometry import matrix_to_params
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(out.transforms, ref.transforms))
    assert d <= PARAM_TOL, d
    p_out, p_ref = _psnr(gt, a), _psnr(gt, b)
    assert abs(p_out - p_ref) <= PSNR_TOL, (p_out, p_ref)
    assert p_out > 12.0  # 2 outer iterations of 2 / 3 inner at n=24
    np.testing.assert_allclose(out.slice_weights, ref.slice_weights,
                               atol=1e-3)
    assert out.excluded_slices == ref.excluded_slices


def test_exact_run_manual_mask_matches_jax(exact_runs):
    ref, out = exact_runs
    a, b = out.manual_mask_volume, ref.manual_mask_volume
    _same_grid(a, b)
    assert set(np.unique(a.data)) <= {0.0, 1.0}
    assert 0 < a.data.sum() < a.data.size
    # the volumes come from slightly different final geometries: allow
    # only voxels at the threshold to flip
    assert np.mean(a.data != b.data) <= 1e-3


def test_exact_run_bspline_matches_jax(exact_runs):
    ref, out = exact_runs
    a, b = out.bspline_reconstructed, ref.bspline_reconstructed
    _same_grid(a, b)
    assert np.isfinite(a.data).all()
    err = np.abs(a.data - b.data).max() / np.abs(b.data).max()
    assert err <= REC_TOL, err


def test_fast_run_manual_mask_matches_jax(data):
    gt, stacks, mask_img, manual = data
    kw = _kw(manual_mask=manual)
    ref = jsvr.run_svr(_cfg(**kw), stacks=stacks, mask=mask_img)
    out = svr.run_svr(_cfg(**kw), stacks=stacks, mask=mask_img,
                      device="cpu")
    a, b = out.manual_mask_volume, ref.manual_mask_volume
    _same_grid(a, b)
    assert 0 < a.data.sum() < a.data.size
    assert np.mean(a.data != b.data) <= 1e-3


def test_cli_writes_exact_manual_mask_and_bspline(data, tmp_path):
    gt, stacks, mask_img, manual = data
    paths = []
    for i, st in enumerate(stacks):
        paths.append(str(tmp_path / f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    write_nifti(mask_img, str(tmp_path / "mask.nii.gz"))
    outs = {}
    for name, main, extra in (("j", jcli.main, []),
                              ("t", svr_main.main, ["--useCPU"])):
        mdir = tmp_path / name
        mdir.mkdir()
        mpath = str(mdir / "manual.nii.gz")
        write_nifti(read_nifti(manual), mpath)
        out = str(mdir / "recon.nii.gz")
        assert main(["-o", out, "-i", *paths, "-m",
                     str(tmp_path / "mask.nii.gz"), "--engine", "exact",
                     "--manualMask", mpath, "--bspline", "--iterations",
                     "1", "--resolution", "1.5", "--smooth_mask", "2.0",
                     "--rec_iterations_last", "1", "--no_log",
                     "--log_prefix", str(mdir / "p_"), *extra]) == 0
        outs[name] = [read_nifti(p) for p in (
            out, out + ".bspline.nii.gz",
            str(mdir / "PSFTransformed_manual.nii.gz"))]
    for a, b in zip(outs["t"], outs["j"]):
        assert np.allclose(a.attr.i2w(), b.attr.i2w())
        err = np.abs(a.data - b.data).max() / max(np.abs(b.data).max(), 1)
        assert err <= REC_TOL, err
    assert os.path.exists(tmp_path / "t" / "PSFTransformed_manual.nii.gz")
