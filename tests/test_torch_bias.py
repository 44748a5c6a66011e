"""The port's bias correction vs the JAX package.

- em/bias.py: `bias_step` (both values of global_bias_correction) and
  `bias_correct_volume` on seeded numpy inputs that keep clear of the
  gates (simw > 0.99, sim > 1, s > 1, the intensity cutoff); limit 1e-5
  relative to max|ref| (log, exp and the blur's float32 sums);
- svr_core.normalise_bias_step on the fast engine, with the same geometry
  carried across (utils/convert.py), limit 1e-5;
- one outer iteration of run_svr's body with the bias steps switched on
  (do_bias, do_normalise_bias, global bias correction), each package on
  its own svr_core, limit 1e-4 as in test_torch_svr_core.py;
- run_svr with bias correction and with global bias correction on
  test_torch_svr_pipeline.py's problem, at that file's limits.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.core.geometry import matrix_to_params
from fetalreconstruction_tpu.em import bias as jbias
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu_torch.em import bias
from fetalreconstruction_tpu_torch.pipeline import svr, svr_core
from fetalreconstruction_tpu_torch.sr.superresolution import (
    mask_volume, smoothing_parameters)
from fetalreconstruction_tpu_torch.utils import convert

from test_torch_svr_pipeline import (PARAM_TOL, PSNR_TOL, REC_TOL, _cfg,
                                     _psnr, data)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402

FN_TOL = 1e-5
CORE_TOL = 1e-4
INNER = 3


def _close(out, ref, tol):
    out = (out.numpy() if isinstance(out, torch.Tensor)
           else np.asarray(out)).astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    assert np.isfinite(out).all()
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def slice_batch():
    """Slices with invalid pixels and confident / unconfident simulation
    weights, a non-zero starting bias and per-slice scales."""
    rng = np.random.default_rng(5)
    n, h, w = 5, 11, 9
    f32 = np.float32
    slices = rng.uniform(50, 400, (n, h, w)).astype(f32)
    valid = rng.uniform(size=(n, h, w)) > 0.15
    valid[3] = False  # a slice with no valid pixel
    sim = (slices * rng.uniform(0.7, 1.3, (n, h, w))).astype(f32)
    sim[rng.uniform(size=(n, h, w)) < 0.1] = 0.5  # below the sim > 1 gate
    simw = np.where(rng.uniform(size=(n, h, w)) < 0.8,
                    rng.uniform(0.995, 1.5, (n, h, w)),
                    rng.uniform(0.0, 0.98, (n, h, w))).astype(f32)
    return dict(slices=slices, valid=valid,
                bias=rng.uniform(-0.2, 0.2, (n, h, w)).astype(f32),
                scale=rng.uniform(0.8, 1.2, n).astype(f32),
                weights=rng.uniform(0.0, 1.0, (n, h, w)).astype(f32),
                sim=sim, simw=simw)


@pytest.mark.parametrize("global_bias", [False, True])
def test_bias_step_matches_jax(slice_batch, global_bias):
    b = slice_batch
    names = ("slices", "valid", "bias", "scale", "weights", "sim", "simw")
    ref = jbias.bias_step(*[jnp.asarray(b[k]) for k in names], 12.0,
                          (1.25, 1.5), global_bias)
    out = bias.bias_step(*[torch.as_tensor(b[k]) for k in names], 12.0,
                         (1.25, 1.5), global_bias)
    _close(out, ref, FN_TOL)
    # the field moved, and an all-invalid slice keeps its bias
    assert np.abs(out.numpy() - b["bias"]).max() > 1e-3
    np.testing.assert_array_equal(out.numpy()[3], b["bias"][3])


def test_bias_correct_volume_matches_jax():
    rng = np.random.default_rng(6)
    shape = (9, 12, 10)
    original = rng.uniform(20, 600, shape).astype(np.float32)
    recon = (original * rng.uniform(0.8, 1.25, shape)).astype(np.float32)
    recon[0, :3] = 1.0  # under the cutoff
    mask = (rng.uniform(size=shape) > 0.2).astype(np.float32)
    args = (10.0, 650.0, 0.01, 6.0, (1.2, 1.2, 1.5))
    ref = jbias.bias_correct_volume(jnp.asarray(recon), jnp.asarray(original),
                                    jnp.asarray(mask), *args)
    out = bias.bias_correct_volume(torch.as_tensor(recon),
                                   torch.as_tensor(original),
                                   torch.as_tensor(mask), *args)
    _close(out, ref, FN_TOL)
    assert np.abs(out.numpy() - recon).max() > 1.0


@pytest.fixture(scope="module")
def tiny():
    """__graft_entry__._tiny_problem on the fast engine with bias
    correction switched on; the port's context carries the same taps."""
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=True,
                              n_stacks=2)
    ctx = dataclasses.replace(ctx, disable_bias=False, sigma_bias=8.0)
    jf = ctx.fast
    fast = convert.fast_psf(jf.terms, jf.ranges, jf.support)
    return ctx, fast, p


def _tctx(ctx, fast, global_bias=False):
    return svr_core.SVRContext(
        vol_shape=ctx.vol_shape, vol_spacing=ctx.vol_spacing,
        slice_spacing_xy=ctx.slice_spacing_xy, fast=fast,
        sigma_bias=ctx.sigma_bias, global_bias_correction=global_bias,
        disable_bias=False)


def test_normalise_bias_step_matches_jax(tiny):
    ctx, fast, p = tiny
    rng = np.random.default_rng(7)
    n, h, w = np.asarray(p["slices"]).shape
    vs = ctx.vol_shape
    g = p["geom"]
    em = p["em"]._replace(
        bias=jnp.asarray(rng.uniform(-0.3, 0.3, (n, h, w)), jnp.float32),
        scale=jnp.asarray(rng.uniform(0.7, 1.4, n), jnp.float32))
    recon = np.asarray(p["recon"]).copy()
    recon[0, 0, :4] = -1.0  # padding voxels stay as they are
    vol_weights = rng.uniform(0.0, 2.0, vs).astype(np.float32)
    vol_weights[vol_weights < 0.3] = 0.0
    mask = (rng.uniform(size=vs) > 0.1).astype(np.float32)
    ref = jcore.normalise_bias_step(
        ctx, g, p["sume"], p["valid"], em, jnp.asarray(recon),
        jnp.asarray(vol_weights), jnp.asarray(mask),
        jnp.asarray(mask.reshape(-1)))
    tgeom = convert.fast_geom(g.xp, g.valid, g.sume, g.sid, g.den, vs,
                              fast.n_stacks, "cpu")
    tem = convert.em_state(*[np.asarray(x) for x in em], device="cpu")
    out = svr_core.normalise_bias_step(
        _tctx(ctx, fast), tgeom, tgeom.sume, tgeom.valid, tem,
        torch.as_tensor(recon), torch.as_tensor(vol_weights),
        torch.as_tensor(mask), torch.as_tensor(mask.reshape(-1)))
    _close(out, ref, FN_TOL)
    assert np.abs(out.numpy() - recon).max() > 1e-2


def _exclusion(vc):
    vc = np.asarray(vc)
    return vc < 0.1 * np.sort(vc)[int(round(len(vc) * 0.5))]


def _outer_jax(ctx, p, flags, alpha, lam, mx, mn):
    geom, sume = jcore.build_geometry(
        ctx, jnp.asarray(p["recon_attr"].w2i(), jnp.float32),
        p["transforms"], jnp.asarray(p["i2w"], jnp.float32),
        jnp.asarray(p["dims"]), p["valid"], p["mask_flat"],
        stack_id=jnp.asarray(p["stack_id"]))
    mask = p["mask_flat"].reshape(ctx.vol_shape)
    em = jcore.init_em_state(p["slices"].shape[0], p["valid"])
    recon, vw, vc = jcore.gaussian_reconstruction(
        ctx, geom, sume, p["slices"], p["valid"], em.bias, em.scale,
        p["mask_flat"])
    excluded = jnp.asarray(_exclusion(vc))
    ss = jcore.simulate(ctx, geom, sume, recon, p["mask_flat"])
    em = jcore.initialize_robust_statistics(ctx, p["slices"], p["valid"], ss,
                                            em, mx, mn, excluded)
    em, _ = jcore.estep(ctx, p["slices"], p["valid"], sume, ss, em, excluded)
    for it in range(INNER):
        em, ss, recon = jcore.inner_iteration(
            ctx, geom, sume, p["slices"], p["valid"], em, ss, recon, vw,
            mask, p["mask_flat"], excluded, jnp.float32(alpha),
            jnp.float32(lam), jnp.float32(mn), jnp.float32(mx),
            jnp.int32(it + 1), **flags)
    return em, jcore.sr.mask_volume(recon, mask)


def _outer_torch(tctx, p, flags, alpha, lam, mx, mn):
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)  # noqa
    slices, valid, mask_flat = t(p["slices"]), t(p["valid"]), \
        t(p["mask_flat"])
    geom, sume = svr_core.build_geometry(
        tctx, t(p["recon_attr"].w2i()), t(p["transforms"]), t(p["i2w"]),
        valid, mask_flat, stack_id=t(p["stack_id"]))
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
            mask_flat, excluded, alpha, lam, mn, mx, it + 1, **flags)
    return em, mask_volume(recon, mask)


@pytest.mark.parametrize("mode", ["bias", "normalise_bias", "global"])
def test_inner_iteration_with_bias_matches_jax(tiny, mode):
    ctx, fast, p = tiny
    flags = dict(do_bias=mode != "normalise_bias",
                 do_normalise_bias=mode == "normalise_bias")
    global_bias = mode == "global"
    jctx = dataclasses.replace(ctx, global_bias_correction=global_bias)
    alpha, lam = smoothing_parameters(150.0, 0.08)
    s = np.asarray(p["slices"])
    mx, mn = float(s[s > 0].max()), float(s[s > 0].min())
    ref_em, ref_recon = _outer_jax(jctx, p, flags, alpha, lam, mx, mn)
    em, recon = _outer_torch(_tctx(ctx, fast, global_bias), p, flags, alpha,
                             lam, mx, mn)
    _close(recon, ref_recon, CORE_TOL)
    for name in ("bias", "scale", "weights", "slice_weight", "sigma2"):
        _close(getattr(em, name), getattr(ref_em, name), CORE_TOL)
    if flags["do_bias"]:
        assert float(em.bias.abs().max()) > 1e-3


@pytest.fixture(scope="module")
def runs(data):
    gt, stacks, mask_img = data
    out = {}
    for name, kw in (("bias", dict(disable_bias_correction=False)),
                     ("global", dict(disable_bias_correction=False,
                                     global_bias_correction=True))):
        out[name] = (jsvr.run_svr(_cfg(**kw), stacks=stacks, mask=mask_img),
                     svr.run_svr(_cfg(**kw), stacks=stacks, mask=mask_img,
                                 device="cpu"))
    return out


@pytest.mark.parametrize("name", ["bias", "global"])
def test_run_svr_with_bias_matches_jax(data, runs, name):
    ref, out = runs[name]
    a, b = out.reconstructed, ref.reconstructed
    assert a.attr == b.attr and np.isfinite(a.data).all()
    err = np.abs(a.data - b.data).max() / np.abs(b.data).max()
    assert err <= REC_TOL, err
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(out.transforms, ref.transforms))
    assert d <= PARAM_TOL, d
    gt = data[0]
    p_out, p_ref = _psnr(gt, a), _psnr(gt, b)
    assert abs(p_out - p_ref) <= PSNR_TOL, (p_out, p_ref)
    np.testing.assert_allclose(out.slice_weights, ref.slice_weights,
                               atol=1e-3)
