"""Port's em/robust.py and sr/superresolution.py vs the JAX package.

Inputs are made with numpy from fixed seeds and fed to both sides.
Tolerance 1e-5 relative to max|ref| for the f32 reductions and stencils
(the same formulas, summed in another order); gate-dependent outputs are
built from inputs that keep clear of the gates' thresholds.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.em import robust as jrob
from fetalreconstruction_tpu.sr import superresolution as jsr
from fetalreconstruction_tpu_torch.em import robust
from fetalreconstruction_tpu_torch.sr import superresolution as sr

TOL = 1e-5


def _close(out, ref, tol=TOL):
    out = out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    if out.dtype == bool or ref.dtype == bool:
        np.testing.assert_array_equal(out, ref)
        return
    out, ref = out.astype(np.float64), ref.astype(np.float64)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


@pytest.fixture(scope="module")
def batch():
    """A slice batch with invalid pixels, excluded slices and confident /
    unconfident simulation weights."""
    rng = np.random.default_rng(11)
    n, h, w = 6, 9, 7
    f32 = np.float32
    d = dict(
        slices=rng.uniform(50, 150, (n, h, w)).astype(f32),
        sim=rng.uniform(50, 150, (n, h, w)).astype(f32),
        simw=np.where(rng.uniform(size=(n, h, w)) < 0.7, 1.0,
                      rng.uniform(0.0, 0.9, (n, h, w))).astype(f32),
        valid=rng.uniform(size=(n, h, w)) < 0.9,
        inside=rng.uniform(size=(n, h, w)) < 0.95,
        bias=rng.normal(0, 0.05, (n, h, w)).astype(f32),
        scale=rng.uniform(0.8, 1.2, n).astype(f32),
        weights=rng.uniform(0, 1, (n, h, w)).astype(f32),
        slice_weight=rng.uniform(0, 1, n).astype(f32),
    )
    d["simw"][1] = 0.5  # a slice with no confident voxels
    return d


def _both(d, *names):
    return ([jnp.asarray(d[k]) for k in names],
            [torch.from_numpy(np.array(d[k])) for k in names])


def test_gauss_and_corrected_slice(batch):
    x = np.linspace(-3, 3, 41).astype(np.float32)
    _close(robust.gauss(torch.from_numpy(x), torch.tensor(0.7)),
           jrob.gauss(jnp.asarray(x), 0.7))
    j, t = _both(batch, "slices", "bias", "scale")
    _close(robust.corrected_slice(*t), jrob.corrected_slice(*j))


def test_init_robust_stats(batch):
    j, t = _both(batch, "slices", "valid", "sim", "simw", "inside")
    s2, num = robust.init_robust_stats(*t)
    rs2, rnum = jrob.init_robust_stats(*j)
    _close(s2, rs2)
    assert int(num) == int(rnum)


def test_voxel_estep(batch):
    j, t = _both(batch, "slices", "valid", "bias", "scale", "sim", "simw")
    args = (300.0, 1.0 / 1000.0, 0.8)
    w, pot = robust.voxel_estep(*t, *[torch.tensor(a) for a in args])
    rw, rpot = jrob.voxel_estep(*j, *[jnp.float32(a) for a in args])
    _close(w, rw)
    _close(pot, rpot)
    assert float(pot[1]) == -1.0


@pytest.mark.parametrize("case", ["mixed", "all_inliers", "excluded"])
def test_slice_estep_and_mixture(case):
    rng = np.random.default_rng({"mixed": 1, "all_inliers": 2,
                                 "excluded": 3}[case])
    pot = rng.uniform(0.1, 0.9, 12).astype(np.float32)
    sw = rng.uniform(0, 1, 12).astype(np.float32)
    if case == "all_inliers":
        sw[:] = 1.0
    if case == "excluded":
        pot[[0, 4, 7]] = -1.0
    mix_s = np.float32(0.85)
    out = robust.slice_mixture(torch.from_numpy(pot), torch.from_numpy(sw))
    ref = jrob.slice_mixture(jnp.asarray(pot), jnp.asarray(sw))
    for o, r in zip(out, ref):
        _close(o, r)
    w, st = robust.slice_estep(torch.from_numpy(pot), torch.from_numpy(sw),
                               torch.tensor(mix_s))
    rw, rst = jrob.slice_estep(jnp.asarray(pot), jnp.asarray(sw),
                               jnp.float32(mix_s))
    _close(w, rw)
    for k in rst:
        _close(st[k], rst[k])


@pytest.mark.parametrize("iteration", [1, 2])
def test_mstep(batch, iteration):
    j, t = _both(batch, "slices", "valid", "bias", "scale", "weights", "sim",
                 "simw")
    out = robust.mstep(*t, iteration, torch.tensor(0.9))
    ref = jrob.mstep(*j, iteration, jnp.float32(0.9))
    for o, r in zip(out, ref):
        _close(o, r)


def test_scale_step_and_volume_factor(batch):
    j, t = _both(batch, "slices", "valid", "bias", "weights", "sim", "simw")
    _close(robust.scale_step(*t), jrob.scale_step(*j))
    j, t = _both(batch, "slices", "valid", "weights", "slice_weight", "sim",
                 "simw")
    _close(robust.scale_volume_factor(*t), jrob.scale_volume_factor(*j))


def _vols(seed=12, shape=(9, 10, 11)):
    rng = np.random.default_rng(seed)
    recon = rng.uniform(100, 700, shape).astype(np.float32)
    original = recon + rng.normal(0, 30, shape).astype(np.float32)
    addon = rng.normal(0, 40, shape).astype(np.float32)
    cmap = np.where(rng.uniform(size=shape) < 0.85,
                    rng.uniform(0.1, 3, shape), 0).astype(np.float32)
    return recon, original, addon, cmap


def test_smoothing_parameters_and_shift3d():
    assert sr.smoothing_parameters(150.0, 0.08) == \
        jsr.smoothing_parameters(150.0, 0.08)
    vol = np.random.default_rng(0).normal(size=(5, 6, 7)).astype(np.float32)
    for d in jsr.DIRECTIONS:
        for sgn in (1, -1):
            np.testing.assert_array_equal(
                sr.shift3d(torch.from_numpy(vol), sgn * d).numpy(),
                np.asarray(jsr.shift3d(jnp.asarray(vol), sgn * d)))


@pytest.mark.parametrize("adaptive", [False, True])
def test_apply_addon(adaptive):
    recon, _, addon, cmap = _vols()
    out = sr.apply_addon(torch.from_numpy(recon), torch.from_numpy(addon),
                         torch.from_numpy(cmap), 0.625, 100.0, 700.0,
                         adaptive)
    ref = jsr.apply_addon(jnp.asarray(recon), jnp.asarray(addon),
                          jnp.asarray(cmap), 0.625, 100.0, 700.0, adaptive)
    for o, r in zip(out, ref):
        _close(o, r)


def test_adaptive_regularization():
    recon, original, _, cmap = _vols()
    out = sr.adaptive_regularization(
        torch.from_numpy(recon), torch.from_numpy(original),
        torch.from_numpy(cmap), 0.625, 1800.0, 150.0)
    ref = jsr.adaptive_regularization(
        jnp.asarray(recon), jnp.asarray(original), jnp.asarray(cmap),
        0.625, 1800.0, 150.0)
    _close(out, ref)


def test_equalize_and_mask_volume():
    recon, _, _, cmap = _vols()
    _close(sr.equalize(torch.from_numpy(recon), torch.from_numpy(cmap)),
           jsr.equalize(jnp.asarray(recon), jnp.asarray(cmap)))
    _close(sr.mask_volume(torch.from_numpy(recon), torch.from_numpy(cmap)),
           jsr.mask_volume(jnp.asarray(recon), jnp.asarray(cmap)))
