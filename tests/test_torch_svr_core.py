"""The port's reconstruction core, end to end, vs the JAX package.

One outer iteration of run_svr's body (pipeline/svr.py:788-821) on
__graft_entry__._tiny_problem(fast=True, n_stacks=2), through each
package's own svr_core entry points: build_geometry, gaussian_
reconstruction, small-slice exclusion, simulate, initialize_robust_
statistics, estep, 3 x inner_iteration, mask_volume.  Both sides build
their own geometry; only the separable taps are carried across
(utils/convert.py), so both run on the same PSF.

Limit: 1e-4 relative to max|ref| for recon, sim, weights and slice_weight
and relative for the EM scalars: f32 sums in another order, compounded
over the whole sequence.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu_torch.pipeline import svr_core
from fetalreconstruction_tpu_torch.sr.superresolution import (
    mask_volume, smoothing_parameters)
from fetalreconstruction_tpu_torch.utils import convert

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402

TOL = 1e-4
INNER = 3


def _exclusion(vc):
    vc = np.asarray(vc)
    median = np.sort(vc)[int(round(len(vc) * 0.5))]
    return vc < 0.1 * median


def _run_jax(ctx, p, alpha, lam, mx, mn):
    geom, sume = jcore.build_geometry(
        ctx, jnp.asarray(p["recon_attr"].w2i(), jnp.float32),
        p["transforms"], jnp.asarray(p["i2w"], jnp.float32),
        jnp.asarray(p["dims"]), p["valid"], p["mask_flat"],
        stack_id=jnp.asarray(p["stack_id"]))
    n = p["slices"].shape[0]
    mask = p["mask_flat"].reshape(ctx.vol_shape)
    em = jcore.init_em_state(n, p["valid"])
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
            jnp.int32(it + 1))
    return em, ss, jcore.sr.mask_volume(recon, mask), vc


def _run_torch(tctx, p, alpha, lam, mx, mn):
    t = lambda a, dt=None: torch.as_tensor(np.array(a), dtype=dt)  # noqa
    slices, valid = t(p["slices"]), t(p["valid"])
    mask_flat = t(p["mask_flat"])
    geom, sume = svr_core.build_geometry(
        tctx, t(p["recon_attr"].w2i()), t(p["transforms"]), t(p["i2w"]),
        valid, mask_flat, stack_id=t(p["stack_id"]))
    n = slices.shape[0]
    mask = mask_flat.reshape(tctx.vol_shape)
    em = svr_core.init_em_state(n, valid)
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
            mask_flat, excluded, alpha, lam, mn, mx, it + 1)
    return em, ss, mask_volume(recon, mask), vc


@pytest.fixture(scope="module")
def both():
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=True,
                              n_stacks=2)
    jf = ctx.fast
    tctx = svr_core.SVRContext(
        vol_shape=ctx.vol_shape, vol_spacing=ctx.vol_spacing,
        slice_spacing_xy=ctx.slice_spacing_xy, disable_bias=True,
        fast=convert.fast_psf(jf.terms, jf.ranges, jf.support))
    alpha, lam = smoothing_parameters(150.0, 0.08)
    s = np.asarray(p["slices"])
    mx, mn = float(s[s > 0].max()), float(s[s > 0].min())
    return (_run_jax(ctx, p, alpha, lam, mx, mn),
            _run_torch(tctx, p, alpha, lam, mx, mn))


def _close(out, ref, tol=TOL):
    out = out.numpy().astype(np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def _field(run, name):
    em, ss, recon, vc = run
    if name == "recon":
        return recon
    if name == "voxel_count":
        return vc
    if name in ("sim", "simw"):
        return getattr(ss, name)
    return getattr(em, name)


@pytest.mark.parametrize("name", ["recon", "sim", "simw", "weights",
                                  "slice_weight", "sigma2", "mix", "m",
                                  "voxel_count"])
def test_slice_matches_jax(both, name):
    ref, out = both
    r, o = _field(ref, name), _field(out, name)
    assert bool(torch.isfinite(o.float()).all())
    _close(o, r)


def test_slice_state_is_live(both):
    """The run did real work: recon inside the mask is non-trivial, some
    slices carry weight, and the EM scalars moved off their defaults."""
    _, out = both
    em, _, recon, _ = out
    assert float(recon.max()) > 0 and float(recon.std()) > 0
    assert float(em.slice_weight.sum()) > 0
    assert float(em.sigma2) > 0 and float(em.m) > 0


def test_unported_paths_raise():
    ctx, _ = ge._tiny_problem(n_slices=4, vol=8, hw=6, fast=True,
                              n_stacks=2)
    with pytest.raises(NotImplementedError, match="item 12"):
        svr_core.SVRContext(fast=None, vol_shape=ctx.vol_shape,
                            vol_spacing=ctx.vol_spacing,
                            slice_spacing_xy=ctx.slice_spacing_xy)
