"""Port's PSF engine (ops/psf.py, ops/psf_fast.py) vs the JAX package.

Inputs are made with numpy from fixed seeds and go through both sides; the
JAX side runs on the CPU as its own tests run it.  Tolerances, relative to
max|ref|:
- 1e-5 for calc_psf, the separable taps and single operators: the same f32
  formulas, with sin/exp and the banded-matrix sums from other libraries;
- 1e-4 for whole engine calls (geometry tables, simulate, scatter), whose
  f32 sums run through several convolution passes in another order.
"""
import sys
from pathlib import Path

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.ops import psf as jpsf
from fetalreconstruction_tpu.ops import psf_fast as jpf
from fetalreconstruction_tpu_torch.ops import psf, psf_fast
from fetalreconstruction_tpu_torch.pipeline import svr_core
from fetalreconstruction_tpu_torch.utils import convert

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import __graft_entry__ as ge  # noqa: E402


def _close(out, ref, tol):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-12)
    assert err <= tol, err


def _a3(seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * rng.uniform(0.5, 1.5)


def test_calc_psf_matches_jax():
    rng = np.random.default_rng(0)
    mm = rng.uniform(-6, 6, (500, 3)).astype(np.float32)
    mm[0] = 0.0  # the r -> 0 branch
    dims = np.array([1.25, 1.25, 5.0], np.float32)
    ref = jpsf.calc_psf(jnp.asarray(mm), jnp.asarray(dims))
    out = psf.calc_psf(torch.from_numpy(mm), torch.from_numpy(dims))
    assert out.dtype == torch.float32
    _close(out, ref, 1e-5)


def test_support_and_offsets_match_jax():
    dims = np.array([[1.25, 1.25, 5.0], [2.5, 2.5, 4.0]])
    for dx, q, mx in ((1.0, 1.0, 12), (0.75, 1.0, 16), (2.0, 2.0, 8)):
        assert psf.reference_support(dims, dx, q, mx) == \
            jpsf.reference_support(dims, dx, q, mx)
    np.testing.assert_array_equal(psf.make_offsets(6), jpsf.make_offsets(6))


@pytest.mark.parametrize("seed,support", [(1, 12), (2, 7)])
def test_separable_taps_match_jax(seed, support):
    a3, dims = _a3(seed), np.array([1.25, 1.25, 5.0])
    k_ref = jpf.stack_kernel(a3, dims, support)
    k = psf_fast.stack_kernel(a3, dims, support)
    _close(k, k_ref, 1e-5)
    t_ref = jpf.separable_decompose(k_ref)
    t = psf_fast.separable_decompose(k)
    assert len(t) == len(t_ref)
    for (kz, ky, kx, c), (rz, ry, rx, rc) in zip(t, t_ref):
        _close(c * np.einsum("i,j,k->ijk", kz, ky, kx),
               rc * np.einsum("i,j,k->ijk", rz, ry, rx), 1e-5)


def _terms(seed=1, support=6):
    a3, dims = _a3(seed), np.array([2.5, 2.5, 5.0])
    return jpf.separable_decompose(jpf.stack_kernel(a3, dims, support))


@pytest.mark.parametrize("flip", [False, True])
def test_conv_separable_matches_jax(flip):
    terms = _terms()
    shape = (9, 11, 10)
    vol = np.random.default_rng(4).uniform(-1, 1, (2,) + shape)
    vol = vol.astype(np.float32)
    ref = jpf.conv_separable(jnp.asarray(vol), terms, flip=flip)
    bands = psf_fast.band_terms(terms, shape, flip, "cpu")
    out = psf_fast.conv_separable(torch.from_numpy(vol), bands)
    _close(out, ref, 1e-5)


def test_conv_separable_adjoint_identity():
    """<A x, y> == <x, A^T y> with A^T the flip=True pass."""
    terms = _terms(seed=3, support=8)  # even support: the shifted centre
    shape = (8, 12, 10)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=shape)).double()
    y = torch.from_numpy(rng.normal(size=shape)).double()
    fwd = [b._replace(bz=b.bz.double(), by=b.by.double(), bx=b.bx.double())
           for b in psf_fast.band_terms(terms, shape, False, "cpu")]
    adj = [b._replace(bz=b.bz.double(), by=b.by.double(), bx=b.bx.double())
           for b in psf_fast.band_terms(terms, shape, True, "cpu")]
    lhs = float((psf_fast.conv_separable(x, fwd) * y).sum())
    rhs = float((x * psf_fast.conv_separable(y, adj)).sum())
    assert abs(lhs - rhs) <= 1e-10 * max(abs(lhs), 1.0)


def test_shingle_gather_matches_jax():
    rng = np.random.default_rng(6)
    shape = (7, 9, 8)
    vols = rng.uniform(0, 1, (2, 2) + shape).astype(np.float32)  # (S, P)
    xp = rng.uniform(-2, 10, (5, 4, 6, 3)).astype(np.float32)
    sid = rng.integers(0, 2, (5,))
    jtab = jnp.concatenate([jpf.make_shingle([jnp.asarray(v) for v in vs])
                            for vs in vols], axis=1)
    ref = jpf.shingle_gather(jtab, jnp.asarray(xp), shape, 2,
                             sid=jnp.asarray(sid, jnp.int32))
    tab = torch.cat([psf_fast.make_shingle([torch.from_numpy(v) for v in vs])
                     for vs in vols], dim=1)
    np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))
    out = psf_fast.shingle_gather(tab, torch.from_numpy(xp), shape, 2,
                                  sid=torch.from_numpy(sid))
    for o, r in zip(out, ref):
        _close(o, r, 1e-6)


@pytest.fixture(scope="module")
def tiny():
    ctx, p = ge._tiny_problem(n_slices=8, vol=16, hw=12, fast=True,
                              n_stacks=2)
    jf = ctx.fast
    fast = convert.fast_psf(jf.terms, jf.ranges, jf.support)
    return ctx, p, fast


def test_make_fast_geom_matches_jax(tiny):
    ctx, p, fast = tiny
    g = p["geom"]
    tctx = svr_core.SVRContext(vol_shape=ctx.vol_shape,
                               vol_spacing=ctx.vol_spacing,
                               slice_spacing_xy=ctx.slice_spacing_xy,
                               fast=fast, disable_bias=True)
    geom, sume = svr_core.build_geometry(
        tctx, torch.from_numpy(p["recon_attr"].w2i()),
        torch.from_numpy(np.array(p["transforms"])),
        torch.from_numpy(p["i2w"]), torch.from_numpy(np.array(p["valid"])),
        torch.from_numpy(np.array(p["mask_flat"])),
        stack_id=torch.from_numpy(p["stack_id"]))
    _close(geom.xp, g.xp, 1e-6)
    _close(sume, g.sume, 1e-4)
    _close(geom.den, g.den, 1e-4)
    np.testing.assert_array_equal(geom.sid.numpy(), np.asarray(g.sid))


def test_fast_simulate_and_scatter2_match_jax(tiny):
    ctx, p, fast = tiny
    g, vs = p["geom"], tuple(ctx.vol_shape)
    geom = convert.fast_geom(g.xp, g.valid, g.sume, g.sid, g.den, vs,
                             len(ctx.fast.terms), "cpu")
    mask = np.ones(vs, np.float32)
    mask[:3] = 0.0  # a masked slab exercises den and the output mask
    rng = np.random.default_rng(7)
    vol = rng.uniform(10, 100, vs).astype(np.float32)
    ref = jpf.fast_simulate(ctx.fast, g, jnp.asarray(vol), jnp.asarray(mask),
                            vs)
    out = psf_fast.fast_simulate(fast, geom, torch.from_numpy(vol),
                                 torch.from_numpy(mask), vs)
    for o, r in zip(out[:2], ref[:2]):
        _close(o, r, 1e-4)
    np.testing.assert_array_equal(out[2].numpy(), np.asarray(ref[2]))

    gate = np.asarray(g.valid) & (np.asarray(g.sume) > 0)
    pa = np.where(gate, rng.uniform(-1, 1, gate.shape), 0).astype(np.float32)
    pb = np.where(gate, rng.uniform(0, 1, gate.shape), 0).astype(np.float32)
    ref = jpf.fast_scatter2(ctx.fast, g, jnp.asarray(pa), jnp.asarray(pb),
                            jnp.asarray(mask), vs)
    out = psf_fast.fast_scatter2(fast, geom, torch.from_numpy(pa),
                                 torch.from_numpy(pb),
                                 torch.from_numpy(mask), vs)
    for o, r in zip(out, ref):
        _close(o, r, 1e-4)

