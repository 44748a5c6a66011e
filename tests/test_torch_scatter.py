"""Port's scatter plan, B1 and B2 vs the JAX package.

The JAX side runs as tests/test_pallas_scatter.py runs it on the CPU: the
XLA scatter (`psf_fast._splat2_blocked`, `_unblock2`) and the Pallas
kernels in interpret mode.  Limit: max|diff| <= 1e-5 * max|ref|, as in
test_pallas_scatter.py — both sides add the same f32 products, in another
order.  The blocked level is compared only with the SAME xp on both sides
(a floor() flip would move a pixel to another parity row).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.ops import pallas_scatter as ps
from fetalreconstruction_tpu.ops import psf_fast as pf
from fetalreconstruction_tpu_torch.ops import scatter

SHAPES = [((20, 18, 16), 12, 10, 2), ((33, 33, 33), 7, 17, 1)]
TOL = 1e-5


def _close(out, ref, tol=TOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    scale = max(np.abs(ref).max(), 1e-6)
    err = np.abs(out - ref).max() / scale
    assert err <= tol, err


def _inputs(vol, n, hw, n_stacks):
    """Positions spanning in/out of bounds (incl. the -1 halo) and
    payloads zeroed at out-of-support pixels (the engine's contract)."""
    rng = np.random.default_rng(3)
    xp = rng.uniform(-2.0, max(vol) + 1.0, (n, hw, hw, 3)).astype(np.float32)
    sid = rng.integers(0, n_stacks, (n,)).astype(np.int32)
    pay_a = rng.uniform(-1, 1, (n, hw, hw)).astype(np.float32)
    pay_b = rng.uniform(0, 1, (n, hw, hw)).astype(np.float32)
    zs, ys, xs = vol
    u = np.floor(xp).astype(np.int64)
    inb = ((u[..., 0] >= -1) & (u[..., 0] < xs) & (u[..., 1] >= -1)
           & (u[..., 1] < ys) & (u[..., 2] >= -1) & (u[..., 2] < zs))
    return xp, sid, np.where(inb, pay_a, 0), np.where(inb, pay_b, 0)


def _emulate_b1(plan, pay_a, pay_b):
    """B1's loop over the plan, in numpy: each touched row sums its run."""
    pix = plan.pix.numpy().astype(np.int64)
    wts = plan.wts.numpy()
    a, b = pay_a.reshape(-1)[pix], pay_b.reshape(-1)[pix]
    upd = np.stack([wts * a[:, None], wts * b[:, None]], -1).reshape(-1, 16)
    out = np.zeros((scatter.acc_rows(plan.vol_shape, plan.n_stacks), 16),
                   np.float32)
    ptr = plan.row_ptr.numpy()
    if len(pix):
        out[plan.rows.numpy()] = np.add.reduceat(upd, ptr[:-1], axis=0)
    Bz, By, Bx = scatter.block_dims(plan.vol_shape)
    return out.reshape(plan.n_stacks, 8, Bz, By, Bx, 2, 2, 2, 2)


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_splat2_plain_matches_jax(vol, n, hw, n_stacks):
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    ref = pf._splat2_blocked(jnp.asarray(xp), jnp.asarray(pa),
                             jnp.asarray(pb), vol, sid=jnp.asarray(sid),
                             n_stacks=n_stacks)
    out = scatter.splat2_blocked_plain(
        torch.from_numpy(xp), torch.from_numpy(pa), torch.from_numpy(pb),
        vol, torch.from_numpy(sid), n_stacks)
    _close(out, ref)
    # and against the Pallas kernel (interpret mode), blocked level
    jplan = ps.build_scatter_plan(jnp.asarray(xp), jnp.asarray(sid), vol,
                                  n_stacks)
    pal = ps.pallas_splat2_blocked(jplan, jnp.asarray(pa), jnp.asarray(pb),
                                   vol, n_stacks)
    _close(out, pal)


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_plan_drives_b1_to_jax_result(vol, n, hw, n_stacks):
    """The plan as B1 consumes it (CSR of touched rows, sorted runs) gives
    the JAX blocked accumulator; out-of-support pixels are dropped."""
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    plan = scatter.build_scatter_plan(torch.from_numpy(xp),
                                      torch.from_numpy(sid).long(), vol,
                                      n_stacks)
    rows = plan.rows.numpy()
    assert np.all(np.diff(rows) > 0)
    assert plan.row_ptr[-1].item() == plan.pix.numel()
    u = np.floor(xp.reshape(-1, 3)).astype(np.int64)
    zs, ys, xs = vol
    inb = ((u[:, 0] >= -1) & (u[:, 0] < xs) & (u[:, 1] >= -1)
           & (u[:, 1] < ys) & (u[:, 2] >= -1) & (u[:, 2] < zs))
    assert sorted(plan.pix.tolist()) == np.nonzero(inb)[0].tolist()
    ref = pf._splat2_blocked(jnp.asarray(xp), jnp.asarray(pa),
                             jnp.asarray(pb), vol, sid=jnp.asarray(sid),
                             n_stacks=n_stacks)
    _close(_emulate_b1(plan, pa, pb), ref)


def test_negative_floor_parity_matches_jax():
    """ui = -1 must give parity 1 and block 0 on both sides (floor parity
    in two's complement), landing in the same blocked cells."""
    vol = (6, 6, 6)
    xp = np.array([[[[-0.75, -0.25, 2.5], [5.5, -0.5, -0.9],
                     [0.25, 3.0, 4.99]]]], np.float32)  # (1, 1, 3, 3)
    pa = np.array([[[1.0, 2.0, 3.0]]], np.float32)
    pb = np.array([[[0.5, -1.0, 4.0]]], np.float32)
    ref = pf._splat2_blocked(jnp.asarray(xp), jnp.asarray(pa),
                             jnp.asarray(pb), vol)
    out = scatter.splat2_blocked_plain(torch.from_numpy(xp),
                                       torch.from_numpy(pa),
                                       torch.from_numpy(pb), vol)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_unblock2_plain_matches_jax(vol, n, hw, n_stacks):
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    blocked = pf._splat2_blocked(jnp.asarray(xp), jnp.asarray(pa),
                                 jnp.asarray(pb), vol, sid=jnp.asarray(sid),
                                 n_stacks=n_stacks)
    out = scatter.unblock2_plain(torch.from_numpy(np.array(blocked)), vol)
    ref = np.stack([np.stack(pf._unblock2(blocked[s], vol))
                    for s in range(n_stacks)])
    _close(out, ref)
    # dense level against the two Pallas kernels (interpret mode)
    jplan = ps.build_scatter_plan(jnp.asarray(xp), jnp.asarray(sid), vol,
                                  n_stacks)
    vm = ps.pallas_splat2_packed(jplan, jnp.asarray(pa), jnp.asarray(pb),
                                 vol, n_stacks)
    _close(out, ps.pallas_unblock(vm, vol, n_stacks))


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    vol, n, hw, n_stacks = SHAPES[0]
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    xp_t, sid_t = torch.from_numpy(xp), torch.from_numpy(sid).long()
    plan = scatter.build_scatter_plan(xp_t, sid_t, vol, n_stacks)
    before = dict(scatter.LAUNCHES)
    acc = scatter.splat2_blocked(plan, torch.from_numpy(pa),
                                 torch.from_numpy(pb))
    dense = scatter.unblock2(acc, vol)
    assert scatter.LAUNCHES == before
    ref = scatter.splat2_blocked_plain(xp_t, torch.from_numpy(pa),
                                       torch.from_numpy(pb), vol, sid_t,
                                       n_stacks)
    assert torch.equal(acc, ref)
    assert torch.equal(dense, scatter.unblock2_plain(ref, vol))
