"""Port's scatter plan and dense splat vs the JAX package.

The JAX side runs as tests/test_pallas_scatter.py runs it on the CPU: the
XLA scatter followed by its un-block (`psf_fast._splat2_blocked`,
`_unblock2`), and the two Pallas kernels in interpret mode
(`pallas_splat2_packed`, then `pallas_unblock`).  Limit: max|diff| <=
1e-5 * max|ref|, as in test_pallas_scatter.py — both sides add the same
f32 products, in another order.  The numpy walk of the CUDA kernel
(`_emulate_dense`) is held to the plain version at 1e-6 (the same
products; the plain version's per-parity index_add_ associates the sums
as the kernel does, so on the CPU the two agree bit for bit).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.ops import pallas_scatter as ps
from fetalreconstruction_tpu.ops import psf_fast as pf
from fetalreconstruction_tpu_torch.ops import scatter
from fetalreconstruction_tpu_torch.parallel import volume_sharded as vsd
from fetalreconstruction_tpu_torch.parallel.sharded import Mesh

SHAPES = [((20, 18, 16), 12, 10, 2), ((33, 33, 33), 7, 17, 1)]
SLABS = [2, 3]  # z-slabs of each SHAPES volume (each divides its z)
TOL = 1e-5
WALK_TOL = 1e-6


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


def _jax_dense(xp, pa, pb, vol, sid, n_stacks):
    """psf_fast._splat2_blocked then _unblock2, every stack."""
    blocked = pf._splat2_blocked(jnp.asarray(xp), jnp.asarray(pa),
                                 jnp.asarray(pb), vol, sid=jnp.asarray(sid),
                                 n_stacks=n_stacks)
    return np.stack([np.stack(pf._unblock2(blocked[s], vol))
                     for s in range(n_stacks)])


def _plan(xp, sid, vol, n_stacks):
    return scatter.build_scatter_plan(torch.from_numpy(xp),
                                      torch.from_numpy(sid).long(), vol,
                                      n_stacks)


def _plain(xp, pa, pb, vol, sid, n_stacks):
    return scatter.splat2_dense_plain(
        torch.from_numpy(xp), torch.from_numpy(pa), torch.from_numpy(pb),
        vol, torch.from_numpy(sid).long(), n_stacks).numpy()


def _emulate_dense(plan, pay_a, pay_b):
    """The CUDA kernel's walk over the plan, in numpy float32: each floor
    cell's run summed in plan order from 0 (per corner and payload), then
    per voxel the 8 run totals of its floor cells added in par order from
    0, the floor on each axis the one of {v - 1, v} with par's parity."""
    zs, ys, xs = plan.vol_shape
    S = plan.n_stacks
    pix = plan.pix.numpy().astype(np.int64)
    ptr = plan.cell_ptr.numpy().astype(np.int64)
    wts = plan.wts.numpy()
    a, b = pay_a.reshape(-1)[pix], pay_b.reshape(-1)[pix]
    prod = np.stack([wts * a[:, None], wts * b[:, None]], -1)  # (M, 8, 2)
    start, length = ptr[:-1], np.diff(ptr)
    tot = np.zeros((len(start), 8, 2), np.float32)
    for j in range(int(length.max(initial=0))):
        run = length > j
        tot[run] = tot[run] + prod[start[run] + j]
    s, z, y, x = np.meshgrid(np.arange(S), np.arange(zs), np.arange(ys),
                             np.arange(xs), indexing="ij")
    out = np.zeros((S, zs, ys, xs, 2), np.float32)
    for par in range(8):
        cw, cv, cu = (z ^ (par >> 2)) & 1, (y ^ (par >> 1)) & 1, (x ^ par) & 1
        cell = (((s * (zs + 1) + z + 1 - cw) * (ys + 1) + y + 1 - cv)
                * (xs + 1) + x + 1 - cu)
        out = out + tot[cell, (cw * 2 + cv) * 2 + cu]
    return np.moveaxis(out, -1, 1)


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_splat2_plain_matches_jax(vol, n, hw, n_stacks):
    """The dense plain version against the XLA splat + un-block."""
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    out = _plain(xp, pa, pb, vol, sid, n_stacks)
    assert out.shape == (n_stacks, 2) + vol
    _close(out, _jax_dense(xp, pa, pb, vol, sid, n_stacks))


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_splat2_plain_matches_pallas(vol, n, hw, n_stacks):
    """The dense plain version against the two Pallas kernels (interpret
    mode): pallas_splat2_packed, then pallas_unblock."""
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    out = _plain(xp, pa, pb, vol, sid, n_stacks)
    jplan = ps.build_scatter_plan(jnp.asarray(xp), jnp.asarray(sid), vol,
                                  n_stacks)
    vm = ps.pallas_splat2_packed(jplan, jnp.asarray(pa), jnp.asarray(pb),
                                 vol, n_stacks)
    _close(out, ps.pallas_unblock(vm, vol, n_stacks))


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_plan_cells(vol, n, hw, n_stacks):
    """The cell plan: slots in ascending cell order (pixel-ascending within
    a cell), cell_ptr a CSR over every floor cell ending at M, the
    in-support pixels exactly, int32 indices."""
    xp, sid, _, _ = _inputs(vol, n, hw, n_stacks)
    plan = _plan(xp, sid, vol, n_stacks)
    zs, ys, xs = vol
    assert plan.pix.dtype == torch.int32
    assert plan.cell_ptr.dtype == torch.int32
    ptr = plan.cell_ptr.numpy()
    assert len(ptr) == n_stacks * (zs + 1) * (ys + 1) * (xs + 1) + 1
    assert ptr[0] == 0 and ptr[-1] == plan.pix.numel()
    assert np.all(np.diff(ptr) >= 0)
    u = np.floor(xp.reshape(-1, 3)).astype(np.int64)
    inb = ((u[:, 0] >= -1) & (u[:, 0] < xs) & (u[:, 1] >= -1)
           & (u[:, 1] < ys) & (u[:, 2] >= -1) & (u[:, 2] < zs))
    pix = plan.pix.numpy().astype(np.int64)
    assert sorted(pix.tolist()) == np.nonzero(inb)[0].tolist()
    s = np.repeat(sid, hw * hw).astype(np.int64)[pix]
    q = u[pix] + 1
    cell = ((s * (zs + 1) + q[:, 2]) * (ys + 1) + q[:, 1]) * (xs + 1) + q[:, 0]
    assert np.all(np.diff(cell) >= 0)
    same = np.diff(cell) == 0
    assert np.all(np.diff(pix)[same] > 0)
    # each slot lies in its cell's run
    slot_cell = np.repeat(np.arange(len(ptr) - 1), np.diff(ptr))
    np.testing.assert_array_equal(slot_cell, cell)
    np.testing.assert_array_equal(
        plan.wts.numpy(), scatter.corner_weights(
            torch.from_numpy(xp.reshape(-1, 3)))[3].numpy()[pix])


@pytest.mark.parametrize("vol,n,hw,n_stacks", SHAPES)
def test_emulated_kernel_walk_matches(vol, n, hw, n_stacks):
    """The kernel's index walk (numpy) gives the plain version's volumes,
    bit for bit (both add in the kernel's order), and JAX's."""
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    walk = _emulate_dense(_plan(xp, sid, vol, n_stacks), pa, pb)
    plain = _plain(xp, pa, pb, vol, sid, n_stacks)
    _close(walk, plain, WALK_TOL)
    np.testing.assert_array_equal(walk, plain)
    _close(walk, _jax_dense(xp, pa, pb, vol, sid, n_stacks))


def test_negative_floor_parity_matches_jax():
    """ui = -1 (parity 1 in two's complement, block 0 of the TPU layout)
    must land in floor cell 0 and put its corner-1 weights on voxel 0, as
    the JAX version does."""
    vol = (6, 6, 6)
    xp = np.array([[[[-0.75, -0.25, 2.5], [5.5, -0.5, -0.9],
                     [0.25, 3.0, 4.99]]]], np.float32)  # (1, 1, 3, 3)
    sid = np.zeros(1, np.int32)
    pa = np.array([[[1.0, 2.0, 3.0]]], np.float32)
    pb = np.array([[[0.5, -1.0, 4.0]]], np.float32)
    ref = _jax_dense(xp, pa, pb, vol, sid, 1)
    out = _plain(xp, pa, pb, vol, sid, 1)
    np.testing.assert_array_equal(out != 0, ref != 0)
    _close(out, ref)
    plan = _plan(xp, sid, vol, 1)
    _close(_emulate_dense(plan, pa, pb), ref)
    # pixel 0 (floor (-1, -1, 2)) sits in cell (3, 0, 0), pixel 1 (floor
    # (5, -1, -1)) in (0, 0, 6), pixel 2 (floor (0, 3, 4)) in (5, 4, 1)
    ptr = plan.cell_ptr.numpy()
    for p, (cz, cy, cx) in enumerate([(3, 0, 0), (0, 0, 6), (5, 4, 1)]):
        c = (cz * 7 + cy) * 7 + cx
        assert ptr[c + 1] - ptr[c] == 1
        assert plan.pix[ptr[c]].item() == p


@pytest.mark.parametrize("case,n_slabs", zip(SHAPES, SLABS))
def test_slab_plans_match_full_volume(case, n_slabs):
    """volume_sharded._slab_plan on each slab's (lz + 1, ys, xs) volume:
    the slabs' pixels partition the in-support ones, and their volumes,
    each at its slab's rows (the top plane on the next slab's first),
    add up to the full volume's (plain version and the kernel's walk)."""
    vol, n, hw, n_stacks = case
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    zs, ys, xs = vol
    lz = zs // n_slabs
    full = _plain(xp, pa, pb, vol, sid, n_stacks)
    xp_t, sid_t = torch.from_numpy(xp), torch.from_numpy(sid).long()
    plain = np.zeros((n_stacks, 2, zs + 1, ys, xs), np.float32)
    walk = np.zeros_like(plain)
    owned = []
    for r in range(n_slabs):
        mesh = Mesh(group=None, rank=r, size=n_slabs,
                    device=torch.device("cpu"))
        plan = vsd._slab_plan(xp_t, sid_t, vol, lz, n_stacks, mesh)
        assert plan.vol_shape == (lz + 1, ys, xs)
        owned += plan.pix.tolist()
        rows = slice(r * lz, (r + 1) * lz + 1)
        plain[:, :, rows] += scatter.splat2_dense(
            plan, torch.from_numpy(pa), torch.from_numpy(pb)).numpy()
        walk[:, :, rows] += _emulate_dense(plan, pa, pb)
    full_plan = _plan(xp, sid, vol, n_stacks)
    assert sorted(owned) == sorted(full_plan.pix.tolist())
    _close(plain[:, :, :zs], full)
    _close(walk[:, :, :zs], full)


def test_cpu_dispatch_runs_plain_and_counts_nothing():
    vol, n, hw, n_stacks = SHAPES[0]
    xp, sid, pa, pb = _inputs(vol, n, hw, n_stacks)
    plan = _plan(xp, sid, vol, n_stacks)
    before = dict(scatter.LAUNCHES)
    dense = scatter.splat2_dense(plan, torch.from_numpy(pa),
                                 torch.from_numpy(pb))
    assert scatter.LAUNCHES == before
    assert torch.equal(dense, torch.from_numpy(
        _plain(xp, pa, pb, vol, sid, n_stacks)))
