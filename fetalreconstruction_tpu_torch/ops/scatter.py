"""Transpose trilinear splat of the fast engine: plan and kernel.

Counterpart of fetalreconstruction_tpu/ops/pallas_scatter.py.  Each pixel
with floor index (u, v, w) adds its 8 trilinear corner weights times 2
payloads to the dense per-stack volumes (S, 2, zs, ys, xs) at the corners
(w + cw, v + cv, u + cu) that lie inside the grid: the function of the
JAX package's psf_fast._splat2_blocked followed by _unblock2.

- `build_scatter_plan` (geometry time, torch ops): drops out-of-support
  pixels (a floor outside [-1, dim - 1] on any axis), sorts the rest by
  floor cell (stable, so the pixels of one cell stay in ascending order)
  and keeps a CSR over all floor cells, (S, zs + 1, ys + 1, xs + 1) of
  them, cell (((s*(zs+1) + w+1)*(ys+1) + v+1)*(xs+1) + u+1).
- `splat2_dense(plan, a, b)`: CUDA kernel `frt_splat2_dense`
  (csrc/scatter.cu): a block sums the runs of its voxel tile's floor cells
  into shared memory, then one thread per voxel adds the totals of its 8
  cells; no atomics, bitwise deterministic.  Plain version:
  `splat2_dense_plain`.

The TPU's parity-blocked accumulator (8.3x the dense volumes), its chunk
schedule (CHUNK, BR), its BXP plane padding and its val-major flush
existed for the TPU's sequential grid and (8, 128) tiling and are not
carried over: a parity row (s, par, bz, by, bx) of that accumulator holds
the same pixels, in the same order, as the floor cell 2b - par on each
axis, so the kernel adds the same products in the same order.

Dispatch: the plain version runs only for CPU tensors.  For CUDA tensors
the wrapper launches its kernel or raises; nothing switches this.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _kernels

# launches of each kernel in this process (reset by the caller that reads
# them); the plain versions never count
LAUNCHES = {"splat2_dense": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def corner_weights(xp: torch.Tensor):
    """Floor indices + per-corner trilinear weights for (..., 3) positions.

    Returns (ui, vi, wi, wts): int64 floors and (..., 8) f32 weights in
    (cw, cv, cu) lexicographic corner order, each the product
    x-factor * y-factor * z-factor evaluated left to right (as the JAX
    version does, so the f32 weights agree bit for bit).
    """
    x, y, z = xp[..., 0], xp[..., 1], xp[..., 2]
    u, v, w = torch.floor(x), torch.floor(y), torch.floor(z)
    du, dv, dw = x - u, y - v, z - w
    wts = []
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                wts.append((du if cu else 1 - du) * (dv if cv else 1 - dv)
                           * (dw if cw else 1 - dw))
    return (u.to(torch.int64), v.to(torch.int64), w.to(torch.int64),
            torch.stack(wts, dim=-1))


def n_cells(vol_shape, n_stacks: int) -> int:
    """Floor cells of the plan: floors in [-1, dim - 1] on each axis."""
    zs, ys, xs = vol_shape
    return n_stacks * (zs + 1) * (ys + 1) * (xs + 1)


def _floors(xp, sid, vol_shape, n_stacks):
    """Per pixel (flattened): floors, stack id, in-support flag, weights.

    Out-of-support pixels (floor outside [-1, dim - 1] on any axis) get
    inb=False and must be masked by the caller: the JAX scatter sends them
    to row -1 with mode="drop", which torch indexing does not accept.
    """
    if n_stacks < 1 or (sid is not None and sid.numel()
                        and int(sid.max()) >= n_stacks):
        raise ValueError(f"stack ids must lie in [0, {n_stacks})")
    zs, ys, xs = vol_shape
    ui, vi, wi, wts = corner_weights(xp)
    inb = ((ui >= -1) & (ui < xs) & (vi >= -1) & (vi < ys)
           & (wi >= -1) & (wi < zs))
    if sid is None:
        s = torch.zeros_like(ui)
    else:
        s = sid.to(torch.int64).reshape(
            tuple(sid.shape) + (1,) * (ui.ndim - sid.ndim)).expand_as(ui)
    return (ui.reshape(-1), vi.reshape(-1), wi.reshape(-1), s.reshape(-1),
            inb.reshape(-1), wts.reshape(-1, 8))


def dense_index(s, wi, vi, ui, vol_shape, n_stacks: int):
    """(n, 16) int64 flat indices into the dense volumes (n_stacks, 2, zs,
    ys, xs) of n pixels' 8 corners (in corner_weights' order) for payload
    a, then payload b.  Corners outside the grid get an index past the
    end (at least n_stacks * 2 * zs * ys * xs, below total + nvox + 1)."""
    zs, ys, xs = vol_shape
    nvox = zs * ys * xs
    c = torch.arange(8, device=ui.device)
    z, y, x = wi[:, None] + (c >> 2), vi[:, None] + ((c >> 1) & 1), \
        ui[:, None] + (c & 1)
    inside = ((z >= 0) & (z < zs) & (y >= 0) & (y < ys)
              & (x >= 0) & (x < xs))
    lin = torch.where(inside, (s[:, None] * 2 * zs + z) * ys * xs
                      + y * xs + x, n_stacks * 2 * nvox)
    return torch.cat([lin, lin + nvox], dim=1)


def splat2_dense_plain(xp, pay_a, pay_b, vol_shape, sid=None,
                       n_stacks: int = 1):
    """Plain PyTorch version of splat2_dense (psf_fast._splat2_blocked +
    _unblock2 for every stack): per in-support pixel its 8 corner weights
    and dense indices (corners outside the grid land past the end, cut off
    after), one index_add_ per parity class of the floor (the kernel's
    par) into zeroed volumes, the 8 classes added in par order.  Within a
    class each voxel's updates come from one floor cell, added in pixel
    order (in sequence on the CPU), so the sums associate as the kernel's
    do.

    Returns (n_stacks, 2, zs, ys, xs)."""
    vol_shape = tuple(int(v) for v in vol_shape)
    ui, vi, wi, s, inb, wts = _floors(xp, sid, vol_shape, n_stacks)
    par = ((wi & 1) << 2) | ((vi & 1) << 1) | (ui & 1)
    a, b = pay_a.reshape(-1), pay_b.reshape(-1)
    out = torch.zeros((n_stacks, 2) + vol_shape, dtype=torch.float32,
                      device=xp.device)
    for p in range(8):
        keep = torch.nonzero(inb & (par == p)).squeeze(1)
        idx = dense_index(s[keep], wi[keep], vi[keep], ui[keep], vol_shape,
                          n_stacks)
        w = wts[keep]
        upd = torch.cat([w * a[keep, None], w * b[keep, None]], dim=1)
        out = out + dense_from_updates(idx, upd, vol_shape, n_stacks)
    return out


def dense_from_updates(idx, upd, vol_shape, n_stacks: int):
    """One index_add_ of the (n, 16) updates at dense_index's indices into
    zeroed volumes; returns (n_stacks, 2, zs, ys, xs)."""
    zs, ys, xs = vol_shape
    nvox = zs * ys * xs
    total = n_stacks * 2 * nvox
    out = torch.zeros(total + nvox + 1, dtype=torch.float32,
                      device=upd.device)
    out.index_add_(0, idx.reshape(-1), upd.reshape(-1))
    return out[:total].reshape(n_stacks, 2, zs, ys, xs)


class ScatterPlan(NamedTuple):
    """Geometry-time scatter schedule (rebuilt with the geometry).

    xp, sid:   the geometry's positions and stack ids (the plain version's
               inputs; kept by reference)
    pix:       (M,) i32   in-support pixel per slot, sorted by floor cell;
               pixels of one cell in ascending order
    wts:       (M, 8) f32 the slot's corner weights
    cell_ptr:  (n_cells + 1,) i32  the slots of floor cell c are
               cell_ptr[c] .. cell_ptr[c + 1]
    """
    xp: torch.Tensor
    sid: Optional[torch.Tensor]
    vol_shape: Tuple[int, int, int]
    n_stacks: int
    pix: torch.Tensor
    wts: torch.Tensor
    cell_ptr: torch.Tensor


def build_scatter_plan(xp, sid, vol_shape, n_stacks: int) -> ScatterPlan:
    """Sort in-support pixels by floor cell and build the cell CSR."""
    vol_shape = tuple(int(v) for v in vol_shape)
    zs, ys, xs = vol_shape
    ui, vi, wi, s, inb, wts = _floors(xp, sid, vol_shape, n_stacks)
    if ui.numel() >= 2 ** 31:
        raise ValueError("pixel count does not fit the plan's int32 index")
    cell = (((s * (zs + 1) + wi + 1) * (ys + 1) + vi + 1) * (xs + 1)
            + ui + 1)
    keep = torch.nonzero(inb).squeeze(1)
    order = torch.argsort(cell[keep], stable=True)
    pix = keep[order]
    counts = torch.bincount(cell[pix], minlength=n_cells(vol_shape,
                                                         n_stacks))
    cell_ptr = torch.zeros(counts.numel() + 1, dtype=torch.int32,
                           device=xp.device)
    cell_ptr[1:] = torch.cumsum(counts, 0)
    return ScatterPlan(xp=xp, sid=sid, vol_shape=vol_shape,
                       n_stacks=int(n_stacks), pix=pix.to(torch.int32),
                       wts=wts[pix].contiguous(), cell_ptr=cell_ptr)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _require_cuda(name, tensors, dtypes):
    dev = tensors[0].device
    for t, dt in zip(tensors, dtypes):
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor is not contiguous")
    if dev.type != "cuda":
        raise RuntimeError(f"{name}: no kernel for device {dev}")


def splat2_dense(plan: ScatterPlan, pay_a, pay_b):
    """Dense per-stack volumes (S, 2, zs, ys, xs) of the plan's pixels with
    payloads pay_a / pay_b (shaped like the geometry's pixels, zero at
    invalid pixels)."""
    if pay_a.device.type == "cpu":
        return splat2_dense_plain(plan.xp, pay_a, pay_b, plan.vol_shape,
                                  plan.sid, plan.n_stacks)
    n_pix = plan.xp.numel() // 3
    if pay_a.numel() != n_pix or pay_b.numel() != n_pix:
        raise ValueError(f"payloads must have {n_pix} pixels, got "
                         f"{pay_a.numel()} and {pay_b.numel()}")
    f32, i32 = torch.float32, torch.int32
    _require_cuda("splat2_dense",
                  [pay_a, pay_b, plan.pix, plan.wts, plan.cell_ptr],
                  [f32, f32, i32, f32, i32])
    zs, ys, xs = plan.vol_shape
    if plan.wts.shape != (plan.pix.numel(), 8) or \
            plan.cell_ptr.numel() != n_cells(plan.vol_shape,
                                             plan.n_stacks) + 1:
        raise ValueError("malformed scatter plan")
    out = torch.empty((plan.n_stacks, 2, zs, ys, xs), dtype=f32,
                      device=pay_a.device)
    lib = _kernels.library()
    err = lib.frt_splat2_dense(
        plan.pix.data_ptr(), plan.wts.data_ptr(), plan.cell_ptr.data_ptr(),
        pay_a.data_ptr(), pay_b.data_ptr(), out.data_ptr(), plan.n_stacks,
        zs, ys, xs, _stream(out))
    _kernels.check(err, "frt_splat2_dense")
    LAUNCHES["splat2_dense"] += 1
    return out
