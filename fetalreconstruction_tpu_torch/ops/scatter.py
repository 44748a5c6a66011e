"""Transpose trilinear splat of the fast engine: plan, kernels B1 and B2.

Counterpart of fetalreconstruction_tpu/ops/pallas_scatter.py.  Each pixel
with floor index q adds its 8 trilinear corner weights x 2 payloads, one
16-vector, to ONE row of the parity-blocked accumulator (psf_fast.
_splat2_blocked's layout, (S*8*Bz*By*Bx, 16) f32, row
(((s*8 + par)*Bz + bz)*By + by)*Bx + bx), which B2 then un-blocks into
dense per-stack volumes.

- `build_scatter_plan` (geometry time, torch ops): drops out-of-support
  pixels, sorts the rest by accumulator row (stable, so pixels of one row
  stay in ascending order) and keeps a CSR of the touched rows.
- B1 `splat2_blocked(plan, a, b)`: CUDA kernel `frt_splat2_rows`
  (csrc/scatter.cu), one thread per touched row summing its run; no
  atomics, bitwise deterministic.  Plain version: `splat2_blocked_plain`.
- B2 `unblock2(acc, vol_shape)`: CUDA kernel `frt_unblock2`, one thread per
  dense voxel summing its 8 parity reads.  Plain version: `unblock2_plain`.

The TPU kernel's chunk schedule (CHUNK, BR), its BXP plane padding and its
val-major flush existed for the TPU's sequential grid and (8, 128) tiling
and are not carried over.

Dispatch: the plain version runs only for CPU tensors.  For CUDA tensors
the wrapper launches its kernel or raises; nothing switches this.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .. import _kernels

# launches of each kernel in this process (reset by the caller that reads
# them); the plain versions never count
LAUNCHES = {"splat2_rows": 0, "unblock2": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def block_dims(vol_shape) -> Tuple[int, int, int]:
    """(Bz, By, Bx): parity-block extents of a [z, y, x] volume."""
    zs, ys, xs = vol_shape
    return (zs + 3) // 2, (ys + 3) // 2, (xs + 3) // 2


def acc_rows(vol_shape, n_stacks: int) -> int:
    Bz, By, Bx = block_dims(vol_shape)
    return n_stacks * 8 * Bz * By * Bx


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


def _rows(xp, sid, vol_shape, n_stacks):
    """Flat accumulator row, in-support flag and corner weights per pixel.

    Out-of-support pixels (floor outside [-1, dim-1] on any axis) get
    inb=False and must be masked by the caller: the JAX scatter sends them
    to row -1 with mode="drop", which torch indexing does not accept.
    Floor parity uses two's complement, so ui = -1 gives sx = 1 and
    bx = 0, as in the JAX version.
    """
    if n_stacks < 1 or (sid is not None and sid.numel()
                        and int(sid.max()) >= n_stacks):
        raise ValueError(f"stack ids must lie in [0, {n_stacks})")
    zs, ys, xs = vol_shape
    Bz, By, Bx = block_dims(vol_shape)
    ui, vi, wi, wts = corner_weights(xp)
    inb = ((ui >= -1) & (ui < xs) & (vi >= -1) & (vi < ys)
           & (wi >= -1) & (wi < zs))
    sx, sy, sz = ui & 1, vi & 1, wi & 1
    bx, by, bz = (ui + sx) >> 1, (vi + sy) >> 1, (wi + sz) >> 1
    par = (sz << 2) | (sy << 1) | sx
    row = ((par * Bz + bz) * By + by) * Bx + bx
    if sid is not None:
        nd = row.ndim - 1
        row = row + sid.to(torch.int64).reshape(
            sid.shape + (1,) * nd) * (8 * Bz * By * Bx)
    return row.reshape(-1), inb.reshape(-1), wts.reshape(-1, 8)


def splat2_blocked_plain(xp, pay_a, pay_b, vol_shape, sid=None,
                         n_stacks: int = 1):
    """Plain PyTorch version of B1 (psf_fast._splat2_blocked).

    Returns the blocked accumulator (n_stacks, 8, Bz, By, Bx, 2, 2, 2, 2).
    """
    Bz, By, Bx = block_dims(vol_shape)
    row, inb, wts = _rows(xp, sid, vol_shape, n_stacks)
    upd = torch.stack([wts * pay_a.reshape(-1, 1), wts * pay_b.reshape(-1, 1)],
                      dim=-1).reshape(-1, 16)
    acc = torch.zeros((acc_rows(vol_shape, n_stacks), 16),
                      dtype=torch.float32, device=xp.device)
    acc.index_add_(0, row[inb], upd[inb])
    return acc.reshape(n_stacks, 8, Bz, By, Bx, 2, 2, 2, 2)


def unblock2_plain(acc, vol_shape):
    """Plain PyTorch version of B2 (psf_fast._unblock2, all stacks).

    acc: (S, 8, Bz, By, Bx, 2, 2, 2, 2) -> (S, 2, zs, ys, xs) with
    dense_s[2b + c] = blocks[b, c] and vol[i] += dense_s[i + s].
    """
    zs, ys, xs = vol_shape
    S, _, Bz, By, Bx = acc.shape[:5]
    out = torch.zeros((S, 2, zs, ys, xs), dtype=torch.float32,
                      device=acc.device)
    for p in range(8):
        szp, syp, sxp = (p >> 2) & 1, (p >> 1) & 1, p & 1
        dense = acc[:, p].permute(0, 1, 4, 2, 5, 3, 6, 7).reshape(
            S, 2 * Bz, 2 * By, 2 * Bx, 2)
        sl = dense[:, szp:szp + zs, syp:syp + ys, sxp:sxp + xs]
        out = out + sl.movedim(-1, 1)
    return out


class ScatterPlan(NamedTuple):
    """Geometry-time scatter schedule (rebuilt with the geometry).

    xp, sid:  the geometry's positions and stack ids (the plain version's
              inputs; kept by reference)
    pix:      (M,) i32   in-support pixel per slot, sorted by row; pixels
              of one row in ascending order
    wts:      (M, 8) f32 the slot's corner weights
    rows:     (T,) i64   touched accumulator rows, ascending
    row_ptr:  (T+1,) i64 slot run of rows[t] is row_ptr[t] .. row_ptr[t+1]
    """
    xp: torch.Tensor
    sid: Optional[torch.Tensor]
    vol_shape: Tuple[int, int, int]
    n_stacks: int
    pix: torch.Tensor
    wts: torch.Tensor
    rows: torch.Tensor
    row_ptr: torch.Tensor


def build_scatter_plan(xp, sid, vol_shape, n_stacks: int) -> ScatterPlan:
    """Sort in-support pixels by accumulator row and build the row CSR."""
    vol_shape = tuple(int(v) for v in vol_shape)
    row, inb, wts = _rows(xp, sid, vol_shape, n_stacks)
    if row.numel() >= 2 ** 31:
        raise ValueError("pixel count does not fit the plan's int32 index")
    keep = torch.nonzero(inb).squeeze(1)
    order = torch.argsort(row[keep], stable=True)
    pix = keep[order]
    rows, counts = torch.unique_consecutive(row[pix], return_counts=True)
    row_ptr = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                          device=xp.device)
    torch.cumsum(counts, 0, out=row_ptr[1:])
    return ScatterPlan(xp=xp, sid=sid, vol_shape=vol_shape,
                       n_stacks=int(n_stacks), pix=pix.to(torch.int32),
                       wts=wts[pix].contiguous(), rows=rows,
                       row_ptr=row_ptr)


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


def splat2_blocked(plan: ScatterPlan, pay_a, pay_b):
    """B1: blocked accumulator (S, 8, Bz, By, Bx, 2, 2, 2, 2) of the plan's
    pixels with payloads pay_a / pay_b (shaped like the geometry's pixels,
    zero at invalid pixels)."""
    if pay_a.device.type == "cpu":
        return splat2_blocked_plain(plan.xp, pay_a, pay_b, plan.vol_shape,
                                    plan.sid, plan.n_stacks)
    n_pix = plan.xp.numel() // 3
    if pay_a.numel() != n_pix or pay_b.numel() != n_pix:
        raise ValueError(f"payloads must have {n_pix} pixels, got "
                         f"{pay_a.numel()} and {pay_b.numel()}")
    f32, i32, i64 = torch.float32, torch.int32, torch.int64
    _require_cuda("splat2_blocked",
                  [pay_a, pay_b, plan.pix, plan.wts, plan.rows,
                   plan.row_ptr],
                  [f32, f32, i32, f32, i64, i64])
    if plan.wts.shape != (plan.pix.numel(), 8) or \
            plan.row_ptr.numel() != plan.rows.numel() + 1:
        raise ValueError("malformed scatter plan")
    Bz, By, Bx = block_dims(plan.vol_shape)
    out = torch.zeros((acc_rows(plan.vol_shape, plan.n_stacks), 16),
                      dtype=f32, device=pay_a.device)
    lib = _kernels.library()
    err = lib.frt_splat2_rows(
        plan.pix.data_ptr(), plan.wts.data_ptr(), plan.rows.data_ptr(),
        plan.row_ptr.data_ptr(), plan.rows.numel(), pay_a.data_ptr(),
        pay_b.data_ptr(), out.data_ptr(), _stream(out))
    _kernels.check(err, "frt_splat2_rows")
    LAUNCHES["splat2_rows"] += 1
    return out.view(plan.n_stacks, 8, Bz, By, Bx, 2, 2, 2, 2)


def unblock2(acc, vol_shape):
    """B2: blocked accumulator (S, 8, Bz, By, Bx, 2, 2, 2, 2) -> dense
    per-stack volumes (S, 2, zs, ys, xs)."""
    if acc.device.type == "cpu":
        return unblock2_plain(acc, vol_shape)
    zs, ys, xs = (int(v) for v in vol_shape)
    S = acc.shape[0]
    if acc.shape != (S, 8) + block_dims(vol_shape) + (2, 2, 2, 2):
        raise ValueError(f"accumulator shape {tuple(acc.shape)} does not "
                         f"match volume {vol_shape}")
    _require_cuda("unblock2", [acc], [torch.float32])
    out = torch.empty((S, 2, zs, ys, xs), dtype=torch.float32,
                      device=acc.device)
    lib = _kernels.library()
    err = lib.frt_unblock2(acc.data_ptr(), out.data_ptr(), S, zs, ys, xs,
                           _stream(out))
    _kernels.check(err, "frt_unblock2")
    LAUNCHES["unblock2"] += 1
    return out
