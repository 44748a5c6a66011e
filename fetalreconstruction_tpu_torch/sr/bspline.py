"""Multi-level B-spline scattered-data reconstruction (alternative path).

Port of fetalreconstruction_tpu/sr/bspline.py, the capability of
irtkBSplineReconstruction (irtkBSplineReconstruction.cc, header API at
:76): fit a smooth volume to the scattered motion-corrected slice samples
by multilevel cubic B-spline approximation (Lee / Wolberg / Shin BA / MBA):

- level 0 fits a coarse control lattice to the scattered (position, value)
  samples with the closed-form weighted-BA update
  phi_c = sum_p w_c(p)^2 v_p / sum_p w_c(p)^2 over the 4^3 support;
- each finer level halves the control spacing and fits the residuals;
- the volume is the sum of the level evaluations on the recon grid.

Not on the main SVR path (as in the reference): run_svr's --bspline writes
it beside the reconstruction.  The lattice scatter is `index_add_` over the
in-bounds support entries (float atomics on CUDA, so the sums vary from run
to run in the last bits); the grid evaluation is three float32 matrix
products.  XLA flushes float32 subnormals to zero and torch keeps them (on
the CPU and on CUDA), so the lattice weights w^2 and w^3 and their payload
w^3 v are flushed below the smallest normal float32 here: a control point
reached only by subnormal weights stays empty (0), as in JAX, instead of
taking the full value of a vanishing fit.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops.psf import flush_subnormals as _ftz


def _bspline_w(t):
    """Cubic B-spline basis values for offsets -1..2 given fraction t."""
    t2 = t * t
    t3 = t2 * t
    return (
        (1 - t) ** 3 / 6.0,
        (3 * t3 - 6 * t2 + 4) / 6.0,
        (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0,
        t3 / 6.0,
    )


def _lattice(grid_shape, spacing) -> Tuple[int, int, int]:
    zs, ys, xs = grid_shape
    return (int(np.ceil(zs / spacing)) + 3, int(np.ceil(ys / spacing)) + 3,
            int(np.ceil(xs / spacing)) + 3)


def _cell(pts, spacing):
    """Per point: lattice cell (iu, iv, iw) int32 and basis weights."""
    u, v, w = (pts[:, k] / spacing for k in range(3))
    iu, iv, iw = (torch.floor(a).to(torch.int32) for a in (u, v, w))
    return (iu, iv, iw), (_bspline_w(u - iu), _bspline_w(v - iv),
                          _bspline_w(w - iw))


def _fit_level(pts, vals, grid_shape, spacing):
    """One BA fit: scattered pts (M, 3) in voxel coords -> the control
    lattice (nz, ny, nx) at control spacing `spacing` voxels."""
    nz, ny, nx = _lattice(grid_shape, spacing)
    (iu, iv, iw), (bu, bv, bw) = _cell(pts, spacing)
    num = torch.zeros(nz * ny * nx, dtype=torch.float32, device=pts.device)
    den = torch.zeros_like(num)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                wt = bu[a] * bv[b] * bw[c]
                cx, cy, cz = iu + a, iv + b, iw + c
                inb = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                       & (cz >= 0) & (cz < nz))
                lin = (cz * ny * nx + cy * nx + cx)[inb].long()
                w3 = _ftz(_ftz(wt * wt) * wt)[inb]
                num.index_add_(0, lin, _ftz(w3 * vals[inb]))
                den.index_add_(0, lin, w3)
    ctrl = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return ctrl.reshape(nz, ny, nx)


def _axis_matrix(n_vox, n_ctrl, spacing, device):
    """(n_vox, n_ctrl) float32 basis matrix of one axis (host numpy, as in
    JAX)."""
    rows = np.zeros((n_vox, n_ctrl), np.float32)
    for i in range(n_vox):
        u = i / spacing
        iu = int(np.floor(u))
        t = u - iu
        for a, wv in enumerate(_bspline_w(np.float64(t))):
            c = iu + a
            if 0 <= c < n_ctrl:
                rows[i, c] = float(wv)
    return torch.as_tensor(rows, device=device)


def _eval_level(ctrl, grid_shape, spacing):
    """Evaluate the control lattice on the full voxel grid (separable)."""
    zs, ys, xs = grid_shape
    nz, ny, nx = ctrl.shape
    dev = ctrl.device
    out = torch.einsum("xc,zyc->zyx", _axis_matrix(xs, nx, spacing, dev),
                       ctrl)
    out = torch.einsum("yc,zcx->zyx", _axis_matrix(ys, ny, spacing, dev),
                       out)
    return torch.einsum("zc,cyx->zyx", _axis_matrix(zs, nz, spacing, dev),
                        out)


def _eval_at_points(ctrl, pts, spacing):
    nz, ny, nx = ctrl.shape
    (iu, iv, iw), (bu, bv, bw) = _cell(pts, spacing)
    flat = ctrl.reshape(-1)
    out = torch.zeros(pts.shape[0], dtype=torch.float32, device=pts.device)
    for a in range(4):
        for b in range(4):
            for c in range(4):
                cx = torch.clamp(iu + a, 0, nx - 1)
                cy = torch.clamp(iv + b, 0, ny - 1)
                cz = torch.clamp(iw + c, 0, nz - 1)
                inb = ((iu + a >= 0) & (iu + a < nx) & (iv + b >= 0)
                       & (iv + b < ny) & (iw + c >= 0) & (iw + c < nz))
                val = flat[(cz * ny * nx + cy * nx + cx).long()]
                out = out + torch.where(inb, bu[a] * bv[b] * bw[c] * val,
                                        0.0)
    return out


def bspline_reconstruct(points, values, grid_shape: Tuple[int, int, int],
                        levels: int = 4, initial_spacing: float = 0.0, *,
                        device):
    """Fit a smooth volume to scattered samples on `device`.

    points: (M, 3) continuous voxel coordinates (x, y, z) on the recon
    grid; values: (M,).  Returns a [z, y, x] float32 volume.
    """
    zs, ys, xs = grid_shape
    if initial_spacing <= 0:
        initial_spacing = max(xs, ys, zs) / 4.0
    points = torch.as_tensor(np.asarray(points, np.float32), device=device)
    resid = torch.as_tensor(np.asarray(values, np.float32), device=device)
    out = torch.zeros(grid_shape, dtype=torch.float32, device=device)
    spacing = float(initial_spacing)
    for _ in range(levels):
        ctrl = _fit_level(points, resid, grid_shape, spacing)
        out = out + _eval_level(ctrl, grid_shape, spacing)
        resid = resid - _eval_at_points(ctrl, points, spacing)
        spacing = max(spacing / 2.0, 1.0)
    return out
