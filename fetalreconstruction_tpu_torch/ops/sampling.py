"""Interpolation and resampling on tensors.

Port of fetalreconstruction_tpu/ops/sampling.py:25-185 (the reference's
irtkLinearInterpolateImageFunction, irtkResampling and
irtkResamplingWithPadding):

- trilinear weights from floor / fraction, corners summed in the JAX
  order (x outer, z inner);
- padding rule: a corner counts if it is in bounds and != padding; the
  output is the renormalised sum if fewer than 4 in-bounds corners equal
  padding and the weight is positive, else the padding value;
- nearest neighbour rounds half to even (`torch.round`, as `jnp.round`).

Volumes are [z, y, x]; points are (x, y, z) continuous voxel indices.  The
samplers also take a batch of volumes (M, Z, Y, X) with points (M, ..., 3),
each point reading its own volume (the JAX package vmaps instead).  There
is no jit wrapper: PyTorch runs eagerly.
"""
from __future__ import annotations

import numpy as np
import torch


def _flat_gather(vol, ix, iy, iz):
    """vol[z, y, x] at integer index tensors (clamped).  vol is (Z, Y, X),
    or (M, Z, Y, X) with index tensors shaped (M, ...)."""
    zs, ys, xs = vol.shape[-3:]
    lin = (torch.clamp(iz, 0, zs - 1) * (ys * xs)
           + torch.clamp(iy, 0, ys - 1) * xs + torch.clamp(ix, 0, xs - 1))
    if vol.ndim == 4:
        m = vol.shape[0]
        off = torch.arange(m, device=vol.device) * (zs * ys * xs)
        lin = lin + off.reshape((m,) + (1,) * (lin.ndim - 1))
    return vol.reshape(-1)[lin]


def _floors(pts):
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    u, v, w = torch.floor(x), torch.floor(y), torch.floor(z)
    return (x - u, y - v, z - w, u.to(torch.int64), v.to(torch.int64),
            w.to(torch.int64))


def sample_linear(vol, pts, padding=0.0):
    """Plain trilinear sampling; out-of-bounds corners read `padding`.

    vol: (Z, Y, X) or (M, Z, Y, X); pts: (..., 3) in (x, y, z) voxels.
    """
    zs, ys, xs = vol.shape[-3:]
    dx, dy, dz, u, v, w = _floors(pts)
    out = torch.zeros_like(dx)
    wsum = torch.zeros_like(dx)
    for du in (0, 1):
        for dv in (0, 1):
            for dw in (0, 1):
                wgt = ((dx if du else 1 - dx) * (dy if dv else 1 - dy)
                       * (dz if dw else 1 - dz))
                iu, iv, iw = u + du, v + dv, w + dw
                inb = ((iu >= 0) & (iu < xs) & (iv >= 0) & (iv < ys)
                       & (iw >= 0) & (iw < zs))
                val = _flat_gather(vol, iu, iv, iw)
                out = out + torch.where(inb, wgt * val, 0.0)
                wsum = wsum + torch.where(inb, wgt, 0.0)
    return torch.where(wsum > 0.999999, out,
                       torch.where(wsum > 0, out + (1 - wsum) * padding,
                                   padding))


def sample_linear_padded(vol, pts, padding=-1.0):
    """Padding-aware trilinear sampling (irtkResamplingWithPadding rule).

    `padding` is a number, or a tensor that broadcasts against pts[..., 0]
    (one value per volume of a batch).
    """
    zs, ys, xs = vol.shape[-3:]
    dx, dy, dz, u, v, w = _floors(pts)
    val_sum = torch.zeros_like(dx)
    wgt_sum = torch.zeros_like(dx)
    pad_count = torch.zeros(dx.shape, dtype=torch.int32, device=dx.device)
    for du in (0, 1):
        for dv in (0, 1):
            for dw in (0, 1):
                wgt = ((dx if du else 1 - dx) * (dy if dv else 1 - dy)
                       * (dz if dw else 1 - dz))
                iu, iv, iw = u + du, v + dv, w + dw
                inb = ((iu >= 0) & (iu < xs) & (iv >= 0) & (iv < ys)
                       & (iw >= 0) & (iw < zs))
                val = _flat_gather(vol, iu, iv, iw)
                is_pad = inb & (val == padding)
                use = inb & (val != padding)
                val_sum = val_sum + torch.where(use, wgt * val, 0.0)
                wgt_sum = wgt_sum + torch.where(use, wgt, 0.0)
                pad_count = pad_count + is_pad.to(torch.int32)
    ok = (pad_count < 4) & (wgt_sum > 0)
    pad = torch.as_tensor(padding, dtype=dx.dtype, device=dx.device)
    return torch.where(ok, val_sum / torch.where(wgt_sum > 0, wgt_sum, 1.0),
                       pad)


def sample_nearest(vol, pts, padding=0.0):
    """Nearest-neighbour sampling (round half to even); out-of-bounds ->
    padding."""
    zs, ys, xs = vol.shape[-3:]
    ix = torch.round(pts[..., 0]).to(torch.int64)
    iy = torch.round(pts[..., 1]).to(torch.int64)
    iz = torch.round(pts[..., 2]).to(torch.int64)
    inb = ((ix >= 0) & (ix < xs) & (iy >= 0) & (iy < ys)
           & (iz >= 0) & (iz < zs))
    return torch.where(inb, _flat_gather(vol, ix, iy, iz), padding)


def grid_points(shape_zyx, dtype=torch.float32, device=None):
    """(Z*Y*X, 3) grid of (x, y, z) voxel indices for a [z, y, x] volume."""
    zs, ys, xs = shape_zyx
    z, y, x = torch.meshgrid(
        torch.arange(zs, dtype=dtype, device=device),
        torch.arange(ys, dtype=dtype, device=device),
        torch.arange(xs, dtype=dtype, device=device), indexing="ij")
    return torch.stack([x, y, z], dim=-1).reshape(-1, 3)


def resample_to_grid(src_vol, src_w2i, dst_shape_zyx, dst_i2w,
                     interp="linear", padding=0.0, source_padding=None):
    """Resample src_vol into a destination grid.

    src_w2i / dst_i2w: 4x4 matrices (numpy or tensors; compose a rigid
    transform into them for transformed resampling).  Computes on
    src_vol's device.  As in the JAX version, m = src_w2i @ dst_i2w is
    formed in the volume's dtype (float32) from the two matrices cast to
    it, never in float64: nearest-neighbour resampling rounds at .5, and a
    float64 product flips mask voxels against the reference.

    interp="bspline" is the cubic B-spline interpolator
    (irtkBSplineInterpolateImageFunction), a one-shot host-side prep step
    that runs through scipy as in the JAX version.
    """
    dst = tuple(int(s) for s in dst_shape_zyx)
    if str(interp) == "bspline":
        from scipy import ndimage
        m = (np.asarray(_np(src_w2i), np.float64)
             @ np.asarray(_np(dst_i2w), np.float64))
        pts = np.asarray(grid_points(dst).numpy(), np.float64)
        spts = pts @ m[:3, :3].T + m[:3, 3]
        out = ndimage.map_coordinates(
            np.asarray(_np(src_vol), np.float64), spts[:, ::-1].T, order=3,
            mode="constant", cval=float(padding), prefilter=True)
        return torch.as_tensor(out.reshape(dst).astype(np.float32),
                               device=src_vol.device)
    dev, dt = src_vol.device, src_vol.dtype
    m = (torch.as_tensor(src_w2i, device=dev).to(dt)
         @ torch.as_tensor(dst_i2w, device=dev).to(dt))
    pts = grid_points(dst, dtype=dt, device=dev)
    spts = pts @ m[:3, :3].T + m[:3, 3]
    if interp == "linear":
        if source_padding is not None:
            out = sample_linear_padded(src_vol, spts,
                                       padding=float(source_padding))
        else:
            out = sample_linear(src_vol, spts, padding=float(padding))
    elif interp == "nn":
        out = sample_nearest(src_vol, spts, padding=float(padding))
    else:
        raise ValueError(interp)
    return out.reshape(dst)


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)
