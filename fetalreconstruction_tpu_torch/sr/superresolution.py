"""Super-resolution update + edge-preserving adaptive regularisation.

Port of fetalreconstruction_tpu/sr/superresolution.py:33-171: the exact
engine's residual scatter `sr_accumulate` (SuperresolutionKernel3D_tex,
reconstruction_cuda2.cu:408-520, through ops.psf.psf_scatter; the fast
engine scatters through ops.psf_fast.fast_scatter2), the non-adaptive
addon /= cmap step with intensity clamping (irtkReconstructionGPU.cc:
4080-4102) and AdaptiveRegularization passes 1+2 (.cc:4265-4430), a
13-direction edge-preserving weighted diffusion with confidence-map
weighting.

Out-of-bounds neighbour terms vanish like the reference's bounds checks
because shifts zero-fill.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..em.robust import corrected_slice
from ..ops import psf as psf_ops

DIRECTIONS = np.array([
    [1, 0, -1], [0, 1, -1], [1, 1, -1], [1, -1, -1],
    [1, 0, 0], [0, 1, 0], [1, 1, 0], [1, -1, 0],
    [1, 0, 1], [0, 1, 1], [1, 1, 1], [1, -1, 1],
    [0, 0, 1]], dtype=np.int32)
FACTORS = (1.0 / np.abs(DIRECTIONS).sum(axis=1)).astype(np.float64)


def smoothing_parameters(delta: float, lambda_user: float):
    """The reference's SetSmoothingParameters
    (irtkReconstructionGPU.h:605-612): (alpha, lambda_eff) with
    lambda_eff = lambda*delta^2 and alpha = min(0.05/lambda, 1)."""
    alpha = min(0.05 / lambda_user, 1.0)
    return alpha, lambda_user * delta * delta


def shift3d(arr: torch.Tensor, d: Sequence[int]) -> torch.Tensor:
    """arr shifted so that out[z,y,x] = arr[z+dz, y+dy, x+dx], zero-filled.

    d = (dx, dy, dz) in (x, y, z) order; arr is [z, y, x].
    """
    dx, dy, dz = int(d[0]), int(d[1]), int(d[2])
    out = torch.zeros_like(arr)
    src, dst = [], []
    for s, n in ((dz, arr.shape[0]), (dy, arr.shape[1]), (dx, arr.shape[2])):
        src.append(slice(max(s, 0), n + min(s, 0)))
        dst.append(slice(max(-s, 0), n - max(s, 0)))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def _inbounds3d(shape_zyx, d, device) -> torch.Tensor:
    """Boolean field: voxel + d is inside the volume."""
    zs, ys, xs = shape_zyx
    dx, dy, dz = int(d[0]), int(d[1]), int(d[2])
    z = torch.arange(zs, device=device)[:, None, None]
    y = torch.arange(ys, device=device)[None, :, None]
    x = torch.arange(xs, device=device)[None, None, :]
    return ((x + dx >= 0) & (x + dx < xs) & (y + dy >= 0) & (y + dy < ys)
            & (z + dz >= 0) & (z + dz < zs))


def sr_accumulate(geom, offsets, sume, slices, valid, bias, scale,
                  weights, slice_weight, sim, mask_flat, vol_shape,
                  disable_bias: bool = False):
    """Scatter the residuals through the exact engine: returns (addon,
    cmap) as [z, y, x] volumes.  Residual = s e^-b scale - sim (0 where
    sim <= 0), payloads weighted by voxel weight x slice weight."""
    if disable_bias:
        s = slices * scale[:, None, None]
    else:
        s = corrected_slice(slices, bias, scale)
    resid = torch.where(sim > 0.0, s - sim, 0.0)
    wfac = weights * slice_weight[:, None, None]
    gate = valid & (sume > 0.0)
    addon, cmap = psf_ops.psf_scatter(
        geom, offsets, sume, [torch.where(gate, resid * wfac, 0.0),
                              torch.where(gate, wfac, 0.0)],
        mask_flat, vol_shape)
    return addon.reshape(vol_shape), cmap.reshape(vol_shape)


def apply_addon(recon, addon, cmap, alpha, min_intensity, max_intensity,
                adaptive: bool = False):
    """recon += alpha * addon (addon /= cmap first if non-adaptive), clamp
    to [0.9*min, 1.1*max] (.cc:4080-4102).  Returns (recon, cmap_out)."""
    if not adaptive:
        pos = cmap > 0
        addon = torch.where(pos, addon / torch.where(pos, cmap, 1.0), addon)
        cmap = torch.where(pos, 1.0, cmap)
    recon = recon + alpha * addon
    recon = torch.clamp(recon, 0.9 * min_intensity, 1.1 * max_intensity)
    return recon, cmap


def adaptive_regularization(recon, original, cmap, alpha, lambda_, delta):
    """13-direction edge-preserving regularisation (both passes).

    recon: volume AFTER the addon update; original: volume BEFORE (the
    reference passes `original` to pass 1 and the post-addon volume to
    pass 2 as `original2`).
    """
    shape = tuple(recon.shape)
    dev = recon.device
    # pass 1: b[i] = factor/sqrt(1 + diff^2), diff from `original`
    bs = []
    for i, d in enumerate(DIRECTIONS):
        f = float(FACTORS[i])
        o_sh = shift3d(original, d)
        c_sh = shift3d(cmap, d)
        inb = _inbounds3d(shape, d, dev)
        diff = (o_sh - original) * float(np.sqrt(f)) / delta
        bs.append(torch.where(inb & (cmap > 0) & (c_sh > 0),
                              f / torch.sqrt(1.0 + diff * diff), 0.0))

    # pass 2 operates on the post-addon volume
    original2 = recon
    val = torch.zeros_like(recon)
    valw = torch.zeros_like(recon)
    ssum = torch.zeros_like(recon)
    for i, d in enumerate(DIRECTIONS):
        nd = [-int(x) for x in d]
        inb_p = _inbounds3d(shape, d, dev)
        inb_m = _inbounds3d(shape, nd, dev)
        o_p = shift3d(original2, d)
        c_p = shift3d(cmap, d)
        val = val + torch.where(inb_p, bs[i] * o_p * c_p, 0.0)
        valw = valw + torch.where(inb_p, bs[i] * c_p, 0.0)
        ssum = ssum + torch.where(inb_p, bs[i], 0.0)
        b_m = shift3d(bs[i], nd)
        o_m = shift3d(original2, nd)
        c_m = shift3d(cmap, nd)
        val = val + torch.where(inb_m, b_m * o_m * c_m, 0.0)
        valw = valw + torch.where(inb_m, b_m * c_m, 0.0)
        ssum = ssum + torch.where(inb_m, b_m, 0.0)

    val = val - ssum * original2 * cmap
    valw = valw - ssum * cmap
    reg = alpha * lambda_ / (delta * delta)
    val = original2 * cmap + reg * val
    valw = cmap + reg * valw
    pos = valw > 0
    return torch.where(pos, val / torch.where(pos, valw, 1.0), 0.0)


def equalize(recon_num, vol_weights):
    """Divide the PSF-accumulated volume by the volume weights
    (equalizeVol)."""
    ok = vol_weights > 0
    return torch.where(ok, recon_num / torch.where(ok, vol_weights, 1.0),
                       recon_num)


def mask_volume(recon, mask):
    """Outside-mask voxels -> -1 (MaskVolume, .cc:5325)."""
    return torch.where(mask == 0, -1.0, recon)
