"""Synthetic SVR problems.

`motion_problem` is the end-to-end problem (ground truth, mask and
motion-corrupted stacks, numpy) and `psnr_vs_truth` its quality measure;
see their docstrings.  `canonical_problem` builds the reconstruction
core's inputs on a given device, with the same construction as the JAX
package's bench (bench.py:33-85), the shape
class of the reference's bundled 4-stack 3T run: 4 stacks x 42 slices of
144^2 pixels at 1.25 mm in-plane and 5 mm thick, reconstructed on a 160^3
grid at 1.0 mm, PSF support <= 12; stack rotations (0, 90 deg about x,
90 deg about y, 45/45 deg) and slice origins as there; slice intensities
uniform in [LOW, HIGH) = [100, 700) from `numpy.random.default_rng(seed)`;
all pixels valid, identity transforms, an all-ones mask.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..core.geometry import ImageAttributes, rigid_matrix
from ..ops import psf as psf_ops
from ..ops.psf_fast import FastPSF
from .svr_core import SVRContext

LOW, HIGH = 100.0, 700.0  # slice intensity range, also the EM's min / max
ROTATIONS = [[0, 0, 0, 0, 0, 0], [0, 0, 0, 90, 0, 0], [0, 0, 0, 0, 90, 0],
             [0, 0, 0, 45, 45, 0]]


class Problem(NamedTuple):
    ctx: SVRContext
    recon_w2i: torch.Tensor   # (4, 4)
    slice_i2w: torch.Tensor   # (N, 4, 4)
    transforms: torch.Tensor  # (N, 4, 4)
    slices: torch.Tensor      # (N, H, W) f32
    valid: torch.Tensor       # (N, H, W) bool
    mask_flat: torch.Tensor   # (zs*ys*xs,) f32
    stack_id: torch.Tensor    # (N,) i64
    max_intensity: float
    min_intensity: float


def canonical_problem(device, n_stacks: int = 4, stack_slices: int = 42,
                      hw: int = 144, vol: int = 160, recon_dx: float = 1.0,
                      in_plane: float = 1.25, thickness: float = 5.0,
                      max_support: int = 12, seed: int = 0) -> Problem:
    rng = np.random.default_rng(seed)
    recon_attr = ImageAttributes(x=vol, y=vol, z=vol, dx=recon_dx,
                                 dy=recon_dx, dz=recon_dx)
    n = n_stacks * stack_slices
    i2w = np.zeros((n, 4, 4))
    dims = np.tile([[in_plane, in_plane, thickness]], (n, 1))
    k = 0
    for s in range(n_stacks):
        t = rigid_matrix(ROTATIONS[s % len(ROTATIONS)])
        for j in range(stack_slices):
            a = ImageAttributes(x=hw, y=hw, z=1, dx=in_plane, dy=in_plane,
                                dz=thickness)
            a.zorigin = (j - stack_slices / 2) * thickness / 2.0
            i2w[k] = t @ a.i2w()
            k += 1
    support = psf_ops.reference_support(dims, recon_dx, 1.0, max_support)
    ranges = [(s * stack_slices, (s + 1) * stack_slices)
              for s in range(n_stacks)]
    a3s = [np.linalg.inv((recon_attr.w2i() @ i2w[r[0]])[:3, :3])
           for r in ranges]
    fast = FastPSF(np.asarray(a3s), dims[[r[0] for r in ranges]], ranges,
                   support)
    ctx = SVRContext(vol_shape=recon_attr.shape_zyx,
                     vol_spacing=(recon_dx,) * 3,
                     slice_spacing_xy=(in_plane, in_plane),
                     disable_bias=True, fast=fast)
    slices = rng.uniform(LOW, HIGH, (n, hw, hw)).astype(np.float32)
    f32 = torch.float32
    return Problem(
        ctx=ctx,
        recon_w2i=torch.as_tensor(recon_attr.w2i(), dtype=f32, device=device),
        slice_i2w=torch.as_tensor(i2w, dtype=f32, device=device),
        transforms=torch.eye(4, dtype=f32, device=device).repeat(n, 1, 1),
        slices=torch.as_tensor(slices, device=device),
        valid=torch.ones((n, hw, hw), dtype=torch.bool, device=device),
        mask_flat=torch.ones(vol ** 3, dtype=f32, device=device),
        stack_id=torch.repeat_interleave(
            torch.arange(n_stacks, device=device), stack_slices),
        max_intensity=HIGH, min_intensity=LOW)


def _np_trilinear(v, pts):
    """numpy trilinear sample of a [z,y,x] volume at (..., 3) (x,y,z),
    zero outside."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    zs, ys, xs = v.shape
    u, w, q = np.floor(x).astype(int), np.floor(y).astype(int), \
        np.floor(z).astype(int)
    du, dv, dw = x - u, y - w, z - q
    out = np.zeros(x.shape, np.float32)
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                xi, yi, zi = u + cu, w + cv, q + cw
                inb = ((xi >= 0) & (xi < xs) & (yi >= 0) & (yi < ys)
                       & (zi >= 0) & (zi < zs))
                val = np.where(inb, v[np.clip(zi, 0, zs - 1),
                                      np.clip(yi, 0, ys - 1),
                                      np.clip(xi, 0, xs - 1)], 0.0)
                wgt = ((du if cu else 1 - du) * (dv if cv else 1 - dv)
                       * (dw if cw else 1 - dw))
                out += (wgt * val).astype(np.float32)
    return out


def _compose_attr(attr: ImageAttributes, t) -> ImageAttributes:
    """Attributes whose i2w equals t @ attr.i2w() (rigid t: rotate the
    axes, move the origin)."""
    a = attr.copy()
    r = np.asarray(t, np.float64)[:3, :3]
    a.xaxis = list(r @ np.asarray(attr.xaxis, np.float64))
    a.yaxis = list(r @ np.asarray(attr.yaxis, np.float64))
    a.zaxis = list(r @ np.asarray(attr.zaxis, np.float64))
    o = r @ np.asarray([attr.xorigin, attr.yorigin, attr.zorigin],
                       np.float64) + np.asarray(t, np.float64)[:3, 3]
    a.xorigin, a.yorigin, a.zorigin = map(float, o)
    return a


def motion_problem(seed: int = 0, n_stacks: int = 4, hw: int = 144,
                   in_plane: float = 1.25, thickness: float = 5.0,
                   motion_t: float = 1.5, motion_r: float = 1.5,
                   gn: int = 168):
    """Ground truth + motion-corrupted thick-slice stacks: the problem of
    the JAX package's end-to-end bench (tools/bench_full.py:31-126), in
    numpy.

    A textured ellipsoid on a gn^3 grid at 1 mm; n_stacks stacks (rotations
    0, 90 deg about x, 90 deg about y, 45/45 deg) of round(gn/2.5)//2
    slices (33 at gn=168) of hw^2 pixels, each slice a trilinear sample of
    the truth, with rigid motion of +-motion_t mm / +-motion_r deg on every
    other slice.  Returns (truth Image, mask Image, stacks).
    """
    from ..core.image import Image
    rng = np.random.default_rng(seed)
    ga = ImageAttributes(x=gn, y=gn, z=gn, dx=1.0, dy=1.0, dz=1.0)
    lin = np.linspace(-1, 1, gn)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xx ** 2 + 1.15 * yy ** 2 + 1.25 * zz ** 2)
    tex = (360.0 + 140.0 * np.cos(9 * np.pi * r)
           + 90.0 * np.sin(7 * xx + 11 * yy - 9 * zz)
           + 70.0 * np.sin(13 * xx * yy + 8 * zz))
    vol = np.where(r < 0.82, np.maximum(tex, 1.0), 0.0).astype(np.float32)
    gt = Image(vol, ga)
    mask = Image((r < 0.86).astype(np.float32), ga.copy())
    stack_rots = [[0, 0, 0], [90, 0, 0], [0, 90, 0], [45, 45, 0]]
    n_sl = int(round(gn / (thickness / 2))) // 2  # ~2x coverage
    px = np.arange(hw, dtype=np.float32)
    gy, gx = np.meshgrid(px, px, indexing="ij")
    stacks = []
    for s in range(n_stacks):
        srot = rigid_matrix([0, 0, 0] + stack_rots[s % len(stack_rots)])
        a = ImageAttributes(x=hw, y=hw, z=n_sl, dx=in_plane, dy=in_plane,
                            dz=thickness)
        data = np.zeros((n_sl, hw, hw), np.float32)
        for j in range(n_sl):
            # motion on every other slice: the unmoved half anchors the
            # initial template
            mot = np.eye(4) if j % 2 else rigid_matrix(
                list(rng.uniform(-motion_t, motion_t, 3))
                + list(rng.uniform(-motion_r, motion_r, 3)))
            fwd = ga.w2i() @ mot @ srot @ a.region(0, 0, j, hw, hw,
                                                   j + 1).i2w()
            pts = (fwd[:3, 0][None, None] * gx[..., None]
                   + fwd[:3, 1][None, None] * gy[..., None]
                   + fwd[:3, 3][None, None])
            data[j] = _np_trilinear(vol, pts)
        stacks.append(Image(data, _compose_attr(a, srot)))
    return gt, mask, stacks


def psnr_vs_truth(recon, truth, *, device) -> float:
    """Masked PSNR of a reconstruction Image against the truth resampled
    onto its grid (linear, 0 outside), over truth > 1, with the truth's
    maximum as peak (tools/bench_full.py:180-191)."""
    from ..ops.sampling import resample_to_grid
    gt_on = resample_to_grid(
        torch.as_tensor(truth.data, device=device),
        truth.attr.w2i().astype(np.float32), recon.attr.shape_zyx,
        recon.attr.i2w().astype(np.float32), interp="linear",
        padding=0.0).cpu().numpy()
    m = gt_on > 1.0
    diff = (recon.data - gt_on)[m]
    return float(10 * np.log10(gt_on[m].max() ** 2 / np.mean(diff ** 2)))
