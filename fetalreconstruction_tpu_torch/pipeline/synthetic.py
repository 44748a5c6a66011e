"""The canonical synthetic SVR problem, built on a given device.

Same construction as the JAX package's bench (bench.py:33-85), the shape
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

from fetalreconstruction_tpu.core.geometry import ImageAttributes, rigid_matrix

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
