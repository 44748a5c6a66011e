"""The reconstruction mask, worked out again from the case's mask.

The reconstruction programs smooth the mask with a Gaussian of `sigma` mm
(IRTK's filter: a sampled kernel of radius round(4 sigma / voxel size),
normalised, renormalised by its mass inside the volume at the edges, one
axis at a time), keep the voxels above one half, and take the output
grid's voxels from it by nearest neighbour.  A voxel whose smoothed value
lies within `tie` of the half, or whose source position lies within
`tie` of a rounding boundary, can fall either way by rounding: it is
reported as undecided.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch


def _kernel(sigma_vox: float) -> np.ndarray:
    r = int(round(4.0 * sigma_vox))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-xs * xs / (2.0 * sigma_vox * sigma_vox))
    return k / k.sum()


def _smooth_axis(vol: torch.Tensor, k: np.ndarray, axis: int):
    r = (len(k) - 1) // 2
    if r == 0:
        return vol
    n = vol.shape[axis]
    x = vol.movedim(axis, -1).reshape(-1, 1, n)
    w = torch.as_tensor(k, dtype=vol.dtype, device=vol.device)[None, None]
    num = torch.nn.functional.conv1d(x, w, padding=r)
    den = torch.nn.functional.conv1d(torch.ones_like(x[:1]), w, padding=r)
    out = (num / den).reshape(*vol.movedim(axis, -1).shape)
    return out.movedim(-1, axis)


def smoothed(mask: np.ndarray, spacing_xyz, sigma: float, device):
    """The mask ([z, y, x]) smoothed by a Gaussian of sigma mm (float64)."""
    v = torch.as_tensor(np.asarray(mask, np.float64), device=device)
    for axis, d in ((2, spacing_xyz[0]), (1, spacing_xyz[1]),
                    (0, spacing_xyz[2])):
        v = _smooth_axis(v, _kernel(sigma / float(d)), axis)
    return v.cpu().numpy()


def on_grid(mask: np.ndarray, mask_w2i: np.ndarray, shape_zyx,
            grid_i2w: np.ndarray, sigma: float, device,
            tie: float = 1e-3):
    """(inside, undecided): bool volumes on the output grid.  inside is
    the smoothed mask above one half at the voxel's nearest source voxel,
    where that is decided."""
    s = smoothed(mask, _spacing(mask_w2i), sigma, device)
    over = s > 0.5
    unsure = np.abs(s - 0.5) <= tie
    z, y, x = np.meshgrid(*(np.arange(n) for n in shape_zyx), indexing="ij")
    pts = np.stack([x, y, z, np.ones_like(x)], -1).reshape(-1, 4)
    m = np.asarray(mask_w2i, np.float64) @ np.asarray(grid_i2w, np.float64)
    src = pts @ m[:3].T                       # (n, 3) in (x, y, z)
    base = np.floor(src + 0.5)
    near = np.abs(src - base) >= 0.5 - tie    # a tie on this axis
    zs, ys, xs = mask.shape
    hi = np.array([xs, ys, zs])
    votes = []
    for pick in itertools.product((0, 1), repeat=3):
        step = np.where(np.array(pick)[None] & near,
                        np.where(src > base, 1, -1), 0)
        p = (base + step).astype(np.int64)
        inb = ((p >= 0) & (p < hi)).all(axis=1)
        pc = np.clip(p, 0, hi - 1)
        val = np.where(inb, over[pc[:, 2], pc[:, 1], pc[:, 0]], False)
        und = np.where(inb, unsure[pc[:, 2], pc[:, 1], pc[:, 0]], False)
        votes.append((val, und))
    vals = np.stack([v for v, _ in votes])
    undecided = (vals.any(0) != vals.all(0)) | np.stack(
        [u for _, u in votes]).any(0)
    return (vals.all(0) & ~undecided).reshape(shape_zyx), \
        undecided.reshape(shape_zyx)


def _spacing(w2i: np.ndarray):
    """Voxel sizes (x, y, z) of a grid from its world-to-image matrix."""
    return tuple(1.0 / np.linalg.norm(np.asarray(w2i, np.float64)[i, :3])
                 for i in range(3))


def eroded(mask: np.ndarray, reach: int) -> np.ndarray:
    """The mask's voxels whose cube of half-width `reach` voxels lies
    inside it."""
    out = torch.as_tensor(np.asarray(mask) <= 0,
                          dtype=torch.float32)[None, None]
    k = 2 * reach + 1
    for size in ((k, 1, 1), (1, k, 1), (1, 1, k)):
        out = torch.nn.functional.max_pool3d(
            out, size, stride=1, padding=tuple(s // 2 for s in size))
    return (out[0, 0] == 0).cpu().numpy()
