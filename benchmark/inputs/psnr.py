"""Masked PSNR of a reconstruction against the case's truth, in NumPy.

The truth is resampled trilinearly (zero outside its grid) onto the
reconstruction's grid through world coordinates; the PSNR is taken over
the voxels where that resampled truth exceeds 1, with its maximum there as
the peak (the arithmetic of the repository's end-to-end benches, frozen
here).
"""
from __future__ import annotations

import numpy as np

from .geometry import Grid, trilinear


def truth_on_grid(truth: np.ndarray, truth_grid: Grid,
                  grid: Grid) -> np.ndarray:
    zs, ys, xs = grid.shape_zyx
    m = truth_grid.w2i() @ grid.i2w()
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    idx = np.stack([x, y, z], -1).astype(np.float64)
    pts = idx @ m[:3, :3].T + m[:3, 3]
    return trilinear(truth, pts)


def psnr(recon: np.ndarray, gt: np.ndarray) -> float:
    """PSNR of recon against the truth on its grid (truth_on_grid)."""
    keep = gt > 1.0
    diff = (np.asarray(recon, np.float64) - gt)[keep]
    peak = float(gt[keep].max())
    return float(10.0 * np.log10(peak ** 2 / np.mean(diff ** 2)))
