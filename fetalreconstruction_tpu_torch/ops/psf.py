"""PSF model and support (port of fetalreconstruction_tpu/ops/psf.py:90-130).

Only what the fast engine needs: the sinc-Gauss PSF itself, the reference's
support-size formula and the integer offset cube.  The exact offset engine
(`make_slice_geom`, `psf_sums`, `psf_scatter`, `psf_gather`) is not ported
yet (ROADMAP.md queue 1 item 12).
"""
from __future__ import annotations

import math

import numpy as np
import torch

PSF_CONST = 2.3548  # FWHM -> sigma conversion used throughout the reference


def calc_psf(mm: torch.Tensor, slice_dim: torch.Tensor) -> torch.Tensor:
    """Bartlett sinc^2 in-plane x Gaussian through-plane PSF, in float32.

    mm: (..., 3) offsets in slice-frame mm; slice_dim broadcastable (..., 3).
    Matches calcPSF (reconstruction_cuda2.cu:112-131).  Float32 like the
    JAX version, because its output feeds the SVD that makes the separable
    taps, and those taps must agree between the two packages.
    """
    mm = mm.to(torch.float32)
    slice_dim = slice_dim.to(torch.float32)
    sigmaz = slice_dim[..., 2] / PSF_CONST
    ax = mm[..., 0] * slice_dim[..., 0] / PSF_CONST
    ay = mm[..., 1] * slice_dim[..., 1] / PSF_CONST
    r = math.pi * torch.sqrt(ax * ax + ay * ay)
    big = r > 1e-6
    si = torch.where(big, torch.sin(r) / torch.where(big, r, 1.0), 1.0)
    gz = torch.exp(-(mm[..., 2] ** 2) / (2.0 * sigmaz * sigmaz))
    return si * si * gz


def reference_support(slice_dims: np.ndarray, recon_dx: float,
                      quality_factor: float, max_support: int = 16) -> int:
    """The reference's PSF support size formula
    (reconstruction_cuda2.cu:225-231, non-infinite branch), maxed over
    slices and clamped to MAX_PSF_SUPPORT."""
    size_inv = 2.0 * quality_factor / recon_dx
    dims = np.atleast_2d(np.asarray(slice_dims, dtype=np.float64))
    best = 3
    for d in dims:
        xd = round(d[0] * size_inv)
        yd = round(d[1] * size_inv)
        zd = round(d[2] * size_inv)
        dim = int(np.floor(np.ceil(np.sqrt(float(xd * xd + yd * yd + zd * zd))
                                   / quality_factor) * 0.5) * 2 + 3)
        best = max(best, dim)
    return min(best, max_support)


def make_offsets(support: int) -> np.ndarray:
    """Integer offset cube, matching the reference's loop
    (o = idx - centre, centre = (dim-1)//2, idx in [0, dim))."""
    centre = (support - 1) // 2
    r = np.arange(support) - centre
    oz, oy, ox = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([ox.ravel(), oy.ravel(), oz.ravel()],
                    axis=-1).astype(np.int32)
