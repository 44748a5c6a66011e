"""Manual segmentation mask pushed through the PSF into recon space.

Port of fetalreconstruction_tpu/ops/manual_mask.py
(transformManualMaskwithPSF, irtkReconstructionGPU.cc:4824 +
psfManualMaskTransform, reconstruction_cuda2.cu:5302): the per-slice
manual mask values are scattered into the volume with the same PSF
weighting as the data, normalised by the scattered weights and
thresholded, giving a reconstruction-space segmentation consistent with
the motion-corrected slices.  The fast engine scatters through
ops.psf_fast.fast_scatter2 (kernels B1 and B2 on the card), the exact one
through ops.psf.psf_scatter.
"""
from __future__ import annotations

import torch

from . import psf as psf_ops
from . import psf_fast


def transform_manual_mask(ctx, geom, sume, mask_slices_batch, valid,
                          mask_flat, threshold: float = 0.5):
    """mask_slices_batch: (N, H, W) manual mask (0/1) per slice; returns a
    [z, y, x] binary float32 volume."""
    gate = valid & (sume > 0)
    pay = torch.where(gate, mask_slices_batch, 0.0)
    ones = torch.where(gate, 1.0, 0.0)
    if ctx.fast is not None:
        num, den = psf_fast.fast_scatter2(
            ctx.fast, geom, pay, ones, mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        num, den = psf_ops.psf_scatter(geom, ctx.offsets, sume, [pay, ones],
                                       mask_flat, ctx.vol_shape)
        num = num.reshape(ctx.vol_shape)
        den = den.reshape(ctx.vol_shape)
    frac = torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)
    return (frac > threshold).to(torch.float32)
