"""Per-slice bias field estimation and volume bias correction.

Port of fetalreconstruction_tpu/em/bias.py:24-104:

- `bias_step` (ParallelBias, irtkReconstructionGPU.cc:3796-3902): the
  weighted log-residual field of each slice, blurred in-plane (sigma =
  _sigma_bias, 12 mm by default) and made zero-mean per slice unless the
  bias is global;
- `bias_correct_volume` (BiasCorrectVolume, .cc:4430-4501): the smooth
  residual between the updated and the previous volume, divided out;
- `normalise_bias` (ParallelNormaliseBias + NormaliseBias, .cc:4578-4740)
  on the exact engine: the average slice bias scattered into the volume,
  blurred inside the mask and removed (the fast engine's form is
  pipeline/svr_core.normalise_bias_step); with a `group` (a
  torch.distributed process group) the scattered field is the rank's
  partial volume, all-reduced before it is divided.

As in the reference GPU path, the slice blur uses one in-plane spacing for
the whole batch.
"""
from __future__ import annotations

import torch

from ..ops import psf as psf_ops
from ..ops.gaussian import gaussian_blur
from ..parallel.sharded import psum
from .robust import corrected_slice


def bias_step(slices, valid, bias, scale, weights, sim, simw,
              sigma_bias_mm, spacing_xy, global_bias_correction=False):
    """One bias-field update for all slices.  spacing_xy is (dx, dy), so
    the (N, H, W) batch is blurred in-plane only.  Returns the new bias
    (N, H, W)."""
    s = corrected_slice(slices, bias, scale)
    conf = valid & (simw > 0.99)
    wb0 = torch.where(conf, weights * s, 0.0)
    ok = conf & (sim > 1.0) & (s > 1.0)
    wres0 = torch.where(ok, torch.log(torch.clamp(s, min=1e-6)
                                      / torch.clamp(sim, min=1e-6)) * wb0,
                        0.0)
    wres = gaussian_blur(wres0, sigma_bias_mm, spacing_xy)
    wb = gaussian_blur(wb0, sigma_bias_mm, spacing_xy)
    new_bias = bias + torch.where(valid & (wb > 0),
                                  wres / torch.where(wb > 0, wb, 1.0), 0.0)
    if not global_bias_correction:
        num = valid.sum(dim=(1, 2))
        mean = torch.where(valid, new_bias, 0.0).sum(dim=(1, 2)) \
            / torch.clamp(num, min=1)
        new_bias = torch.where(valid & (num[:, None, None] > 0),
                               new_bias - mean[:, None, None], new_bias)
    return new_bias


def bias_correct_volume(recon, original, mask, min_intensity, max_intensity,
                        low_intensity_cutoff, sigma_bias_mm, vol_spacing):
    """Divide out the smooth log-residual between `recon` and the
    pre-update volume `original` inside the mask (mask == 1, both above
    low_intensity_cutoff * max_intensity), clamped to [0.9 min, 1.1 max]."""
    cutoff = low_intensity_cutoff * max_intensity
    ok = (mask == 1) & (original > cutoff) & (recon > cutoff)
    residual = torch.where(ok, torch.log(torch.clamp(recon, min=1e-30)
                                         / torch.clamp(original, min=1e-30)),
                           0.0)
    weights = torch.where(ok, 1.0, 0.0)
    residual = gaussian_blur(residual, sigma_bias_mm, vol_spacing)
    weights = gaussian_blur(weights, sigma_bias_mm, vol_spacing)
    field = torch.exp(torch.where(
        weights != 0, residual / torch.where(weights != 0, weights, 1.0),
        0.0))
    corrected = torch.clamp(recon / field, 0.9 * min_intensity,
                            1.1 * max_intensity)
    return torch.where(mask == 1, corrected, recon)


def normalise_bias(geom, offsets, sume, slices_valid, bias, scale, recon,
                   vol_weights, mask, mask_flat, vol_shape, sigma_bias_mm,
                   vol_spacing, group=None):
    """Remove the average slice bias from the volume through the exact
    engine.  Returns (corrected volume, volume bias field)."""
    logs = torch.log(torch.clamp(scale, min=1e-30))
    b = torch.where(slices_valid & (scale[:, None, None] > 0),
                    bias - logs[:, None, None], bias)
    payload = torch.where(slices_valid, b, 0.0)
    (vol_bias,) = psf_ops.psf_scatter(geom, offsets, sume, [payload],
                                      mask_flat, vol_shape)
    vol_bias = psum(vol_bias.reshape(vol_shape), group)
    ok = vol_weights > 0
    vol_bias = torch.where(ok, vol_bias / torch.where(ok, vol_weights, 1.0),
                           0.0)
    vol_bias = torch.where(mask != 0, vol_bias, 0.0)
    m = (mask != 0).to(recon.dtype)
    vol_bias = gaussian_blur(vol_bias, sigma_bias_mm, vol_spacing)
    m_blur = gaussian_blur(m, sigma_bias_mm, vol_spacing)
    vol_bias = torch.where(m_blur != 0,
                           vol_bias / torch.where(m_blur != 0, m_blur, 1.0),
                           0.0)
    return torch.where(recon != -1.0, recon / torch.exp(-vol_bias),
                       recon), vol_bias
