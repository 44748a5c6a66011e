"""EM robust statistics: voxel posteriors, slice mixture model, M-step.

Port of fetalreconstruction_tpu/em/robust.py (the reference's
ParallelEStep, EStep's slice mixture, ParallelMStep, ParallelScale,
InitializeRobustStatistics).  Scalars are 0-d float32 tensors on the
inputs' device.  The JAX version's mesh reductions (`axis_name`) are plain
reductions here until the multi-device port (ROADMAP.md queue 1 item 13).

Constants: STEP = 1e-4 (the reference's _step, .cc:161);
G(x, s) = STEP * exp(-x^2/(2s)) / sqrt(6.28 s); M(m) = m * STEP.
"""
from __future__ import annotations

import torch

STEP = 1e-4
SIGMA_FLOOR = STEP * STEP / 6.28


def _max1(n):
    """max(n, 1) for an integer count tensor."""
    return torch.clamp(n, min=1)


def _maxf(x, floor=1e-30):
    return torch.clamp(x, min=floor)


def gauss(x, s):
    """The reference's G() (irtkReconstructionGPU.h:529)."""
    return STEP * torch.exp(-x * x / (2.0 * s)) / torch.sqrt(6.28 * s)


def corrected_slice(slices, bias, scale):
    """slice * exp(-bias) * scale (the universal intensity correction)."""
    return slices * torch.exp(-bias) * scale[:, None, None]


def init_robust_stats(slices, valid, sim, simw, sim_inside):
    """Initial sigma^2 = mean squared (slice - sim) over confident voxels
    (sim_inside and simw > 0.99).  Returns (sigma2, num)."""
    use = valid & sim_inside & (simw > 0.99)
    e = torch.where(use, slices - sim, 0.0)
    num = use.sum()
    sigma2 = (e * e).sum() / _max1(num)
    return sigma2, num


def voxel_estep(slices, valid, bias, scale, sim, simw, sigma2, m, mix):
    """Voxel posteriors + slice potentials (ParallelEStep, .cc:3096-3143).

    Returns (weights (N,H,W), potential (N,)); potential = -1 where a slice
    has no confident voxels.
    """
    s = corrected_slice(slices, bias, scale)
    use = valid & (simw > 0.0)
    e = torch.where(use, s - sim, 0.0)
    g = gauss(e, sigma2)
    mterm = m * STEP
    post = g * mix / (g * mix + mterm * (1.0 - mix))
    weights = torch.where(use, post, 0.0)
    conf = use & (simw > 0.99)
    num = conf.sum(dim=(1, 2))
    pot_sq = torch.where(conf, (1.0 - weights) ** 2, 0.0).sum(dim=(1, 2))
    potential = torch.where(num > 0, torch.sqrt(pot_sq / _max1(num)), -1.0)
    return weights, potential


def slice_mixture(potential, slice_weight):
    """Slice-level two-Gaussian mixture (EStepGPU, .cc:3284-3440): weighted
    means / variances of the potentials for the inlier and outlier
    classes, sigma floors, degenerate-case fallbacks and the one-sided
    Gaussian likelihoods.

    potential: (N,) with -1 flagging excluded slices.
    Returns (ok, gs1, gs2, mean_s, mean_s2, sigma_s, sigma_s2, den).
    """
    ok = potential >= 0.0
    w = torch.where(ok, slice_weight, 0.0)
    wo = torch.where(ok, 1.0 - slice_weight, 0.0)
    p = torch.where(ok, potential, 0.0)

    den = w.sum()
    den2 = wo.sum()
    sum1 = (p * w).sum()
    sum2 = (p * wo).sum()
    maxs = torch.where(ok, potential, 0.0).max()
    mins = torch.where(ok, potential, 1.0).min()

    mean_s = torch.where(den > 0, sum1 / _maxf(den), mins)
    mean_s2 = torch.where(den2 > 0, sum2 / _maxf(den2), (maxs + mean_s) / 2.0)

    vsum1 = ((p - mean_s) ** 2 * w).sum()
    vsum2 = ((p - mean_s2) ** 2 * wo).sum()
    sigma_s = torch.where((vsum1 > 0) & (den > 0),
                          _maxf(vsum1 / _maxf(den), SIGMA_FLOOR),
                          0.025)
    sigma_s2 = torch.where((vsum2 > 0) & (den2 > 0),
                           vsum2 / _maxf(den2),
                           (mean_s2 - mean_s) ** 2 / 4.0)
    sigma_s2 = _maxf(sigma_s2, SIGMA_FLOOR)

    gs1 = torch.where(potential < mean_s2,
                      gauss(potential - mean_s, sigma_s), 0.0)
    gs2 = torch.where(potential > mean_s,
                      gauss(potential - mean_s2, sigma_s2), 0.0)
    return ok, gs1, gs2, mean_s, mean_s2, sigma_s, sigma_s2, den


def slice_estep(potential, slice_weight, mix_s):
    """Full slice-level E-step: returns (new_slice_weight, stats dict)."""
    ok, gs1, gs2, mean_s, mean_s2, sigma_s, sigma_s2, den = \
        slice_mixture(potential, slice_weight)
    # mix_s here is the PREVIOUS iterate (the reference updates it after)
    likelihood = gs1 * mix_s + gs2 * (1.0 - mix_s)
    post = torch.where(likelihood > 0,
                       gs1 * mix_s / _maxf(likelihood),
                       torch.where(potential <= mean_s, 1.0,
                                   torch.where(potential >= mean_s2, 0.0,
                                               1.0)))
    # degenerate: all outliers or invalid means -> weight 1
    degenerate = (den <= 0) | (mean_s2 <= mean_s)
    new_w = torch.where(ok, torch.where(degenerate, 1.0, post), 0.0)
    nvalid = ok.sum()
    mix_s_new = torch.where(
        nvalid > 0, torch.where(ok, new_w, 0.0).sum() / _max1(nvalid), 0.9)
    stats = dict(mean_s=mean_s, mean_s2=mean_s2, sigma_s=sigma_s,
                 sigma_s2=sigma_s2, mix_s=mix_s_new)
    return new_w, stats


def mstep(slices, valid, bias, scale, weights, sim, simw, iteration: int,
          mix_prev):
    """Voxel-level M-step (ParallelMStep, .cc:4121-4211 + MStep 4226-4260).

    Returns (sigma2, mix, m).  mix is only updated when iteration > 1.
    """
    s = corrected_slice(slices, bias, scale)
    use = valid & (simw > 0.99)
    e = torch.where(use, s - sim, 0.0)
    sigma_sum = (e * e * weights * use).sum()
    mix_sum = (weights * use).sum()
    num = use.sum()
    emin = torch.where(use, e, 0.0).min()
    emax = torch.where(use, e, 0.0).max()
    sigma2 = _maxf(sigma_sum / _maxf(mix_sum), SIGMA_FLOOR)
    mix = mix_sum / _max1(num) if iteration > 1 else mix_prev
    m = 1.0 / _maxf(emax - emin)
    return sigma2, mix, m


def scale_step(slices, valid, bias, weights, sim, simw):
    """Per-slice intensity scale (ParallelScale, .cc:3698-3741):
    scale = sum(w * s * e^-b * sim) / sum(w * (s * e^-b)^2) over confident
    voxels; 1 where the denominator vanishes."""
    eb = torch.exp(-bias)
    use = valid & (simw > 0.99)
    seb = torch.where(use, slices * eb, 0.0)
    num = (weights * seb * sim * use).sum(dim=(1, 2))
    den = (weights * seb * seb).sum(dim=(1, 2))
    return torch.where(den > 0, num / _maxf(den), 1.0)


def scale_volume_factor(slices, valid, weights, slice_weight, sim, simw):
    """Global volume rescale factor (ScaleVolumeKernel,
    reconstruction_cuda2.cu:3386-3413): sum(w * sw * s * sim) /
    sum(w * sw * sim^2) over confident voxels, with the RAW slice value."""
    use = valid & (simw > 0.99)
    sw = slice_weight[:, None, None]
    num = torch.where(use, weights * sw * slices * sim, 0.0).sum()
    den = torch.where(use, weights * sw * sim * sim, 0.0).sum()
    return num / _maxf(den)
