"""Image-pair evaluation metrics (joint-histogram based).

Port of fetalreconstruction_tpu/evaluation/metrics.py (irtkEvaluation,
source/reconstructionGPU2/irtkEvaluation.cpp:43-273, and the
irtkHistogram_2D metric family: CC, SSD, JE, MI, NMI, CR_X|Y, CR_Y|X, LC,
Kappa and PSNR over the voxels of the target grid, the source sampled
trilinearly at the identity transform, out-of-FOV voxels skipped).  The
source is sampled by the port's ops/sampling.sample_linear on the
caller's device; the rest is numpy, as in the JAX version.

Quirks kept:
- bins = min(round(max - min) + 1, 255) per image, bin width
  (max - min)/(bins - 1), samples rounded to the nearest bin;
- PSNR = 20 log10(max target in ROI) - 10 log10(SSD / total target voxel
  count): the divisor counts ALL voxels, not just sampled pairs
  (irtkEvaluation.cpp:214-216).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.image import Image
from ..ops.sampling import sample_linear

DEFAULT_BINS = 255


@dataclasses.dataclass
class EvalResult:
    cc: float = 0.0
    ssd: float = 0.0
    je: float = 0.0
    mi: float = 0.0
    nmi: float = 0.0
    cr_xy: float = 0.0
    cr_yx: float = 0.0
    lc: float = 0.0
    ks: float = 0.0
    psnr: float = 0.0
    samples: int = 0
    # histogram moments (irtkHistogram_2D MeanX/MeanY/VarianceX/VarianceY/
    # Covariance — consumed by the PVR evaluation CSVs)
    mean_x: float = 0.0
    mean_y: float = 0.0
    var_x: float = 0.0
    var_y: float = 0.0
    cov: float = 0.0

    def as_dict(self):
        return dataclasses.asdict(self)


def _entropy(p):
    p = p[p > 0]
    return float(-(p * np.log(p)).sum())


def evaluate(target: Image, source: Image,
             nbins_x: int = 0, nbins_y: int = 0, *, device) -> EvalResult:
    tdata = np.asarray(target.data, np.float64)
    tmin, tmax = float(tdata.min()), float(tdata.max())

    # sample source at target raster (identity world transform)
    zs, ys, xs = target.attr.shape_zyx
    z, y, x = np.meshgrid(np.arange(zs), np.arange(ys), np.arange(xs),
                          indexing="ij")
    pts = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float64)
    w = target.attr.image_to_world(pts)
    sp = source.attr.world_to_image(w)
    # interpolable interior (interpolator->Inside): [0, n-1] open interval
    inside = ((sp[:, 0] > 0) & (sp[:, 0] < source.attr.x - 1)
              & (sp[:, 1] > 0) & (sp[:, 1] < source.attr.y - 1)
              & (sp[:, 2] > 0) & (sp[:, 2] < source.attr.z - 1))
    svals = sample_linear(
        torch.as_tensor(np.asarray(source.data, np.float32), device=device),
        torch.as_tensor(sp, dtype=torch.float32, device=device)).cpu().numpy()
    tvals = tdata.reshape(-1)

    tv = tvals[inside]
    sv = svals[inside].astype(np.float64)
    smin_all = float(np.asarray(source.data).min())
    smax_all = float(np.asarray(source.data).max())

    if nbins_x == 0:
        nbins_x = min(int(round(tmax - tmin)) + 1, DEFAULT_BINS)
    if nbins_y == 0:
        nbins_y = min(int(round(smax_all - smin_all)) + 1, DEFAULT_BINS)
    nbins_x = max(nbins_x, 2)
    nbins_y = max(nbins_y, 2)
    widthx = (tmax - tmin) / (nbins_x - 1.0) or 1.0
    widthy = (smax_all - smin_all) / (nbins_y - 1.0) or 1.0

    bx = np.clip(np.round((tv - tmin) / widthx), 0, nbins_x - 1).astype(int)
    by = np.clip(np.round((sv - smin_all) / widthy), 0,
                 nbins_y - 1).astype(int)
    res = _hist_battery(bx, by, nbins_x, nbins_y,
                        tmin + np.arange(nbins_x) * widthx,
                        smin_all + np.arange(nbins_y) * widthy)
    if res.samples == 0:
        return res

    # PSNR: peak = max target over sampled ROI; MSE divides by the TOTAL
    # voxel count (reference quirk)
    ssd_raw = float(((tv - sv) ** 2).sum())
    mse = ssd_raw / tdata.size
    peak = float(tv.max()) if len(tv) else 1.0
    res.psnr = (20 * np.log10(max(peak, 1e-12))
                - 10 * np.log10(max(mse, 1e-30)))
    return res


def _hist_battery(bx, by, nbins_x: int, nbins_y: int, cx, cy) -> EvalResult:
    """The irtkHistogram_2D metric battery from pre-binned pairs.

    cx/cy: bin-centre intensity values.  PSNR is left to the caller
    (each reference battery defines its own peak/divisor convention)."""
    hist = np.zeros((nbins_x, nbins_y), np.float64)
    np.add.at(hist, (bx, by), 1.0)
    n = hist.sum()
    res = EvalResult(samples=int(n))
    if n == 0:
        return res

    p = hist / n
    px = p.sum(axis=1)
    py = p.sum(axis=0)

    mean_x = float((px * cx).sum())
    mean_y = float((py * cy).sum())
    var_x = float((px * (cx - mean_x) ** 2).sum())
    var_y = float((py * (cy - mean_y) ** 2).sum())
    cov = float((p * np.outer(cx - mean_x, cy - mean_y)).sum())
    res.cc = cov / np.sqrt(max(var_x * var_y, 1e-30))
    res.mean_x, res.mean_y = mean_x, mean_y
    res.var_x, res.var_y, res.cov = var_x, var_y, cov

    # SSD from the histogram (bin-centre approximation, as the reference)
    diff2 = (cx[:, None] - cy[None, :]) ** 2
    res.ssd = float((p * diff2).sum())

    hx = _entropy(px)
    hy = _entropy(py)
    hxy = _entropy(p.reshape(-1))
    res.je = hxy
    res.mi = hx + hy - hxy
    res.nmi = (hx + hy) / hxy if hxy > 0 else 0.0

    # correlation ratios (irtkHistogram_2D::CorrelationRatioXY/YX)
    def corr_ratio(p_joint, marginal, centres_num, var_num, mean_num):
        s = 0.0
        for j in range(p_joint.shape[1]):
            pj = p_joint[:, j].sum()
            if pj > 0:
                m = (p_joint[:, j] * centres_num).sum() / pj
                s += pj * (m - mean_num) ** 2
        return s / var_num if var_num > 0 else 0.0

    res.cr_xy = corr_ratio(p, py, cx, var_x, mean_x)
    res.cr_yx = corr_ratio(p.T, px, cy, var_y, mean_y)

    if nbins_x == nbins_y:
        res.lc = float(np.trace(p))
        pe = float((px * py).sum())
        po = float(np.trace(p))
        res.ks = (po - pe) / (1.0 - pe) if pe < 1.0 else 1.0
    return res


def evaluate_pair(tv, sv, min_intensity: float, max_intensity: float,
                  nbins: int = 0) -> EvalResult:
    """Battery for PAIRED 1-D samples with SHARED [min, max] binning on
    both axes — the per-patch 2D battery convention
    (irtkPatchBasedReconstruction.cpp:1320-1347 builds the histogram
    from the global m_min/m_max intensity for both axes; PSNR uses
    20 log10(max_intensity) - 10 log10(mean squared diff),
    cpp:1190-1191)."""
    tv = np.asarray(tv, np.float64)
    sv = np.asarray(sv, np.float64)
    if nbins == 0:
        nbins = min(int(round(max_intensity - min_intensity)) + 1,
                    DEFAULT_BINS)
    nbins = max(nbins, 2)
    width = (max_intensity - min_intensity) / (nbins - 1.0) or 1.0
    bx = np.clip(np.round((tv - min_intensity) / width), 0,
                 nbins - 1).astype(int)
    by = np.clip(np.round((sv - min_intensity) / width), 0,
                 nbins - 1).astype(int)
    centres = min_intensity + np.arange(nbins) * width
    res = _hist_battery(bx, by, nbins, nbins, centres, centres)
    if len(tv):
        mse = float(((tv - sv) ** 2).mean())
        res.psnr = (20 * np.log10(max(max_intensity, 1e-12))
                    - 10 * np.log10(max(mse, 1e-30)))
    return res
