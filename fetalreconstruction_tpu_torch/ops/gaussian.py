"""Separable Gaussian blurring on tensors, with IRTK's filter semantics.

Port of fetalreconstruction_tpu/ops/gaussian.py:22-137
(irtkGaussianBlurring: radius round(4*sigma/voxel size), sampled Gaussian,
boundary renormalisation; irtkGaussianBlurringWithPadding: convolve only
over non-padding voxels, renormalise by the in-mask kernel mass, padded
voxels stay padded).  Taps are accumulated in the JAX order (tap 0 first),
each as an in-place add on the shifted slab.  There is no jit wrapper.
"""
from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma_vox: float) -> np.ndarray:
    """Sampled, normalised 1D Gaussian with radius round(4*sigma) (>= 0)."""
    r = int(round(4.0 * sigma_vox))
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-xs * xs / (2.0 * sigma_vox * sigma_vox)) if sigma_vox > 0 \
        else np.array([1.0])
    k = k / k.sum()
    return k.astype(np.float32)


def _taps(kernel: np.ndarray, n: int):
    """(weight, source start, destination start, length) of each tap that
    reaches the axis: out[i] += w * data[i + shift]."""
    r = (len(kernel) - 1) // 2
    for tap in range(len(kernel)):
        shift = tap - r
        lo, hi = max(shift, 0), min(n + shift, n)
        if hi > lo:  # a tap wider than the axis falls off the edge
            yield float(kernel[tap]), lo, lo - shift, hi - lo


def _correlate(data, kernel: np.ndarray, axis: int):
    """sum_t w_t * data shifted by t along `axis`, zero outside."""
    out = torch.zeros_like(data)
    for w, lo, dst, ln in _taps(kernel, data.shape[axis]):
        out.narrow(axis, dst, ln).add_(w * data.narrow(axis, lo, ln))
    return out


def _blur_axis(data, kernel: np.ndarray, axis: int):
    """Correlate along one axis with boundary renormalisation."""
    if (len(kernel) - 1) // 2 == 0:
        return data
    n = data.shape[axis]
    wsum = torch.zeros(n, dtype=data.dtype, device=data.device)
    for w, lo, dst, ln in _taps(kernel, n):
        wsum[dst:dst + ln] += w
    shape = [1] * data.ndim
    shape[axis] = n
    return _correlate(data, kernel, axis) / wsum.reshape(shape)


def gaussian_blur(data, sigma_mm: float, spacing_xyz):
    """Blur a [z, y, x] volume (or a (..., Y, X) batch of 2D images).

    sigma_mm in millimetres; spacing_xyz = (dx, dy, dz) in mm.  For 2D
    batches only dx, dy are used.
    """
    dx, dy = float(spacing_xyz[0]), float(spacing_xyz[1])
    out = _blur_axis(data, gaussian_kernel1d(sigma_mm / dx), data.ndim - 1)
    out = _blur_axis(out, gaussian_kernel1d(sigma_mm / dy), data.ndim - 2)
    if data.ndim >= 3 and len(spacing_xyz) >= 3 and data.shape[-3] > 1:
        kz = gaussian_kernel1d(sigma_mm / float(spacing_xyz[2]))
        out = _blur_axis(out, kz, data.ndim - 3)
    return out


def _blur_axis_masked(data, mask, kernel: np.ndarray, axis: int):
    if (len(kernel) - 1) // 2 == 0:
        return data * mask, mask
    return _correlate(data * mask, kernel, axis), \
        _correlate(mask, kernel, axis)


def _renormalise(num, den):
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def gaussian_blur_padded(data, sigma_mm: float, spacing_xyz,
                         padding: float = -1.0):
    """Padding-aware blur: voxels <= padding are excluded and stay padded
    (irtkGaussianBlurringWithPadding semantics, applied separably)."""
    mask = (data > padding).to(data.dtype)
    dx, dy = float(spacing_xyz[0]), float(spacing_xyz[1])
    cur = _renormalise(*_blur_axis_masked(
        data, mask, gaussian_kernel1d(sigma_mm / dx), data.ndim - 1))
    cur = _renormalise(*_blur_axis_masked(
        cur, mask, gaussian_kernel1d(sigma_mm / dy), data.ndim - 2))
    if data.ndim >= 3 and len(spacing_xyz) >= 3 and data.shape[-3] > 1:
        kz = gaussian_kernel1d(sigma_mm / float(spacing_xyz[2]))
        cur = _renormalise(*_blur_axis_masked(cur, mask, kz, data.ndim - 3))
    return torch.where(mask > 0, cur, padding)
