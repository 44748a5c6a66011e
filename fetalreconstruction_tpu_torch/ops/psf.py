"""PSF projection engine: slice <-> volume transfer through the sinc-Gauss
PSF (port of fetalreconstruction_tpu/ops/psf.py).

The exact engine is the reference-faithful path: it reimplements the
reference's three CUDA kernels (reconstruction_cuda2.cu)

- gaussianReconstructionKernel3D_tex (:176) -> psf_sums + psf_scatter
- simulateSlicesKernel3D_tex         (:298) -> psf_gather
- SuperresolutionKernel3D_tex        (:408) -> psf_scatter (addon + cmap)

and is the oracle of the fast engine (ops/psf_fast.py).  For slice pixel p
of slice s with F_s = reconW2I @ T_s @ sliceI2W and A3_s the linear part of
F_s^-1, the PSF weight of volume voxel v = round(F_s p) + o is

    w(s, p, o) = calcPSF(sliceDim * (A3_s (o - frac_{s,p})))

with frac = F_s p - round(F_s p).  `sume` sums w over the in-bounds voxels
(pixels with sume <= 0.5 are dropped); scatter and gather use w / sume over
the in-bounds voxels with mask != 0.

The JAX version scans over the K integer offsets.  Here a host loop walks
the slices in tiles of SLICE_TILE and, for each tile, the offsets in
chunks of at most OFFSET_CHUNK_ELEMS offset x pixel elements of a whole
tile, so K x pixels is never materialised (1728 offsets x 2.7 M pixels at
the canonical size would be 18.7 GB for one float temporary), and a
chunk's working memory does not follow the batch's slice count from
SLICE_TILE slices on (with chunks over every slice, a peak moved 1.4%
between batches of 108 and 109 slices).  Within a chunk the per-offset
terms are added to the accumulators one offset at a time, in JAX's order,
so tiles and chunks change no sum.  The scatter is `index_add_` on the
entries whose weight is non-zero (in bounds, in the mask, a kept pixel):
the skipped entries add exactly zero in JAX.  On CUDA `index_add_` uses
float atomics, so its sums vary from run to run in the last bits.  XLA
flushes float32 subnormals to zero and torch keeps them (on the CPU and on
CUDA), so each offset's weight is flushed below the smallest normal
float32: a pixel whose PSF reaches the mask only through such weights has
den = 0 and sim = 0, as in JAX.  These are plain torch ops, as they are
XLA ops in the JAX package.

Each of the three transfers is a span (`psf sums`, `psf scatter`, `psf
gather`) and counts `psf call` (one) and `psf pairs` (offsets x pixels, the
pixel-offset pairs it walks), filed under the phase that runs it
(utils/perfstats.py).  They never synchronise: a span holds the host's
seconds, which the scatter's `nonzero` and a full launch queue keep near
the device's.
"""
from __future__ import annotations

import functools
import math
from typing import Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..utils.perfstats import count
from ..utils.tracing import annotate

PSF_CONST = 2.3548  # FWHM -> sigma conversion used throughout the reference
OFFSET_CHUNK_ELEMS = 1 << 25  # offsets x pixels per step of the offset loop
SLICE_TILE = 64  # slices a tile of the loop


class SliceGeom(NamedTuple):
    """Per-(slice, pixel) geometry, rebuilt after each registration.

    centre:    (N, H, W, 3) int32  round(F_s p), the volume voxel (x, y, z)
    frac:      (N, H, W, 3) f32    F_s p - centre
    a3:        (N, 3, 3)    f32    linear part of F_s^-1
    slice_dim: (N, 3)       f32    (dx, dy, thickness) of each slice in mm
    valid:     (N, H, W)    bool   pixel != padding
    """
    centre: torch.Tensor
    frac: torch.Tensor
    a3: torch.Tensor
    slice_dim: torch.Tensor
    valid: torch.Tensor


def make_slice_geom(fwd: torch.Tensor, slice_dim: torch.Tensor,
                    valid: torch.Tensor) -> SliceGeom:
    """SliceGeom from the forward matrices fwd (N, 4, 4) f32 =
    reconW2I @ T_s @ sliceI2W, on their device."""
    f32 = torch.float32
    fwd = fwd.to(f32)
    n, h, w = valid.shape
    a3 = torch.linalg.inv(fwd[:, :3, :3])
    px = torch.arange(w, dtype=f32, device=fwd.device)
    py = torch.arange(h, dtype=f32, device=fwd.device)
    vp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    centre = torch.floor(vp + 0.5)  # CUDA roundf (half away from 0, vp>=0)
    return SliceGeom(centre=centre.to(torch.int32), frac=vp - centre,
                     a3=a3.to(f32), slice_dim=slice_dim.to(f32),
                     valid=valid)


def flush_subnormals(x: torch.Tensor) -> torch.Tensor:
    """x with float32 subnormals set to zero, as XLA computes them."""
    return torch.where(x.abs() < torch.finfo(torch.float32).tiny, 0.0, x)


def _psf(mx, my, mz, dx, dy, dz):
    """calcPSF (reconstruction_cuda2.cu:112-131) on mm components."""
    sigmaz = dz / PSF_CONST
    ax = mx * dx / PSF_CONST
    ay = my * dy / PSF_CONST
    r = math.pi * torch.sqrt(ax * ax + ay * ay)
    big = r > 1e-6
    si = torch.where(big, torch.sin(r) / torch.where(big, r, 1.0), 1.0)
    gz = torch.exp(-(mz ** 2) / (2.0 * sigmaz * sigmaz))
    return si * si * gz


def calc_psf(mm: torch.Tensor, slice_dim: torch.Tensor) -> torch.Tensor:
    """Bartlett sinc^2 in-plane x Gaussian through-plane PSF, in float32.

    mm: (..., 3) offsets in slice-frame mm; slice_dim broadcastable (..., 3).
    Float32 like the JAX version, because its output feeds the SVD that
    makes the separable taps, and those taps must agree between the two
    packages.
    """
    mm = mm.to(torch.float32)
    d = slice_dim.to(torch.float32)
    return _psf(mm[..., 0], mm[..., 1], mm[..., 2], d[..., 0], d[..., 1],
                d[..., 2])


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


def prune_offsets(offsets: np.ndarray, a3: np.ndarray, slice_dim: np.ndarray,
                  eps: float = 1e-5) -> np.ndarray:
    """Drop offsets whose largest possible PSF weight is below eps for
    EVERY slice (eps defaults to the reference's PSF_EPSILON,
    reconstruction_cuda2.cuh:72).  Host numpy, as in JAX: per offset the
    closest mm position within the +-0.5 frac slack, sinc^2 bounded by
    min(1, 1/(pi r)^2), times the through-plane Gaussian.  a3: (N, 3, 3);
    slice_dim: (N, 3)."""
    keep = np.zeros(len(offsets), dtype=bool)
    a3 = np.atleast_3d(np.asarray(a3, dtype=np.float64))
    slice_dim = np.atleast_2d(np.asarray(slice_dim, dtype=np.float64))
    for a, d in zip(a3, slice_dim):
        o = offsets.astype(np.float64)  # (K,3)
        mm = np.einsum("ij,kj->ki", a, o) * d[None, :]
        slack = np.abs(a) @ (0.5 * np.ones(3)) * d  # per-axis mm slack
        mmin = np.maximum(np.abs(mm) - slack[None, :], 0.0)
        ax = mmin[:, 0] * d[0] / PSF_CONST
        ay = mmin[:, 1] * d[1] / PSF_CONST
        rr = np.pi * np.sqrt(ax ** 2 + ay ** 2)  # sinc argument
        sinc_env = np.where(rr > 1.0, 1.0 / (rr * rr), 1.0)
        sigz = d[2] / PSF_CONST
        gz = np.exp(-mmin[:, 2] ** 2 / (2.0 * sigz * sigz))
        keep |= (sinc_env * gz) >= eps
    return offsets[keep]


def _tiles(geom: SliceGeom, offsets: np.ndarray
           ) -> Iterator[Tuple[slice, SliceGeom, List[torch.Tensor]]]:
    """The batch in tiles of at most SLICE_TILE slices: each tile's slice
    range, its geometry, and the offsets as (C, 3) int32 tensors on
    geom's device, C offsets x the pixels of a whole tile <=
    OFFSET_CHUNK_ELEMS (at least one offset), the same C for every
    tile."""
    offs = torch.as_tensor(np.asarray(offsets, np.int32),
                           device=geom.valid.device)
    n = geom.valid.shape[0]
    tile = max(1, min(n, SLICE_TILE))
    step = max(1, OFFSET_CHUNK_ELEMS // max(geom.valid[:tile].numel(), 1))
    chunks = [offs[s:s + step] for s in range(0, offs.shape[0], step)]
    for s0 in range(0, n, tile):
        sl = slice(s0, s0 + tile)
        yield sl, SliceGeom(*(t[sl] for t in geom)), chunks


def _offset_weight(geom: SliceGeom, off: torch.Tensor) -> torch.Tensor:
    """PSF weight (C, N, H, W) for C integer offsets off (C, 3), without
    subnormals."""
    o = off.to(torch.float32)[:, None, None, None, :]
    rel = [o[..., j] - geom.frac[None, ..., j] for j in range(3)]
    a = geom.a3[None, :, None, None]
    d = geom.slice_dim[None, :, None, None]
    mm = [(a[..., i, 0] * rel[0] + a[..., i, 1] * rel[1]
           + a[..., i, 2] * rel[2]) * d[..., i] for i in range(3)]
    return flush_subnormals(_psf(*mm, d[..., 0], d[..., 1], d[..., 2]))


def _lin_index(vox: torch.Tensor, shape_zyx: Tuple[int, int, int]):
    """(..., 3) int voxels (x, y, z) -> (linear index into [z, y, x]
    .ravel(), -1 out of bounds; in-bounds mask)."""
    zs, ys, xs = shape_zyx
    x, y, z = vox[..., 0], vox[..., 1], vox[..., 2]
    inb = (x >= 0) & (x < xs) & (y >= 0) & (y < ys) & (z >= 0) & (z < zs)
    lin = z * (ys * xs) + y * xs + x
    return torch.where(inb, lin, -1), inb


def _voxels(geom: SliceGeom, off: torch.Tensor) -> torch.Tensor:
    """(C, N, H, W, 3) voxels centre + offset for C offsets."""
    return geom.centre[None] + off[:, None, None, None, :]


def _inv_sume(sume: torch.Tensor) -> torch.Tensor:
    gate = sume > 0.0
    return torch.where(gate, 1.0 / torch.where(gate, sume, 1.0), 0.0)


def _transfer(name: str):
    """A transfer over (geom, offsets, ...) as the span `name`, counting
    one `psf call` and its offsets x pixels `psf pairs`."""
    def wrap(fn):
        @functools.wraps(fn)
        def f(geom: SliceGeom, offsets: np.ndarray, *a, **k):
            with annotate(name):
                count("psf call")
                count("psf pairs", len(offsets) * geom.valid.numel())
                return fn(geom, offsets, *a, **k)
        return f
    return wrap


@_transfer("psf sums")
def psf_sums(geom: SliceGeom, offsets: np.ndarray,
             vol_shape: Tuple[int, int, int]) -> torch.Tensor:
    """Per-pixel PSF normalisation `sume` (pass 1 of
    gaussianReconstructionKernel3D_tex): the sum of w over in-bounds
    voxels, zeroed where <= 0.5 or the pixel is padding."""
    out = torch.zeros(geom.valid.shape, dtype=torch.float32,
                      device=geom.valid.device)
    for sl, g, chunks in _tiles(geom, offsets):
        acc = torch.zeros_like(out[sl])
        for off in chunks:
            _, inb = _lin_index(_voxels(g, off), vol_shape)
            w = torch.where(inb, _offset_weight(g, off), 0.0)
            for c in range(w.shape[0]):
                acc = acc + w[c]
        out[sl] = acc
    return torch.where(geom.valid & (out > 0.5), out, 0.0)


@_transfer("psf scatter")
def psf_scatter(geom: SliceGeom, offsets: np.ndarray, sume: torch.Tensor,
                payloads: Sequence[torch.Tensor], mask_flat: torch.Tensor,
                vol_shape: Tuple[int, int, int]) -> Tuple[torch.Tensor, ...]:
    """Transpose-PSF accumulation: out_k[v] += (w / sume) * payload_k[p]
    over in-bounds voxels with mask != 0 (reconstruction_cuda2.cu:270-289,
    508-519).  Payloads must be zero at invalid pixels.  Returns flat
    volumes."""
    nvox = vol_shape[0] * vol_shape[1] * vol_shape[2]
    inv_sume = _inv_sume(sume)
    acc = torch.zeros((len(payloads), nvox), dtype=torch.float32,
                      device=sume.device)
    for sl, g, chunks in _tiles(geom, offsets):
        pl = torch.stack([p.reshape(geom.valid.shape)[sl].reshape(-1)
                          for p in payloads])  # (P, tile pixels)
        for off in chunks:
            c = off.shape[0]
            w = flush_subnormals(_offset_weight(g, off) * inv_sume[sl])
            w = w.reshape(c, -1)
            lin, _ = _lin_index(_voxels(g, off), vol_shape)
            lin = lin.reshape(c, -1)
            m = torch.where(lin >= 0, mask_flat[lin.clamp(min=0).long()],
                            0.0)
            wv = w * m
            ci, pi = torch.nonzero(wv != 0, as_tuple=True)
            acc.index_add_(1, lin[ci, pi].long(), pl[:, pi] * wv[ci, pi])
    return tuple(acc[i] for i in range(len(payloads)))


@_transfer("psf gather")
def psf_gather(geom: SliceGeom, offsets: np.ndarray, sume: torch.Tensor,
               vol_flat: torch.Tensor, mask_flat: torch.Tensor,
               vol_shape: Tuple[int, int, int]):
    """Forward projection (simulateSlicesKernel3D_tex): per pixel
    num = sum (w / sume) vol[v], den = sum (w / sume) over in-bounds,
    in-mask voxels.  Returns (sim = num / den where den > 0 else 0,
    sim_weight = den, inside = some in-mask voxel touched)."""
    inv_sume = _inv_sume(sume)
    num = torch.zeros(geom.valid.shape, dtype=torch.float32,
                      device=geom.valid.device)
    den = torch.zeros_like(num)
    inside = torch.zeros_like(geom.valid)
    for sl, g, chunks in _tiles(geom, offsets):
        n_t, d_t, i_t = (torch.zeros_like(t[sl]) for t in (num, den,
                                                            inside))
        for off in chunks:
            w = flush_subnormals(_offset_weight(g, off) * inv_sume[sl])
            lin, _ = _lin_index(_voxels(g, off), vol_shape)
            linc = lin.clamp(min=0).long()
            out = lin < 0
            use = torch.where(out, 0.0, mask_flat[linc]) != 0
            v = torch.where(out, 0.0, vol_flat[linc])
            wv = torch.where(use, w * v, 0.0)
            wu = torch.where(use, w, 0.0)
            for c in range(w.shape[0]):
                n_t = n_t + wv[c]
                d_t = d_t + wu[c]
            i_t = i_t | use.any(dim=0)
        num[sl], den[sl], inside[sl] = n_t, d_t, i_t
    ok = (den > 0) & (sume > 0.0) & geom.valid
    sim = torch.where(ok, num / torch.where(den > 0, den, 1.0), 0.0)
    simw = torch.where(ok, den, 0.0)
    return sim, simw, inside & ok
