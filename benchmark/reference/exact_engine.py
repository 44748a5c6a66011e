"""Plain PyTorch reference of the reconstruction's last stage on the exact
PSF engine: the upstream program's own point-spread function, evaluated
for every slice pixel and every voxel of its support.

From the upstream description (bkainz/fetalReconstruction,
reconstruction_cuda2.cu): `calcPSF` (:112-131) is a Bartlett sinc^2 in
the slice plane times a Gaussian through it, at a voxel's place in the
slice's frame, which the inverse of the slice's combined transform gives
(`getPSFParamsPrecomp`, :164).  `gaussianReconstructionKernel3D_tex`
(:176) walks, for each slice pixel, the support cube around the voxel
nearest the pixel's place: pass 1 sums the weights over the voxels inside
the grid (`sume`; the pixel is dropped where the sum is 0.5 or less), pass
2 adds psf / sume times the pixel's value and weight to the voxels in the
mask.  `simulateSlicesKernel3D_tex` (:298) sums (psf / sume) vol over the
in-grid, in-mask voxels and divides by the sum of their psf / sume;
`SuperresolutionKernel3D_tex` (:408) adds the weighted residual and the
weight as pass 2 does.  Written out:

    xp     = F_s (x, y, 0, 1), F_s = reconW2I T_s sliceI2W (voxel units)
    c      = roundf(xp), halves away from zero
    voxels = c + o for o in [-(K - 1) // 2, K // 2]^3, K the support
    mm     = dim_s . (A_s (c + o - xp)): A_s the linear part of F_s^-1,
             dim_s the slice's (dx, dy, thickness)
    w      = sinc^2(pi |(mm_x dx, mm_y dy)| / 2.3548)
             . exp(-mm_z^2 / (2 (dz / 2.3548)^2))
    raw[p] = sum of w over the voxels inside the grid; sume = raw where
             the pixel is valid and raw > 0.5, else 0
    simw[p] = sum of w / sume over the voxels inside the grid and mask
    simulate: sim = (sum of (w / sume) vol over those voxels) / simw
    scatter:  out_k[v] += (w / sume) payload_k[p] where v is in the mask

The E-step's confident set is a cut on simw (0.99), which a pixel can sit
within rounding of, and a centre that rounding decides moves the whole
support by a voxel.  So the reference rounds as the upstream does: F_s
and A_s are formed in float32 on the device, as the program forms them,
and each
per-pixel sum adds one support voxel after another in the kernels' loop
order (z, y, x, x fastest), each weight over sume before it is added (in
float64, `dtype`, only the place within the centre voxel and the sums
change).  With blocked=True each block of offsets is summed first and
the block's sum added: another float32 order, the second witness of
what rounding alone moves.  The scatter adds in any order, as the
kernels' atomics do.  K is the upstream's support formula at the
configuration's quality factor, capped at its `max_psf_support`
(fast_engine.psf_support).  No weight is flushed: a float32 weight under
the smallest normal, which the program flushes, needs a through-plane
distance far outside the support (at 5 mm slices the support's farthest
corner weighs 7e-7 through plane).

The EM, the regulariser, the restoration and the voxels left out of the
volume's comparison are fast_engine's, run on this module's geometry; the
units near a cut follow this module's own bands.  Everything is computed
in `dtype`, float32 by default, TF32 off.  With tf32=True every PSF weight
and every payload or volume value is rounded to TF32 (10-bit mantissa) at
each pixel-offset pair, before its product: the benchmark's control.
Imports only torch, numpy and fast_engine.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from . import fast_engine as fe

PSF_CONST = fe.PSF_CONST
PAIRS_PER_STEP = 1 << 25  # pixel-offset pairs held at once
# How near a cut rounding alone can put a pixel on either side of it:
# above the largest gap between two float32 orders of simw within 1e-3 of
# CONF_CUT on the card (this reference's loop order and its blocked one,
# or the program; at most 5.24e-6 over 12 seeds, the two orders' gaps
# from float64 added).  A pixel nearer the cut than that may fall on
# either side in a program that sums in another order.  No pixel's raw
# came within 1e-3 of SUME_CUT on 24 seeds (nearest 0.025); raw sums the
# same weights as simw, unnormalised, so it takes simw's band.
CUT_BAND = 6e-6      # of CONF_CUT, on simw
SUME_BAND = 6e-6     # of SUME_CUT, on raw


def offsets(support: int) -> np.ndarray:
    """(K^3, 3) integer (x, y, z) offsets of the support cube, x fastest."""
    r = np.arange(support) - (support - 1) // 2
    z, y, x = np.meshgrid(r, r, r, indexing="ij")
    return np.stack([x.ravel(), y.ravel(), z.ravel()], -1)


class Geom(NamedTuple):
    """Per pixel: its support's centre voxel and the place within it, the
    slice's A_s and dim_s, and the sums that the geometry and the mask
    decide (under fast_engine's names sume, den and raw, what
    fast_engine.start reads)."""
    centre: torch.Tensor  # (N, H, W, 3) int64 (x, y, z)
    frac: torch.Tensor    # (N, H, W, 3) xp - centre
    a3: torch.Tensor      # (N, 3, 3)
    dims: torch.Tensor    # (N, 3)
    valid: torch.Tensor   # (N, H, W)
    sume: torch.Tensor    # (N, H, W) raw, 0 where invalid or <= SUME_CUT
    den: torch.Tensor     # (N, H, W) simw: fast_engine's den / sume
    raw: torch.Tensor     # (N, H, W) sum of w over in-grid voxels


class Engine:
    """The exact engine on one grid for one batch of slices."""

    def __init__(self, dims, support: int, vol_shape, device,
                 dtype=torch.float32, tf32: bool = False,
                 blocked: bool = False):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.vol_shape = tuple(int(v) for v in vol_shape)
        self.device = torch.device(device)
        self.tf32 = bool(tf32)
        self.blocked = bool(blocked)
        self.dtype = torch.float32 if tf32 else dtype
        self.dims = self.t(np.asarray(dims, np.float64))
        self.offsets = torch.as_tensor(offsets(support), device=self.device)

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    def rounded(self, x: torch.Tensor) -> torch.Tensor:
        return fe.round_tf32(x) if self.tf32 else x

    def pairs(self, g: Geom):
        """The pixel-offset pairs, a block of offsets at a time: each
        pair's voxel (flat index into [z, y, x], 0 outside the grid),
        whether it lies inside the grid, and its weight (rounded for the
        control); (C, N * H * W) each."""
        zs, ys, xs = self.vol_shape
        hi = torch.tensor([xs, ys, zs], device=self.device)
        npix = g.valid.numel()
        c = g.centre.reshape(1, npix, 3)
        f = g.frac.reshape(1, npix, 3)
        n, h, w = g.valid.shape
        a3 = g.a3.repeat_interleave(h * w, 0)[None]       # (1, npix, 3, 3)
        dims = g.dims.repeat_interleave(h * w, 0)[None]   # (1, npix, 3)
        step = max(1, PAIRS_PER_STEP // npix)
        for s in range(0, len(self.offsets), step):
            o = self.offsets[s:s + step][:, None, :]       # (C, 1, 3)
            vox = c + o
            inside = ((vox >= 0) & (vox < hi)).all(-1)
            flat = (vox[..., 2] * ys + vox[..., 1]) * xs + vox[..., 0]
            d = o.to(self.dtype) - f                       # (C, npix, 3)
            mm = (a3[..., 0] * d[..., 0:1] + a3[..., 1] * d[..., 1:2]
                  + a3[..., 2] * d[..., 2:3]) * dims
            yield (torch.where(inside, flat, 0), inside,
                   self.rounded(psf(mm, dims)))

    def walk(self, g: Geom, term):
        """Per pixel, the sum of term(vox, inside, w) (C, N * H * W) over
        its support, one offset after another in the support's loop
        order, as the upstream's kernels add (blocked: a block's sum at a
        time)."""
        acc = torch.zeros(g.valid.numel(), dtype=self.dtype,
                          device=self.device)
        for pair in self.pairs(g):
            terms = term(*pair)
            if self.blocked:
                acc = acc + terms.sum(0)
                continue
            for t in terms:
                acc = acc + t
        return acc.reshape(g.valid.shape)

    def places(self, fwd, shape, dtype):
        """xp (N, H, W, 3) of every pixel under fwd (N, 4, 4)."""
        n, h, w = shape
        fwd = fwd.to(dtype)
        px = torch.arange(w, dtype=dtype, device=self.device)
        py = torch.arange(h, dtype=dtype, device=self.device)
        return (fwd[:, None, None, :3, 0] * px[None, None, :, None]
                + fwd[:, None, None, :3, 1] * py[None, :, None, None]
                + fwd[:, None, None, :3, 3])

    def geometry(self, recon_w2i, transforms, slice_i2w, valid, mask, sid):
        """Each pixel's support and its sums after a transform update;
        matrices in float64 numpy (sid, the stack of each slice, is not
        needed: the PSF is the slice's own)."""
        f32 = torch.float32
        fwd = torch.einsum("ij,njk,nkl->nil", *(
            torch.as_tensor(np.asarray(a), dtype=f32, device=self.device)
            for a in (recon_w2i, transforms, slice_i2w)))
        xp = self.places(fwd, valid.shape, f32)
        centre = torch.sign(xp) * torch.floor(xp.abs() + 0.5)
        a3 = torch.linalg.inv(fwd[:, :3, :3])
        if self.dtype != f32:
            fwd = self.t(np.einsum("ij,njk,nkl->nil", recon_w2i, transforms,
                                   slice_i2w))
            xp = self.places(fwd, valid.shape, self.dtype)
            a3 = torch.linalg.inv(fwd[:, :3, :3])
        g = Geom(centre.to(torch.int64), xp - centre.to(self.dtype), a3,
                 self.dims, valid, None, None, None)
        raw = self.walk(g, lambda vox, inside, w:
                        torch.where(inside, w, 0.0))
        sume = torch.where(valid & (raw > fe.SUME_CUT), raw, 0.0)
        inv = _inverse(sume).reshape(-1)
        m = mask.reshape(-1) != 0
        simw = self.walk(g, lambda vox, inside, w:
                         torch.where(inside & m[vox], w * inv, 0.0))
        return g._replace(sume=sume, den=simw, raw=raw)

    def scatter2(self, g: Geom, pay_a, pay_b, mask):
        """out_k[v] = sum of (w / sume) payload_k[p] over the pairs whose
        voxel v lies in the mask, for two payloads."""
        inv = _inverse(g.sume).reshape(-1)
        pays = [self.rounded(p.reshape(-1)) for p in (pay_a, pay_b)]
        m = mask.reshape(-1) != 0
        out = torch.zeros((2, m.numel()), dtype=self.dtype,
                          device=self.device)
        live = g.sume.reshape(-1) > 0
        for vox, inside, w in self.pairs(g):
            ci, pi = torch.nonzero(inside & m[vox] & live[None],
                                   as_tuple=True)
            wk = w[ci, pi] * inv[pi]
            for k in range(2):
                out[k].index_add_(0, vox[ci, pi], wk * pays[k][pi])
        return tuple(o.reshape(self.vol_shape) for o in out)

    def simulate(self, g: Geom, vol, mask):
        """(sim, simw, inside) of a volume."""
        m = mask.reshape(-1) != 0
        v = self.rounded(vol.reshape(-1))
        inv = _inverse(g.sume).reshape(-1)
        num = self.walk(g, lambda vox, inside, w:
                        torch.where(inside & m[vox], w * inv * v[vox], 0.0))
        inside = (g.sume > 0) & g.valid & (g.den > 0)
        sim = torch.where(inside, num / torch.where(inside, g.den, 1.0), 0.0)
        return sim, torch.where(inside, g.den, 0.0), inside


def _inverse(x: torch.Tensor) -> torch.Tensor:
    """1 / x where x > 0, else 0."""
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, 1.0), 0.0)


def psf(mm: torch.Tensor, dims: torch.Tensor) -> torch.Tensor:
    """calcPSF at (..., 3) mm in the slice's frame, dims (..., 3) the
    slice's (dx, dy, thickness)."""
    ax = mm[..., 0] * dims[..., 0] / PSF_CONST
    ay = mm[..., 1] * dims[..., 1] / PSF_CONST
    r = math.pi * torch.sqrt(ax * ax + ay * ay)
    big = r > 1e-6
    si = torch.where(big, torch.sin(r) / torch.where(big, r, 1.0), 1.0)
    sz = dims[..., 2] / PSF_CONST
    return si * si * torch.exp(-mm[..., 2] ** 2 / (2.0 * sz * sz))


def cut_distance(g: Geom) -> torch.Tensor:
    """(N, 2): per unit, how near its valid pixels come to the cuts that
    decide whether a pixel is in the E-step's confident set: simw to
    CONF_CUT, and raw to SUME_CUT (inf for a unit without valid pixels);
    fast_engine.cut_distance's, on this geometry."""
    d = torch.stack([(g.den - fe.CONF_CUT).abs(),
                     (g.raw - fe.SUME_CUT).abs()], -1)
    d = torch.where(g.valid[..., None], d, math.inf)
    return d.flatten(1, 2).amin(dim=1)


def near_cut(dist) -> np.ndarray:
    """Per unit, whether rounding alone could move one of its pixels
    across a cut: a pixel within CUT_BAND of CONF_CUT or within SUME_BAND
    of SUME_CUT (dist: cut_distance's, as numpy)."""
    return (dist[:, 0] < CUT_BAND) | (dist[:, 1] < SUME_BAND)


def engine(dims, recon_dx: float, vol_shape, device, *, quality: float,
           max_support: int, dtype=torch.float32, tf32: bool = False,
           blocked: bool = False) -> Engine:
    """The exact engine of a slice batch on the reconstruction's grid, its
    support the upstream's formula at `quality` capped at max_support
    (the configuration's quality_factor and max_psf_support)."""
    return Engine(dims, fe.psf_support(dims, recon_dx, quality, max_support),
                  vol_shape, device, dtype, tf32, blocked)


def last_stage(slices, slice_i2w, stack_index, dims, transforms, recon_w2i,
               recon_dx: float, vol_shape, mask, stack_factors,
               iterations: int, delta: float, lambda_: float, device, *,
               quality: float, max_support: int, dtype=torch.float32,
               tf32: bool = False, blocked: bool = False) -> fe.Last:
    """The whole last stage from numpy inputs (fast_engine.last_stage's
    arguments and result), at the support of `quality` and max_support."""
    eng = engine(dims, recon_dx, vol_shape, device, quality=quality,
                 max_support=max_support, dtype=dtype, tf32=tf32,
                 blocked=blocked)
    p = fe.problem(eng, slices, slice_i2w, stack_index, transforms,
                   recon_w2i, mask)
    dist = cut_distance(p.geom).cpu().numpy()
    st, excluded = fe.start(eng, p)
    alpha, lam = fe.smoothing(delta, lambda_)
    for it in range(iterations):
        st = fe.inner(eng, p, st, excluded, alpha, lam, delta, it + 1)
    return fe.Last(st, fe.finish(p, st, stack_factors,
                                 stack_index).cpu().numpy(),
                   fe.settled(st, p.mask).cpu().numpy(), near_cut(dist),
                   dist)
