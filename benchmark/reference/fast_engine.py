"""Plain PyTorch reference of the reconstruction's last stage on the fast
PSF engine: Gaussian reconstruction, simulation, the robust EM statistics
and the super-resolution loop with its edge-preserving regulariser, then
the final intensity restoration.

The fast engine's model, as the configuration states it:

    sim[p]  = (K_s * (vol . mask))(F_s p) / (K_s * mask)(F_s p)
    addon   = mask . sum_s K_s^T * splat_s(payload / sume)
    sume[p] = (K_s * 1)(F_s p)

K_s is the slice PSF (sinc^2 in plane, Gaussian through plane) rasterised
on the volume grid in stack s's orientation and cut to its separable
rank-1 triads (two-stage SVD, tolerance 1e-3, at most 8 triads); `*` is a
zero-padded correlation along each axis, sampling and splatting are
trilinear at the continuous position F_s p, zero outside the grid.  The EM
and the regulariser follow the reference program (reconstruction.cc and
irtkReconstructionGPU.cc: EStep, MStep, Scale, AdaptiveRegularization).

Everything is computed in `dtype`: float32 with full-precision matrix
products, the precision the configurations state, so that the reference
meets the same underflows as the program (the slice mixture's Gaussians
underflow to the fallback branch of the E-step when its variance sits at
its floor; float64 does not, and flips a slice's weight between 0 and 1).
With tf32=True every matrix product rounds its operands to TF32 (10-bit
mantissa) first, as tensor cores do with TF32 on: the benchmark's control.
Imports only torch and numpy.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

PSF_CONST = 2.3548   # FWHM -> sigma
STEP = 1e-4          # the reference's _step
SIGMA_FLOOR = STEP * STEP / 6.28
CONF_CUT = 0.99      # the E-step's confidence cut: simw > CONF_CUT
SUME_CUT = 0.5       # the geometry's cut: a pixel counts where sume > it
# How near a cut rounding alone can put a pixel on either side of it:
# four times the largest float32 - float64 gap of this reference near
# each cut over the recon cells' seeds on the card (simw within 1e-3 of
# CONF_CUT: 7.4e-7; (K_s * 1)(xp) within 1e-3 of SUME_CUT, where its sums
# cancel less: 6.8e-6).  The program's own simw stood within 1.2e-6 of
# the float32 reference's there, under CUT_BAND by more than twice.
CUT_BAND = 3e-6      # of CONF_CUT, on simw
SUME_BAND = 3e-5     # of SUME_CUT, on (K_s * 1)(xp)
DIRECTIONS = np.array([
    [1, 0, -1], [0, 1, -1], [1, 1, -1], [1, -1, -1],
    [1, 0, 0], [0, 1, 0], [1, 1, 0], [1, -1, 0],
    [1, 0, 1], [0, 1, 1], [1, 1, 1], [1, -1, 1],
    [0, 0, 1]], dtype=np.int64)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32 (nearest, ties to even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -0x2000
    return i.view(torch.float32)


# ----- the PSF and its separable triads ------------------------------------

def psf_support(dims: np.ndarray, recon_dx: float, quality: float = 1.0,
                max_support: int = 12) -> int:
    """The reference's PSF support size (Python's round, as the program
    uses), the largest over the slices, at most max_support."""
    size_inv = 2.0 * quality / recon_dx
    best = 3
    for d in np.atleast_2d(np.asarray(dims, np.float64)):
        xd, yd, zd = (round(float(v) * size_inv) for v in d)
        dim = int(math.floor(math.ceil(math.sqrt(xd * xd + yd * yd + zd * zd)
                                       / quality) * 0.5) * 2 + 3)
        best = max(best, dim)
    return min(best, max_support)


def psf(mm: np.ndarray, dim: np.ndarray) -> np.ndarray:
    """sinc^2 in plane x Gaussian through plane at (..., 3) mm offsets in
    the slice frame."""
    ax = mm[..., 0] * dim[0] / PSF_CONST
    ay = mm[..., 1] * dim[1] / PSF_CONST
    r = math.pi * np.sqrt(ax * ax + ay * ay)
    si = np.where(r > 1e-6, np.sin(r) / np.where(r > 1e-6, r, 1.0), 1.0)
    sz = dim[2] / PSF_CONST
    return si * si * np.exp(-mm[..., 2] ** 2 / (2.0 * sz * sz))


def stack_triads(a3: np.ndarray, dim: np.ndarray, support: int,
                 tol: float = 1e-3, max_terms: int = 8):
    """The PSF on the volume grid for one stack orientation (a3: the 3x3
    linear part of the volume-to-slice map), as rank-1 triads
    (kz, ky, kx, coeff)."""
    c = (support - 1) // 2
    r = np.arange(support) - c
    oz, oy, ox = np.meshgrid(r, r, r, indexing="ij")
    o = np.stack([ox, oy, oz], -1).astype(np.float64)
    k = psf(np.einsum("ij,abcj->abci", a3, o) * dim, dim)
    u, s, vt = np.linalg.svd(k.reshape(support, -1), full_matrices=False)
    total = np.sqrt((s ** 2).sum())
    terms = []
    for i in range(len(s)):
        if s[i] < tol * total or len(terms) >= max_terms:
            break
        u2, s2, vt2 = np.linalg.svd(vt[i].reshape(support, support),
                                    full_matrices=False)
        t2 = np.sqrt((s2 ** 2).sum())
        for j in range(len(s2)):
            if s2[j] < tol * t2 or len(terms) >= max_terms:
                break
            terms.append((u[:, i], u2[:, j], vt2[j], float(s[i] * s2[j])))
    return terms


def band(taps: np.ndarray, n: int, adjoint: bool) -> np.ndarray:
    """(n, n) matrix B of the zero-padded 1-D pass out = arr @ B:
    out[i] = sum_t taps[t] arr[i + t - r] (adjoint: arr[i - t + r]),
    r = (k - 1) // 2."""
    r = (len(taps) - 1) // 2
    b = np.zeros((n, n))
    idx = np.arange(n)
    for t, w in enumerate(taps):
        src = idx + (r - t if adjoint else t - r)
        ok = (src >= 0) & (src < n)
        b[src[ok], idx[ok]] = w
    return b


# ----- the engine ----------------------------------------------------------

class Geom(NamedTuple):
    xp: torch.Tensor     # (N, H, W, 3) continuous voxel position (x, y, z)
    sid: torch.Tensor    # (N,) stack of each slice
    valid: torch.Tensor  # (N, H, W)
    sume: torch.Tensor   # (N, H, W) raw, 0 where invalid or <= SUME_CUT
    den: torch.Tensor    # (N, H, W) (K_s * mask)(xp)
    raw: torch.Tensor    # (N, H, W) (K_s * 1)(xp)


class Engine:
    """The fast engine on one grid: per-stack triads as band matrices."""

    def __init__(self, stack_a3: Sequence[np.ndarray],
                 stack_dims: Sequence[np.ndarray], support: int,
                 vol_shape: Tuple[int, int, int], device,
                 dtype=torch.float32, tf32: bool = False):
        self.vol_shape = tuple(int(v) for v in vol_shape)
        self.device = torch.device(device)
        self.tf32 = bool(tf32)
        self.dtype = torch.float32 if tf32 else dtype
        zs, ys, xs = self.vol_shape
        self.bands = {False: [], True: []}
        for a3, dim in zip(stack_a3, stack_dims):
            terms = stack_triads(np.asarray(a3, np.float64),
                                 np.asarray(dim, np.float64), support)
            for adj in (False, True):
                self.bands[adj].append([
                    tuple(self.t(band(k, n, adj)) for k, n in
                          ((kz, zs), (ky, ys), (kx, xs))) + (c,)
                    for kz, ky, kx, c in terms])

    def t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device).to(
            self.dtype)

    def mm(self, a, b):
        if self.tf32:
            return torch.matmul(round_tf32(a), round_tf32(b))
        return torch.matmul(a, b)

    def conv(self, vol, s: int, adjoint: bool = False):
        """sum of stack s's triads over a (..., z, y, x) volume."""
        out = torch.zeros_like(vol)
        for bz, by, bx, c in self.bands[adjoint][s]:
            t = self.mm(vol, bx)
            t = self.mm(t.transpose(-1, -2), by).transpose(-1, -2)
            t = self.mm(t.transpose(-1, -3), bz).transpose(-1, -3)
            out = out + c * t
        return out

    def _corners(self, xp):
        """Per pixel and corner: flat voxel index, weight, in-grid flag."""
        zs, ys, xs = self.vol_shape
        f = torch.floor(xp)
        d = xp - f
        f = f.to(torch.int64)
        idx, wts, inb = [], [], []
        for cw in (0, 1):
            for cv in (0, 1):
                for cu in (0, 1):
                    x, y, z = f[..., 0] + cu, f[..., 1] + cv, f[..., 2] + cw
                    ok = ((x >= 0) & (x < xs) & (y >= 0) & (y < ys)
                          & (z >= 0) & (z < zs))
                    idx.append(torch.where(ok, (z * ys + y) * xs + x, 0))
                    wts.append((d[..., 0] if cu else 1 - d[..., 0])
                               * (d[..., 1] if cv else 1 - d[..., 1])
                               * (d[..., 2] if cw else 1 - d[..., 2]))
                    inb.append(ok)
        return idx, wts, inb

    def sample(self, vols, geom_xp, sid):
        """Trilinear samples of each slice's own stack volume
        (vols: (S, z, y, x))."""
        nvox = int(np.prod(self.vol_shape))
        flat = vols.reshape(-1)
        base = (sid * nvox).reshape(-1, 1, 1)
        out = torch.zeros(geom_xp.shape[:-1], dtype=self.dtype,
                          device=self.device)
        for i, w, ok in zip(*self._corners(geom_xp)):
            out = out + torch.where(ok, w * flat[base + i], 0.0)
        return out

    def splat(self, pays, geom_xp, sid):
        """Trilinear splat of payloads (P, N, H, W) into per-stack volumes
        (S, P, z, y, x)."""
        n_st = len(self.bands[False])
        nvox = int(np.prod(self.vol_shape))
        p = pays.shape[0]
        out = torch.zeros((n_st * nvox * p,), dtype=self.dtype,
                          device=self.device)
        base = (sid * nvox).reshape(-1, 1, 1)
        for i, w, ok in zip(*self._corners(geom_xp)):
            keep = ok.reshape(-1)
            tgt = (base + i).reshape(-1)[keep]
            for k in range(p):
                # index layout (stack, voxel, payload)
                out.index_add_(0, tgt * p + k,
                               (w * pays[k]).reshape(-1)[keep])
        out = out.reshape(n_st, nvox, p).permute(0, 2, 1)
        return out.reshape((n_st, p) + self.vol_shape)

    def geometry(self, recon_w2i, transforms, slice_i2w, valid, mask, sid):
        """Positions, sume and the mask denominator after a transform
        update; matrices in float64 numpy."""
        fwd = self.t(np.einsum("ij,njk,nkl->nil", recon_w2i, transforms,
                               slice_i2w))
        n, h, w = valid.shape
        px = torch.arange(w, dtype=self.dtype, device=self.device)
        py = torch.arange(h, dtype=self.dtype, device=self.device)
        xp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
              + fwd[:, None, None, :3, 1] * py[None, :, None, None]
              + fwd[:, None, None, :3, 3])
        n_st = len(self.bands[False])
        ones = torch.ones(self.vol_shape, dtype=self.dtype,
                          device=self.device)
        c1 = torch.stack([self.conv(ones, s) for s in range(n_st)])
        cm = torch.stack([self.conv(mask, s) for s in range(n_st)])
        raw = self.sample(c1, xp, sid)
        sume = torch.where(valid & (raw > SUME_CUT), raw, 0.0)
        return Geom(xp=xp, sid=sid, valid=valid, sume=sume,
                    den=self.sample(cm, xp, sid), raw=raw)

    def scatter2(self, g: Geom, pay_a, pay_b, mask):
        """mask . sum_s K_s^T * splat_s(payload / sume) for two payloads."""
        pos = g.sume > 0
        inv = torch.where(pos, 1.0 / torch.where(pos, g.sume, 1.0), 0.0)
        dense = self.splat(torch.stack([pay_a * inv, pay_b * inv]), g.xp,
                           g.sid)
        out = sum(self.conv(dense[s], s, adjoint=True)
                  for s in range(dense.shape[0]))
        m = (mask != 0).to(self.dtype)
        return out[0] * m, out[1] * m

    def simulate(self, g: Geom, vol, mask):
        """(sim, simw, inside) of a volume."""
        vm = vol * mask
        num = self.sample(torch.stack([self.conv(vm, s) for s in
                                       range(len(self.bands[False]))]),
                          g.xp, g.sid)
        pos = g.den > 0
        sim = torch.where(pos, num / torch.where(pos, g.den, 1.0), 0.0)
        inside = (g.sume > 0) & g.valid & pos
        simw = torch.where(inside, simw_of(g), 0.0)
        return torch.where(inside, sim, 0.0), simw, inside


def simw_of(g: Geom) -> torch.Tensor:
    """(N, H, W) simw = (K_s * mask)(xp) / (K_s * 1)(xp) where the pixel
    counts (0 elsewhere): the geometry and the mask alone decide it."""
    pos = g.sume > 0
    return torch.where(pos, g.den / torch.where(pos, g.sume, 1.0), 0.0)


def cut_distance(g: Geom) -> torch.Tensor:
    """(N, 2): per unit, how near its valid pixels come to the cuts that
    decide whether a pixel is in the E-step's confident set: simw to
    CONF_CUT, and (K_s * 1)(xp) to SUME_CUT (inf for a unit without valid
    pixels).  Both follow from the geometry and the mask alone, never
    from a volume."""
    simw = simw_of(g)
    d = torch.stack([(simw - CONF_CUT).abs(), (g.raw - SUME_CUT).abs()], -1)
    d = torch.where(g.valid[..., None], d, math.inf)
    return d.flatten(1, 2).amin(dim=1)


def near_cut(dist) -> np.ndarray:
    """Per unit, whether rounding alone could move one of its pixels
    across a cut: a pixel within CUT_BAND of CONF_CUT or within SUME_BAND
    of SUME_CUT (dist: cut_distance's, as numpy)."""
    return (dist[:, 0] < CUT_BAND) | (dist[:, 1] < SUME_BAND)


# ----- EM, super-resolution, regulariser ------------------------------------

class State(NamedTuple):
    recon: torch.Tensor
    sim: torch.Tensor
    simw: torch.Tensor
    inside: torch.Tensor
    weights: torch.Tensor
    scale: torch.Tensor
    slice_weight: torch.Tensor
    sigma2: torch.Tensor
    m: torch.Tensor
    mix: torch.Tensor
    mix_s: torch.Tensor
    cmap: torch.Tensor    # the lowest of the SR steps' confidence maps,
                          # before they are normalised (inf before one)


def gauss(x, s):
    return STEP * torch.exp(-x * x / (2.0 * s)) / torch.sqrt(6.28 * s)


def voxel_estep(slices, valid, scale, sim, simw, sigma2, m, mix):
    s = slices * scale[:, None, None]
    use = valid & (simw > 0.0)
    e = torch.where(use, s - sim, 0.0)
    g = gauss(e, sigma2)
    post = g * mix / (g * mix + m * STEP * (1.0 - mix))
    weights = torch.where(use, post, 0.0)
    conf = use & (simw > CONF_CUT)
    num = conf.sum(dim=(1, 2))
    pot = torch.where(conf, (1.0 - weights) ** 2, 0.0).sum(dim=(1, 2))
    potential = torch.where(num > 0, torch.sqrt(pot / num.clamp(min=1)),
                            -1.0)
    return weights, potential


def slice_estep(potential, slice_weight, mix_s):
    """The slice-level two-Gaussian mixture and its posterior."""
    ok = potential >= 0.0
    w = torch.where(ok, slice_weight, 0.0)
    wo = torch.where(ok, 1.0 - slice_weight, 0.0)
    p = torch.where(ok, potential, 0.0)
    den, den2 = w.sum(), wo.sum()
    maxs = torch.where(ok, potential, 0.0).max()
    mins = torch.where(ok, potential, 1.0).min()
    mean_s = torch.where(den > 0, (p * w).sum() / den.clamp(min=1e-30), mins)
    mean_s2 = torch.where(den2 > 0, (p * wo).sum() / den2.clamp(min=1e-30),
                          (maxs + mean_s) / 2.0)
    v1 = ((p - mean_s) ** 2 * w).sum()
    v2 = ((p - mean_s2) ** 2 * wo).sum()
    sigma_s = torch.where((v1 > 0) & (den > 0),
                          (v1 / den.clamp(min=1e-30)).clamp(min=SIGMA_FLOOR),
                          0.025)
    sigma_s2 = torch.where((v2 > 0) & (den2 > 0), v2 / den2.clamp(min=1e-30),
                           (mean_s2 - mean_s) ** 2 / 4.0).clamp(
                               min=SIGMA_FLOOR)
    gs1 = torch.where(potential < mean_s2, gauss(potential - mean_s, sigma_s),
                      0.0)
    gs2 = torch.where(potential > mean_s, gauss(potential - mean_s2,
                                                sigma_s2), 0.0)
    lik = gs1 * mix_s + gs2 * (1.0 - mix_s)
    post = torch.where(lik > 0, gs1 * mix_s / lik.clamp(min=1e-30),
                       torch.where(potential <= mean_s, 1.0,
                                   torch.where(potential >= mean_s2, 0.0,
                                               1.0)))
    degenerate = (den <= 0) | (mean_s2 <= mean_s)
    new_w = torch.where(ok, torch.where(degenerate, 1.0, post), 0.0)
    nvalid = ok.sum()
    mix_new = torch.where(nvalid > 0, torch.where(ok, new_w, 0.0).sum()
                          / nvalid.clamp(min=1), 0.9)
    return new_w, mix_new


def estep(slices, valid, st: State, excluded):
    weights, potential = voxel_estep(slices, valid, st.scale, st.sim,
                                     st.simw, st.sigma2, st.m, st.mix)
    bad = (st.scale < 0.2) | (st.scale > 5.0)
    potential = torch.where(excluded | bad, -1.0, potential)
    sw, mix_s = slice_estep(potential, st.slice_weight, st.mix_s)
    return st._replace(weights=weights, slice_weight=sw,
                       mix_s=mix_s.to(sw.dtype))


def mstep(slices, valid, st: State, iteration: int):
    s = slices * st.scale[:, None, None]
    use = valid & (st.simw > CONF_CUT)
    e = torch.where(use, s - st.sim, 0.0)
    ssum = (e * e * st.weights * use).sum()
    msum = (st.weights * use).sum()
    num = use.sum()
    emin = torch.where(use, e, 0.0).min()
    emax = torch.where(use, e, 0.0).max()
    sigma2 = (ssum / msum.clamp(min=1e-30)).clamp(min=SIGMA_FLOOR)
    mix = msum / num.clamp(min=1) if iteration > 1 else st.mix
    return st._replace(sigma2=sigma2, mix=mix.to(sigma2.dtype),
                       m=1.0 / (emax - emin).clamp(min=1e-30))


def scale_step(slices, valid, st: State):
    use = valid & (st.simw > CONF_CUT)
    seb = torch.where(use, slices, 0.0)
    num = (st.weights * seb * st.sim * use).sum(dim=(1, 2))
    den = (st.weights * seb * seb).sum(dim=(1, 2))
    return torch.where(den > 0, num / den.clamp(min=1e-30), 1.0)


def shift(arr, d):
    """out[z, y, x] = arr[z + dz, y + dy, x + dx], zero outside."""
    out = torch.zeros_like(arr)
    src, dst = [], []
    for s, n in ((int(d[2]), arr.shape[0]), (int(d[1]), arr.shape[1]),
                 (int(d[0]), arr.shape[2])):
        src.append(slice(max(s, 0), n + min(s, 0)))
        dst.append(slice(max(-s, 0), n - max(s, 0)))
    out[tuple(dst)] = arr[tuple(src)]
    return out


def inside_after(shape, d, device):
    zs, ys, xs = shape
    z = torch.arange(zs, device=device)[:, None, None] + int(d[2])
    y = torch.arange(ys, device=device)[None, :, None] + int(d[1])
    x = torch.arange(xs, device=device)[None, None, :] + int(d[0])
    return ((x >= 0) & (x < xs) & (y >= 0) & (y < ys) & (z >= 0)
            & (z < zs))


def regularise(recon, original, cmap, alpha, lam, delta):
    """AdaptiveRegularization, both passes: pass 1 weighs each of the 13
    directions by the edge in the pre-update volume, pass 2 diffuses the
    post-update volume with those weights and the confidence map."""
    shape, dev = tuple(recon.shape), recon.device
    factors = 1.0 / np.abs(DIRECTIONS).sum(axis=1)
    bs = []
    for d, f in zip(DIRECTIONS, factors):
        diff = (shift(original, d) - original) * math.sqrt(f) / delta
        ok = inside_after(shape, d, dev) & (cmap > 0) & (shift(cmap, d) > 0)
        bs.append(torch.where(ok, f / torch.sqrt(1.0 + diff * diff), 0.0))
    val = torch.zeros_like(recon)
    valw = torch.zeros_like(recon)
    ssum = torch.zeros_like(recon)
    for d, b in zip(DIRECTIONS, bs):
        for dd, bb in ((d, b), (-d, shift(b, -d))):
            ok = inside_after(shape, dd, dev)
            c = shift(cmap, dd)
            val = val + torch.where(ok, bb * shift(recon, dd) * c, 0.0)
            valw = valw + torch.where(ok, bb * c, 0.0)
            ssum = ssum + torch.where(ok, bb, 0.0)
    val = val - ssum * recon * cmap
    valw = valw - ssum * cmap
    reg = alpha * lam / (delta * delta)
    val = recon * cmap + reg * val
    valw = cmap + reg * valw
    pos = valw > 0
    return torch.where(pos, val / torch.where(pos, valw, 1.0), 0.0)


class Problem(NamedTuple):
    """Inputs of the last stage, on the engine's device and dtype."""
    slices: torch.Tensor   # (N, H, W), -1 where invalid
    valid: torch.Tensor    # (N, H, W) bool
    mask: torch.Tensor     # (z, y, x) 0 / 1
    geom: Geom
    max_i: float
    min_i: float


def problem(eng: Engine, slices: np.ndarray, slice_i2w, stack_index,
            transforms, recon_w2i, mask: np.ndarray) -> Problem:
    """Geometry and intensity range of a slice batch (numpy inputs)."""
    s = eng.t(slices)
    valid = s != -1.0
    m = eng.t(mask)
    sid = torch.as_tensor(np.asarray(stack_index, np.int64),
                          device=eng.device)
    geom = eng.geometry(np.asarray(recon_w2i, np.float64),
                        np.asarray(transforms, np.float64),
                        np.asarray(slice_i2w, np.float64), valid, m, sid)
    pos = slices[slices > 0]
    return Problem(s, valid, m, geom, float(pos.max()), float(pos.min()))


def start(eng: Engine, p: Problem):
    """Gaussian reconstruction, the small-slice exclusion, simulation,
    the initial robust statistics and the first E-step.  Returns
    (state, excluded)."""
    dt, dev = eng.dtype, eng.device
    n = p.slices.shape[0]
    gate = p.valid & (p.geom.sume > 0)
    num, wts = eng.scatter2(p.geom, torch.where(gate, p.slices, 0.0),
                            torch.where(gate, 1.0, 0.0).to(dt), p.mask)
    recon = torch.where(wts > 0, num / torch.where(wts > 0, wts, 1.0), num)
    vc = (gate & (p.geom.den > 0)).sum(dim=(1, 2)).cpu().numpy()
    median = np.sort(vc)[int(round(len(vc) * 0.5))]
    excluded = torch.as_tensor(vc < 0.1 * median, device=dev)
    sim, simw, inside = eng.simulate(p.geom, recon, p.mask)
    use = p.valid & inside & (simw > CONF_CUT)
    e = torch.where(use, p.slices - sim, 0.0)
    sigma2 = (e * e).sum() / use.sum().clamp(min=1)
    scalar = lambda v: torch.tensor(v, dtype=dt, device=dev)  # noqa: E731
    slice_in = inside.any(dim=2).any(dim=1)
    st = State(recon=recon, sim=sim, simw=simw, inside=inside,
               weights=p.valid.to(dt),
               scale=torch.ones(n, dtype=dt, device=dev),
               slice_weight=torch.where(slice_in & ~excluded, 1.0, 0.0).to(
                   dt),
               sigma2=sigma2.to(dt),
               m=scalar(1.0 / (2.1 * p.max_i - 1.9 * p.min_i)),
               mix=scalar(0.9), mix_s=scalar(0.9),
               cmap=torch.full_like(recon, math.inf))
    return estep(p.slices, p.valid, st, excluded), excluded


def inner(eng: Engine, p: Problem, st: State, excluded, alpha, lam, delta,
          iteration: int) -> State:
    """One SR / EM iteration: scale, super-resolution + regularisation,
    simulation, M-step, E-step (no bias field)."""
    st = st._replace(scale=scale_step(p.slices, p.valid, st))
    gated = p.valid & (p.geom.sume > 0)
    s = p.slices * st.scale[:, None, None]
    resid = torch.where(st.sim > 0, s - st.sim, 0.0)
    wfac = st.weights * st.slice_weight[:, None, None]
    addon, cmap = eng.scatter2(p.geom, torch.where(gated, resid * wfac, 0.0),
                               torch.where(gated, wfac, 0.0), p.mask)
    st = st._replace(cmap=torch.minimum(st.cmap, cmap))
    pos = cmap > 0
    addon = torch.where(pos, addon / torch.where(pos, cmap, 1.0), addon)
    cmap = torch.where(pos, 1.0, cmap)
    original = st.recon
    recon = torch.clamp(original + alpha * addon, 0.9 * p.min_i,
                        1.1 * p.max_i)
    recon = regularise(recon, original, cmap, alpha, lam, delta)
    sim, simw, inside = eng.simulate(p.geom, recon, p.mask)
    st = st._replace(recon=recon, sim=sim, simw=simw, inside=inside)
    st = mstep(p.slices, p.valid, st, iteration)
    return estep(p.slices, p.valid, st, excluded)


def finish(p: Problem, st: State, stack_factors, stack_index):
    """Mask the volume (-1 outside), then restore the slices' original
    intensities and rescale the volume to them."""
    recon = torch.where(p.mask == 0, -1.0, st.recon)
    f = torch.as_tensor(np.asarray(stack_factors, np.float64)[
        np.asarray(stack_index)], device=p.slices.device).to(p.slices.dtype)
    restored = torch.where(p.slices > 0, p.slices / f[:, None, None],
                           p.slices)
    use = p.valid & (st.simw > CONF_CUT)
    sw = st.slice_weight[:, None, None]
    num = torch.where(use, st.weights * sw * restored * st.sim, 0.0).sum()
    den = torch.where(use, st.weights * sw * st.sim * st.sim, 0.0).sum()
    scale = num / den.clamp(min=1e-30)
    return torch.where(recon > 0, recon * scale, recon)


def settled(st: State, mask, ratio: float = 1e-3, reach: int = 2):
    """The voxels whose values do not hang on rounding: inside the mask, a
    voxel whose confidence map fell in some SR step under `ratio` of the
    median voxel's is divided by a sum that is nought to rounding, and the
    regulariser carries what that gives `reach` voxels on; those voxels
    are left out.  Returns a bool volume of the voxels to compare."""
    low = st.cmap
    med = torch.quantile(low[(low > 0) & torch.isfinite(low)].float().cpu(),
                         0.5).item() if bool((low > 0).any()) else 0.0
    bad = ((mask != 0) & (low < ratio * med)).to(torch.float32)[None, None]
    k = 2 * reach + 1
    near = torch.nn.functional.max_pool3d(bad, k, stride=1, padding=reach)
    return near[0, 0] == 0


def smoothing(delta: float, lambda_: float):
    """(alpha, lambda * delta^2), alpha = min(0.05 / lambda, 1)."""
    return min(0.05 / lambda_, 1.0), lambda_ * delta * delta


def stack_geometry(slice_i2w, stack_index, dims, recon_w2i):
    """Each stack's a3 (the inverse linear part of its first slice's
    volume map) and voxel size."""
    a3s, sdims = [], []
    idx = np.asarray(stack_index)
    for s in range(int(idx.max()) + 1):
        first = int(np.nonzero(idx == s)[0][0])
        fwd = np.asarray(recon_w2i, np.float64) @ np.asarray(
            slice_i2w[first], np.float64)
        a3s.append(np.linalg.inv(fwd[:3, :3]))
        sdims.append(np.asarray(dims[first], np.float64))
    return a3s, sdims


class Last(NamedTuple):
    """What the last stage gives: the final state, then as numpy the
    (restored, masked) volume, the voxels to compare, per unit whether
    rounding alone could move one of its pixels across a cut (near_cut),
    and how near its pixels come to each cut (cut_distance's)."""
    state: State
    volume: np.ndarray
    settled: np.ndarray
    near_cut: np.ndarray
    cut_distance: np.ndarray


def engine(slice_i2w, stack_index, dims, recon_w2i, recon_dx: float,
           vol_shape, device, dtype=torch.float32,
           tf32: bool = False) -> Engine:
    """The fast engine of a slice batch on the reconstruction's grid."""
    a3s, sdims = stack_geometry(slice_i2w, stack_index, dims, recon_w2i)
    return Engine(a3s, sdims, psf_support(dims, recon_dx), vol_shape,
                  device, dtype, tf32)


def last_stage(slices, slice_i2w, stack_index, dims, transforms, recon_w2i,
               recon_dx: float, vol_shape, mask, stack_factors,
               iterations: int, delta: float, lambda_: float, device,
               dtype=torch.float32, tf32: bool = False) -> Last:
    """The whole last stage from numpy inputs."""
    eng = engine(slice_i2w, stack_index, dims, recon_w2i, recon_dx,
                 vol_shape, device, dtype, tf32)
    p = problem(eng, slices, slice_i2w, stack_index, transforms, recon_w2i,
                mask)
    dist = cut_distance(p.geom).cpu().numpy()
    st, excluded = start(eng, p)
    alpha, lam = smoothing(delta, lambda_)
    for it in range(iterations):
        st = inner(eng, p, st, excluded, alpha, lam, delta, it + 1)
    return Last(st, finish(p, st, stack_factors, stack_index).cpu().numpy(),
                settled(st, p.mask).cpu().numpy(), near_cut(dist), dist)
