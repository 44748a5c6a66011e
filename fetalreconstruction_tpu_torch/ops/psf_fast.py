"""Fast PSF engine: per-stack separable convolution + trilinear sampling.

Port of fetalreconstruction_tpu/ops/psf_fast.py (fast engine only):

    sim[p]  = (K_s * (vol . mask))(F_s p) / (K_s * mask)(F_s p)
    addon   = mask . (K_s * splat(payload / sume))
    sume[p] = (K_s * 1_volume)(F_s p)

K_s is the PSF rasterised on the volume grid in stack s's orientation,
decomposed into separable rank-1 triads; `*` is zero-padded volume
convolution and sampling / splatting is trilinear at the continuous
position F_s p.  See the JAX module for the two documented deviations from
the reference's exact model.

One conv form is ported: each 1-D pass is a product with an (n, n) banded
matrix (`torch.matmul`, as the JAX package leaves it to XLA).  It must run
in full float32: on the card `torch.backends.cuda.matmul.allow_tf32` has to
be False (PyTorch's default), and `conv_separable` raises otherwise.  No
pass goes through cuDNN.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import scatter
from .psf import calc_psf
from .scatter import corner_weights


class FastGeom(NamedTuple):
    """Per-pixel continuous sampling geometry (rebuilt after registration).

    xp:    (N, H, W, 3) f32 continuous volume position F_s p (x, y, z)
    valid: (N, H, W)   bool
    sume:  (N, H, W)   f32  PSF normalisation (conv(1))(xp), 0-gated
    sid:   (N,)        i64  stack index per slice
    den:   (N, H, W)   f32  (conv(mask))(xp), constant between rebuilds
    plan:  scatter.ScatterPlan for the transpose splat
    """
    xp: torch.Tensor
    valid: torch.Tensor
    sume: torch.Tensor
    sid: torch.Tensor
    den: torch.Tensor
    plan: scatter.ScatterPlan


def stack_kernel(a3: np.ndarray, slice_dim: np.ndarray,
                 support: int) -> np.ndarray:
    """Rasterise the PSF on the volume grid for one stack orientation.

    a3: (3,3) linear part of F^{-1} for the stack's identity-motion
    geometry; slice_dim: (3,).  Returns the [z,y,x]-ordered (K,K,K) f32
    kernel.
    """
    centre = (support - 1) // 2
    r = np.arange(support) - centre
    oz, oy, ox = np.meshgrid(r, r, r, indexing="ij")
    o = np.stack([ox, oy, oz], axis=-1).astype(np.float64)  # (K,K,K,3)
    mm = np.einsum("ij,abcj->abci", a3, o) * slice_dim[None, None, None, :]
    k = calc_psf(torch.from_numpy(mm.astype(np.float32)),
                 torch.from_numpy(np.asarray(slice_dim, np.float32)))
    return k.numpy().astype(np.float32)


def separable_decompose(kernel: np.ndarray, tol: float = 1e-3,
                        max_terms: int = 8):
    """Decompose a (K,K,K) kernel into rank-1 triads via two-stage SVD.

    Returns a list of (kz, ky, kx, coeff) with
    kernel ~= sum coeff * kz x ky x kx.
    """
    kz, ky, kx = kernel.shape
    m1 = kernel.reshape(kz, ky * kx)
    u, s, vt = np.linalg.svd(m1, full_matrices=False)
    total = np.sqrt((s ** 2).sum())
    terms = []
    for i in range(len(s)):
        if s[i] < tol * total or len(terms) >= max_terms:
            break
        m2 = vt[i].reshape(ky, kx)
        u2, s2, vt2 = np.linalg.svd(m2, full_matrices=False)
        t2 = np.sqrt((s2 ** 2).sum())
        for j in range(len(s2)):
            if s2[j] < tol * t2 or len(terms) >= max_terms:
                break
            terms.append((u[:, i].astype(np.float32),
                          u2[:, j].astype(np.float32),
                          vt2[j].astype(np.float32),
                          float(s[i] * s2[j])))
    return terms


def band_matrix(taps: np.ndarray, n: int, adjoint: bool = False
                ) -> np.ndarray:
    """(n, n) f32 banded matrix of the zero-padded 1-D tap pass, applied as
    out = arr @ B along an axis of length n.

    Forward:  out[i] = sum_t taps[t] arr[i + t - r]
    Adjoint:  out[j] = sum_t taps[t] arr[j - t + r]
    with r = (k-1)//2 (even supports treat tap (k-1)//2 as centre, so the
    adjoint also shifts by one; forward and adjoint agree on it)."""
    taps = np.asarray(taps, np.float32)
    r = (len(taps) - 1) // 2
    b = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    for t, w in enumerate(taps):
        src = idx + (r - t if adjoint else t - r)
        ok = (src >= 0) & (src < n)
        b[src[ok], idx[ok]] = w
    return b


class BandTerm(NamedTuple):
    """One separable triad as banded matrices on a device."""
    bz: torch.Tensor
    by: torch.Tensor
    bx: torch.Tensor
    coeff: float


def band_terms(terms, vol_shape, flip: bool, device) -> List[BandTerm]:
    """Banded-matrix form of one stack's triads for a [z, y, x] volume.

    flip=True gives the adjoint pass: the individual SVD triads are not
    per-axis symmetric, so the transpose uses per-axis flipped taps."""
    zs, ys, xs = vol_shape
    out = []
    for kz, ky, kx, c in terms:
        mats = [torch.from_numpy(band_matrix(k, n, flip)).to(device)
                for k, n in ((kz, zs), (ky, ys), (kx, xs))]
        out.append(BandTerm(*mats, float(c)))
    return out


def conv_separable(vol: torch.Tensor, bands: Sequence[BandTerm]):
    """Apply a sum of separable triads to a (..., z, y, x) volume."""
    if vol.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("conv_separable needs full float32 matmuls: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    out = torch.zeros_like(vol)
    for b in bands:
        t = torch.matmul(vol, b.bx)
        t = torch.einsum("...yx,yw->...wx", t, b.by)
        t = torch.einsum("...zyx,zw->...wyx", t, b.bz)
        out = out + b.coeff * t
    return out


def make_shingle(vols: Sequence[torch.Tensor]) -> torch.Tensor:
    """Stack volumes into a corner-major shingled table for fast gathers.

    vols: P [z,y,x] tensors of one shape.  Returns (8P, (zs+1)(ys+1)(xs+1))
    f32: row p*8+c holds, over the one-voxel-front-halo grid (position
    index ((z+1)(ys+1) + y+1)(xs+1) + x+1, so floor index -1 is valid),
    corner c of volume p's 2x2x2 window starting at that voxel; zero
    outside the volume.
    """
    cols = []
    for vol in vols:
        for cw in (0, 1):
            for cv in (0, 1):
                for cu in (0, 1):
                    sh = torch.nn.functional.pad(
                        vol, (1 - cu, cu, 1 - cv, cv, 1 - cw, cw))
                    cols.append(sh.reshape(-1))
    return torch.stack(cols, dim=0)


def shingle_rows(vol_shape) -> int:
    """Rows per volume in a make_shingle table."""
    zs, ys, xs = vol_shape
    return (zs + 1) * (ys + 1) * (xs + 1)


def shingle_gather(shingle, xp, vol_shape, n_vols: int = 1, sid=None):
    """Trilinear sample from a make_shingle table at (..., 3) (x,y,z).

    shingle: (8*n_vols, S*R) corner-major table, column-stacked per stack
    when sid is given (each sample reads column s*R + lin of its own
    stack).  Returns a tuple of n_vols tensors shaped xp.shape[:-1]; zero
    where the floor index leaves [-1, dim-1].
    """
    zs, ys, xs = vol_shape
    R = shingle_rows(vol_shape)
    ui, vi, wi, wts = corner_weights(xp)
    inb = ((ui >= -1) & (ui < xs) & (vi >= -1) & (vi < ys)
           & (wi >= -1) & (wi < zs))
    lin = ((wi + 1) * (ys + 1) + (vi + 1)) * (xs + 1) + (ui + 1)
    lin = torch.clamp(lin, 0, R - 1)
    if sid is not None:
        nd = lin.ndim - 1
        lin = lin + sid.to(torch.int64).reshape(sid.shape + (1,) * nd) * R
    cols = torch.index_select(shingle, 1, lin.reshape(-1))  # (8P, Npix)
    outs = []
    for p in range(n_vols):
        acc = torch.zeros(lin.shape, dtype=torch.float32, device=xp.device)
        for c in range(8):
            acc = acc + cols[8 * p + c].reshape(lin.shape) * wts[..., c]
        outs.append(torch.where(inb, acc, 0.0))
    return tuple(outs)


class FastPSF:
    """Per-run fast-engine state: per-stack separable triads + slice ranges.

    The triads stay on the host (they are the SVD's output); their banded
    matrices are built per (volume shape, direction, device) on first use
    and cached here.
    """

    def __init__(self, stack_a3: np.ndarray, stack_dims: np.ndarray,
                 stack_slice_ranges: Sequence[Tuple[int, int]],
                 support: int, tol: float = 1e-3):
        terms = []
        for a3, dims in zip(stack_a3, stack_dims):
            k = stack_kernel(np.asarray(a3, np.float64),
                             np.asarray(dims, np.float64), support)
            terms.append(separable_decompose(k, tol))
        self._init(terms, stack_slice_ranges, support)

    def _init(self, terms, ranges, support):
        self.support = int(support)
        self.ranges = [(int(lo), int(hi)) for lo, hi in ranges]
        self.terms = [[(np.asarray(kz, np.float32), np.asarray(ky, np.float32),
                        np.asarray(kx, np.float32), float(c))
                       for kz, ky, kx, c in t] for t in terms]
        self._bands: Dict[tuple, List[List[BandTerm]]] = {}

    @classmethod
    def from_terms(cls, terms, stack_slice_ranges, support: int):
        """Build from already decomposed per-stack triads."""
        self = cls.__new__(cls)
        self._init(terms, stack_slice_ranges, support)
        return self

    @classmethod
    def from_batch(cls, batch, recon_w2i: np.ndarray, support: int,
                   tol: float = 1e-3):
        """Build from a SliceBatch using each stack's identity-motion
        geometry (first slice of the stack).  Each stack's members must be
        contiguous (create_slices and the patch extractors give them so)."""
        ranges, a3s, dims = [], [], []
        idx = np.asarray(batch.stack_index)
        for s in np.unique(idx):
            members = np.nonzero(idx == s)[0]
            if members[-1] - members[0] + 1 != len(members):
                raise ValueError(f"the members of stack {s} are not "
                                 "contiguous in the batch")
            ranges.append((int(members[0]), int(members[-1]) + 1))
            fwd = np.asarray(recon_w2i) @ batch.i2w[members[0]]
            a3s.append(np.linalg.inv(fwd[:3, :3]))
            dims.append(batch.dims[members[0]])
        return cls(np.asarray(a3s), np.asarray(dims), ranges, support, tol)

    @property
    def n_stacks(self) -> int:
        return len(self.terms)

    def bands(self, vol_shape, flip: bool, device) -> List[List[BandTerm]]:
        """Per-stack banded triads for vol_shape on device (cached)."""
        key = (tuple(vol_shape), bool(flip), torch.device(device))
        if key not in self._bands:
            self._bands[key] = [band_terms(t, vol_shape, flip, device)
                                for t in self.terms]
        return self._bands[key]


def default_stack_id(fast: FastPSF, n: int) -> np.ndarray:
    """(n,) stack index from the FastPSF slice ranges; rows past the last
    range inherit the last stack id."""
    sid = np.full((n,), len(fast.ranges) - 1, np.int64)
    for s, (lo, hi) in enumerate(fast.ranges):
        sid[lo:min(hi, n)] = s
    return sid


def make_fast_geom(fast: FastPSF, fwd, valid, vol_shape, mask=None,
                   stack_id=None) -> FastGeom:
    """Continuous per-pixel positions, sume = (conv(1))(xp), the cached
    simulate denominator (conv(mask))(xp), and the scatter plan.

    fwd: (N,4,4) f32 = reconW2I @ T_s @ sliceI2W; valid: (N,H,W) bool;
    mask: [z,y,x] (ones if None); stack_id: (N,) (from fast.ranges if
    omitted).  Computes on valid's device.
    """
    dev = valid.device
    n, h, w = valid.shape
    vol_shape = tuple(int(v) for v in vol_shape)
    if stack_id is None:
        stack_id = default_stack_id(fast, n)
    sid = torch.as_tensor(stack_id, device=dev).to(torch.int64)
    fwd = fwd.to(device=dev, dtype=torch.float32)
    px = torch.arange(w, dtype=torch.float32, device=dev)
    py = torch.arange(h, dtype=torch.float32, device=dev)
    xp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    ones = torch.ones(vol_shape, dtype=torch.float32, device=dev)
    mask = ones if mask is None else mask.reshape(vol_shape).to(torch.float32)
    bands = fast.bands(vol_shape, False, dev)
    # per-stack conv(1) and conv(mask) volumes in ONE corner-major table
    # (16, S*R), gathered once; the table itself is not kept
    tab = torch.cat(
        [torch.cat([make_shingle([conv_separable(ones, b)]) for b in bands],
                   dim=1),
         torch.cat([make_shingle([conv_separable(mask, b)]) for b in bands],
                   dim=1)], dim=0)
    sume, den = shingle_gather(tab, xp, vol_shape, 2, sid=sid)
    del tab
    sume = torch.where(valid & (sume > 0.5), sume, 0.0)
    plan = scatter.build_scatter_plan(xp, sid, vol_shape, fast.n_stacks)
    return FastGeom(xp=xp, valid=valid, sume=sume, sid=sid, den=den,
                    plan=plan)


def fast_simulate(fast: FastPSF, geom: FastGeom, vol, mask, vol_shape):
    """sim, simw, inside: the forward projection of vol.

    The denominator (conv(mask))(xp) comes from the geometry (geom.den);
    per call only the conv(vol*mask) numerator is built and gathered."""
    vm = vol * mask
    bands = fast.bands(vol_shape, False, vol.device)
    num_tab = torch.cat([make_shingle([conv_separable(vm, b)])
                         for b in bands], dim=1)
    (num,) = shingle_gather(num_tab, geom.xp, vol_shape, 1, sid=geom.sid)
    den = geom.den
    pos = den > 0
    sim = torch.where(pos, num / torch.where(pos, den, 1.0), 0.0)
    gate = (geom.sume > 0.0) & geom.valid
    inside = gate & pos
    simw = torch.where(inside,
                       den / torch.where(geom.sume > 0, geom.sume, 1.0), 0.0)
    sim = torch.where(inside, sim, 0.0)
    return sim, simw, inside


def fast_scatter2(fast: FastPSF, geom: FastGeom, pay_a, pay_b, mask,
                  vol_shape):
    """Transpose accumulation of two payloads (e.g. addon + cmap):
    out_k = mask . sum_stacks K_s * splat(payload_k / sume).

    Payloads must be zero at invalid pixels.  One splat (kernel
    splat2_dense) covers all stacks, straight into dense per-stack
    volumes, and the adjoint convolution runs per stack on both payloads.
    """
    pos = geom.sume > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, geom.sume, 1.0), 0.0)
    a = (pay_a * inv).contiguous()
    b = (pay_b * inv).contiguous()
    dense = scatter.splat2_dense(geom.plan, a, b)  # (S, 2, zs, ys, xs)
    out = torch.zeros((2,) + tuple(vol_shape), dtype=torch.float32,
                      device=a.device)
    for s, bands in enumerate(fast.bands(vol_shape, True, a.device)):
        out = out + conv_separable(dense[s], bands)
    m = (mask != 0).to(torch.float32)
    return out[0] * m, out[1] * m
