"""Volume sharding: the recon grid's z-slabs over ranks, slices replicated.

Port of fetalreconstruction_tpu/parallel/volume_sharded.py, the
large-area mode: the replicated design keeps per-stack conv tables and
scatter volumes per device (the JAX package's parity-blocked accumulator
alone about 8.8 GB at 8 stacks of 0.75 mm); here all volume-space state
(recon, mask, addon / cmap, volume weights, the per-stack conv(1) /
conv(mask) slabs, the per-stack scatter volumes) is split into z-slabs,
rank r holding rows
[r lz, (r + 1) lz), while every rank holds the slices:

- trilinear gathers mask each of a pixel's 8 corners by the slab that
  holds it (a 2x2x2 window can straddle two slabs) and sum the partial
  values over the ranks;
- the scatter gives each pixel to the slab of its floor voxel: the slab's
  scatter plan (kernel splat2_dense, ops/scatter.py) holds only those
  pixels, at slab-local positions on a (lz + 1, ys, xs) volume, and the
  top plane goes to the next slab's first;
- the separable PSF convolutions, the Gaussian blur of NormaliseBias and
  the 13-direction regulariser exchange z-halos (parallel/halo.py),
  zero at the volume's ends as the single-device operators' padding.

The stage functions take `mesh`, the ranks that split the volume, and
`group`, the process group that splits the slice batch: None here, where
every rank holds every slice and the EM statistics need no collective;
the 2-D grid (parallel/mesh2d.py) passes the group of its slice axis, and
the partial volumes of each rank's slice block are summed over it.  They
are plain functions that every rank of the mesh calls in the same order,
where the JAX package builds shard_map programs.  Only the fast PSF
engine is sharded.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import psf_fast, scatter
from ..ops.gaussian import _blur_axis, _correlate, gaussian_kernel1d
from ..pipeline import svr_core
from ..pipeline.state import SimState
from ..sr import superresolution as sr
from .halo import from_below, halo_exchange_z
from .sharded import Mesh, psum

# slab-local position of the pixels a slab does not own: outside the
# support of its plan's volume, so that the plan and the splat's plain
# version both leave them out
_NOT_OWNED = -2.0


def pad_attr_z(attr, n_ranks: int):
    """attr with z extended at the high end to a multiple of n_ranks, every
    existing voxel keeping its world position (the origin moves by half
    the added extent along the z axis).  Returns (attr, rows added)."""
    extra = (-attr.z) % n_ranks
    if extra == 0:
        return attr.copy(), 0
    new = attr.copy()
    new.z = attr.z + extra
    shift = np.asarray(attr.zaxis, np.float64) * (extra * attr.dz / 2.0)
    new.xorigin = attr.xorigin + float(shift[0])
    new.yorigin = attr.yorigin + float(shift[1])
    new.zorigin = attr.zorigin + float(shift[2])
    return new, extra


def conv_terms_radius(terms) -> int:
    """The largest one-sided z reach of a stack's triads.  An even kernel
    size treats tap (k-1)//2 as centre, so its reach is k-1-(k-1)//2 on
    one side (4 for k = 8); both halos take the larger side, which covers
    the flipped adjoint too."""
    if not terms:
        return 0
    return max(len(t[0]) - 1 - (len(t[0]) - 1) // 2 for t in terms)


def vs_conv_stacks(fast: psf_fast.FastPSF, slab, mesh: Mesh,
                   flip: bool = False, per_stack: bool = False):
    """[K_s * slab for each stack s] on the slab's rows (with per_stack,
    K_s * slab[s]), each equal to the rows of the single-device
    convolution: one halo exchange at the largest reach of all stacks,
    then the banded passes over the extended slab, whose band matrices
    (FastPSF.bands, cached by shape) zero-pad it as the single-device
    operator pads the volume."""
    h = max(conv_terms_radius(t) for t in fast.terms)
    ext = halo_exchange_z(slab, h, mesh)
    lz = slab.shape[-3]
    bands = fast.bands(tuple(ext.shape[-3:]), flip, slab.device)
    return [psf_fast.conv_separable(ext[s] if per_stack else ext,
                                    b).narrow(-3, h, lz)
            for s, b in enumerate(bands)]


def _vs_gather(tables, xp, sid, vol_shape, mesh: Mesh):
    """Trilinear samples at xp of P slab-split volumes per stack,
    tables (P, S, lz, ys, xs): each corner counted on the slab that holds
    it, the partial sums added over the ranks.  Returns a (P, *xp.shape[:-1])
    tensor, the same on every rank."""
    zs, ys, xs = vol_shape
    p_, s_, lz = tables.shape[:3]
    z0 = mesh.rank * lz
    ui, vi, wi, wts = scatter.corner_weights(xp)
    sid_b = sid.to(torch.int64).reshape(
        tuple(sid.shape) + (1,) * (wi.ndim - sid.ndim))
    flat = tables.reshape(p_, -1)
    out = torch.zeros((p_,) + tuple(wi.shape), dtype=torch.float32,
                      device=xp.device)
    for c in range(8):
        cw, cv, cu = (c >> 2) & 1, (c >> 1) & 1, c & 1
        zc, yc, xc = wi + cw, vi + cv, ui + cu
        own = ((zc >= z0) & (zc < z0 + lz) & (zc >= 0) & (zc < zs)
               & (yc >= 0) & (yc < ys) & (xc >= 0) & (xc < xs))
        lin = ((sid_b * lz + (zc - z0)) * ys + yc) * xs + xc
        lin = torch.clamp(lin, 0, s_ * lz * ys * xs - 1).reshape(-1)
        w = torch.where(own, wts[..., c], 0.0)
        for p in range(p_):
            out[p] += w * torch.index_select(flat[p], 0, lin).reshape(
                wi.shape)
    return psum(out, mesh.group)


def _slab_plan(xp, sid, vol_shape, lz: int, n_stacks: int, mesh: Mesh):
    """The scatter plan of the pixels whose floor voxel this slab owns
    (slab 0 also owns floor -1, the grid's front halo), at slab-local
    positions on a (lz + 1, ys, xs) volume: a pixel's 2x2x2 window spans
    local rows [w, w + 1], so the extra top plane takes the corners that
    belong to the next slab."""
    _, ys, xs = vol_shape
    z0 = mesh.rank * lz
    w = torch.floor(xp[..., 2]) - z0
    own = (w >= (-1 if mesh.rank == 0 else 0)) & (w <= lz - 1)
    local = xp - torch.tensor([0.0, 0.0, float(z0)], device=xp.device)
    local = torch.where(own[..., None], local, _NOT_OWNED)
    return scatter.build_scatter_plan(local, sid, (lz + 1, ys, xs), n_stacks)


def vs_build_geometry(ctx: svr_core.SVRContext, recon_w2i, transforms,
                      slice_i2w, valid, mask_slab, stack_id,
                      mesh: Mesh) -> psf_fast.FastGeom:
    """make_fast_geom on slabs (vs_build_geometry_fn): the per-stack conv(1)
    and conv(mask) slabs, gathered once into sume and the simulate
    denominator den, then dropped.  xp, valid, sume, sid and den are those
    of the rank's slices, the same on every rank of the mesh; the plan is
    the slab's, at slab-local positions, so the geometry serves the vs_*
    functions only."""
    fast = _fast(ctx)
    dev = valid.device
    _, h, w = valid.shape
    sid = torch.as_tensor(stack_id, device=dev).to(torch.int64)
    fwd = svr_core.slice_forward_matrices(recon_w2i, transforms, slice_i2w)
    px = torch.arange(w, dtype=torch.float32, device=dev)
    py = torch.arange(h, dtype=torch.float32, device=dev)
    xp = (fwd[:, None, None, :3, 0] * px[None, None, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, None, None]
          + fwd[:, None, None, :3, 3])
    mask_slab = mask_slab.to(torch.float32)
    pair = torch.stack([torch.ones_like(mask_slab), mask_slab])
    tables = torch.stack(vs_conv_stacks(fast, pair, mesh), dim=1)
    sume, den = _vs_gather(tables, xp, sid, ctx.vol_shape, mesh)
    del tables
    sume = torch.where(valid & (sume > 0.5), sume, 0.0)
    plan = _slab_plan(xp, sid, ctx.vol_shape, mask_slab.shape[0],
                      fast.n_stacks, mesh)
    return psf_fast.FastGeom(xp=xp, valid=valid, sume=sume, sid=sid,
                             den=den, plan=plan)


def _inside(geom: psf_fast.FastGeom):
    return (geom.sume > 0.0) & geom.valid & (geom.den > 0)


def vs_fast_simulate(fast: psf_fast.FastPSF, geom: psf_fast.FastGeom,
                     vol_slab, mask_slab, vol_shape, mesh: Mesh):
    """sim, simw, inside of the rank's slices from slab-split volumes: the
    conv(vol * mask) numerator is built on the slabs and gathered; the
    denominator is the geometry's."""
    num_slab = torch.stack(vs_conv_stacks(fast, vol_slab * mask_slab, mesh))
    (num,) = _vs_gather(num_slab[None], geom.xp, geom.sid, vol_shape, mesh)
    den = geom.den
    pos = den > 0
    inside = _inside(geom)
    sim = torch.where(inside, num / torch.where(pos, den, 1.0), 0.0)
    simw = torch.where(inside,
                       den / torch.where(geom.sume > 0, geom.sume, 1.0), 0.0)
    return sim, simw, inside


def vs_fast_scatter2(fast: psf_fast.FastPSF, geom: psf_fast.FastGeom,
                     pay_a, pay_b, mask_slab, vol_shape, mesh: Mesh,
                     group=None):
    """fast_scatter2 into slabs: splat2_dense over the slab's plan into
    (lz + 1, ys, xs), the top plane added to the next slab's first (slab 0
    receives zeros), then the per-stack adjoint convolutions with a halo.
    With `group` (the 2-D grid's slice axis) the masked slabs of the
    rank's slice block are summed over it (_g2_scatter)."""
    lz, ys, xs = mask_slab.shape
    pos = geom.sume > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, geom.sume, 1.0), 0.0)
    a = (pay_a * inv).contiguous()
    b = (pay_b * inv).contiguous()
    acc = scatter.splat2_dense(geom.plan, a, b)   # (S, 2, lz+1, ys, xs)
    recv = from_below(acc[:, :, lz].contiguous(), mesh)
    acc = acc[:, :, :lz].clone()
    acc[:, :, 0] += recv
    out = torch.zeros((2, lz, ys, xs), dtype=torch.float32,
                      device=a.device)
    for conv in vs_conv_stacks(fast, acc, mesh, flip=True, per_stack=True):
        out = out + conv
    out = out * (mask_slab != 0).to(torch.float32)
    return tuple(psum(out, group))


def vs_gaussian_blur(slab, sigma_mm: float, spacing_xyz, mesh: Mesh):
    """ops/gaussian.gaussian_blur on a slab: the in-plane passes are local;
    the z pass exchanges a halo of both the data and a ones-volume, so
    that the boundary renormalisation divides by the whole volume's
    in-bounds weight, as the single-device blur does."""
    dx, dy, dz = (float(s) for s in spacing_xyz[:3])
    out = _blur_axis(slab, gaussian_kernel1d(sigma_mm / dx), 2)
    out = _blur_axis(out, gaussian_kernel1d(sigma_mm / dy), 1)
    kz = gaussian_kernel1d(sigma_mm / dz)
    r = (len(kz) - 1) // 2
    if r == 0:
        return out
    ext = halo_exchange_z(torch.stack([out, torch.ones_like(slab)]), r, mesh)
    num = _correlate(ext[0], kz, 0)[r:-r]
    den = _correlate(ext[1], kz, 0)[r:-r]
    return num / den


def vs_normalise_bias(ctx: svr_core.SVRContext, geom: psf_fast.FastGeom,
                      valid, em, recon_slab, vol_weights_slab, mask_slab,
                      mesh: Mesh, group=None):
    """svr_core.normalise_bias_step on slabs: scatter each slice's bias
    less its log scale, divide by the volume weights, blur inside the
    mask with z-halos, divide by the blurred mask, remove the field."""
    logs = torch.log(torch.clamp(em.scale, min=1e-30))
    b = torch.where(valid & (em.scale[:, None, None] > 0),
                    em.bias - logs[:, None, None], em.bias)
    payload = torch.where(valid & (geom.sume > 0), b, 0.0)
    vol_bias, _ = vs_fast_scatter2(_fast(ctx), geom, payload,
                                   torch.zeros_like(payload), mask_slab,
                                   ctx.vol_shape, mesh, group)
    ok = vol_weights_slab > 0
    vol_bias = torch.where(ok, vol_bias / torch.where(ok, vol_weights_slab,
                                                      1.0), 0.0)
    m = (mask_slab != 0).to(recon_slab.dtype)
    vol_bias = torch.where(mask_slab != 0, vol_bias, 0.0)
    vol_bias = vs_gaussian_blur(vol_bias, ctx.sigma_bias, ctx.vol_spacing,
                                mesh)
    m_blur = vs_gaussian_blur(m, ctx.sigma_bias, ctx.vol_spacing, mesh)
    vol_bias = torch.where(m_blur != 0,
                           vol_bias / torch.where(m_blur != 0, m_blur, 1.0),
                           0.0)
    return torch.where(recon_slab != -1.0,
                       recon_slab / torch.exp(-vol_bias), recon_slab)


def vs_adaptive_regularization(recon_slab, original_slab, cmap_slab, alpha,
                               lam, delta, mesh: Mesh):
    """The 13-direction regulariser on slabs with a 2-row halo (reach 1,
    two chained shifts).  It equals the single-device operator: every term
    that crosses an extended slab's edge is gated by the neighbour's cmap,
    which is zero in the halo at the volume's ends."""
    ext = halo_exchange_z(torch.stack([recon_slab, original_slab,
                                       cmap_slab]), 2, mesh)
    out = sr.adaptive_regularization(ext[0], ext[1], ext[2], alpha, lam,
                                     delta)
    return out[2:-2]


def _fast(ctx: svr_core.SVRContext) -> psf_fast.FastPSF:
    if ctx.fast is None:
        raise ValueError("volume sharding needs the fast PSF engine")
    return ctx.fast


# ---------------------------------------------------------------------------
# the pipeline's stages (vs_*_fn of the JAX package)
# ---------------------------------------------------------------------------

def vs_gaussian_reconstruction(ctx: svr_core.SVRContext,
                               geom: psf_fast.FastGeom, slices, valid, bias,
                               scale, mask_slab, mesh: Mesh, group=None):
    """Returns (recon slab, volume weights slab, voxel count of the rank's
    slices)."""
    s = svr_core._corrected(ctx, slices, bias, scale)
    gate = valid & (geom.sume > 0.0)
    num, wts = vs_fast_scatter2(_fast(ctx), geom, torch.where(gate, s, 0.0),
                                torch.where(gate, 1.0, 0.0), mask_slab,
                                ctx.vol_shape, mesh, group)
    return sr.equalize(num, wts), wts, _inside(geom).sum(dim=(1, 2))


def vs_simulate(ctx: svr_core.SVRContext, geom: psf_fast.FastGeom,
                recon_slab, mask_slab, mesh: Mesh) -> SimState:
    sim, simw, inside = vs_fast_simulate(_fast(ctx), geom, recon_slab,
                                         mask_slab, ctx.vol_shape, mesh)
    return SimState(sim=sim, simw=simw, inside=inside,
                    slice_inside=inside.any(dim=2).any(dim=1))


def vs_inner_iteration(ctx: svr_core.SVRContext, geom: psf_fast.FastGeom,
                       slices, valid, em, sim_state: SimState, recon_slab,
                       vol_weights_slab, mask_slab, excluded, alpha, lam,
                       min_intensity, max_intensity, sr_iteration: int,
                       mesh: Mesh, group=None, do_bias: bool = False,
                       do_scale: bool = True,
                       do_normalise_bias: bool = False):
    """One inner SR/EM iteration on slabs: [bias], [scale], the slab
    scatter, addon and regulariser, [normalise bias], simulate, M-step,
    E-step; the EM sums over `group`.  As in the JAX package's slab modes
    there is no volume bias correction (global_bias_correction's
    BiasCorrectVolume).  Returns (em, sim_state, recon slab)."""
    sume = geom.sume
    if do_bias:
        em = svr_core.bias_step(ctx, slices, valid, sume, sim_state, em)
    if do_scale:
        em = svr_core.scale_step(ctx, slices, valid, sume, sim_state, em)
    gated = valid & (sume > 0)
    s = svr_core._corrected(ctx, slices, em.bias, em.scale)
    resid = torch.where(sim_state.sim > 0.0, s - sim_state.sim, 0.0)
    wfac = em.weights * em.slice_weight[:, None, None]
    addon, cmap = vs_fast_scatter2(
        _fast(ctx), geom, torch.where(gated, resid * wfac, 0.0),
        torch.where(gated, wfac, 0.0), mask_slab, ctx.vol_shape, mesh,
        group)
    original = recon_slab
    recon_slab, cmap = sr.apply_addon(recon_slab, addon, cmap, alpha,
                                      min_intensity, max_intensity,
                                      ctx.adaptive)
    recon_slab = vs_adaptive_regularization(recon_slab, original, cmap,
                                            alpha, lam, ctx.delta, mesh)
    if do_normalise_bias:
        recon_slab = vs_normalise_bias(ctx, geom, valid, em, recon_slab,
                                       vol_weights_slab, mask_slab, mesh,
                                       group)
    sim_state = vs_simulate(ctx, geom, recon_slab, mask_slab, mesh)
    em = svr_core.mstep(ctx, slices, valid, sume, sim_state, em,
                        sr_iteration, group)
    em, _ = svr_core.estep(ctx, slices, valid, sume, sim_state, em,
                           excluded, group)
    return em, sim_state, recon_slab
