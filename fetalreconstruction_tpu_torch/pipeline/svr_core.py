"""SVR EM/SR core: port of fetalreconstruction_tpu/pipeline/svr_core.py:
31-393, both PSF engines.

The reference's inner loop (reconstruction.cc:817-1237):

  GaussianReconstruction -> SimulateSlices -> InitializeRobustStatistics ->
  EStep -> { [Bias,] [Scale,] Superresolution+Regularize, [NormaliseBias,]
             SimulateSlices, MStep, EStep } * rec_iterations

Plain functions on tensors; every function computes on its inputs' device
and returns new tensors (nothing is updated in place, so the JAX version's
buffer donation has no counterpart).  The context picks the engine: with
`fast` (a FastPSF) the separable-conv + trilinear engine (ops/psf_fast.py,
kernels B1 and B2), without it the exact offset engine (ops/psf.py) over
`offsets`, the reference-faithful oracle of the fast one.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..em import bias as bias_mod
from ..em import robust
from ..ops.gaussian import gaussian_blur
from ..ops import psf as psf_ops
from ..ops import psf_fast
from ..sr import superresolution as sr
from .state import EMState, SimState


@dataclasses.dataclass(frozen=True)
class SVRContext:
    """Static reconstruction configuration.  fast=None selects the exact
    engine, which needs `offsets` (K, 3), the PSF support's integer
    offsets."""
    vol_shape: Tuple[int, int, int]          # [z, y, x]
    vol_spacing: Tuple[float, float, float]  # (dx, dy, dz) mm
    slice_spacing_xy: Tuple[float, float]
    fast: Optional[psf_fast.FastPSF] = None
    sigma_bias: float = 12.0
    global_bias_correction: bool = False
    disable_bias: bool = False
    adaptive: bool = False
    delta: float = 150.0
    low_intensity_cutoff: float = 0.01
    offsets: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.fast is None and self.offsets is None:
            raise ValueError("the exact engine (fast=None) needs offsets")
        object.__setattr__(self, "vol_shape",
                           tuple(int(v) for v in self.vol_shape))
        if self.offsets is not None:
            object.__setattr__(self, "offsets", np.ascontiguousarray(
                self.offsets, np.int32))


def slice_forward_matrices(recon_w2i, transforms, slice_i2w):
    """fwd_s = reconW2I @ T_s @ sliceI2W for the whole batch, in f32.

    recon_w2i: (4,4); transforms: (N,4,4); slice_i2w: (N,4,4).
    """
    f32 = torch.float32
    return torch.einsum("ij,njk,nkl->nil", recon_w2i.to(f32),
                        transforms.to(f32), slice_i2w.to(f32))


def build_geometry(ctx: SVRContext, recon_w2i, transforms, slice_i2w,
                   valid, mask_flat=None, stack_id=None, slice_dims=None):
    """Geometry + PSF sums after a transform update.  Returns
    (geom, sume).  mask_flat and stack_id feed the fast engine (its cached
    conv(mask), the per-slice kernel); slice_dims (N, 3), each slice's
    (dx, dy, thickness), the exact one."""
    fwd = slice_forward_matrices(recon_w2i, transforms, slice_i2w)
    if ctx.fast is not None:
        geom = psf_fast.make_fast_geom(ctx.fast, fwd, valid, ctx.vol_shape,
                                       mask_flat, stack_id=stack_id)
        return geom, geom.sume
    geom = psf_ops.make_slice_geom(fwd, slice_dims, valid)
    return geom, psf_ops.psf_sums(geom, ctx.offsets, ctx.vol_shape)


def _corrected(ctx, slices, bias, scale):
    if ctx.disable_bias:
        return slices * scale[:, None, None]
    return robust.corrected_slice(slices, bias, scale)


def gaussian_reconstruction(ctx: SVRContext, geom, sume, slices, valid,
                            bias, scale, mask_flat):
    """Initial PSF-weighted average volume
    (gaussianReconstructionKernel3D_tex + equalizeVol).

    Returns (recon [z,y,x], vol_weights [z,y,x], voxel_count (N,)).
    """
    s = _corrected(ctx, slices, bias, scale)
    gate = valid & (sume > 0.0)
    p_val = torch.where(gate, s, 0.0)
    p_one = torch.where(gate, 1.0, 0.0)
    mask_vol = mask_flat.reshape(ctx.vol_shape)
    if ctx.fast is not None:
        num, wts = psf_fast.fast_scatter2(ctx.fast, geom, p_val, p_one,
                                          mask_vol, ctx.vol_shape)
        recon = sr.equalize(num, wts)
        _, _, inside = psf_fast.fast_simulate(ctx.fast, geom, num, mask_vol,
                                              ctx.vol_shape)
        return recon, wts, inside.sum(dim=(1, 2))
    num, wts = psf_ops.psf_scatter(geom, ctx.offsets, sume, [p_val, p_one],
                                   mask_flat, ctx.vol_shape)
    num, wts = num.reshape(ctx.vol_shape), wts.reshape(ctx.vol_shape)
    recon = sr.equalize(num, wts)
    # per-slice voxel count: pixels that scatter into at least one voxel
    # (sliceVoxel_count, cuda2.cu:291-294), found by the gather
    _, _, inside = psf_ops.psf_gather(geom, ctx.offsets, sume,
                                      num.reshape(-1), mask_flat,
                                      ctx.vol_shape)
    return recon, wts, inside.sum(dim=(1, 2))


def simulate(ctx: SVRContext, geom, sume, recon, mask_flat) -> SimState:
    """Forward-project the current volume (SimulateSlices)."""
    if ctx.fast is not None:
        sim, simw, inside = psf_fast.fast_simulate(
            ctx.fast, geom, recon, mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        sim, simw, inside = psf_ops.psf_gather(
            geom, ctx.offsets, sume, recon.reshape(-1), mask_flat,
            ctx.vol_shape)
    return SimState(sim=sim, simw=simw, inside=inside,
                    slice_inside=inside.any(dim=2).any(dim=1))


def init_em_state(n_slices: int, valid) -> EMState:
    """InitializeEMValues (.cc:2955): weights 1 on valid pixels, bias 0,
    scales 1, slice weights 1; robust-stat scalars at reference
    defaults."""
    dev, f32 = valid.device, torch.float32

    def scalar(v):
        return torch.tensor(v, dtype=f32, device=dev)

    return EMState(
        weights=torch.where(valid, 1.0, 0.0).to(f32),
        bias=torch.zeros(valid.shape, dtype=f32, device=dev),
        scale=torch.ones((n_slices,), dtype=f32, device=dev),
        slice_weight=torch.ones((n_slices,), dtype=f32, device=dev),
        sigma2=scalar(0.0), m=scalar(0.0), mix=scalar(0.9),
        mix_s=scalar(0.9))


def initialize_robust_statistics(ctx: SVRContext, slices, valid, sim_state,
                                 em: EMState, max_intensity, min_intensity,
                                 excluded) -> EMState:
    """InitializeRobustStatistics (.cc:3022-3069) + slice-inside zeroing."""
    sigma2, _ = robust.init_robust_stats(slices, valid, sim_state.sim,
                                         sim_state.simw, sim_state.inside)
    f32, dev = torch.float32, slices.device
    mx = torch.as_tensor(max_intensity, dtype=f32, device=dev)
    mn = torch.as_tensor(min_intensity, dtype=f32, device=dev)
    m = 1.0 / (2.1 * mx - 1.9 * mn)
    slice_weight = torch.where(sim_state.slice_inside & ~excluded,
                               em.slice_weight, 0.0)
    return em._replace(sigma2=sigma2.to(f32), m=m,
                       mix=torch.tensor(0.9, dtype=f32, device=dev),
                       mix_s=torch.tensor(0.9, dtype=f32, device=dev),
                       slice_weight=slice_weight)


def estep(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState,
          excluded):
    """Voxel + slice E-step (EStepGPU, .cc:3184-3440).  excluded: (N,)
    bool, force-excluded or small slices; scale-based exclusion (scale <
    0.2 or > 5) is applied here too.  Returns (em, potential)."""
    weights, potential = robust.voxel_estep(
        slices, valid & (sume > 0), em.bias, em.scale, sim_state.sim,
        sim_state.simw, em.sigma2, em.m, em.mix)
    bad_scale = (em.scale < 0.2) | (em.scale > 5.0)
    potential = torch.where(excluded | bad_scale, -1.0, potential)
    slice_weight, stats = robust.slice_estep(potential, em.slice_weight,
                                             em.mix_s)
    return em._replace(weights=weights, slice_weight=slice_weight,
                       mix_s=stats["mix_s"]), potential


def mstep(ctx: SVRContext, slices, valid, sume, sim_state, em: EMState,
          iteration: int) -> EMState:
    sigma2, mix, m = robust.mstep(
        slices, valid & (sume > 0), em.bias, em.scale, em.weights,
        sim_state.sim, sim_state.simw, iteration, em.mix)
    return em._replace(sigma2=sigma2, mix=mix, m=m)


def scale_step(ctx: SVRContext, slices, valid, sume, sim_state,
               em: EMState) -> EMState:
    return em._replace(scale=robust.scale_step(
        slices, valid & (sume > 0), em.bias, em.weights, sim_state.sim,
        sim_state.simw))


def bias_step(ctx: SVRContext, slices, valid, sume, sim_state,
              em: EMState) -> EMState:
    return em._replace(bias=bias_mod.bias_step(
        slices, valid & (sume > 0), em.bias, em.scale, em.weights,
        sim_state.sim, sim_state.simw, ctx.sigma_bias, ctx.slice_spacing_xy,
        ctx.global_bias_correction))


def superresolution_step(ctx: SVRContext, geom, sume, slices, valid,
                         em: EMState, sim_state, recon, mask_flat, alpha,
                         lambda_, min_intensity, max_intensity):
    """One SR update: scatter residuals, addon step, regularisation and,
    with global bias correction, BiasCorrectVolume against the pre-update
    volume inside the mask.  Returns (recon, cmap)."""
    if ctx.fast is not None:
        gated = valid & (sume > 0.0)
        s = _corrected(ctx, slices, em.bias, em.scale)
        resid = torch.where(sim_state.sim > 0.0, s - sim_state.sim, 0.0)
        wfac = em.weights * em.slice_weight[:, None, None]
        addon, cmap = psf_fast.fast_scatter2(
            ctx.fast, geom, torch.where(gated, resid * wfac, 0.0),
            torch.where(gated, wfac, 0.0), mask_flat.reshape(ctx.vol_shape),
            ctx.vol_shape)
    else:
        addon, cmap = sr.sr_accumulate(
            geom, ctx.offsets, sume, slices, valid, em.bias, em.scale,
            em.weights, em.slice_weight, sim_state.sim, mask_flat,
            ctx.vol_shape, ctx.disable_bias)
    original = recon
    recon, cmap = sr.apply_addon(recon, addon, cmap, alpha, min_intensity,
                                 max_intensity, ctx.adaptive)
    recon = sr.adaptive_regularization(recon, original, cmap, alpha,
                                       lambda_, ctx.delta)
    if ctx.global_bias_correction:
        recon = bias_mod.bias_correct_volume(
            recon, original, mask_flat.reshape(ctx.vol_shape), min_intensity,
            max_intensity, ctx.low_intensity_cutoff, ctx.sigma_bias,
            ctx.vol_spacing)
    return recon, cmap


def normalise_bias_step(ctx: SVRContext, geom, sume, valid, em: EMState,
                        recon, vol_weights, mask, mask_flat):
    """NormaliseBias: scatter each slice's bias less its log scale into
    the volume (on the fast engine one B1 + B2 call with a zero second
    payload; on the exact one em/bias.normalise_bias), divide by the
    volume weights, blur inside the mask and remove the field from the
    volume.  Returns the corrected volume."""
    if ctx.fast is None:
        return bias_mod.normalise_bias(
            geom, ctx.offsets, sume, valid, em.bias, em.scale, recon,
            vol_weights, mask, mask_flat, ctx.vol_shape, ctx.sigma_bias,
            ctx.vol_spacing)[0]
    logs = torch.log(torch.clamp(em.scale, min=1e-30))
    b = torch.where(valid & (em.scale[:, None, None] > 0),
                    em.bias - logs[:, None, None], em.bias)
    payload = torch.where(valid & (sume > 0), b, 0.0)
    vol_bias, _ = psf_fast.fast_scatter2(
        ctx.fast, geom, payload, torch.zeros_like(payload),
        mask_flat.reshape(ctx.vol_shape), ctx.vol_shape)
    ok = vol_weights > 0
    vol_bias = torch.where(ok, vol_bias / torch.where(ok, vol_weights, 1.0),
                           0.0)
    m = (mask != 0).to(recon.dtype)
    vol_bias = torch.where(mask != 0, vol_bias, 0.0)
    vol_bias = gaussian_blur(vol_bias, ctx.sigma_bias, ctx.vol_spacing)
    m_blur = gaussian_blur(m, ctx.sigma_bias, ctx.vol_spacing)
    vol_bias = torch.where(m_blur != 0,
                           vol_bias / torch.where(m_blur != 0, m_blur, 1.0),
                           0.0)
    return torch.where(recon != -1.0, recon / torch.exp(-vol_bias), recon)


def inner_iteration(ctx: SVRContext, geom, sume, slices, valid,
                    em: EMState, sim_state: SimState, recon, vol_weights,
                    mask, mask_flat, excluded, alpha, lam, min_intensity,
                    max_intensity, sr_iteration: int,
                    do_bias: bool = False, do_scale: bool = True,
                    do_normalise_bias: bool = False):
    """One inner SR/EM iteration (reconstruction.cc:1013-1110): [bias],
    [scale], superresolution + regularisation [+ volume bias correction],
    [normalise bias], simulate, M-step, E-step.

    Returns (em, sim_state, recon).
    """
    if do_bias:
        em = bias_step(ctx, slices, valid, sume, sim_state, em)
    if do_scale:
        em = scale_step(ctx, slices, valid, sume, sim_state, em)
    recon, _ = superresolution_step(ctx, geom, sume, slices, valid, em,
                                    sim_state, recon, mask_flat, alpha, lam,
                                    min_intensity, max_intensity)
    if do_normalise_bias:
        recon = normalise_bias_step(ctx, geom, sume, valid, em, recon,
                                    vol_weights, mask, mask_flat)
    sim_state = simulate(ctx, geom, sume, recon, mask_flat)
    em = mstep(ctx, slices, valid, sume, sim_state, em, sr_iteration)
    em, _ = estep(ctx, slices, valid, sume, sim_state, em, excluded)
    return em, sim_state, recon
