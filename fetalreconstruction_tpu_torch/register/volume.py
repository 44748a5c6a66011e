"""Rigid 3D-3D volume registration (multi-resolution pyramid, CC / NMI).

Port of fetalreconstruction_tpu/register/volume.py:42-531 (the IRTK
registration used by the reference for stack-to-template and
package-to-volume alignment, irtkImageRegistration::Run with the
GuessParameterThickSlices / ...NMI / GuessParameterSliceToVolume presets of
irtkImageRigidRegistrationWithPadding.cc:110-404):

- per level, both images are blurred (padding-aware) and resampled, the
  in-plane resolution doubling per level;
- similarity over the overlap: target voxels above their padding whose
  transformed position samples the source without padding;
- CC in the accumulator form, or NMI = (H(t) + H(s)) / H(t, s) from a
  `bins` x `bins` joint histogram (counted with `scatter_add_`; integer
  counts in float32 are exact, so the order of the adds does not matter);
- the optimizer is the shared coordinate sweep (optimizer.py), with an
  optional gradient-descent polish ("coord+gd").

`register_volumes_batched` runs M independent pairs in lock-step (the
reference's ParallelStackRegistrations / package fan-out); a source shared
by every pair (package mode) is read once, not copied.  Images are the
JAX package's numpy `Image`; the device work runs on `device`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from fetalreconstruction_tpu.core.image import Image

from ..core.geometry import matrix_to_params, rigid_matrix
from ..ops.gaussian import gaussian_blur_padded
from ..ops.sampling import resample_to_grid, sample_linear_padded
from .optimizer import OptimizerConfig, coord_sweep, optimize_level


@dataclasses.dataclass(frozen=True)
class VolRegConfig:
    """The same fields and defaults as the JAX package's VolRegConfig."""
    levels: int = 3
    bins: int = 64
    metric: str = "cc"           # "cc" | "nmi"
    iterations: int = 20
    steps: int = 4
    step0: float = 2.0           # _LengthOfSteps[l] = 2 * 2^l
    epsilon: float = 1e-4
    max_linesearch: int = 16
    blur_z: bool = False         # thick-slice presets keep z resolution
    source_iso: bool = False     # SliceToVolume preset: isotropic source
    optimizer: str = "coord"     # "coord" | "coord+gd"
    gd_steps: int = 2            # polish step-halving rounds
    gd_iterations: int = 8       # polish iterations per round


def guess_padding(data: np.ndarray) -> float:
    """Corner-based padding guess: if all 8 corners share one value, that
    value is padding; else -32768 (MIN_GREY)."""
    corners = [data[z, y, x] for z in (0, -1) for y in (0, -1)
               for x in (0, -1)]
    if all(c == corners[0] for c in corners):
        return float(corners[0])
    return -32768.0


def _pyramid_level(img: Image, level: int, padding: float, blur_z: bool,
                   iso: bool = False, *, device) -> Image:
    """Blur + resample one level (irtkImageRegistration::Initialize).

    Level 0 blurs with sigma = in-plane/2 at resolution (in-plane,
    in-plane, dz); each further level doubles both in-plane.  With iso the
    level-0 resolution is min(dx, dy, dz) isotropic and z doubles too.
    """
    a = img.attr
    size = min(a.dx, a.dy, a.dz) if iso else min(a.dx, a.dy)
    sigma = (size / 2.0) * (2.0 ** level)
    res = size * (2.0 ** level)
    data = torch.as_tensor(np.array(img.data, np.float32), device=device)
    data = gaussian_blur_padded(data, sigma,
                                (a.dx, a.dy, a.dz if blur_z else 1e30),
                                padding=padding)
    dst = a.with_spacing(res, res, res if iso else a.dz)
    out = resample_to_grid(data, a.w2i(), dst.shape_zyx, dst.i2w(),
                           interp="linear", source_padding=padding)
    return Image(out.cpu().numpy(), dst)


def _cc_metric(t, s, ok):
    dims = tuple(range(1, t.ndim))
    n = ok.sum(dim=dims)
    tv = torch.where(ok, t, 0.0)
    sv = torch.where(ok, s, 0.0)
    sx, sy = tv.sum(dim=dims), sv.sum(dim=dims)
    sxy = (tv * sv).sum(dim=dims)
    sxx = (tv * tv).sum(dim=dims)
    syy = (sv * sv).sum(dim=dims)
    nn = torch.clamp(n, min=1)
    num = sxy - sx * sy / nn
    den = (sxx - sx * sx / nn) * (syy - sy * sy / nn)
    return torch.where(den > 0, num / torch.sqrt(torch.clamp(den, min=1e-30)),
                       0.0)


def _nmi_metric(t_bin, s_bin, ok, bins: int):
    """NMI from a joint histogram of pre-binned intensities (int bin
    indices t_bin / s_bin, valid-pair mask ok), per batch row."""
    batch = t_bin.shape[0]
    lin = torch.where(ok.reshape(batch, -1),
                      t_bin.reshape(batch, -1).to(torch.int64) * bins
                      + s_bin.reshape(batch, -1).to(torch.int64),
                      bins * bins)
    hist = torch.zeros((batch, bins * bins + 1), dtype=torch.float32,
                       device=lin.device)
    hist.scatter_add_(1, lin, torch.ones(lin.shape, dtype=torch.float32,
                                         device=lin.device))
    joint = hist[:, :bins * bins].reshape(batch, bins, bins)
    n = torch.clamp(joint.sum(dim=(1, 2)), min=1.0)
    p = joint / n[:, None, None]
    px, py = p.sum(dim=2), p.sum(dim=1)

    def ent(q, dims):
        return -torch.where(q > 0, q * torch.log(torch.clamp(q, min=1e-30)),
                            0.0).sum(dim=dims)

    hx, hy, hxy = ent(px, (1,)), ent(py, (1,)), ent(p, (1, 2))
    return torch.where(hxy > 0, (hx + hy) / torch.clamp(hxy, min=1e-30),
                       0.0)


def _rescale_for_bins(data, padding, bins):
    """Rescale valid intensities to [0, bins-1]; invalid voxels -> -1."""
    ok = data > padding
    lo = torch.where(ok, data, float("inf")).amin()
    hi = torch.where(ok, data, float("-inf")).amax()
    rng = torch.clamp(hi - lo, min=1e-6)
    return torch.where(ok, (data - lo) / rng * (bins - 1), -1.0)


def _vol_cost(metric, bins, shared_src, tdata, sdata, tgt_i2w, src_w2i,
              tpad, spad, params):
    """Similarity of source(T(x)) vs target over each target raster, for M
    pairs at once.

    tdata: (M, z, y, x) targets padded to a common shape with each pair's
    own padding; sdata: (M, ...) sources, or (1, ...) with shared_src;
    tgt_i2w / src_w2i: (M, 4, 4); tpad / spad: (M,); params: (M, 6).
    """
    zs, ys, xs = tdata.shape[1:]
    dev = tdata.device
    gx = torch.arange(xs, dtype=torch.float32, device=dev)
    gy = torch.arange(ys, dtype=torch.float32, device=dev)
    gz = torch.arange(zs, dtype=torch.float32, device=dev)
    m = torch.einsum("nij,njk,nkl->nil", src_w2i, rigid_matrix(params),
                     tgt_i2w)
    pts = (m[:, None, None, None, :3, 0] * gx[None, None, None, :, None]
           + m[:, None, None, None, :3, 1] * gy[None, None, :, None, None]
           + m[:, None, None, None, :3, 2] * gz[None, :, None, None, None]
           + m[:, None, None, None, :3, 3])
    spad_b = spad[:, None, None, None]
    sv = sample_linear_padded(sdata[0] if shared_src else sdata, pts,
                              padding=spad_b)
    ok = (tdata > tpad[:, None, None, None]) & (sv > spad_b)
    if metric == "nmi":
        tbin = torch.clamp(tdata, 0, bins - 1).to(torch.int32)
        sbin = torch.clamp(sv, 0, bins - 1).to(torch.int32)
        return _nmi_metric(tbin, sbin, ok, bins)
    return _cc_metric(tdata, sv, ok)


def _pad_batch(vols: List[np.ndarray], pads: List[float]) -> np.ndarray:
    """Stack differently-shaped volumes into (M, z, y, x), padding each at
    the high end with its own padding value."""
    zs = max(v.shape[0] for v in vols)
    ys = max(v.shape[1] for v in vols)
    xs = max(v.shape[2] for v in vols)
    out = np.empty((len(vols), zs, ys, xs), np.float32)
    for i, (v, p) in enumerate(zip(vols, pads)):
        out[i] = p
        out[i, :v.shape[0], :v.shape[1], :v.shape[2]] = v
    return out


def _optimize_level(cfg: VolRegConfig, level: int, cost, params, ok):
    """The per-level schedule: coordinate sweeps over the step-halving
    rounds (pairs with ok False stay frozen), then the optional
    gradient-descent polish.  Returns (params, best)."""
    for sr in range(cfg.steps):
        step = torch.tensor(cfg.step0 * (2.0 ** level) / (2.0 ** sr),
                            dtype=torch.float32, device=params.device)
        best = cost(params)
        active = ok
        for _ in range(cfg.iterations):
            params, active, best = coord_sweep(cost, params, active, best,
                                               step, cfg.epsilon)
            if not bool(active.any()):
                break
    if cfg.optimizer.endswith("gd"):
        ocfg = OptimizerConfig(steps=cfg.gd_steps,
                               iterations=cfg.gd_iterations,
                               epsilon=cfg.epsilon,
                               max_linesearch=cfg.max_linesearch)
        p_gd, best_gd = optimize_level(ocfg, cost, params,
                                       cfg.step0 * (2.0 ** level) / 2.0)
        take = ok & (best_gd >= best)
        params = torch.where(take[:, None], p_gd, params)
        best = torch.where(take, best_gd, best)
    return params, best


def _reset_origin(img: Image):
    """(Image with its origin zeroed, Mo translating by the origin): the
    ResetOrigin trick (irtkReconstructionGPU.cc:987)."""
    a = img.attr.copy()
    mo = np.eye(4)
    mo[:3, 3] = [a.xorigin, a.yorigin, a.zorigin]
    a.xorigin = a.yorigin = a.zorigin = 0.0
    return Image(img.data, a), mo


def register_volumes_batched(cfg: VolRegConfig, targets: List[Image],
                             sources: List[Image],
                             init_matrices: Optional[np.ndarray] = None,
                             target_paddings: Optional[List[float]] = None,
                             source_paddings: Optional[List[float]] = None,
                             *, device):
    """Register M independent rigid pairs in lock-step on `device`: pair i
    finds T_i with targets[i](x) ~ sources[i](T_i(x)).  `sources` may be
    one Image object for every pair (package mode), which is then read
    once.  A pair whose coarse target keeps fewer than 200 valid voxels
    sits that level out.

    Returns ((M, 4, 4) float64 matrices, (M,) final similarity).
    """
    m_pairs = len(targets)
    if len(sources) != m_pairs:
        raise ValueError(f"{m_pairs} targets but {len(sources)} sources")
    tps = [guess_padding(t.data) if target_paddings is None
           or target_paddings[i] is None else target_paddings[i]
           for i, t in enumerate(targets)]
    sps = [guess_padding(s.data) if source_paddings is None
           or source_paddings[i] is None else source_paddings[i]
           for i, s in enumerate(sources)]
    shared_src = all(s is sources[0] for s in sources)
    shared_tgt = all(t is targets[0] for t in targets)

    reset = [_reset_origin(t) for t in targets]
    targets0 = [t for t, _ in reset]
    mos = np.stack([mo for _, mo in reset])
    init = np.tile(np.eye(4), (m_pairs, 1, 1)) if init_matrices is None \
        else np.asarray(init_matrices)
    f32 = torch.float32
    params = matrix_to_params(torch.as_tensor(
        np.einsum("nij,njk->nik", init, mos), dtype=f32, device=device))

    sim = torch.zeros((m_pairs,), dtype=f32, device=device)
    for level in range(cfg.levels - 1, -1, -1):
        if shared_tgt:
            tls = [_pyramid_level(targets0[0], level, tps[0], cfg.blur_z,
                                  device=device)] * m_pairs
        else:
            tls = [_pyramid_level(t, level, tp, cfg.blur_z, device=device)
                   for t, tp in zip(targets0, tps)]
        srcs = sources[:1] if shared_src else sources
        sls = [_pyramid_level(s, level, sp, cfg.blur_z, iso=cfg.source_iso,
                              device=device) for s, sp in zip(srcs, sps)]
        level_ok = np.asarray([int(np.sum(tl.data > tp)) >= 200
                               for tl, tp in zip(tls, tps)])
        if not level_ok.any():
            continue
        tdatas = [tl.data for tl in tls]
        sdatas = [sl.data for sl in sls]
        if cfg.metric == "nmi":
            def rescale(d, p):
                return _rescale_for_bins(torch.as_tensor(d, device=device),
                                         p, cfg.bins).cpu().numpy()
            tdatas = [rescale(d, tp) for d, tp in zip(tdatas, tps)]
            sdatas = [rescale(d, sp) for d, sp in zip(sdatas, sps)]
            tpad, spad = [-1.0] * m_pairs, [-1.0] * m_pairs
        else:
            tpad, spad = list(tps), list(sps)
        tdata = torch.as_tensor(_pad_batch(tdatas, tpad), device=device)
        sdata = torch.as_tensor(
            _pad_batch(sdatas, spad[:1] if shared_src else spad),
            device=device)
        tgt_i2w = torch.as_tensor(np.stack([tl.attr.i2w() for tl in tls]),
                                  dtype=f32, device=device)
        src_w2i = torch.as_tensor(
            np.stack([sls[0 if shared_src else i].attr.w2i()
                      for i in range(m_pairs)]), dtype=f32, device=device)
        tpad_t = torch.as_tensor(tpad, dtype=f32, device=device)
        spad_t = torch.as_tensor(spad, dtype=f32, device=device)
        ok = torch.as_tensor(level_ok, device=device)

        def cost(p):
            return _vol_cost(cfg.metric, cfg.bins, shared_src, tdata, sdata,
                             tgt_i2w, src_w2i, tpad_t, spad_t, p)

        params, best = _optimize_level(cfg, level, cost, params, ok)
        sim = torch.where(ok, best, sim)

    t_new = rigid_matrix(params).cpu().numpy().astype(np.float64)
    out = np.einsum("nij,njk->nik", t_new, np.linalg.inv(mos))
    return out, sim.cpu().numpy()


def register_volumes(cfg: VolRegConfig, target: Image, source: Image,
                     init_matrix: Optional[np.ndarray] = None,
                     target_padding: Optional[float] = None,
                     source_padding: Optional[float] = None, *,
                     device):
    """Register source to target, one pair: find rigid T with target(x) ~
    source(T(x)) (T maps target world -> source world), as a batch of one
    through `register_volumes_batched`.

    Returns (4x4 float64 matrix, final similarity).
    """
    init = None if init_matrix is None else np.asarray(init_matrix)[None]
    out, sim = register_volumes_batched(cfg, [target], [source], init,
                                        [target_padding], [source_padding],
                                        device=device)
    return out[0], float(sim[0])
