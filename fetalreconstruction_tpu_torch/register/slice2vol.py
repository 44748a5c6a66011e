"""Batched rigid slice-to-volume registration.

Port of fetalreconstruction_tpu/register/slice2vol.py:50-651 (the
reference's registerMultipleSlicesToVolume / evaluateCostsMultipleSlices,
reconstruction_cuda2.cu:4001-4230, with the CPU GuessParameterSliceToVolume
preset as the default schedule).  See the JAX module for the documented
deviations from the reference.  The cost of a slice is the sum over the
through-plane offsets of NCC (or NMI) between its blurred target and the
blurred slice generated from the volume; the optimizer works in the
slice-centred frame T' = T @ Mo.

Generation reads ONE corner-major shingle table of the volume
(`ops.psf_fast.make_shingle` / `shingle_gather`), bf16 by default
(`table_dtype`): a bf16 corner times its float32 weight promotes to
float32 in both frameworks, so the sums are float32 as in JAX.

Optimizers: "coord" runs the stepped host loop (`_stepped_round`): one
Gauss-Seidel sweep at a time, the host reading the active mask after each
and compacting the working set to exactly its active rows (the JAX
package pads to a {16, 128, 1024} bucket ladder to bound recompiles;
eager PyTorch compiles nothing, and per-slice costs do not depend on the
batch, so results equal the uncompacted "coord-scan" path).
"coord-scan" and "gd" run `optimizer.optimize_level_coord` /
`optimize_level` on the whole batch.  There are no jit wrappers.

Dispatch of the cost (`fused_cost_applies`): on a CUDA device, for NCC
and generating from the volume itself (no PSF-matched table), a cost
evaluation is the kernel pair `frt_reg_ncc_cost` (csrc/register.cu),
which samples a bf16 (or, with table_dtype "f32", float32) copy of the
volume, so no shingle table is built.  Everywhere else, the CPU, NMI and
PSF-matched generation, the torch path runs: the kernel's plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import _kernels
from ..core.geometry import matrix_to_params_torch, rigid_matrix_torch
from ..ops import psf_fast
from ..ops.sampling import sample_linear
from ..utils.perfstats import count
from ..utils.tracing import annotate
from .optimizer import (OptimizerConfig, coord_sweep, optimize_level,
                        optimize_level_coord)
from .volume import _nmi_metric

# launches of the fused cost's kernel pair in this process (reset by the
# caller that reads them); the torch path never counts
LAUNCHES = {"reg_ncc_cost": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@dataclasses.dataclass(frozen=True)
class SliceRegConfig:
    """Slice-to-volume registration hyperparameters (the same fields and
    defaults as the JAX package's SliceRegConfig)."""
    levels: int = 3
    steps: int = 4
    iterations: int = 20
    epsilon: float = 1e-4
    step0: float = 2.0          # _LengthOfSteps[l] = step0 * 2^l
    max_linesearch: int = 16
    through_plane_offsets: Tuple[int, ...] = (-1, 0, 1)  # x2 voxels in z
    metric: str = "ncc"         # "ncc" | "nmi"
    bins: int = 64
    pyramid: bool = True        # blur + decimate the pixel grid by 2^level
    optimizer: str = "coord"    # "coord" | "coord-scan" | "gd"
    psf_matched: bool = False   # generate from the per-stack PSF tables
    table_dtype: str = "bf16"   # registration table precision: bf16 | f32

    def blur_sigmas(self, recon_dx: float):
        """_Blurring[0] = recon_dx/2, doubled per level (mm)."""
        out = [recon_dx / 2.0]
        for _ in range(1, self.levels):
            out.append(out[-1] * 2.0)
        return out


def _gauss_kernel_taps(sigma_pix: float):
    r = max(int(round(4.0 * sigma_pix)), 1)
    xs = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-xs * xs / (2.0 * max(sigma_pix, 1e-6) ** 2))
    k /= k.sum()
    return k.astype(np.float32)


def reg_blur(batch, sigma_pix: float):
    """The GPU registration blur (GaussXKernel / GaussYKernel): -1 stays
    -1; valid pixels convolve neighbours clamped to >= 0, clamp-to-edge
    boundary.  batch: (N, H, W)."""
    if sigma_pix <= 0:
        return batch
    k = _gauss_kernel_taps(sigma_pix)
    r = (len(k) - 1) // 2
    out = batch
    for axis, pad in ((2, (r, r, 0, 0)), (1, (0, 0, r, r))):  # x then y
        n = out.shape[axis]
        acc = out * float(k[r])
        # edge-replicated copy: its window at r + i is x[clip(j + i)]
        ext = F.pad(torch.clamp(out, min=0.0), pad, mode="replicate")
        for i in range(1, r + 1):
            acc = acc + float(k[r + i]) * (ext.narrow(axis, r + i, n)
                                           + ext.narrow(axis, r - i, n))
        out = torch.where(out == -1.0, -1.0, acc)
    return out


def _slice_points(recon_w2i, params, ofs_i2w, shape_hw, insofs):
    """(N, H, W, 3) volume positions of the slice raster at through-plane
    offset insofs (x2 voxels)."""
    h, w = shape_hw
    dev = params.device
    t = rigid_matrix_torch(params)
    m = torch.einsum("ij,njk,nkl->nil", recon_w2i, t, ofs_i2w)
    xs = torch.arange(w, dtype=torch.float32, device=dev)
    ys = torch.arange(h, dtype=torch.float32, device=dev)
    zval = float(insofs) * 2.0
    return (m[:, None, None, :3, 0] * xs[None, None, :, None]
            + m[:, None, None, :3, 1] * ys[None, :, None, None]
            + m[:, None, None, :3, 2] * zval
            + m[:, None, None, :3, 3])


def generate_slices(recon, recon_w2i, params, ofs_i2w, shape_hw, insofs):
    """Sample the volume at the transformed slice raster
    (genenerateRegistrationSlices).  Samples outside the volume read 0 and
    only negative samples become -1.  Returns (N, H, W)."""
    pts = _slice_points(recon_w2i, params, ofs_i2w, shape_hw, insofs)
    vals = sample_linear(recon, pts, padding=0.0)
    return torch.where(vals < 0.0, -1.0, vals)


def generate_slices_psf(table, vol_shape, sid, recon_w2i, params, ofs_i2w,
                        shape_hw, insofs):
    """Slice generation from a corner-major shingle `table`: the
    registration table of the volume (sid None), or the per-stack
    PSF-convolved volumes of `build_psf_tables` (sid per slice)."""
    pts = _slice_points(recon_w2i, params, ofs_i2w, shape_hw, insofs)
    (vals,) = psf_fast.shingle_gather(table, pts, vol_shape, 1, sid=sid)
    return torch.where(vals < 0.0, -1.0, vals)


def _masked_mean(batch):
    """Per-slice mean over pixels > -1 (averageIf)."""
    ok = batch > -1.0
    cnt = ok.sum(dim=(1, 2))
    s = torch.where(ok, batch, 0.0).sum(dim=(1, 2))
    return torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0), cnt


def _ncc(target, target_mean, source, sub_mask):
    """Per-slice NCC over pixels where both are >= 0
    (computeNCCAndReduce)."""
    src_mean, _ = _masked_mean(source)
    ok = (target >= 0.0) & (source >= 0.0) & sub_mask[None, :, :]
    a = torch.where(ok, target - target_mean[:, None, None], 0.0)
    b = torch.where(ok, source - src_mean[:, None, None], 0.0)
    sab = (a * b).sum(dim=(1, 2))
    saa = (a * a).sum(dim=(1, 2))
    sbb = (b * b).sum(dim=(1, 2))
    norm = saa * sbb
    return torch.where(norm > 0,
                       sab / torch.sqrt(torch.clamp(norm, min=1e-30)), 0.0)


def _bin_indices(batch, ok, bins: int):
    """Per-slice rescale of valid intensities to [0, bins-1] int32."""
    big = 3.4e38
    mx = torch.where(ok, batch, -big).amax(dim=(1, 2))
    mn = torch.where(ok, batch, big).amin(dim=(1, 2))
    span = torch.clamp(mx - mn, min=1e-6)[:, None, None]
    t = (batch - mn[:, None, None]) / span * (bins - 1)
    return torch.clamp(t, 0, bins - 1).to(torch.int32)


def _nmi_slices(targets, source, sub_mask, bins: int):
    """Per-slice NMI over the valid-pair support."""
    ok = (targets >= 0.0) & (source >= 0.0) & sub_mask[None, :, :]
    return _nmi_metric(_bin_indices(targets, ok, bins),
                       _bin_indices(source, ok, bins), ok, bins)


def fused_cost_applies(cfg: SliceRegConfig, device, psf_table) -> bool:
    """Whether a cost function on `device` is the fused kernel pair: on a
    CUDA device, for NCC, when generation samples the volume itself (no
    psf_table)."""
    return (torch.device(device).type == "cuda" and cfg.metric == "ncc"
            and psf_table is None)


def reg_volume(recon, dtype: str = "bf16"):
    """The volume the fused cost samples: recon cast to bf16 unless dtype
    is "f32", the values of make_reg_table's corners."""
    return (recon.to(torch.bfloat16) if dtype == "bf16"
            else recon.to(torch.float32)).contiguous()


def fused_ncc_cost(vol, recon_w2i, ofs_i2w, targets_blurred, target_means,
                   level: int, sigma_pix: float, offsets):
    """params (N, 6) -> summed NCC (N,) through the kernel pair
    `frt_reg_ncc_cost`: what make_cost_fn's torch path computes for NCC,
    generating from `vol` (bf16 or float32) as the registration table
    does.  CUDA tensors only; it launches or raises."""
    dev = targets_blurred.device
    if dev.type != "cuda":
        raise RuntimeError(f"fused_ncc_cost: no kernel for device {dev}")
    if vol.dtype not in (torch.bfloat16, torch.float32) or \
            vol.device != dev or vol.ndim != 3:
        raise TypeError("fused_ncc_cost: the volume must be a (z, y, x) "
                        "bf16 or float32 tensor on the targets' device")
    f32 = torch.float32
    vol = vol.contiguous()
    w2i = recon_w2i.to(device=dev, dtype=f32).contiguous()
    ofs = ofs_i2w.to(f32).contiguous()
    tgt = targets_blurred.to(f32).contiguous()
    mean = target_means.to(f32).contiguous()
    n, h, w = tgt.shape
    if ofs.shape != (n, 4, 4) or mean.shape != (n,) or \
            ofs.device != dev or mean.device != dev:
        raise ValueError("fused_ncc_cost: ofs_i2w (N, 4, 4) and "
                         "target_means (N,) must match the targets")
    taps = _gauss_kernel_taps(sigma_pix) if sigma_pix > 0 else \
        np.ones(1, np.float32)
    r = (len(taps) - 1) // 2
    c_taps = (ctypes.c_float * (r + 1))(*taps[r:].tolist())
    c_ofs = (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
    lib = _kernels.library()
    n_strips = lib.frt_reg_cost_strips(h, w, r)
    zs, ys, xs = vol.shape

    def cost(params):
        if params.shape != (n, 6) or params.dtype != f32 or \
                params.device != dev:
            raise ValueError(f"fused_ncc_cost: params must be ({n}, 6) "
                             f"float32 on {dev}")
        params = params.contiguous()
        out = torch.empty((n,), dtype=f32, device=dev)
        part = torch.empty((n, len(offsets), n_strips, 8),
                           dtype=torch.float64, device=dev)
        err = lib.frt_reg_ncc_cost(
            vol.data_ptr(), int(vol.dtype == torch.bfloat16), zs, ys, xs,
            w2i.data_ptr(), params.data_ptr(), ofs.data_ptr(),
            tgt.data_ptr(), mean.data_ptr(), n, h, w, level + 1, c_taps, r,
            c_ofs, len(offsets), part.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
        _kernels.check(err, "frt_reg_ncc_cost")
        LAUNCHES["reg_ncc_cost"] += 1
        return out

    return cost


def make_cost_fn(cfg: SliceRegConfig, recon, recon_w2i, ofs_i2w,
                 targets_blurred, target_means, shape_hw, level: int,
                 sigma_pix: float, psf_table=None, vol_shape=None,
                 sid=None):
    """The per-level cost function params (N, 6) -> similarity (N,).

    With psf_table, generation reads the shingle table instead of
    sampling `recon` directly.  Where fused_cost_applies, the cost is the
    fused kernel pair sampling reg_volume(recon, cfg.table_dtype)."""
    if fused_cost_applies(cfg, targets_blurred.device, psf_table):
        fused = fused_ncc_cost(reg_volume(recon, cfg.table_dtype),
                               recon_w2i, ofs_i2w, targets_blurred,
                               target_means, level, sigma_pix,
                               cfg.through_plane_offsets)

        def fused_cost(params):
            count("cost eval")
            count("fused cost eval")
            with annotate("cost eval"), annotate("generate"):
                return fused(params)

        return fused_cost
    h, w = shape_hw
    dev = targets_blurred.device
    lin = (torch.arange(h, device=dev)[:, None] * w
           + torch.arange(w, device=dev)[None, :])
    sub_mask = (lin % (level + 1)) == 0
    use_nmi = cfg.metric == "nmi"

    def cost(params):
        count("cost eval")
        with annotate("cost eval"):
            sim = torch.zeros((params.shape[0],), dtype=torch.float32,
                              device=params.device)
            for insofs in cfg.through_plane_offsets:
                with annotate("generate"):
                    if psf_table is not None:
                        gen = generate_slices_psf(psf_table, vol_shape, sid,
                                                  recon_w2i, params, ofs_i2w,
                                                  shape_hw, insofs)
                    else:
                        gen = generate_slices(recon, recon_w2i, params,
                                              ofs_i2w, shape_hw, insofs)
                with annotate("blur"):
                    gen = reg_blur(gen, sigma_pix)
                with annotate("similarity"):
                    if use_nmi:
                        sim = sim + _nmi_slices(targets_blurred, gen,
                                                sub_mask, cfg.bins)
                    else:
                        sim = sim + _ncc(targets_blurred, target_means, gen,
                                         sub_mask)
            return sim

    return cost


def make_reg_table(recon, dtype: str = "bf16"):
    """The registration shingle table of `recon`, cast to bf16 unless
    dtype is "f32"."""
    t = psf_fast.make_shingle([recon])
    return t.to(torch.bfloat16) if dtype == "bf16" else t


def _level_factor(cfg: SliceRegConfig, shape_hw, level: int) -> int:
    """Decimation factor of a pyramid level (a shape-only decision);
    targets are not decimated below 32 pixels."""
    f = 2 ** level if cfg.pyramid else 1
    while f > 1 and min(shape_hw) // f < 32:
        f //= 2
    return f


def level_arrays(f: int, sigma_pix_full: float, targets, ofs_i2w):
    """Per-level target prep: blur, then (f > 1) padding-aware f x f
    average pooling, and the per-slice masked means.  Decimated pixel
    (x', y') sits at original (f x' + (f-1)/2).

    Returns (targets, ofs_i2w of the level, means)."""
    tgt = reg_blur(targets, sigma_pix_full)
    if f > 1:
        n, h, w = tgt.shape
        hp, wp = h - h % f, w - w % f
        t2 = tgt[:, :hp, :wp].reshape(n, hp // f, f, wp // f, f)
        ok = t2 > -1.0
        s = torch.where(ok, t2, 0.0).sum(dim=(2, 4))
        c = ok.sum(dim=(2, 4))
        tgt = torch.where(c > 0, s / torch.clamp(c, min=1), -1.0)
        scale = np.diag([f, f, 1.0, 1.0]).astype(np.float32)
        scale[0, 3] = scale[1, 3] = (f - 1) / 2.0
        ofs_l = torch.einsum("nij,jk->nik", ofs_i2w,
                             torch.as_tensor(scale, device=ofs_i2w.device))
    else:
        ofs_l = ofs_i2w
    mean, _ = _masked_mean(tgt)
    return tgt, ofs_l, mean


def _stepped_round(cfg, cost_args, params, best, step, n):
    """One step-size round of the stepped host loop with active-set
    compaction: after each sweep the host reads the active mask, and once
    fewer rows are active than the working set holds, the remaining sweeps
    run on the active rows alone (an inactive row never moves again).
    Results are those of the uncompacted path because per-slice costs do
    not depend on the batch.

    cost_args: (source, vol_shape, sid, recon_w2i, ofs_l, tgt, tgt_mean,
    sub_level, gen_sigma), where source is the table of a volume of
    vol_shape, or with vol_shape None the volume itself (the fused cost).
    Returns (params, best) over the full batch.
    """
    source, vol_shape, sid, recon_w2i, ofs_l, tgt, tgt_mean, sub_level, \
        gen_sigma = cost_args
    volume, table = (source, None) if vol_shape is None else (None, source)

    def make_cost(rows):
        take = (lambda a: a) if rows is None else \
            (lambda a: None if a is None else a.index_select(0, rows))
        return make_cost_fn(cfg, volume, recon_w2i, take(ofs_l), take(tgt),
                            take(tgt_mean), tgt.shape[1:], sub_level,
                            gen_sigma, psf_table=table, vol_shape=vol_shape,
                            sid=take(sid))

    cost = make_cost(None)
    rows = torch.arange(n, device=params.device)  # the working set
    full_params, full_best = params.clone(), best.clone()
    p, a, b = params, torch.ones((n,), dtype=torch.bool,
                                 device=params.device), best
    for _ in range(cfg.iterations):
        count("sweep")
        count("rows evaluated", 12 * rows.numel())
        p, a, b = coord_sweep(cost, p, a, b, step, cfg.epsilon)
        with annotate("wait"):  # the host waits for the sweep here
            k = int(a.sum())
        if k == 0:
            break
        if k < rows.numel():
            # write the working set back, then keep its active rows
            full_params[rows], full_best[rows] = p, b
            keep = torch.nonzero(a).squeeze(1)
            rows, p, a, b = rows[keep], p[keep], a[keep], b[keep]
            cost = make_cost(rows)
    full_params[rows], full_best[rows] = p, b
    return full_params, full_best


def register_slices_to_volume(cfg: SliceRegConfig, recon, recon_w2i,
                              transforms, mo, ofs_i2w, targets, recon_dx,
                              psf_table=None, vol_shape=None, sid=None):
    """Full batched registration, on the tensors' device.

    recon: [z, y, x] volume; recon_w2i: (4, 4); transforms: (N, 4, 4)
    current slice transforms T; mo: (N, 4, 4) origin offsets; ofs_i2w:
    (N, 4, 4) origin-zeroed resampled-slice i2w; targets: (N, H, W)
    resampled slices (-1 padded); psf_table / vol_shape / sid (optional):
    per-stack convolved-volume table for PSF-matched generation.

    Returns ((N, 4, 4) updated transforms, (N,) final similarity).
    """
    f32 = torch.float32
    recon_w2i = recon_w2i.to(f32)
    transforms, mo, ofs_i2w = transforms.to(f32), mo.to(f32), \
        ofs_i2w.to(f32)
    params = matrix_to_params_torch(
        torch.einsum("nij,njk->nik", transforms, mo))
    n = targets.shape[0]
    sim = torch.zeros((n,), dtype=f32, device=targets.device)
    sigmas = cfg.blur_sigmas(float(recon_dx))
    if psf_table is None:
        sid = None
        if fused_cost_applies(cfg, targets.device, None):
            # no table: the fused cost samples the volume itself, cast
            # here once so that each level's cost functions find it cast
            recon, vol_shape = reg_volume(recon, cfg.table_dtype), None
        else:
            psf_table = make_reg_table(recon, cfg.table_dtype)
            vol_shape = tuple(recon.shape)
    elif cfg.table_dtype == "bf16":
        psf_table = psf_table.to(torch.bfloat16)
    if sid is not None:
        sid = sid.to(torch.int64)
    ocfg = OptimizerConfig(steps=cfg.steps, iterations=cfg.iterations,
                           epsilon=cfg.epsilon,
                           max_linesearch=cfg.max_linesearch)

    for level in range(cfg.levels - 1, -1, -1):
        sigma_pix = sigmas[level] / float(recon_dx)
        f = _level_factor(cfg, targets.shape[1:], level)
        tgt, ofs_l, tgt_mean = level_arrays(f, float(sigma_pix), targets,
                                            ofs_i2w)
        gen_sigma = sigma_pix / f if f > 1 else sigma_pix
        sub_level = 0 if (f > 1 or cfg.pyramid) else level
        step0_level = cfg.step0 * (2.0 ** level)
        if cfg.optimizer == "coord":
            source = recon if psf_table is None else psf_table
            cost_args = (source, vol_shape, sid, recon_w2i, ofs_l, tgt,
                         tgt_mean, sub_level, float(gen_sigma))
            for sr in range(cfg.steps):
                step = torch.tensor(step0_level / 2.0 ** sr, dtype=f32,
                                    device=params.device)
                # `best` is evaluated anew at every step round, not carried
                # from the previous round's sweeps (slice2vol.py:600-608)
                count("rows evaluated", n)
                best = make_cost_fn(cfg, recon, recon_w2i, ofs_l, tgt,
                                    tgt_mean, tgt.shape[1:], sub_level,
                                    float(gen_sigma), psf_table=psf_table,
                                    vol_shape=vol_shape, sid=sid)(params)
                params, best = _stepped_round(cfg, cost_args, params, best,
                                              step, n)
            sim = best
            continue
        cost = make_cost_fn(cfg, recon, recon_w2i, ofs_l, tgt, tgt_mean,
                            tgt.shape[1:], sub_level, gen_sigma,
                            psf_table=psf_table, vol_shape=vol_shape,
                            sid=sid)
        if cfg.optimizer == "coord-scan":
            params, sim = optimize_level_coord(ocfg, cost, params,
                                               step0_level)
        elif cfg.optimizer == "gd":
            params, sim = optimize_level(ocfg, cost, params, step0_level)
        else:
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
    out = torch.einsum("nij,njk->nik", rigid_matrix_torch(params),
                       torch.linalg.inv(mo))
    return out, sim


def build_psf_tables(fast: psf_fast.FastPSF, recon):
    """(8, S*R) corner-major shingle of the normalised per-stack PSF blur
    (K_s * recon) / (K_s * 1), the source of generate_slices_psf."""
    ones = torch.ones_like(recon)
    tabs = []
    for bands in fast.bands(tuple(recon.shape), False, recon.device):
        num = psf_fast.conv_separable(recon, bands)
        den = psf_fast.conv_separable(ones, bands)
        tabs.append(psf_fast.make_shingle(
            [torch.where(den > 1e-6, num / torch.clamp(den, min=1e-6),
                         0.0)]))
    return torch.cat(tabs, dim=1)
