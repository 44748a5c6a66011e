"""PVR evaluation harness: per-iteration CSV metric rows.

Port of fetalreconstruction_tpu/evaluation/pvr_eval.py (the reference's
evaluation battery, irtkPatchBasedReconstruction.cpp:1010-2381, flags at
patchBasedReconMain.cpp:137-144):

- EvaluateGt3d (cpp:2153-2381): the reconstruction vs a ground-truth
  volume: MSE / PSNR, windowed SSIM / DSSIM (and the dssim image), and the
  joint-histogram battery, one row per iteration in log-evaluate-Gt.csv;
- Evaluate3d (cpp:1767-2151): the reconstruction vs each input stack
  inside the 3x-dilated (26-connected) evaluation mask ->
  log-evaluate-<mask>.csv;
- EvaluateBaseline3d (cpp:1451-1766): the raw stacks vs ground truth;
- Evaluate2d / EvaluateBaseline2d (cpp:1011-1449): the per-patch battery;
- --patchExtraction: the patch batch dumped to disk.

Volumes are resampled by the port's ops/sampling.resample_to_grid on the
caller's device; everything else is numpy, as in the JAX version, and the
files written are the same.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from ..core.image import Image
from ..ops.morphology import dilate
from ..ops.sampling import resample_to_grid
from .metrics import evaluate, evaluate_pair

CSV_HEADER = ("MSE,PSNR,SSIM,DSSIM,PatchMean,ReconMean,PatchVariance,"
              "ReconVariance,Covariance,JointEntropy,Crosscorrelation,"
              "CorrelationRatioPatchRecon,CorrelationRatioReconPatch,"
              "MutualInformation,NormalizedMutualInformation,"
              "SumSquareDiff,LabelConsistency,KappaStatistic")


def _uniform3(vol: np.ndarray) -> np.ndarray:
    """3x3x3 box mean with edge replication (SSIM local moments)."""
    out = vol.astype(np.float64)
    for ax in range(3):
        p = np.concatenate([out.take([0], ax), out,
                            out.take([-1], ax)], axis=ax)
        out = (np.add.reduce([p.take(range(i, i + out.shape[ax]), ax)
                              for i in range(3)])) / 3.0
    return out


def ssim_dssim(ref: np.ndarray, tar: np.ndarray, valid: np.ndarray):
    """Windowed SSIM over valid voxels (EvaluateGt3d, cpp:2290-2304:
    C1=6.5025, C2=58.5225 constants of the 255-range convention).

    Returns (ssim_mean, dssim_mean, dssim_image)."""
    C1, C2 = 6.5025, 58.5225
    mu1 = _uniform3(ref)
    mu2 = _uniform3(tar)
    var1 = _uniform3(ref * ref) - mu1 ** 2
    var2 = _uniform3(tar * tar) - mu2 ** 2
    covar = _uniform3(ref * tar) - mu1 * mu2
    ssim = ((2 * mu1 * mu2 + C1) * (2 * covar + C2)) / (
        (mu1 ** 2 + mu2 ** 2 + C1) * (var1 + var2 + C2))
    dssim = (1.0 - ssim) / 2.0
    n = max(int(valid.sum()), 1)
    return (float(ssim[valid].sum() / n), float(dssim[valid].sum() / n),
            np.where(valid, dssim, 0.0).astype(np.float32))


def _csv_row(path: str, tag: str, write_header: bool, mse, psnr, ssim,
             dssim, ev, header_tag: Optional[str] = None) -> None:
    # Reference header row carries the bare config tag (cpp:2327), while
    # data rows are prefixed "iter-N-..." (cpp:2349).
    new = write_header or not os.path.exists(path)
    with open(path, "a") as f:
        if new:
            f.write((header_tag if header_tag is not None else tag)
                    + "," + CSV_HEADER + ",\n")
        f.write(",".join([tag] + ["%g" % v for v in [
            mse, psnr, ssim, dssim, ev.mean_x, ev.mean_y, ev.var_x,
            ev.var_y, ev.cov, ev.je, ev.cc, ev.cr_xy, ev.cr_yx, ev.mi,
            ev.nmi, ev.ssd, ev.lc, ev.ks]]) + ",\n")


def _resample_like(img: Image, ref: Image, device) -> np.ndarray:
    out = resample_to_grid(
        torch.as_tensor(img.data, dtype=torch.float32, device=device),
        img.attr.w2i().astype(np.float32), ref.attr.shape_zyx,
        ref.attr.i2w().astype(np.float32), interp="linear", padding=0.0)
    return out.cpu().numpy().astype(np.float64)


def evaluate_gt_3d(iteration: int, recon: Image, gt: Image,
                   max_intensity: float, tag: str,
                   csv_path: str = "log-evaluate-Gt.csv",
                   dssim_path: Optional[str] = None, *, device) -> dict:
    """EvaluateGt3d (cpp:2153-2381): metrics over GT voxels > 0."""
    ref = np.asarray(gt.data, np.float64)
    tar = _resample_like(recon, gt, device)
    valid = ref > 0
    n = max(int(valid.sum()), 1)
    mse = float(((ref - tar)[valid] ** 2).sum() / n)
    psnr = 20 * np.log10(max(max_intensity, 1e-30)) \
        - 10 * np.log10(max(mse, 1e-30))
    ssim, dssim, dimg = ssim_dssim(ref, tar, valid)
    ev = evaluate(gt, recon, device=device)
    _csv_row(csv_path, f"iter-{iteration}-{tag}", iteration == 0,
             mse, psnr, ssim, dssim, ev, header_tag=tag)
    if dssim_path:
        from ..io.nifti import write_nifti
        write_nifti(Image(dimg, gt.attr.copy()), dssim_path)
    return dict(mse=mse, psnr=psnr, ssim=ssim, dssim=dssim)


def evaluate_3d(iteration: int, recon: Image, stacks: List[Image],
                eval_mask: Image, tag: str, mask_name: str,
                csv_dir: str = ".", *, device) -> None:
    """Evaluate3d (cpp:1767-2151): reconstruction vs every input stack
    inside the 3x-dilated evaluation mask; one CSV row per stack."""
    md = np.asarray(dilate(eval_mask.data, 3, connectivity=26))
    dmask = Image((md > 0).astype(np.float32), eval_mask.attr.copy())
    csv_path = os.path.join(csv_dir, f"log-evaluate-{mask_name}.csv")
    for si, st in enumerate(stacks):
        # mask the stack by the evaluation mask resampled onto its grid
        m_on_stack = _resample_like(dmask, st, device) > 0.5
        ref = np.where(m_on_stack, np.asarray(st.data, np.float64), 0.0)
        tar = _resample_like(recon, st, device)
        valid = ref > 0
        n = max(int(valid.sum()), 1)
        mse = float(((ref - tar)[valid] ** 2).sum() / n)
        mx = float(ref.max()) if ref.max() > 0 else 1.0
        psnr = 20 * np.log10(mx) - 10 * np.log10(max(mse, 1e-30))
        ssim, dssim, _ = ssim_dssim(ref, tar, valid)
        ev = evaluate(Image(ref.astype(np.float32), st.attr.copy()), recon,
                      device=device)
        _csv_row(csv_path, f"iter-{iteration}-stack-{si}-{tag}",
                 iteration == 0 and si == 0, mse, psnr, ssim, dssim, ev,
                 header_tag=tag)


def evaluate_baseline_3d(stacks: List[Image], gt: Image,
                         max_intensity: float, tag: str,
                         csv_path: str = "log-evaluate-baseline.csv", *,
                         device):
    """EvaluateBaseline3d (cpp:1451-1766): raw input stacks vs ground
    truth — the no-reconstruction baseline row."""
    for si, st in enumerate(stacks):
        ref = np.asarray(gt.data, np.float64)
        tar = _resample_like(st, gt, device)
        valid = ref > 0
        n = max(int(valid.sum()), 1)
        mse = float(((ref - tar)[valid] ** 2).sum() / n)
        psnr = 20 * np.log10(max(max_intensity, 1e-30)) \
            - 10 * np.log10(max(mse, 1e-30))
        ssim, dssim, _ = ssim_dssim(ref, tar, valid)
        ev = evaluate(gt, st, device=device)
        _csv_row(csv_path, f"baseline-stack-{si}-{tag}", si == 0,
                 mse, psnr, ssim, dssim, ev, header_tag=tag)


def dump_patches(batch, path: str) -> None:
    """--patchExtraction: dump the extracted patch batch for offline
    analysis (data + per-patch geometry)."""
    np.savez_compressed(path, data=batch.data, i2w=batch.i2w,
                        dims=batch.dims, stack_index=batch.stack_index)


def _nn_sample(vol: np.ndarray, pos: np.ndarray):
    """Round positions to voxels; returns (values, in-bounds mask) —
    the reference's round_()+bounds-check convention."""
    zs, ys, xs = vol.shape
    p = np.round(pos).astype(int)
    inb = ((p[..., 0] >= 0) & (p[..., 0] < xs)
           & (p[..., 1] >= 0) & (p[..., 1] < ys)
           & (p[..., 2] >= 0) & (p[..., 2] < zs))
    pc = np.clip(p, 0, [xs - 1, ys - 1, zs - 1])
    return vol[pc[..., 2], pc[..., 1], pc[..., 0]], inb


def _patch_world_grid(i2w: np.ndarray, transform: np.ndarray, h: int,
                      w: int) -> np.ndarray:
    """World positions of patch pixels (x, y, 0) through T @ i2w."""
    m = np.asarray(transform, np.float64) @ np.asarray(i2w, np.float64)
    gy, gx = np.meshgrid(np.arange(h, dtype=np.float64),
                         np.arange(w, dtype=np.float64), indexing="ij")
    return (m[:3, 0][None, None] * gx[..., None]
            + m[:3, 1][None, None] * gy[..., None]
            + m[:3, 3][None, None])


def _patch_battery_rows(path: str, header_first: str, pairs) -> int:
    """Write the per-patch 2D CSV (header of cpp:1290-1304); `pairs`
    yields (patch_no, tv, sv, min_i, max_i); returns rows written."""
    C1, C2 = 6.5025, 58.5225
    rows = 0
    with open(path, "w") as f:
        f.write(header_first + ",PSNR,SSIM,DSSIM,PatchMean,ReconMean,"
                "PatchVariance,ReconVariance,Covariance,JointEntropy,"
                "Crosscorrelation,CorrelationRatioPatchRecon,"
                "CorrelationRatioReconPatch,MutualInformation,"
                "NormalizedMutualInformation,SumSquareDiff,"
                "LabelConsistency,KappaStatistic,\n")
        for patch_no, tv, sv, min_i, max_i in pairs:
            if len(tv) < 2:
                continue
            ev = evaluate_pair(tv, sv, min_i, max_i)
            ssim = (((2 * ev.mean_x * ev.mean_y + C1)
                     * (2 * ev.cov + C2))
                    / ((ev.mean_x ** 2 + ev.mean_y ** 2 + C1)
                       * (ev.var_x + ev.var_y + C2)))
            vals = [ev.psnr, ssim, (1 - ssim) / 2, ev.mean_x, ev.mean_y,
                    ev.var_x, ev.var_y, ev.cov, ev.je, ev.cc, ev.cr_xy,
                    ev.cr_yx, ev.mi, ev.nmi, ev.ssd, ev.lc, ev.ks]
            f.write(",".join([str(patch_no)] + ["%g" % v for v in vals])
                    + ",\n")
            rows += 1
    return rows


def evaluate_2d(iteration: int, recon: Image, batch, transforms,
                eval_mask: Image, mask_name: str, patch_size: int,
                patch_stride: int, min_intensity: float,
                max_intensity: float, slice_weights=None,
                sim_weights=None, csv_dir: str = ".") -> List[str]:
    """Evaluate2d (irtkPatchBasedReconstruction.cpp:1236-1449): per-PATCH
    joint-histogram battery of patch pixels vs the NN-sampled
    reconstruction, one CSV per stack
    (log-evaluate-stack-<i>-iteration-<it>-size-<sz>-<stride>-<mask>.csv).

    Gates per the reference: patch weight >= 0.99999 (if slice_weights
    given), per-pixel sim weight >= 0.99999 (if sim_weights given),
    patch value > 0, NN-rounded mask value > 0, recon value > 0."""
    rw2i = recon.attr.w2i()
    mw2i = eval_mask.attr.w2i()
    rdata = np.asarray(recon.data, np.float64)
    mdata = np.asarray(eval_mask.data, np.float64)
    sids = np.asarray(batch.stack_index)
    paths = []
    for si in np.unique(sids):
        members = np.nonzero(sids == si)[0]

        def pairs():
            for z in members:
                if slice_weights is not None and \
                        slice_weights[z] < 0.99999:
                    continue
                pd = np.asarray(batch.data[z], np.float64)
                h, w = pd.shape
                wpos = _patch_world_grid(batch.i2w[z], transforms[z], h, w)
                rv, rin = _nn_sample(
                    rdata, wpos @ np.asarray(rw2i)[:3, :3].T
                    + np.asarray(rw2i)[:3, 3])
                mv, min_b = _nn_sample(
                    mdata, wpos @ np.asarray(mw2i)[:3, :3].T
                    + np.asarray(mw2i)[:3, 3])
                keep = (pd > 0) & rin & min_b & (mv > 0) & (rv > 0)
                if sim_weights is not None:
                    keep &= np.asarray(sim_weights[z]) >= 0.99999
                yield (int(z) + 1, pd[keep], rv[keep], min_intensity,
                       max_intensity)

        path = os.path.join(
            csv_dir, f"log-evaluate-stack-{si}-iteration-{iteration}-"
                     f"size-{patch_size}-{patch_stride}-{mask_name}.csv")
        _patch_battery_rows(path, f"Stack[{si}]//Patch no.", pairs())
        paths.append(path)
    return paths


def evaluate_baseline_2d(batch, stacks: List[Image], eval_mask: Image,
                         mask_name: str, patch_size: int,
                         patch_stride: int, min_intensity: float,
                         max_intensity: float,
                         csv_dir: str = ".") -> str:
    """EvaluateBaseline2d (cpp:1011-1234): the LAST stack's patches vs
    the NN-sampled FIRST (reference) stack — the no-reconstruction
    2D baseline CSV
    (log-evaluate-stack-0-<last>-baseline-size-<sz>-<stride>-<mask>.csv)."""
    ref = stacks[0]
    target_stack = int(np.asarray(batch.stack_index).max())
    rw2i = ref.attr.w2i()
    mw2i = eval_mask.attr.w2i()
    rdata = np.asarray(ref.data, np.float64)
    mdata = np.asarray(eval_mask.data, np.float64)
    members = np.nonzero(np.asarray(batch.stack_index) == target_stack)[0]

    def pairs():
        for z in members:
            pd = np.asarray(batch.data[z], np.float64)
            h, w = pd.shape
            wpos = _patch_world_grid(batch.i2w[z], np.eye(4), h, w)
            rv, rin = _nn_sample(
                rdata, wpos @ np.asarray(rw2i)[:3, :3].T
                + np.asarray(rw2i)[:3, 3])
            mv, min_b = _nn_sample(
                mdata, wpos @ np.asarray(mw2i)[:3, :3].T
                + np.asarray(mw2i)[:3, 3])
            keep = (pd > 0) & rin & min_b & (mv > 0) & (rv > 0)
            yield (int(z) + 1, pd[keep], rv[keep], min_intensity,
                   max_intensity)

    path = os.path.join(
        csv_dir, f"log-evaluate-stack-0-{target_stack}-baseline-"
                 f"size-{patch_size}-{patch_stride}-{mask_name}.csv")
    _patch_battery_rows(path, "Stack[0]//Patch no.", pairs())
    return path
