"""The PVR (patch-to-volume reconstruction) pipeline.

Port of fetalreconstruction_tpu/pipeline/pvr.py:40-190 (the reference's
PVRreconstructionGPU flow, patchBasedReconMain.cpp:51-440 +
irtkPatchBasedReconstruction.cpp:194-593):

- the mask from the stacks' overlap when none is given, binarised,
  dilated (--dilateMask) and, with --resample, resampled with the stacks
  to the reconstruction resolution (cubic B-spline stacks through scipy,
  a nearest-neighbour mask);
- square patches (--patchSize / --patchStride), whole slices
  (--useFullSlices) or SLIC superpixels (--superpixel), each with its own
  rigid transform, scale and weight, through run_svr's slice factory: the
  same EM / SR engine and kernels as SVR, with patch-to-volume in place of
  slice-to-volume registration;
- hierarchical mode (--hierarchical): patch size - 4 and stride - 2 per
  level (patchBasedReconMain.cpp:422-431), each level seeded with the
  previous reconstruction;
- the evaluation harness (--evaluateGt, --evaluation, --evaluateBaseline,
  evaluate_2d) and the --patchExtraction dump.

The thickness given is the net slice thickness (the reference CLI halves
it and the patches double it again).  A mesh (parallel/sharded.Mesh) is
passed through to run_svr, which splits the patches over its ranks; the
evaluation harness and the patch dump run on rank 0.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..core.image import Image
from ..evaluation import pvr_eval
from ..io.nifti import read_nifti
from ..ops.morphology import dilate
from ..ops.sampling import resample_to_grid
from ..patches.extract import extract_patches
from ..patches.slic import extract_superpixel_patches
from ..utils.tracing import annotate
from .config import SVRConfig
from .svr import SVRResult, create_mask_from_overlap, run_svr


@dataclasses.dataclass
class PVRConfig(SVRConfig):
    patch_size: int = 64
    patch_stride: int = 32
    use_full_slices: bool = False
    superpixel: bool = False
    spx_size: int = 64
    spx_extend: int = 50  # 0-100 % of the superpixel size (cpp:106)
    hierarchical: bool = False
    hier_levels: int = 3
    dilate_mask: int = 0
    resample: bool = False  # resample the stacks to the recon resolution
                            # first (irtkPatchBasedReconstruction.cpp:237)
    # the evaluation harness (patchBasedReconMain.cpp:137-144)
    evaluate_gt: str = ""                 # --evaluateGt <gt.nii.gz>
    evaluation_masks: List[str] = dataclasses.field(default_factory=list)
    evaluate_baseline: bool = False       # --evaluateBaseline
    patch_extraction: bool = False        # --patchExtraction
    evaluate_2d: bool = False             # the per-patch 2D battery too


def slic_backend() -> str:
    """"native" when the host C++ library (`native`, SLIC and the NIfTI
    codec, built with g++ at first use) loads, else "python" (the numpy
    versions)."""
    from .. import native
    return "native" if native.get_lib() is not None else "python"


def _resample_inputs(cfg: PVRConfig, stacks, mask: Image, device):
    """--resample: stacks by cubic B-spline (scipy, as in JAX) and the mask
    by nearest neighbour, onto the isotropic recon resolution
    (irtkPatchBasedReconstruction.cpp:229-266).  The mask's matrices are
    cast to float32 before they meet the grid, as in JAX."""
    res = cfg.resolution
    out = []
    for st in stacks:
        a = st.attr.with_spacing(res, res, res)
        d = resample_to_grid(torch.as_tensor(np.asarray(st.data, np.float32)),
                             st.attr.w2i(), a.shape_zyx, a.i2w(),
                             interp="bspline", padding=0.0)
        out.append(Image(d.numpy(), a))
    ma = mask.attr.with_spacing(res, res, res)
    md = resample_to_grid(
        torch.as_tensor(mask.data, dtype=torch.float32, device=device),
        mask.attr.w2i().astype(np.float32), ma.shape_zyx,
        ma.i2w().astype(np.float32), interp="nn", padding=0.0)
    return out, Image(md.cpu().numpy(), ma)


def run_pvr(cfg: PVRConfig, stacks: Optional[List[Image]] = None,
            mask: Optional[Image] = None, mesh=None, *,
            device) -> SVRResult:
    """Reconstruct a volume from patches of the stacks on `device`; with a
    mesh, every rank calls run_pvr with the same arguments."""
    if stacks is None:
        stacks = [read_nifti(p) for p in cfg.input_stacks]
    if mask is None and cfg.mask is not None:
        mask = read_nifti(cfg.mask)
    if mask is None:
        # the PVR default (irtkPatchBasedReconstruction.cpp:196)
        mask = create_mask_from_overlap(stacks)
        mask = Image((mask.data > 0).astype(np.float32), mask.attr)
    if cfg.dilate_mask > 0:
        mask = Image(dilate(mask.data, cfg.dilate_mask).astype(np.float32),
                     mask.attr)
    if cfg.resample:
        stacks, mask = _resample_inputs(cfg, stacks, mask, device)

    if not cfg.hierarchical:
        return _run_level(cfg, stacks, mask, cfg.patch_size,
                          cfg.patch_stride, None, mesh, device=device)
    # coarse to fine (patchBasedReconMain.cpp:422-431)
    size, stride = cfg.patch_size, cfg.patch_stride
    result = None
    for _ in range(cfg.hier_levels):
        result = _run_level(cfg, stacks, mask, size, stride,
                            result.reconstructed if result else None, mesh,
                            device=device)
        size, stride = max(size - 4, 8), max(stride - 2, 4)
    return result


def _run_level(cfg: PVRConfig, stacks, mask, patch_size, patch_stride,
               initial: Optional[Image], mesh, *, device) -> SVRResult:
    """One run_svr over patches of one size, seeded with `initial`."""
    rank0 = mesh is None or mesh.rank == 0
    batch_cell = {}

    def factory(cropped_stacks, thickness, recon_mask_img, stack_transforms):
        with annotate("patch extraction"):
            if cfg.superpixel:
                batch = extract_superpixel_patches(
                    cropped_stacks, thickness, spx_size=cfg.spx_size,
                    spx_extend=cfg.spx_extend)
            else:
                batch = extract_patches(
                    cropped_stacks, thickness, patch_size, patch_stride,
                    mask=recon_mask_img, stack_transforms=stack_transforms,
                    use_full_slices=cfg.use_full_slices)
        batch_cell["batch"] = batch
        if cfg.patch_extraction and rank0:
            # --patchExtraction (irtkPatchBasedReconstruction.cpp:351-385)
            pvr_eval.dump_patches(batch, f"{cfg.log_prefix}patches_"
                                         f"{patch_size}_{patch_stride}.npz")
        return batch

    # per-iteration evaluation CSVs (Evaluate3d / EvaluateGt3d,
    # cpp:570-580)
    hook = None
    tag = f"patch-size-{patch_size}-stride-{patch_stride}"
    gt_img = read_nifti(cfg.evaluate_gt) if cfg.evaluate_gt else None
    if gt_img is not None and cfg.evaluate_baseline and rank0:
        mx = max(float(np.max(s.data)) for s in stacks)
        pvr_eval.evaluate_baseline_3d(stacks, gt_img, mx, tag,
                                      device=device)
    if gt_img is not None or cfg.evaluation_masks:
        def hook(it, recon_img, transforms=None):
            if gt_img is not None:
                pvr_eval.evaluate_gt_3d(
                    it, recon_img, gt_img, float(np.max(gt_img.data)), tag,
                    dssim_path=f"dssim-iter-{it}-size-{patch_size}"
                               f"-{patch_stride}.nii.gz", device=device)
            mx = max(float(np.max(s.data)) for s in stacks)
            mn = min(float(np.min(s.data)) for s in stacks)
            for mpath in cfg.evaluation_masks:
                em = read_nifti(mpath)
                name = os.path.splitext(
                    os.path.basename(mpath))[0].replace(".nii", "")
                pvr_eval.evaluate_3d(it, recon_img, stacks, em, tag, name,
                                     device=device)
                if cfg.evaluate_2d and "batch" in batch_cell:
                    # the per-patch 2D battery (Evaluate2d, cpp:1236-1449)
                    b = batch_cell["batch"]
                    t = transforms if transforms is not None else \
                        np.tile(np.eye(4), (b.n_slices, 1, 1))
                    pvr_eval.evaluate_2d(it, recon_img, b, t, em, name,
                                         patch_size, patch_stride, mn, mx)
                    if it == 0 and cfg.evaluate_baseline:
                        pvr_eval.evaluate_baseline_2d(
                            b, stacks, em, name, patch_size, patch_stride,
                            mn, mx)

    return run_svr(cfg, stacks=stacks, mask=mask, reference_volume=initial,
                   device=device, slice_factory=factory, mesh=mesh,
                   iteration_hook=hook)
