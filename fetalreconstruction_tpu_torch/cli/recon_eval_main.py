"""Reconstruction-evaluation CLI of the port: `fetalrecon-recon-eval-torch`.

Port of fetalreconstruction_tpu/cli/recon_eval_main.py
(irtkReconstructionEvaluation.cc, the crop + rigid-refine + histogram
battery of the paper's quantitative tables; :272-360):
  1. cropImage() (:56-98): the target resampled onto the SOURCE grid where
     source > 0 (nearest voxel), giving the cropped target, the difference
     volume (cropped - source; -1 outside) and the source > 0 mask;
  2. rreg2() (:100-270): rigid registration of the cropped target to the
     source over the mask, written as a .dof transform;
  3. the irtkEvaluation histogram battery between the registered pair
     (CC/SSD/JE/MI/NMI/CR/LC/Kappa/PSNR), printed as the metric row.

Resampling, registration and the battery's sampling run on one CUDA
device; --useCPU runs them on the CPU instead (the user's choice, never a
fallback).

Usage mirrors the reference:
  fetalrecon-recon-eval-torch target source output diff_volume mask dofout
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..core.image import Image
from ..evaluation.metrics import evaluate
from ..io.dof import write_dof
from ..io.nifti import read_nifti, write_nifti
from ..ops.sampling import resample_to_grid
from ..register.volume import VolRegConfig, register_volumes
from . import pick_device


def _resample(img: Image, src_w2i, grid: Image, interp: str, device):
    """img's data resampled onto grid's raster through src_w2i (float64,
    cast to float32 as in JAX)."""
    return resample_to_grid(
        torch.as_tensor(img.data, dtype=torch.float32, device=device),
        np.asarray(src_w2i).astype(np.float32), grid.attr.shape_zyx,
        grid.attr.i2w().astype(np.float32), interp=interp,
        padding=0.0).cpu().numpy()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fetalrecon-recon-eval-torch",
        description="Crop + rigidly refine + evaluate a reconstruction "
                    "against a reference volume "
                    "(irtkReconstructionEvaluation.cc) on one CUDA GPU")
    p.add_argument("target")
    p.add_argument("source")
    p.add_argument("output", help="cropped target (written)")
    p.add_argument("diff_volume", help="difference volume (written)")
    p.add_argument("mask", help="source>0 mask (written)")
    p.add_argument("dofout", help="rigid refinement transform (written)")
    p.add_argument("--nbins_x", type=int, default=0)
    p.add_argument("--nbins_y", type=int, default=0)
    p.add_argument("--useCPU", action="store_true",
                   help="Run on the CPU instead of the GPU")
    args = p.parse_args(argv)
    device = pick_device(args.useCPU, "fetalrecon-recon-eval-torch")

    target = read_nifti(args.target)
    source = read_nifti(args.source)

    # ---- cropImage(): nearest-voxel target values on the source grid
    tvals = _resample(target, target.attr.w2i(), source, "nn", device)
    smask = source.data > 0
    cropped = np.where(smask, tvals, 0.0).astype(np.float32)
    diff = np.where(smask, cropped - source.data, -1.0).astype(np.float32)
    write_nifti(Image(cropped, source.attr.copy()), args.output)
    write_nifti(Image(diff, source.attr.copy()), args.diff_volume)
    write_nifti(Image(smask.astype(np.float32), source.attr.copy()),
                args.mask)
    print("Crop Image ... done")

    # ---- rreg2(): rigid refinement of the cropped target vs the source
    t_mat, sim = register_volumes(
        VolRegConfig(metric="cc"), Image(cropped, source.attr.copy()),
        source, target_padding=0.0, device=device)
    write_dof(args.dofout, t_mat)
    print(f"Registration ... done (similarity {sim:.4f})")

    # ---- the battery on the registered pair: the source sampled through
    # the refined transform onto the cropped target's grid
    sdata = _resample(source, source.attr.w2i() @ t_mat, source, "linear",
                      device)
    r = evaluate(Image(cropped, source.attr.copy()),
                 Image(sdata.astype(np.float32), source.attr.copy()),
                 nbins_x=args.nbins_x, nbins_y=args.nbins_y, device=device)
    print(f"CC: {r.cc}")
    print(f"SSD: {r.ssd}")
    print(f"JE: {r.je}")
    print(f"MI: {r.mi}")
    print(f"NMI: {r.nmi}")
    print(f"CR_X|Y: {r.cr_xy}")
    print(f"CR_Y|X: {r.cr_yx}")
    print(f"LC: {r.lc}")
    print(f"KS: {r.ks}")
    print(f"PSNR: {r.psnr}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
