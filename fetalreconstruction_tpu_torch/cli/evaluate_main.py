"""Volume comparison CLI of the port: `fetalrecon-evaluate-torch`.

Port of fetalreconstruction_tpu/cli/evaluate_main.py (the reference's
irtkEvaluation / --evaluation research harness): prints the
joint-histogram metric row between a reconstruction and a ground-truth /
baseline volume, computed by the port's evaluation/metrics.py (host
numpy, the source sampled on one CUDA device; --useCPU samples it on the
CPU instead, the user's choice and never a fallback).

Also bundles the standalone measureVolWOBorder.cc research tool
(--volume-wo-border): scan a folder of volumes, zero a 3-voxel border,
write the cropped copies and append each nonzero volume (ml) to
volumeMeasures.txt; and a --border flag that excludes an N-voxel target
border from the metric battery (the border-excluded PSNR variant).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

from ..core.image import Image
from ..evaluation.metrics import evaluate
from ..io.nifti import read_nifti, write_nifti
from . import pick_device


def volume_wo_border(folder: str, border: int = 3,
                     out_file: str = "volumeMeasures.txt"):
    """measureVolWOBorder.cc:33-100: for every .nii/.nii.gz under
    `folder`, zero a `border`-voxel border, write `c_<name>`, and append
    `<name[:4]> <nonzero volume in ml>` to volumeMeasures.txt."""
    paths = []
    for root, _dirs, files in os.walk(folder):
        for f in sorted(files):
            if f.endswith(".nii") or f.endswith(".nii.gz"):
                paths.append(os.path.join(root, f))
    rows = []
    with open(out_file, "a") as ef:
        for p in paths:
            img = read_nifti(p)
            b = border
            d = np.zeros_like(img.data)
            if (img.data.shape[0] > 2 * b and img.data.shape[1] > 2 * b
                    and img.data.shape[2] > 2 * b):
                core = img.data[b:-b, b:-b, b:-b]
                d[b:-b, b:-b, b:-b] = core
            count = int(np.count_nonzero(d))
            sp = img.attr.spacing
            ml = int(count * float(sp[0] * sp[1] * sp[2])) // 1000
            name = os.path.basename(p)
            write_nifti(Image(d, img.attr.copy()), "c_" + name)
            short = name[:4]
            print(f"{short} Volume = {ml} ml")
            ef.write(f"{short} {ml}\n")
            rows.append((short, ml))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="fetalrecon-evaluate-torch",
        description="Histogram metrics between two volumes "
                    "(CC/SSD/JE/MI/NMI/CR/LC/Kappa/PSNR)")
    p.add_argument("target", nargs="?", help="Target volume (NIfTI)")
    p.add_argument("source", nargs="?", help="Source volume (NIfTI)")
    p.add_argument("--json", action="store_true",
                   help="Emit one JSON object instead of the text row")
    p.add_argument("--border", type=int, default=0, metavar="N",
                   help="Exclude an N-voxel target border from the "
                        "metrics (the measureVolWOBorder convention)")
    p.add_argument("--volume-wo-border", metavar="FOLDER", default=None,
                   help="measureVolWOBorder.cc mode: measure nonzero "
                        "volume (ml) of every NIfTI under FOLDER with a "
                        "3-voxel border zeroed; writes c_<name> + "
                        "volumeMeasures.txt")
    p.add_argument("--useCPU", action="store_true",
                   help="Sample on the CPU instead of the GPU")
    args = p.parse_args(argv)

    if args.volume_wo_border:
        volume_wo_border(args.volume_wo_border,
                         border=args.border if args.border > 0 else 3)
        return 0
    if not args.target or not args.source:
        p.error("target and source are required (or --volume-wo-border)")
    device = pick_device(args.useCPU, "fetalrecon-evaluate-torch")

    tgt = read_nifti(args.target)
    src = read_nifti(args.source)
    if args.border > 0:
        b = args.border
        a = tgt.attr
        tgt = tgt.get_region(b, b, b, a.x - b, a.y - b, a.z - b)
    r = evaluate(tgt, src, device=device)
    if args.json:
        print(json.dumps(r.as_dict()))
    else:
        # the reference's output row (irtkEvaluation.cpp:247-258)
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
