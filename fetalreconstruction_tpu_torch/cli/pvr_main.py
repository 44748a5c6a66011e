"""PVR reconstruction CLI of the port: `pvr-reconstruct-torch`.

The same flags as `pvr-reconstruct` (the reference's PVRreconstructionGPU
option table, patchBasedReconMain.cpp:110-135; `build_parser` gives the JAX
package's namespace for any argv; the thickness given is passed through as
the net slice thickness), running pipeline.pvr.run_pvr on one CUDA device.
--useCPU runs on the CPU instead: it is the user's choice, never a
fallback, and without it a machine with no CUDA device is refused.  --mesh
is not ported yet and is refused.
"""
from __future__ import annotations

import argparse
import sys
import time

from . import pick_device
from .svr_main import _LogRedirect

_ITEM = "is not ported yet: ROADMAP.md queue 1 item "


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pvr-reconstruct-torch",
        description="Patch-to-volume reconstruction (PVR) on one CUDA GPU")
    p.add_argument("-o", "--output", default="PVRReconstruction.nii.gz")
    p.add_argument("-i", "--input", nargs="+", required=True)
    p.add_argument("-m", "--mask", default=None)
    p.add_argument("--thickness", nargs="*", type=float, default=[])
    p.add_argument("--iterations", type=int, default=9)
    p.add_argument("--resolution", type=float, default=0.75)
    p.add_argument("--patchSize", type=int, default=64)
    p.add_argument("--patchStride", type=int, default=32)
    p.add_argument("--useFullSlices", action="store_true")
    p.add_argument("--superpixel", action="store_true")
    p.add_argument("--spxSize", type=int, default=16)
    p.add_argument("--spxExtend", type=int, default=50,
                   help="0-100%% ratio of superpixel size for mask "
                        "dilation (patchBasedReconMain.cpp:124)")
    p.add_argument("--hierarchical", action="store_true")
    p.add_argument("--resample", action="store_true",
                   help="Resample input stacks to the recon resolution "
                        "before reconstruction")
    p.add_argument("--dilateMask", type=int, default=0)
    # research-evaluation harness (patchBasedReconMain.cpp:137-144)
    p.add_argument("--evaluateGt", default="",
                   help="Ground-truth volume for per-iteration evaluation "
                        "CSVs (log-evaluate-Gt.csv)")
    p.add_argument("--evaluation", nargs="*", default=[],
                   help="Evaluation mask volumes (per-iteration "
                        "log-evaluate-<mask>.csv rows vs input stacks)")
    p.add_argument("--evaluateBaseline", action="store_true",
                   help="Also evaluate the raw input stacks vs ground "
                        "truth before reconstruction")
    p.add_argument("--patchExtraction", action="store_true",
                   help="Dump the extracted patch batch to disk")
    p.add_argument("--useFullSlicePatches", dest="useFullSlices",
                   action="store_true", help=argparse.SUPPRESS)
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="Multi-device: not ported yet (refused)")
    p.add_argument("--checkpoint", default="")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--log_prefix", default="")
    p.add_argument("--no_log", action="store_true")
    p.add_argument("--sigma", type=float, default=20.0)
    p.add_argument("--delta", type=float, default=150.0)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.02)
    p.add_argument("--lastIterLambda", type=float, default=0.01)
    p.add_argument("--average", type=float, default=700.0)
    p.add_argument("--smooth_mask", type=float, default=4.0)
    p.add_argument("--no_intensity_matching", action="store_true")
    p.add_argument("--rec_iterations_first", type=int, default=4)
    p.add_argument("--rec_iterations_last", type=int, default=13)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--engine", choices=["fast", "exact"], default="fast")
    # compatibility no-ops
    p.add_argument("-d", "--devices", nargs="*", type=int, default=[])
    p.add_argument("--useCPU", action="store_true",
                   help="Run on the CPU instead of the GPU")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("multi-device (--mesh) " + _ITEM + "13")
    device = pick_device(args.useCPU, "pvr-reconstruct-torch")

    from ..io.nifti import write_nifti
    from ..pipeline.pvr import PVRConfig, run_pvr

    cfg = PVRConfig(
        output=args.output, input_stacks=args.input, mask=args.mask,
        thickness=args.thickness, iterations=args.iterations,
        resolution=args.resolution, patch_size=args.patchSize,
        patch_stride=args.patchStride, use_full_slices=args.useFullSlices,
        superpixel=args.superpixel, spx_size=args.spxSize,
        spx_extend=args.spxExtend, hierarchical=args.hierarchical,
        resample=args.resample, dilate_mask=args.dilateMask,
        sigma=args.sigma, delta=args.delta, lambda_=args.lambda_,
        last_iter_lambda=args.lastIterLambda, average_value=args.average,
        smooth_mask=args.smooth_mask,
        intensity_matching=not args.no_intensity_matching,
        rec_iterations_first=args.rec_iterations_first,
        rec_iterations_last=args.rec_iterations_last, debug=args.debug,
        engine=args.engine, evaluate_gt=args.evaluateGt,
        evaluation_masks=args.evaluation,
        evaluate_baseline=args.evaluateBaseline,
        patch_extraction=args.patchExtraction,
        checkpoint_dir=args.checkpoint, resume=args.resume,
        log_prefix=args.log_prefix, no_log=args.no_log)

    with _LogRedirect(args.log_prefix, not args.no_log):
        result = run_pvr(cfg, device=device)
    write_nifti(result.reconstructed, cfg.output)
    print(f"wrote {cfg.output}")
    result.stats.print()
    result.stats.write(args.log_prefix
                       + time.strftime("performance_%Y-%m-%d-%H-%M-%S.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
