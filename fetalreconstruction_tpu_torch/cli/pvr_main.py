"""PVR reconstruction CLI of the port: `pvr-reconstruct-torch`.

The same flags as `pvr-reconstruct` (the JAX package's parser, the
reference's PVRreconstructionGPU option table, patchBasedReconMain.cpp:
110-135; the thickness given is passed through as the net slice
thickness), running pipeline.pvr.run_pvr on one CUDA device.  --useCPU
runs on the CPU instead: it is the user's choice, never a fallback, and
without it a machine with no CUDA device is refused.  --mesh is not ported
yet and is refused.
"""
from __future__ import annotations

import sys
import time

import torch

from fetalreconstruction_tpu.cli import pvr_main as _jax_cli
from fetalreconstruction_tpu.cli.svr_main import _LogRedirect

_ITEM = "is not ported yet: ROADMAP.md queue 1 item "


def build_parser():
    p = _jax_cli.build_parser()
    p.prog = "pvr-reconstruct-torch"
    p.description = "Patch-to-volume reconstruction (PVR) on one CUDA GPU"
    for a in p._actions:
        if a.dest == "useCPU":
            a.help = "Run on the CPU instead of the GPU"
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh:
        raise NotImplementedError("multi-device (--mesh) " + _ITEM + "13")
    if args.useCPU:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: pvr-reconstruct-torch runs on a "
                           "GPU (pass --useCPU to run on the CPU)")

    from fetalreconstruction_tpu.io.nifti import write_nifti
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
