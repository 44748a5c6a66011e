"""SVR reconstruction CLI of the port: `svr-reconstruct-torch`.

The same flags as `svr-reconstruct` (the JAX package's parser, the
reference's SVRreconstructionGPU option table, reconstruction.cc:162-211),
running pipeline.svr.run_svr on one CUDA device.  --useCPU runs on the CPU
instead: it is the user's choice, never a fallback, and without it a
machine with no CUDA device is refused.  --mesh, --distributed and --trace
are not ported yet and are refused.
"""
from __future__ import annotations

import sys
import time

import torch

from fetalreconstruction_tpu.cli.svr_main import _LogRedirect, build_parser
from fetalreconstruction_tpu.pipeline.config import SVRConfig

_ITEM = "is not ported yet: ROADMAP.md queue 1 item "


def main(argv=None) -> int:
    parser = build_parser()
    parser.prog = "svr-reconstruct-torch"
    args = parser.parse_args(argv)
    if args.mesh or args.distributed:
        raise NotImplementedError("multi-device (--mesh, --distributed) "
                                  + _ITEM + "13")
    if args.trace:
        raise NotImplementedError("--trace " + _ITEM + "14")
    if args.useCPU:
        device = torch.device("cpu")
    elif torch.cuda.is_available():
        device = torch.device("cuda", 0)
    else:
        raise RuntimeError("no CUDA device: svr-reconstruct-torch runs on a "
                           "GPU (pass --useCPU to run on the CPU)")

    from fetalreconstruction_tpu.io.nifti import write_nifti
    from ..pipeline.svr import run_svr

    cfg = SVRConfig(
        output=args.output, input_stacks=args.input, mask=args.mask,
        thickness=args.thickness, packages=args.packages,
        iterations=args.iterations, sigma=args.sigma,
        resolution=args.resolution, multires_levels=args.multires,
        average_value=args.average, delta=args.delta, lambda_=args.lambda_,
        last_iter_lambda=args.lastIterLambda, smooth_mask=args.smooth_mask,
        global_bias_correction=args.global_bias_correction,
        low_intensity_cutoff=args.low_intensity_cutoff,
        intensity_matching=not args.no_intensity_matching,
        rec_iterations_first=args.rec_iterations_first,
        rec_iterations_last=args.rec_iterations_last,
        disable_bias_correction=args.disableBiasCorrection,
        use_nmi=args.useNMI, tfolder=args.tfolder, sfolder=args.sfolder,
        reference_volume=args.referenceVolume,
        t1_package_size=args.T1PackageSize,
        force_excluded=args.force_exclude,
        debug=args.debug or args.debug_gpu, log_prefix=args.log_prefix,
        save_slice_transformations=args.saveSliceTransformations,
        use_auto_template=args.useAutoTemplate, engine=args.engine,
        patch_based=args.patchBased, patch_size=args.patchSize,
        patch_stride=args.patchStride,
        superpixel_based=args.superpixelBased,
        num_superpixels=args.superpixel, manual_mask=args.manualMask,
        num_stacks_tuner=args.num_stacks_tuner, no_log=args.no_log,
        checkpoint_dir=args.checkpoint, resume=args.resume,
        bspline=args.bspline)
    cfg.transformation_files = args.transformations

    with _LogRedirect(args.log_prefix, not args.no_log):
        result = run_svr(cfg, device=device)
    write_nifti(result.reconstructed, cfg.output)
    print(f"wrote {cfg.output}")
    if args.saveSliceTransformations:
        from fetalreconstruction_tpu.io.dof import save_transformations
        folder = cfg.output + ".transforms"
        save_transformations(folder, result.transforms)
        print(f"wrote {folder}/transformation*.dof")
    result.stats.print()
    result.stats.write(args.log_prefix
                       + time.strftime("performance_%Y-%m-%d-%H-%M-%S.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
