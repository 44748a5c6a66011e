"""SVR reconstruction CLI of the port: `svr-reconstruct-torch`.

The same flags as `svr-reconstruct` (the reference's SVRreconstructionGPU
option table, reconstruction.cc:162-211; `build_parser` gives the JAX
package's namespace for any argv), running pipeline.svr.run_svr on one CUDA
device.  --useCPU runs on the CPU instead: it is the user's choice, never a
fallback, and without it a machine with no CUDA device is refused.

Multi-device:

- `--mesh N` (N > 1) spawns N ranks on this host, rank r on cuda:(r % the
  card count), or N CPU ranks with --useCPU;
- `--distributed` runs this process as one rank of a job that a launcher
  such as torchrun started (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
  LOCAL_RANK), the counterpart of jax.distributed.initialize();
- `--mesh-mode` picks what the ranks split: `slices` (slice data
  parallelism, parallel/sharded.py), `volume` (the volume's z-slabs, the
  large-area mode, parallel/volume_sharded.py) or `grid` (both, on the
  mesh2d.grid_shape(N) grid of parallel/mesh2d.py).

Rank 0 alone writes files.  `--trace DIR` writes a torch.profiler Chrome
trace per rank, DIR/trace_rank<r>.json.  Writes the volume,
<output>.bspline.nii.gz with --bspline, PSFTransformed_<mask> beside the
--manualMask input, and the slice transforms with
--saveSliceTransformations.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time

from ..parallel import sharded
from ..pipeline.config import SVRConfig
from ..utils import tracing
from . import pick_device

PROG = "svr-reconstruct-torch"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=PROG,
        description="Slice-to-volume reconstruction (SVR) on CUDA GPUs")
    p.add_argument("-o", "--output", default="3TReconstruction.nii.gz",
                   help="Name for the reconstructed volume")
    p.add_argument("-i", "--input", nargs="+", required=True,
                   help="Input stacks (NIfTI)")
    p.add_argument("-m", "--mask", default=None, help="Binary mask")
    p.add_argument("-t", "--transformations", nargs="*", default=[],
                   help="Initial stack transform .dof files (optional)")
    p.add_argument("--thickness", nargs="*", type=float, default=[],
                   help="Slice thickness per stack [default: 2*dz]")
    p.add_argument("-p", "--packages", nargs="*", type=int, default=[],
                   help="Packages per stack (hierarchical registration)")
    p.add_argument("--iterations", type=int, default=9)
    p.add_argument("--sigma", type=float, default=20.0)
    p.add_argument("--resolution", type=float, default=0.75)
    p.add_argument("--multires", type=int, default=3)
    p.add_argument("--average", type=float, default=700.0)
    p.add_argument("--delta", type=float, default=150.0)
    p.add_argument("--lambda", dest="lambda_", type=float, default=0.02)
    p.add_argument("--lastIterLambda", type=float, default=0.01)
    p.add_argument("--smooth_mask", type=float, default=4.0)
    p.add_argument("--global_bias_correction", action="store_true")
    p.add_argument("--low_intensity_cutoff", type=float, default=0.01)
    p.add_argument("--force_exclude", nargs="*", type=int, default=[])
    p.add_argument("--no_intensity_matching", action="store_true")
    p.add_argument("--log_prefix", default="")
    p.add_argument("--debug", action="store_true")
    p.add_argument("--debug_gpu", action="store_true",
                   help="Debug device-side results (alias of --debug)")
    p.add_argument("--patchBased", action="store_true",
                   help="Experimental patch-based slice mode")
    p.add_argument("--patchSize", type=int, default=64)
    p.add_argument("--patchStride", type=int, default=32)
    p.add_argument("--superpixelBased", action="store_true",
                   help="Experimental superpixel-based slice mode")
    p.add_argument("-s", "--superpixel", type=float, default=0.0,
                   help="[noLabels] number of superpixels per slice")
    p.add_argument("--manualMask", default="",
                   help="Per-slice manual mask of the FIRST stack; pushed "
                        "through the PSF into recon space at the end")
    p.add_argument("--rec_iterations_first", type=int, default=4)
    p.add_argument("--rec_iterations_last", type=int, default=13)
    p.add_argument("--disableBiasCorrection", action="store_true",
                   default=True)
    p.add_argument("--enableBiasCorrection", dest="disableBiasCorrection",
                   action="store_false",
                   help="Enable the 2D slice bias correction")
    p.add_argument("--useNMI", action="store_true")
    p.add_argument("--saveSliceTransformations", action="store_true")
    p.add_argument("--no_log", action="store_true")
    # accepted for reference compatibility; ignored
    p.add_argument("-d", "--devices", nargs="*", type=int, default=[])
    p.add_argument("--useCPU", action="store_true",
                   help="Run on the CPU instead of the GPU")
    p.add_argument("--useCPUReg", action="store_true")
    p.add_argument("--useGPUReg", action="store_true")
    p.add_argument("--useAutoTemplate", action="store_true")
    p.add_argument("--num_stacks_tuner", type=int, default=0)
    p.add_argument("--sfolder", default="",
                   help="Folder with replacement slices")
    p.add_argument("--referenceVolume", default="",
                   help="Reference volume (seeds reconstruction; "
                        "required by --T1PackageSize)")
    p.add_argument("--T1PackageSize", type=int, default=0)
    p.add_argument("--tfolder", default="",
                   help="Folder with per-slice transformation%%i.dof files")
    p.add_argument("--engine", choices=["fast", "exact"], default="fast",
                   help="PSF engine: fast (separable conv + trilinear) or "
                        "exact (reference-faithful offsets)")
    p.add_argument("--checkpoint", default="",
                   help="Directory for per-outer-iteration checkpoints")
    p.add_argument("--resume", action="store_true",
                   help="Resume from the latest checkpoint in --checkpoint")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="Run N ranks on this host, splitting what "
                        "--mesh-mode names (N <= 1: one device)")
    p.add_argument("--mesh-mode", choices=("slices", "volume", "grid"),
                   default="slices",
                   help="'slices': slice data parallelism (replicated "
                        "volume); 'volume': z-slab volume sharding for "
                        "large-area runs (replicated slices); 'grid': both, "
                        "on a near-square slices x z-slabs grid")
    p.add_argument("--distributed", action="store_true",
                   help="Run as one rank of a job started by a launcher "
                        "such as torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
                        "MASTER_PORT, LOCAL_RANK)")
    p.add_argument("--trace", default="",
                   help="Write a torch.profiler Chrome trace per rank to "
                        "this directory")
    p.add_argument("--bspline", action="store_true",
                   help="Also write the alternative B-spline reconstruction "
                        "(<output>.bspline.nii.gz)")
    return p


class _LogRedirect:
    """stdout/stderr redirection to log files (reconstruction.cc:633-656:
    log-registration.txt / log-registration-error.txt; restored on exit)."""

    def __init__(self, prefix: str, enabled: bool):
        self.enabled = enabled
        self.prefix = prefix

    def __enter__(self):
        if not self.enabled:
            return self
        self._out, self._err = sys.stdout, sys.stderr
        self._fo = open(self.prefix + "log-reconstruction.txt", "a")
        self._fe = open(self.prefix + "log-registration-error.txt", "a")
        sys.stdout, sys.stderr = self._fo, self._fe
        return self

    def __exit__(self, *exc):
        if not self.enabled:
            return False
        sys.stdout, sys.stderr = self._out, self._err
        self._fo.close()
        self._fe.close()
        return False


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    if not (args.mesh > 1 or args.distributed):
        return _run(args, pick_device(args.useCPU, PROG), None)
    pick_device(args.useCPU, PROG)  # refuse a machine without a card first
    if not args.distributed:
        sharded.spawn(_rank, args.mesh, argv, use_cpu=args.useCPU)
        return 0
    mesh = sharded.mesh_from_env(use_cpu=args.useCPU)
    try:
        if args.mesh not in (0, mesh.size):
            raise ValueError(f"--mesh {args.mesh} with --distributed: the "
                             f"launcher started {mesh.size} ranks")
        return _run(args, mesh.device, mesh)
    finally:
        sharded.close()


def _rank(mesh, argv) -> None:
    """One rank of `--mesh N` (spawned by main)."""
    _run(build_parser().parse_args(argv), mesh.device, mesh)


def _run(args, device, mesh) -> int:
    from ..io.nifti import write_nifti
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

    rank = 0 if mesh is None else mesh.rank
    tracer = (tracing.trace(args.trace, rank) if args.trace
              else contextlib.nullcontext())
    with tracer, _LogRedirect(args.log_prefix, rank == 0 and not args.no_log):
        result = run_svr(cfg, device=device, mesh=mesh,
                         mesh_mode=args.mesh_mode)
    if rank != 0:
        return 0
    write_nifti(result.reconstructed, cfg.output)
    print(f"wrote {cfg.output}")
    if result.bspline_reconstructed is not None:
        write_nifti(result.bspline_reconstructed,
                    cfg.output + ".bspline.nii.gz")
        print(f"wrote {cfg.output}.bspline.nii.gz")
    if result.manual_mask_volume is not None:
        d, b = os.path.split(args.manualMask)
        mpath = os.path.join(d, "PSFTransformed_" + b)
        write_nifti(result.manual_mask_volume, mpath)
        print(f"wrote {mpath}")
    if args.saveSliceTransformations:
        from ..io.dof import save_transformations
        folder = cfg.output + ".transforms"
        save_transformations(folder, result.transforms)
        print(f"wrote {folder}/transformation*.dof")
    result.stats.print()
    result.stats.write(args.log_prefix
                       + time.strftime("performance_%Y-%m-%d-%H-%M-%S.txt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
