"""Readings that size `CUT_BAND` (reference/fast_engine.py), on the card.

    python3 -m benchmark.cut_band --workload <recon cell> --seeds 1,2,3
        [--out FILE]

For each seed, in one process: one reconstruction of the cell's case by
the program, then the reference's geometry of its batch and final
transforms on the reference's mask in float32 and in float64.  Over the
valid pixels whose float64 value lies within `NEAR` of a cut (simw of
CONF_CUT, (K_s * 1)(xp) of SUME_CUT), it reads the largest difference
between the float32 and float64 values, and the same for the program's own
simw (its fast engine's geometry).  Then per unit: the program's slice
weight, the float32 reference's and the TF32 control's, and how near the
unit's pixels come to each cut in float32 and in float64, so that the
units left out and the limits that follow can be read off for any band.  One
JSON line per seed on standard output and in FILE.  The benchmark's own
runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import sys
import time

import numpy as np

from .run import ROOT, set_environment

NEAR = 1e-3  # the pixels whose rounding is read: this near a cut


def _pixels(g):
    """Per pixel: simw, (K_s * 1)(xp), and whether it is valid."""
    from .reference.fast_engine import simw_of
    return (simw_of(g).double().cpu().numpy(),
            g.raw.double().cpu().numpy(), g.valid.cpu().numpy())


def readings(cfgd: dict, seed: int, device) -> dict:
    """See the module's docstring."""
    import torch

    from . import loops
    from .inputs import cases
    from .reference import fast_engine as ref
    from .reference import mask as ref_mask
    from .traffic import recon
    case = cases.motion_case(seed, **cfgd["case"])
    stacks = [recon._to_image(d, g) for d, g in case["stacks"]]
    mask = recon._to_image(*case["mask"])
    cfg = loops.program(cfgd["program"]["settings"])(**cfgd["run"])
    batches = []

    def tap(orig):
        def f(*a, **k):
            batches.append(orig(*a, **k))
            return batches[-1]
        return f

    t = time.perf_counter()
    with loops.patched(cfgd["program"]["batch"], tap):
        res = loops.program(cfgd["program"]["entry"])(
            cfg, stacks=stacks, mask=mask, device=device)
    loops.sync(device)
    recon_s = time.perf_counter() - t
    b = batches[-1]
    a = res.reconstructed.attr
    grid = cases.Grid(**{f.name: getattr(a, f.name)
                         for f in dataclasses.fields(cases.Grid)})
    run = cfgd["run"]
    mdata, mgrid = case["mask"]
    inside, undecided = ref_mask.on_grid(
        mdata, mgrid.w2i(), grid.shape_zyx, grid.i2w(),
        run.get("smooth_mask", 4.0), device)
    prog = np.asarray(res.reconstructed.data) != -1.0
    m = (inside | (undecided & prog)).astype(np.float64)

    geo = {}
    for dt in (torch.float32, torch.float64):
        eng = ref.engine(b.i2w, b.stack_index, b.dims, grid.w2i(), grid.dx,
                         grid.shape_zyx, device, dt)
        p = ref.problem(eng, b.data, b.i2w, b.stack_index, res.transforms,
                        grid.w2i(), m)
        geo[dt] = (_pixels(p.geom),
                   ref.cut_distance(p.geom).cpu().numpy())
        del eng, p
    (w32, r32, valid), d32 = geo[torch.float32]
    (w64, r64, _), d64 = geo[torch.float64]
    near_w = valid & (np.abs(w64 - ref.CONF_CUT) < NEAR)
    near_r = valid & (np.abs(r64 - ref.SUME_CUT) < NEAR)

    # the program's own simw: its fast engine's geometry of the same batch
    psf_ops = loops.program("ops.psf")
    fast = loops.program("ops.psf_fast")
    support = psf_ops.reference_support(b.dims, grid.dx,
                                        cfg.quality_factor,
                                        cfg.max_psf_support)
    fpsf = fast.FastPSF.from_batch(b, grid.w2i(), support)
    fwd = loops.program("pipeline.svr_core.slice_forward_matrices")(
        torch.as_tensor(grid.w2i()), torch.as_tensor(res.transforms),
        torch.as_tensor(np.asarray(b.i2w)))
    pg = fast.make_fast_geom(
        fpsf, fwd, torch.as_tensor(b.data != -1.0, device=device),
        grid.shape_zyx, torch.as_tensor(m, dtype=torch.float32,
                                        device=device),
        stack_id=np.asarray(b.stack_index))
    pos = pg.sume > 0
    wp = torch.where(pos, pg.den / torch.where(pos, pg.sume, 1.0),
                     0.0).double().cpu().numpy()
    gate_p = pos.cpu().numpy()
    del fpsf, pg, pos

    def worst(x, where):
        return float(np.abs(x[where]).max()) if where.any() else 0.0

    sw = {}
    for name, tf32 in (("reference", False), ("control", True)):
        r = ref.last_stage(
            b.data, b.i2w, b.stack_index, b.dims, res.transforms, grid.w2i(),
            grid.dx, grid.shape_zyx, m, res.stack_factors,
            run.get("rec_iterations_last", 13), run.get("delta", 150.0),
            run.get("last_iter_lambda", 0.01), device, tf32=tf32)
        sw[name] = r.state.slice_weight.cpu().numpy().astype(float).tolist()
        del r
    return dict(
        seed=seed, recon_s=recon_s, units=int(b.data.shape[0]),
        near_pixels=dict(simw=int(near_w.sum()), sume=int(near_r.sum())),
        simw_f32_f64=worst(w32 - w64, near_w),
        sume_f32_f64=worst(r32 - r64, near_r),
        simw_f32_f64_all=worst(w32 - w64, valid & (w64 > 0)),
        simw_program_f64=worst(wp - w64, near_w),
        simw_program_f32=worst(wp - w32, near_w),
        gate_program_f64=int((gate_p != (valid & (r64 > ref.SUME_CUT)))[
            valid].sum()),
        program=np.asarray(res.slice_weights, float).tolist(),
        reference=sw["reference"], control=sw["control"],
        cut_f32=d32.astype(float).tolist(),
        cut_f64=d64.astype(float).tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.cut_band")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from . import harness
    if not torch.cuda.is_available():
        print("cut_band: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    man = harness.load_manifest(ROOT)
    cfgd = harness.config_of(man, ROOT,
                             harness.cell_of(man, args.workload)["config"])
    with contextlib.ExitStack() as stack:
        sink = stack.enter_context(open(args.out, "a")) if args.out else None
        for seed in (int(s) for s in args.seeds.split(",")):
            line = json.dumps(dict(workload=args.workload,
                                   **readings(cfgd, seed, dev)))
            print(line[:600], flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
