"""Readings that size `CUT_BAND` and `SUME_BAND` of the exact engine's
reference (reference/exact_engine.py), on the card.

    python3 -m benchmark.exact_band --workload <exact recon cell>
        --seeds 1,2,3 [--out FILE]

benchmark/cut_band.py's readings for the fast engine's reference, taken
for the exact one.  For each seed, in one process: one reconstruction of
the cell's case by the program, then the exact reference's geometry of its
batch and final transforms on the reference's mask in float32 and in
float64.  Over the valid pixels whose float64 value lies within
cut_band.NEAR of a cut (simw of CONF_CUT, the PSF sum of SUME_CUT), it
reads the largest difference between the float32 and float64 values, and
the same for the program's own simw and PSF-sum gate (ops.psf's
psf_sums and psf_gather).  Then per unit: the program's slice weight, the
float32 reference's and the TF32 control's, and how near the unit's pixels
come to each cut in float32 and in float64.  Beside them, the second
float32 order (the reference with blocked=True: each block of offsets
summed first): its simw against the loop order's near the cut, its slice
weights, and the volume gap of each of the program, the blocked
reference and the control against the reference, and of the program
against the blocked reference, as the cell's `volume_gap` reads it.  One
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

from .cut_band import NEAR
from .run import ROOT, set_environment


def readings(cfgd: dict, seed: int, device) -> dict:
    """See the module's docstring."""
    import torch

    from . import loops
    from .inputs import cases
    from .reference import exact_engine as ex
    from .reference import fast_engine as fe
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

    support = dict(quality=cfg.quality_factor,
                   max_support=cfg.max_psf_support)
    geo = {}
    for key, dt, blocked in (("f32", torch.float32, False),
                             ("blocked", torch.float32, True),
                             ("f64", torch.float64, False)):
        eng = ex.engine(b.dims, grid.dx, grid.shape_zyx, device, dtype=dt,
                        blocked=blocked, **support)
        p = fe.problem(eng, b.data, b.i2w, b.stack_index, res.transforms,
                       grid.w2i(), m)
        g = p.geom
        geo[key] = ((g.den.double().cpu().numpy(),
                     g.raw.double().cpu().numpy(), g.valid.cpu().numpy()),
                    ex.cut_distance(g).cpu().numpy())
        del eng, p, g
    (w32, r32, valid), d32 = geo["f32"]
    (wb, rb, _), _ = geo["blocked"]
    (w64, r64, _), d64 = geo["f64"]
    near_w = valid & (np.abs(w64 - fe.CONF_CUT) < NEAR)
    near_r = valid & (np.abs(r64 - fe.SUME_CUT) < NEAR)

    # the program's own simw and gate: its exact engine on the same batch
    psf = loops.program("ops.psf")
    fwd = loops.program("pipeline.svr_core.slice_forward_matrices")(
        torch.as_tensor(grid.w2i(), device=device),
        torch.as_tensor(res.transforms, device=device),
        torch.as_tensor(np.asarray(b.i2w), device=device))
    valid_t = torch.as_tensor(b.data != -1.0, device=device)
    pg = psf.make_slice_geom(fwd, torch.as_tensor(b.dims, device=device),
                             valid_t)
    offsets = psf.make_offsets(psf.reference_support(
        b.dims, grid.dx, cfg.quality_factor, cfg.max_psf_support))
    sume = psf.psf_sums(pg, offsets, grid.shape_zyx)
    m_flat = torch.as_tensor(m, dtype=torch.float32, device=device)
    _, simw, _ = psf.psf_gather(pg, offsets, sume, m_flat.reshape(-1),
                                m_flat.reshape(-1), grid.shape_zyx)
    wp = simw.double().cpu().numpy()
    gate_p = (sume > 0).cpu().numpy()
    del pg, sume, simw

    def worst(x, where):
        return float(np.abs(x[where]).max()) if where.any() else 0.0

    sw, vols = {}, {}
    for name, tf32, blocked in (("reference", False, False),
                                ("blocked", False, True),
                                ("control", True, False)):
        r = ex.last_stage(
            b.data, b.i2w, b.stack_index, b.dims, res.transforms, grid.w2i(),
            grid.dx, grid.shape_zyx, m, res.stack_factors,
            run.get("rec_iterations_last", 13), run.get("delta", 150.0),
            run.get("last_iter_lambda", 0.01), device, tf32=tf32,
            blocked=blocked, **support)
        sw[name] = r.state.slice_weight.cpu().numpy().astype(float).tolist()
        vols[name] = (r.volume, r.settled)
        del r
    vol = np.asarray(res.reconstructed.data)
    ref_v, ref_keep = vols["reference"]
    blk_v, blk_keep = vols["blocked"]
    return dict(
        seed=seed, recon_s=recon_s, units=int(b.data.shape[0]),
        near_pixels=dict(simw=int(near_w.sum()), sume=int(near_r.sum())),
        simw_f32_f64=worst(w32 - w64, near_w),
        sume_f32_f64=worst(r32 - r64, near_r),
        simw_f32_f64_all=worst(w32 - w64, valid & (w64 > 0)),
        simw_program_f64=worst(wp - w64, near_w),
        simw_program_f32=worst(wp - w32, near_w),
        simw_blocked_f32=worst(wb - w32, near_w),
        simw_blocked_f32_all=worst(wb - w32, valid & (w64 > 0)),
        sume_blocked_f32=worst(rb - r32, near_r),
        volume_gap=dict(
            program=loops.rel_gap(vol, ref_v, ref_keep),
            blocked=loops.rel_gap(blk_v, ref_v, ref_keep),
            control=loops.rel_gap(vols["control"][0], ref_v, ref_keep),
            program_blocked=loops.rel_gap(vol, blk_v, blk_keep)),
        gate_program_f64=int((gate_p != (valid & (r64 > fe.SUME_CUT)))[
            valid].sum()),
        program=np.asarray(res.slice_weights, float).tolist(),
        reference=sw["reference"], blocked=sw["blocked"],
        control=sw["control"],
        cut_f32=d32.astype(float).tolist(),
        cut_f64=d64.astype(float).tolist())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.exact_band")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    set_environment()
    import torch

    from . import harness
    if not torch.cuda.is_available():
        print("exact_band: no CUDA card", file=sys.stderr)
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
