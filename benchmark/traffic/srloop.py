"""The loop `srloop`: blocks of the reconstruction's inner SR / EM
iteration on a fixed geometry, each block from the state that set-up left;
the window synchronises at its two ends only.

Traffic parameters: `block` (inner iterations a block), `warmup_blocks`,
`trace_blocks` (blocks profiled after the window in a traced run).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import loops
from benchmark.inputs import cases
from benchmark.loops import GIB, Outcome, Run, program
from benchmark.reference import fast_engine as ref
from benchmark.trace import DeviceSpan


def problem(run: Run):
    """The canonical case on the program: its context, geometry and the
    state that the inner loop starts from (as a reconstruction's last
    stage starts: Gaussian reconstruction, small-slice exclusion,
    simulation, robust statistics, E-step)."""
    core = program("pipeline.svr_core")
    fast_psf = program("ops.psf_fast.FastPSF")
    support_of = program("ops.psf.reference_support")
    c, cfg, dev = run.config["canonical"], run.config["run"], run.device
    case = cases.canonical_case(run.seed, **c)
    grid, i2w, ranges = case["grid"], case["i2w"], case["ranges"]
    first = [lo for lo, _ in ranges]
    a3s = [np.linalg.inv((grid.w2i() @ i2w[f])[:3, :3]) for f in first]
    support = support_of(case["dims"], grid.dx, cfg.get("quality_factor", 1.0),
                         cfg.get("max_psf_support", 12))
    ctx = core.SVRContext(
        vol_shape=grid.shape_zyx, vol_spacing=(grid.dx,) * 3,
        slice_spacing_xy=tuple(case["dims"][0][:2]), disable_bias=True,
        delta=cfg.get("delta", 150.0),
        fast=fast_psf(np.asarray(a3s), case["dims"][first], ranges, support))
    f32 = torch.float32
    n = len(case["slices"])
    slices = torch.as_tensor(case["slices"], device=dev)
    valid = slices != -1.0
    stack_id = torch.as_tensor(np.concatenate(
        [np.full(hi - lo, s) for s, (lo, hi) in enumerate(ranges)]),
        device=dev)
    mask = torch.ones(grid.shape_zyx, dtype=f32, device=dev)
    mask_flat = mask.reshape(-1)
    geom, sume = core.build_geometry(
        ctx, torch.as_tensor(grid.w2i(), dtype=f32, device=dev),
        torch.eye(4, dtype=f32, device=dev).repeat(n, 1, 1),
        torch.as_tensor(i2w, dtype=f32, device=dev), valid, mask_flat,
        stack_id=stack_id)
    pos = case["slices"][case["slices"] > 0]
    max_i, min_i = float(pos.max()), float(pos.min())
    em = core.init_em_state(n, valid)
    recon0, wts, vc = core.gaussian_reconstruction(
        ctx, geom, sume, slices, valid, em.bias, em.scale, mask_flat)
    vc = vc.cpu().numpy()
    excluded = torch.as_tensor(vc < 0.1 * np.sort(vc)[int(round(
        len(vc) * 0.5))], device=dev)
    sim = core.simulate(ctx, geom, sume, recon0, mask_flat)
    em = core.initialize_robust_statistics(ctx, slices, valid, sim, em,
                                           max_i, min_i, excluded)
    em, _ = core.estep(ctx, slices, valid, sume, sim, em, excluded)
    alpha, lam = ref.smoothing(cfg.get("delta", 150.0),
                               cfg.get("last_iter_lambda", 0.01))
    iterations = int(run.traffic["block"])

    def block():
        e, s, r = em, sim, recon0
        for i in range(iterations):
            e, s, r = core.inner_iteration(
                ctx, geom, sume, slices, valid, e, s, r, wts, mask,
                mask_flat, excluded, alpha, lam, min_i, max_i, i + 1,
                do_bias=False, do_scale=True, do_normalise_bias=False)
        return e, s, r
    return case, block, iterations


def run(run: Run) -> Outcome:
    dev = run.device
    with loops.planted(run.faults, FAULTS):
        case, block, iters = problem(run)
        for _ in range(int(run.traffic["warmup_blocks"])):
            block()
        loops.sync(dev)
        setup_s = time.perf_counter() - run.t_start
        loops.reset_peak(dev)
        blocks, before = 0, loops.counters()
        t0 = time.perf_counter()
        while True:
            out = block()
            blocks += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        loops.sync(dev)
        window_s = time.perf_counter() - t0
        peak = loops.read_peak(dev)
        records = dict(splat=splat_slots(case), iterations=blocks * iters,
                       counters=loops.counted_since(before))
        breakdown = None
        if run.trace:
            n_blocks = int(run.traffic["trace_blocks"])
            with DeviceSpan(dev) as span:
                for _ in range(n_blocks):
                    block()
            records["trace_iterations"] = n_blocks * iters
            breakdown = loops.keep_trace(records, span.summary(
                [("inner iterations", span.t1)]))
    em, sim, recon_vol = out
    got = dict(recon=recon_vol.cpu().numpy(), sim=sim.sim.cpu().numpy(),
               weights=em.weights.cpu().numpy())
    del out, em, sim, recon_vol
    finite = all(np.isfinite(v).all() for v in got.values())
    e2e = dict(setup_s=setup_s, peak_mem_gib=peak / GIB,
               sr_iter_ms=window_s * 1e3 / (blocks * iters))
    checks, control = check(run, case, got) if finite else (
        {k: np.inf for k in run.compare}, None)
    return Outcome(e2e, records, checks, blocks, 0 if finite else blocks,
                   peak, breakdown, control)


def reference(run: Run, case, tf32: bool = False):
    """The reference's block from its own set-up of the canonical case."""
    cfg, grid = run.config["run"], case["grid"]
    ranges, i2w = case["ranges"], case["i2w"]
    sidx = np.concatenate([np.full(hi - lo, s)
                           for s, (lo, hi) in enumerate(ranges)])
    a3s, dims = ref.stack_geometry(i2w, sidx, case["dims"], grid.w2i())
    eng = ref.Engine(a3s, dims, ref.psf_support(case["dims"], grid.dx),
                     grid.shape_zyx, run.device, tf32=tf32)
    p = ref.problem(eng, case["slices"], i2w, sidx,
                    np.tile(np.eye(4), (len(sidx), 1, 1)), grid.w2i(),
                    np.ones(grid.shape_zyx))
    st, excluded = ref.start(eng, p)
    delta = cfg.get("delta", 150.0)
    alpha, lam = ref.smoothing(delta, cfg.get("last_iter_lambda", 0.01))
    for i in range(int(run.traffic["block"])):
        st = ref.inner(eng, p, st, excluded, alpha, lam, delta, i + 1)
    return dict(recon=st.recon.cpu().numpy(), sim=st.sim.cpu().numpy(),
                weights=st.weights.cpu().numpy(),
                keep=ref.settled(st, p.mask).cpu().numpy())


def check(run: Run, case, got):
    """The program's state after its last block against the reference's
    block; with run.control, the TF32 reference's too (else None)."""
    def gaps(g, want):
        out = dict(volume_gap=lambda: loops.rel_gap(
                       g["recon"], want["recon"], want["keep"]),
                   sim_gap=lambda: loops.rel_gap(g["sim"], want["sim"]),
                   weight_gap=lambda: loops.abs_gap(g["weights"],
                                                    want["weights"]))
        return {k: f() for k, f in out.items() if k in run.compare}
    want = reference(run, case)
    loops.say(f"reference: {int((~want['keep']).sum())} voxels left out "
              "(rounding)")
    control = (gaps(reference(run, case, tf32=True), want)
               if run.control else None)
    return gaps(got, want), control


def splat_slots(case) -> dict:
    """What the splat needs for this case's geometry, from the benchmark's
    own positions: the pixels whose trilinear footprint touches the grid,
    the stacks and the grid."""
    grid, i2w = case["grid"], case["i2w"]
    n, h, w = case["slices"].shape
    fwd = grid.w2i()[None] @ i2w
    px, py = np.meshgrid(np.arange(w), np.arange(h))
    xp = (fwd[:, None, None, :3, 0] * px[None, :, :, None]
          + fwd[:, None, None, :3, 1] * py[None, :, :, None]
          + fwd[:, None, None, :3, 3])
    f = np.floor(xp)
    dims = np.array([grid.x, grid.y, grid.z])
    touch = ((f >= -1) & (f <= dims - 1)).all(axis=-1)
    touch &= case["slices"] != -1.0
    return dict(slots=int(touch.sum()), stacks=len(case["ranges"]),
                voxels=int(np.prod(grid.shape_zyx)))


FAULTS: dict = {}  # every fault of this loop is one of loops.FAULTS
