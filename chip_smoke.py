"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (first use), then drives the
port's main path on cuda:0: first one outer iteration of run_svr's body at
the canonical size (4 stacks x 42 slices of 144^2, 160^3 volume;
pipeline/synthetic.canonical_problem) through pipeline/svr_core —
build_geometry, gaussian_reconstruction, small-slice exclusion, simulate,
initialize_robust_statistics, estep, 4 x inner_iteration (lambda 0.08 ->
alpha 0.625, lam 1800), mask_volume — then the whole pipeline, run_svr,
end to end (phase 7).

Phases, each of which raises on failure (exit code != 0):
1. device: CUDA must be available; prints the card's name and power limit;
2. build: the kernels, with the build time, and whether the host C++
   library (SLIC and the NIfTI codec, g++) built or its numpy versions run;
3. kernels vs plain versions at the canonical shape: B1 (splat2_rows) and
   B2 (unblock2), max|diff| <= 1e-5 * max|ref|, and two B1+B2 runs
   bitwise equal;
4. the slice on the kernel path (launch counts read from that run alone),
   outputs finite, recon and EM state within 1e-4 relative of the same
   slice run on the card through the plain versions;
5. times: steady-state inner iterations per second and B1 / B2 against
   their plain versions, each with the card's name and power limit.  B1's
   plain time is given twice: splat2_blocked_plain, which derives rows and
   corner weights from the positions on every call, and an index_add_ on
   the plan's precomputed slots, the same inputs the kernel reads;
6. breakdown: each part of one inner iteration and of a geometry rebuild
   timed alone, and torch.profiler's device time, kernel count and top
   kernels per inner iteration (from which the device's idle share
   follows);
7. run_svr end to end on pipeline/synthetic.motion_problem(0) at full width
   (4 stacks x 33 slices of 144^2 with per-slice motion, a ~160^3 grid at
   1 mm; 3 outer iterations of 4 inner ones, default registration), with
   every B1 and B2 call also run through its plain version on the same
   tensors (max|diff| <= 1e-5 * max|ref|): the per-phase table,
   end-to-end seconds, slices registered per second per registration
   round, PSNR against the truth, peak device memory and the kernels'
   launch counts inside run_svr (each must be > 0); then one level-0
   slice-to-volume cost evaluation timed alone and split into generate /
   reg_blur / NCC, and torch.profiler's top kernels over one coordinate
   sweep.  Fails on a non-finite volume or a PSNR under 23.5 dB;
8. PVR end to end, run_pvr on the same problem at full width: square
   patches of 32 at stride 16 (about 2600 patches of 32^2), 3 outer
   iterations of 4 inner ones at 1 mm, then superpixels (spxSize 64) at
   SPX_ITERATIONS outer iterations; every B1 and B2 call held against its
   plain version as in phase 7.  Prints each run's per-phase table, patch
   count, patches registered per second per round, PSNR, peak device
   memory, launch counts and whether SLIC ran native or in Python.  Fails
   under 23.5 dB (square patches) or 17 dB (superpixels);
9. SVR with bias correction on the same problem (BIAS_ITERATIONS outer
   iterations), then with global bias correction, every kernel call
   checked as in phase 7, including the normalise-bias scatter, whose B1
   launches are counted apart and must be > 0.  Fails under 23.0 dB;
10. run_svr with the exact PSF engine (engine="exact") on the same problem
   with phase 7's config: the per-phase table, end-to-end seconds, slices
   registered per second and PSNR as in phase 7 (floor EXACT_MIN_PSNR);
   neither kernel may launch.  Then, at the geometry of the stacks'
   slices on its grid, the offset count, the time of one psf_scatter and
   one psf_gather, and the exact engine against the fast one: one
   simulate and one normalised scatter, each within
   tests/test_psf_fast.py's mean relative deviation of 0.03;
11. run_svr with the fast engine, --manualMask (the truth's mask on the
   first stack's grid) and --bspline on the same problem
   (FEATURES_ITERATIONS outer iterations), every kernel call checked as
   in phase 7: the Dice of the manual-mask volume against the truth mask
   and the B-spline volume's PSNR; then fetalrecon-recon-eval-torch on
   the card against phase 7's volume, which prints its metric row.

The line before the last is the per-kernel JSON record (launch counts
summed over the runs of phases 7-11, each counted from zero just before
its run; each kernel's bound from this run's inputs at the card's data
sheet rates); the last line is {"ok": true, "device": {...}}.  Needs no
network and imports no JAX.
"""
import json
import subprocess
import sys
import time
from unittest import mock

import numpy as np

KERNEL_TOL = 1e-5
SLICE_TOL = 1e-4
INNER = 4
TIMED_INNER = 10
KERNEL_REPS = 10
PROFILED_INNER = 3
TOP_KERNELS = 10
DELTA, LAMBDA0 = 150.0, 0.08  # default config, outer iteration 0
E2E_ITERATIONS = 3     # outer iterations of the end-to-end run
E2E_MIN_PSNR = 23.5    # dB; measured 23.842 on the H100 (the JAX
                       # package on the CPU: 23.886); all-zero: about 5
PVR_ITERATIONS = 3     # tools/bench_pvr.py's defaults: 32/16 patches,
PVR_MIN_PSNR = 23.5    # 1 mm, 3 outer iterations of 4 inner ones
SPX_SIZE = 64
SPX_ITERATIONS = 3
SPX_MIN_PSNR = 17.0
BIAS_ITERATIONS = 2
BIAS_MIN_PSNR = 23.0
EXACT_ITERATIONS = 3   # phase 7's config on the exact engine
EXACT_MIN_PSNR = 23.5  # dB; measured 23.871 on the H100
EXACT_REPS = 3         # timed calls of one exact scatter / gather
EXACT_FAST_TOL = 0.03  # tests/test_psf_fast.py's mean relative deviation
FEATURES_ITERATIONS = 2
FEATURES_MIN_PSNR = 23.0   # as phase 9 at 2 outer iterations
MANUAL_MIN_DICE = 0.9      # measured 0.9474 on the H100
BSPLINE_MIN_PSNR = 22.0    # dB; measured 23.063 on the H100
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet, at a 700 W limit
F32_OPS_PER_S = 67e12      # float32 outside the tensor cores


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed no card")
    return out.splitlines()[0]


def rel_err(out, ref):
    """max|out - ref| / max|ref|."""
    out, ref = out.double(), ref.double()
    return float((out - ref).abs().max() / ref.abs().max().clamp(min=1e-30))


def run_slice(prob):
    """One outer iteration of run_svr's body (pipeline/svr.py:788-821)."""
    import torch
    from fetalreconstruction_tpu_torch.pipeline import svr_core
    from fetalreconstruction_tpu_torch.sr.superresolution import (
        mask_volume, smoothing_parameters)

    ctx = prob.ctx
    alpha, lam = smoothing_parameters(DELTA, LAMBDA0)
    geom, sume = svr_core.build_geometry(
        ctx, prob.recon_w2i, prob.transforms, prob.slice_i2w, prob.valid,
        prob.mask_flat, stack_id=prob.stack_id)
    n = prob.slices.shape[0]
    mask = prob.mask_flat.reshape(ctx.vol_shape)
    em = svr_core.init_em_state(n, prob.valid)
    recon, vol_weights, voxel_count = svr_core.gaussian_reconstruction(
        ctx, geom, sume, prob.slices, prob.valid, em.bias, em.scale,
        prob.mask_flat)
    vc = voxel_count.cpu().numpy()
    median = np.sort(vc)[int(round(len(vc) * 0.5))]
    excluded = torch.as_tensor(vc < 0.1 * median, device=prob.slices.device)
    sim = svr_core.simulate(ctx, geom, sume, recon, prob.mask_flat)
    em = svr_core.initialize_robust_statistics(
        ctx, prob.slices, prob.valid, sim, em, prob.max_intensity,
        prob.min_intensity, excluded)
    em, _ = svr_core.estep(ctx, prob.slices, prob.valid, sume, sim, em,
                           excluded)
    args = (vol_weights, mask, prob.mask_flat, excluded, alpha, lam,
            prob.min_intensity, prob.max_intensity)
    for it in range(INNER):
        em, sim, recon = svr_core.inner_iteration(
            ctx, geom, sume, prob.slices, prob.valid, em, sim, recon, *args,
            it + 1)
    state = dict(geom=geom, sume=sume, em=em, sim=sim, recon=recon,
                 args=args, excluded=excluded)
    return mask_volume(recon, mask), em, sim, excluded, state


def plain_paths():
    """Patch fast_scatter2's two kernel calls with the plain versions."""
    from fetalreconstruction_tpu_torch.ops import scatter

    def b1(plan, a, b):
        return scatter.splat2_blocked_plain(plan.xp, a, b, plan.vol_shape,
                                            plan.sid, plan.n_stacks)

    return (mock.patch.object(scatter, "splat2_blocked", b1),
            mock.patch.object(scatter, "unblock2", scatter.unblock2_plain))


def plan_splat_plain(plan, vol_shape, n_stacks):
    """B1's sum as one index_add_ over the plan's slots: the same
    precomputed pixels, corner weights and rows that the kernel reads, so
    its time compares like with like (splat2_blocked_plain also derives the
    rows and weights from the positions)."""
    import torch
    from fetalreconstruction_tpu_torch.ops import scatter
    slot_row = torch.repeat_interleave(plan.rows, plan.row_ptr.diff())
    pix = plan.pix.long()
    n_rows = scatter.acc_rows(vol_shape, n_stacks)

    def run(pay_a, pay_b):
        upd = torch.stack([plan.wts * pay_a.reshape(-1)[pix, None],
                           plan.wts * pay_b.reshape(-1)[pix, None]],
                          dim=-1).reshape(-1, 16)
        acc = torch.zeros((n_rows, 16), dtype=torch.float32,
                          device=upd.device)
        return acc.index_add_(0, slot_row, upd)

    return run


def breakdown(prob, state, card):
    """Each part of one inner iteration, and of a geometry rebuild, timed
    alone on the slice's final state; then torch.profiler's device time
    and kernel count per inner iteration."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fetalreconstruction_tpu_torch.ops import psf_fast, scatter
    from fetalreconstruction_tpu_torch.pipeline import svr_core
    from fetalreconstruction_tpu_torch.sr import superresolution as sr

    ctx, st = prob.ctx, state
    vs, fast = ctx.vol_shape, ctx.fast
    geom, sume, em, sim, recon = (st["geom"], st["sume"], st["em"],
                                  st["sim"], st["recon"])
    slices, valid, mask_flat = prob.slices, prob.valid, prob.mask_flat
    alpha, lam = st["args"][4], st["args"][5]
    mn, mx = prob.min_intensity, prob.max_intensity
    dev = recon.device
    mask_vol = mask_flat.reshape(vs)
    # the SR step's payloads and intermediates, as superresolution_step
    # and fast_scatter2 make them
    gated = valid & (sume > 0)
    wfac = em.weights * em.slice_weight[:, None, None]
    resid = torch.where(sim.sim > 0,
                        slices * em.scale[:, None, None] - sim.sim, 0.0)
    pay_a = torch.where(gated, resid * wfac, 0.0)
    pay_b = torch.where(gated, wfac, 0.0)
    pos = sume > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, sume, 1.0), 0.0)
    a, b = (pay_a * inv).contiguous(), (pay_b * inv).contiguous()
    blocked = scatter.splat2_blocked(geom.plan, a, b)
    dense = scatter.unblock2(blocked, vs)
    addon, cmap = psf_fast.fast_scatter2(fast, geom, pay_a, pay_b, mask_vol,
                                         vs)
    fwd_b = fast.bands(vs, False, dev)
    adj_b = fast.bands(vs, True, dev)
    vm = recon * mask_vol
    convs = [psf_fast.conv_separable(vm, bb) for bb in fwd_b]
    tab = torch.cat([psf_fast.make_shingle([c]) for c in convs], dim=1)

    def inner():
        return svr_core.inner_iteration(ctx, geom, sume, slices, valid, em,
                                        sim, recon, *st["args"], 2)

    parts = [
        ("build_geometry (per rebuild)", lambda: svr_core.build_geometry(
            ctx, prob.recon_w2i, prob.transforms, prob.slice_i2w, valid,
            mask_flat, stack_id=prob.stack_id)),
        ("- plan build", lambda: scatter.build_scatter_plan(
            geom.xp, geom.sid, vs, fast.n_stacks)),
        ("scale_step", lambda: svr_core.scale_step(
            ctx, slices, valid, sume, sim, em)),
        ("superresolution_step", lambda: svr_core.superresolution_step(
            ctx, geom, sume, slices, valid, em, sim, recon, mask_flat, alpha,
            lam, mn, mx)),
        ("- fast_scatter2", lambda: psf_fast.fast_scatter2(
            fast, geom, pay_a, pay_b, mask_vol, vs)),
        ("-- B1 splat2_rows (incl. zero fill)",
         lambda: scatter.splat2_blocked(geom.plan, a, b)),
        ("-- B2 unblock2", lambda: scatter.unblock2(blocked, vs)),
        ("-- adjoint conv, all stacks, 2 payloads", lambda: [
            psf_fast.conv_separable(dense[s], bb)
            for s, bb in enumerate(adj_b)]),
        ("- apply_addon", lambda: sr.apply_addon(
            recon, addon, cmap, alpha, mn, mx, ctx.adaptive)),
        ("- adaptive_regularization", lambda: sr.adaptive_regularization(
            recon, recon, cmap, alpha, lam, ctx.delta)),
        ("simulate", lambda: svr_core.simulate(ctx, geom, sume, recon,
                                               mask_flat)),
        ("- forward conv, all stacks", lambda: [
            psf_fast.conv_separable(vm, bb) for bb in fwd_b]),
        ("- make_shingle, all stacks", lambda: torch.cat(
            [psf_fast.make_shingle([c]) for c in convs], dim=1)),
        ("- shingle_gather", lambda: psf_fast.shingle_gather(
            tab, geom.xp, vs, 1, sid=geom.sid)),
        ("mstep", lambda: svr_core.mstep(ctx, slices, valid, sume, sim, em,
                                         2)),
        ("estep", lambda: svr_core.estep(ctx, slices, valid, sume, sim, em,
                                         st["excluded"])),
        ("inner_iteration", inner),
    ]
    print(f"breakdown, each part timed alone, ms [{card}]:", flush=True)
    out = {}
    for label, fn in parts:
        out[label] = time_ms(fn)
        print(f"  {label:<42s} {out[label]:9.3f}", flush=True)
    del blocked, dense, addon, cmap, convs, tab
    torch.cuda.empty_cache()

    inner()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_INNER):
            inner()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    per_it = dev_ms / PROFILED_INNER
    idle = 1.0 - per_it / out["inner_iteration"]
    print(f"profiler: {per_it:.3f} ms device time and "
          f"{len(kernels) / PROFILED_INNER:.0f} kernels per inner iteration "
          f"(over {PROFILED_INNER}); against the {out['inner_iteration']:.3f}"
          f" ms iteration the device is idle {idle:.1%} [{card}]",
          flush=True)
    if per_it <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_name = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.self_device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    print("profiler, top kernels by device time per inner iteration:",
          flush=True)
    for kname, (n, t) in top:
        print(f"  {t / PROFILED_INNER:8.3f} ms {t / dev_ms:6.1%} "
              f"{n // PROFILED_INNER:5d} x {kname[:90]}", flush=True)


def checked_paths(errs):
    """Patch fast_scatter2's two kernel calls so that every call also runs
    the plain version on the same tensors; errs[name] keeps, on the card,
    the worst max|kernel - plain| / max|plain| over the calls (read once,
    after the run, so the checks add no synchronisation)."""
    import torch
    from fetalreconstruction_tpu_torch.ops import scatter
    b1, b2 = scatter.splat2_blocked, scatter.unblock2

    def check(name, out, ref):
        err = ((out - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).double()
        errs[name] = torch.maximum(errs[name], err) if name in errs else err

    def splat(plan, a, b):
        out = b1(plan, a, b)
        check("splat2_rows", out, scatter.splat2_blocked_plain(
            plan.xp, a, b, plan.vol_shape, plan.sid, plan.n_stacks))
        return out

    def unblock(acc, vol_shape):
        out = b2(acc, vol_shape)
        check("unblock2", out, scatter.unblock2_plain(acc, vol_shape))
        return out

    return (mock.patch.object(scatter, "splat2_blocked", splat),
            mock.patch.object(scatter, "unblock2", unblock))


def checked_run(label, run, truth, min_psnr, dev, card, unit="slices",
                kernels=True):
    """Drive one pipeline run with every B1 and B2 call held against its
    plain version on the same tensors (phase 7's checks), launch counts
    set to 0 just before and read just after.  Prints the per-phase table,
    the worst kernel error, the units registered per second per round,
    the end-to-end time, PSNR against the truth and peak device memory;
    raises on a disagreeing or unlaunched kernel (with kernels=False, the
    exact engine's path: on any launch), a non-finite or misshapen volume,
    or a PSNR under min_psnr.  Returns (result, launches)."""
    import torch
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    errs = {}
    p1, p2 = checked_paths(errs)
    scatter.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with p1, p2:
        res = run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = dict(scatter.LAUNCHES)
    out = res.reconstructed
    print(f"{label} per-phase table, s (with the plain checks) "
          f"[{card}]:\n{res.stats.table()}", flush=True)
    errs = {k: float(v) for k, v in errs.items()}
    print(f"kernels vs plain versions on every call inside {label} "
          f"(worst max|diff| / max|ref|, limit {KERNEL_TOL:.0e}): {errs}",
          flush=True)
    for k in launches:
        if kernels and not errs.get(k, float("nan")) <= KERNEL_TOL:
            raise RuntimeError(f"kernel {k} disagrees with its plain "
                               f"version inside {label}")
    n = len(res.slice_weights)
    for i, s in enumerate(res.stats.samples("registration")):
        print(f"{label} registration round {i + 1}: {n} {unit} in "
              f"{s:.3f} s = {n / s:.2f} {unit} registered/s [{card}]",
              flush=True)
    if not np.isfinite(out.data).all():
        raise RuntimeError(f"{label} returned a non-finite volume")
    if out.data.shape != out.attr.shape_zyx:
        raise RuntimeError(f"volume shape {out.data.shape} != grid "
                           f"{out.attr.shape_zyx}")
    psnr = psnr_vs_truth(out, truth, device=dev)
    print(f"{label}: {total:.3f} s end to end, {n} {unit}, volume "
          f"{out.data.shape}; PSNR vs truth {psnr:.3f} dB (floor "
          f"{min_psnr}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; "
          f"launches {launches} [{card}]", flush=True)
    for k, v in launches.items():
        if kernels and v <= 0:
            raise RuntimeError(f"kernel {k} was not launched by {label}")
        if not kernels and v != 0:
            raise RuntimeError(f"{label} launched kernel {k}")
    if not psnr >= min_psnr:
        raise RuntimeError(f"{label}: PSNR {psnr:.3f} dB is below "
                           f"{min_psnr}")
    return res, launches


def motion(label):
    t0 = time.perf_counter()
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        motion_problem)
    truth, mask, stacks = motion_problem(0)
    print(f"{label}: motion problem built in "
          f"{time.perf_counter() - t0:.2f} s: {len(stacks)} stacks of "
          f"{stacks[0].data.shape}, truth {truth.data.shape}", flush=True)
    return truth, mask, stacks


def end_to_end(dev, card):
    """Phase 7: run_svr on motion_problem(0) at full width, each kernel
    call held against its plain version on the inputs run_svr gives it;
    returns the kernels' launch counts inside run_svr and the
    reconstruction (phase 11 evaluates it)."""
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    truth, mask, stacks = motion("end to end")
    cfg = SVRConfig(iterations=E2E_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    no_log=True)
    res, launches = checked_run(
        "run_svr", lambda: run_svr(cfg, stacks=stacks, mask=mask,
                                   device=dev),
        truth, E2E_MIN_PSNR, dev, card)
    registration_breakdown(stacks, res.reconstructed, dev, card)
    return launches, res.reconstructed


def pvr_end_to_end(dev, card):
    """Phase 8: run_pvr on motion_problem(0) at full width, square patches
    (tools/bench_pvr.py's defaults) and then superpixels; returns the
    kernels' launch counts over both runs."""
    from fetalreconstruction_tpu_torch.pipeline.pvr import (
        PVRConfig, run_pvr, slic_backend)

    truth, mask, stacks = motion("PVR")
    total = {}
    runs = (("run_pvr, square patches 32/16",
             dict(iterations=PVR_ITERATIONS, patch_size=32, patch_stride=16),
             PVR_MIN_PSNR),
            (f"run_pvr, superpixels {SPX_SIZE}",
             dict(iterations=SPX_ITERATIONS, superpixel=True,
                  spx_size=SPX_SIZE),
             SPX_MIN_PSNR))
    for label, kw, floor in runs:
        cfg = PVRConfig(resolution=1.0, rec_iterations_first=4,
                        rec_iterations_last=4, no_log=True, **kw)
        _, launches = checked_run(
            label, lambda: run_pvr(cfg, stacks=stacks, mask=mask,
                                   device=dev),
            truth, floor, dev, card, unit="patches")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    print(f"PVR: SLIC ran {slic_backend()}", flush=True)
    return total


def bias_end_to_end(dev, card):
    """Phase 9: run_svr with bias correction, then with global bias
    correction; the B1 launches inside normalise_bias_step are counted
    apart.  Returns the kernels' launch counts over both runs."""
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.pipeline import svr_core
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    truth, mask, stacks = motion("bias")
    normalise = svr_core.normalise_bias_step
    nb = {"splat2_rows": 0}

    def counted(*a, **kw):
        before = scatter.LAUNCHES["splat2_rows"]
        out = normalise(*a, **kw)
        nb["splat2_rows"] += scatter.LAUNCHES["splat2_rows"] - before
        return out

    total = {}
    for label, kw in (("run_svr, bias correction", {}),
                      ("run_svr, global bias correction",
                       dict(global_bias_correction=True))):
        cfg = SVRConfig(iterations=BIAS_ITERATIONS, resolution=1.0,
                        rec_iterations_first=4, rec_iterations_last=4,
                        disable_bias_correction=False, no_log=True, **kw)
        nb["splat2_rows"] = 0
        with mock.patch.object(svr_core, "normalise_bias_step", counted):
            _, launches = checked_run(
                label, lambda: run_svr(cfg, stacks=stacks, mask=mask,
                                       device=dev),
                truth, BIAS_MIN_PSNR, dev, card)
        print(f"{label}: B1 launches inside normalise_bias_step "
              f"{nb['splat2_rows']}", flush=True)
        if not kw and nb["splat2_rows"] <= 0:
            raise RuntimeError("the normalise-bias scatter launched no B1")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def exact_end_to_end(dev, card):
    """Phase 10: run_svr with the exact PSF engine on motion_problem(0) at
    full width with phase 7's config (neither kernel runs on this path);
    then, at the geometry of the stacks' slices on its grid, the time of
    one psf_scatter and one psf_gather and the exact engine against the
    fast one (test_psf_fast.py's limits)."""
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    truth, mask, stacks = motion("exact engine")
    cfg = SVRConfig(iterations=EXACT_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    engine="exact", no_log=True)
    res, launches = checked_run(
        "run_svr, exact engine", lambda: run_svr(cfg, stacks=stacks,
                                                 mask=mask, device=dev),
        truth, EXACT_MIN_PSNR, dev, card, kernels=False)
    exact_vs_fast(stacks, truth, res.reconstructed.attr, dev, card)
    return launches


def exact_vs_fast(stacks, truth, a, dev, card):
    """Both engines at one geometry: the pixels of the stacks' slices, at
    identity transforms on the grid `a`, whose PSF support lies inside the
    grid, and an all-ones mask (test_psf_fast.py's setup, where the slices
    lie inside the volume: the engines lose weight at the grid's faces in
    different ways).  Times one exact psf_scatter (2 payloads) and
    psf_gather, then
    compares one simulate of the truth on that grid and one normalised
    scatter (addon / cmap on voxels with both cmaps > 0.2) of a random
    payload; fails on a mean relative deviation of 0.03 or more.  (The
    weight mass ratio of test_psf_fast.py is 1 by construction here, where
    every pixel's support lies inside the grid, so it is not checked.)"""
    import torch
    from fetalreconstruction_tpu_torch.ops import psf, psf_fast
    from fetalreconstruction_tpu_torch.ops.sampling import resample_to_grid
    from fetalreconstruction_tpu_torch.pipeline.svr import create_slices
    from fetalreconstruction_tpu_torch.pipeline.svr_core import (
        slice_forward_matrices)

    vs = a.shape_zyx
    batch = create_slices(stacks, [2.0 * s.attr.dz for s in stacks])
    support = psf.reference_support(batch.dims, a.dx, 1.0, 12)
    offsets = psf.make_offsets(support)
    fwd = slice_forward_matrices(
        torch.as_tensor(a.w2i(), device=dev),
        torch.eye(4, device=dev).expand(batch.n_slices, 4, 4),
        torch.as_tensor(batch.i2w, device=dev))
    dims = torch.as_tensor(batch.dims, device=dev)
    centre = psf.make_slice_geom(fwd, dims, torch.ones(
        batch.data.shape, dtype=torch.bool, device=dev)).centre
    margin = support // 2 + 1
    hi = torch.tensor(vs[::-1], device=dev) - margin  # (x, y, z)
    valid = (torch.as_tensor(batch.data != -1.0, device=dev)
             & ((centre >= margin) & (centre < hi)).all(dim=-1))
    ones = torch.ones(vs, dtype=torch.float32, device=dev)
    vol = resample_to_grid(torch.as_tensor(truth.data, device=dev),
                           truth.attr.w2i().astype(np.float32), vs,
                           a.i2w().astype(np.float32))
    geom = psf.make_slice_geom(fwd, dims, valid)
    sume = psf.psf_sums(geom, offsets, vs)
    fast = psf_fast.FastPSF.from_batch(batch, a.w2i(), support)
    fgeom = psf_fast.make_fast_geom(fast, fwd, valid, vs)
    g = torch.Generator(device=dev).manual_seed(0)
    pay = torch.where(valid, 10 + 90 * torch.rand(valid.shape, generator=g,
                                                  device=dev), 0.0)
    gate_e, gate_f = valid & (sume > 0), valid & (fgeom.sume > 0)
    pl_e = [torch.where(gate_e, pay, 0.0), torch.where(gate_e, 1.0, 0.0)]
    n_pix = valid.numel()
    print(f"exact engine: {len(offsets)} offsets (support {support}) x "
          f"{n_pix} pixels ({batch.n_slices} slices of "
          f"{tuple(batch.data.shape[1:])}; {int(valid.sum())} with their "
          f"support inside the grid) against {vs}", flush=True)
    scat_ms = time_ms(lambda: psf.psf_scatter(geom, offsets, sume, pl_e,
                                              ones.reshape(-1), vs),
                      reps=EXACT_REPS)
    gath_ms = time_ms(lambda: psf.psf_gather(geom, offsets, sume,
                                             vol.reshape(-1),
                                             ones.reshape(-1), vs),
                      reps=EXACT_REPS)
    print(f"exact engine, one call each: psf_scatter (2 payloads) "
          f"{scat_ms:.3f} ms, psf_gather {gath_ms:.3f} ms [{card}]",
          flush=True)

    sim_e, _, in_e = psf.psf_gather(geom, offsets, sume, vol.reshape(-1),
                                    ones.reshape(-1), vs)
    sim_f, _, in_f = psf_fast.fast_simulate(fast, fgeom, vol, ones, vs)
    both = in_e & in_f
    sim_dev = float((sim_f[both] - sim_e[both]).abs().mean()
                    / sim_e[both].abs().mean())
    a_e, b_e = (t.reshape(vs) for t in psf.psf_scatter(
        geom, offsets, sume, pl_e, ones.reshape(-1), vs))
    a_f, b_f = psf_fast.fast_scatter2(
        fast, fgeom, torch.where(gate_f, pay, 0.0),
        torch.where(gate_f, 1.0, 0.0), ones, vs)
    core = (b_e > 0.2) & (b_f > 0.2)
    r_e, r_f = a_e[core] / b_e[core], a_f[core] / b_f[core]
    scat_dev = float((r_f - r_e).abs().mean() / r_e.abs().mean())
    print(f"exact vs fast engine: simulate mean relative deviation "
          f"{sim_dev:.4f} on {float(both.float().mean()):.1%} of the pixels; "
          f"normalised scatter {scat_dev:.4f} on {int(core.sum())} voxels "
          f"(limit {EXACT_FAST_TOL})", flush=True)
    if not (sim_dev < EXACT_FAST_TOL and scat_dev < EXACT_FAST_TOL):
        raise RuntimeError("the exact and fast engines disagree")


def features_end_to_end(dev, card, e2e_volume):
    """Phase 11: run_svr with the fast engine, --manualMask and --bspline
    on motion_problem(0); the manual mask is the truth's mask (truth > 1)
    on the first stack's grid.  Prints the Dice of the manual-mask volume
    against the truth mask and the B-spline volume's PSNR, then runs
    fetalrecon-recon-eval-torch and fetalrecon-evaluate-torch on the card
    against phase 7's volume.
    Returns the kernels' launch counts inside run_svr."""
    import tempfile
    import torch
    from fetalreconstruction_tpu_torch.cli import (evaluate_main,
                                                   recon_eval_main)
    from fetalreconstruction_tpu_torch.core.image import Image
    from fetalreconstruction_tpu_torch.io.nifti import write_nifti
    from fetalreconstruction_tpu_torch.ops.sampling import resample_to_grid
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    truth, mask, stacks = motion("manual mask + B-spline")
    truth_mask = Image((truth.data > 1.0).astype(np.float32),
                       truth.attr.copy())

    def on_grid(img, attr):
        return resample_to_grid(
            torch.as_tensor(img.data, device=dev),
            img.attr.w2i().astype(np.float32), attr.shape_zyx,
            attr.i2w().astype(np.float32), interp="nn",
            padding=0.0).cpu().numpy()

    with tempfile.TemporaryDirectory() as tmp:
        s0 = stacks[0].attr
        manual = f"{tmp}/manual.nii.gz"
        write_nifti(Image(on_grid(truth_mask, s0), s0.copy()), manual)
        cfg = SVRConfig(iterations=FEATURES_ITERATIONS, resolution=1.0,
                        rec_iterations_first=4, rec_iterations_last=4,
                        manual_mask=manual, bspline=True, no_log=True)
        res, launches = checked_run(
            "run_svr, --manualMask --bspline",
            lambda: run_svr(cfg, stacks=stacks, mask=mask, device=dev),
            truth, FEATURES_MIN_PSNR, dev, card)
        mvol = res.manual_mask_volume
        ref = on_grid(truth_mask, mvol.attr) > 0.5
        got = mvol.data > 0.5
        dice = 2.0 * np.sum(got & ref) / max(got.sum() + ref.sum(), 1)
        bvol = res.bspline_reconstructed
        if not np.isfinite(bvol.data).all():
            raise RuntimeError("the B-spline volume is not finite")
        b_psnr = psnr_vs_truth(bvol, truth, device=dev)
        print(f"--manualMask: Dice {dice:.4f} against the truth mask "
              f"({int(got.sum())} / {int(ref.sum())} voxels; floor "
              f"{MANUAL_MIN_DICE}); --bspline: PSNR vs truth {b_psnr:.3f} dB "
              f"(floor {BSPLINE_MIN_PSNR}) [{card}]", flush=True)
        if not (dice >= MANUAL_MIN_DICE and b_psnr >= BSPLINE_MIN_PSNR):
            raise RuntimeError("the manual-mask or B-spline volume is off")

        target, source = f"{tmp}/truth.nii.gz", f"{tmp}/recon.nii.gz"
        write_nifti(truth, target)
        write_nifti(e2e_volume, source)
        t0 = time.perf_counter()
        rc = recon_eval_main.main([target, source, f"{tmp}/out.nii.gz",
                                   f"{tmp}/diff.nii.gz", f"{tmp}/m.nii.gz",
                                   f"{tmp}/ref.dof"])
        torch.cuda.synchronize()
        print(f"fetalrecon-recon-eval-torch on phase 7's volume: exit {rc} "
              f"in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        if rc != 0:
            raise RuntimeError("fetalrecon-recon-eval-torch failed")
        t0 = time.perf_counter()
        rc = evaluate_main.main([target, source])
        torch.cuda.synchronize()
        print(f"fetalrecon-evaluate-torch on phase 7's volume: exit {rc} "
              f"in {time.perf_counter() - t0:.3f} s [{card}]", flush=True)
        if rc != 0:
            raise RuntimeError("fetalrecon-evaluate-torch failed")
    return launches


def registration_breakdown(stacks, recon_img, dev, card):
    """One level-0 slice-to-volume cost evaluation timed alone and split
    into its parts, then torch.profiler over one coordinate sweep.  Run on
    all slices of the uncropped stacks against the reconstruction, from
    identity transforms."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from fetalreconstruction_tpu_torch.core.geometry import \
        matrix_to_params_torch
    from fetalreconstruction_tpu_torch.pipeline.svr import create_slices
    from fetalreconstruction_tpu_torch.register import slice2vol as s2v
    from fetalreconstruction_tpu_torch.register.optimizer import coord_sweep
    from fetalreconstruction_tpu_torch.register.prepare import (
        prepare_registration_slices)

    cfg = s2v.SliceRegConfig()
    a = recon_img.attr
    batch = create_slices(stacks, [2.0 * s.attr.dz for s in stacks])
    tg, mo, ofs = [torch.as_tensor(x, device=dev) for x in
                   prepare_registration_slices(batch, a.dx, device=dev)]
    recon = torch.as_tensor(recon_img.data, device=dev)
    w2i = torch.as_tensor(a.w2i(), dtype=torch.float32, device=dev)
    sigma = cfg.blur_sigmas(a.dx)[0] / a.dx
    tgt, ofs_l, mean = s2v.level_arrays(1, sigma, tg, ofs)
    n = tgt.shape[0]
    params = matrix_to_params_torch(mo)  # identity transforms: T' = Mo
    vs = tuple(recon.shape)
    table = s2v.make_reg_table(recon, cfg.table_dtype)
    cost = s2v.make_cost_fn(cfg, None, w2i, ofs_l, tgt, mean,
                            tgt.shape[1:], 0, sigma, psf_table=table,
                            vol_shape=vs)
    sub = torch.ones(tgt.shape[1:], dtype=torch.bool, device=dev)
    gens = [s2v.generate_slices_psf(table, vs, None, w2i, params, ofs_l,
                                    tgt.shape[1:], o)
            for o in cfg.through_plane_offsets]
    blurred = [s2v.reg_blur(g, sigma) for g in gens]
    parts = [
        ("registration table (make_shingle + bf16)",
         lambda: s2v.make_reg_table(recon, cfg.table_dtype)),
        ("cost eval, level 0", lambda: cost(params)),
        ("- generate x3 (shingle gather)", lambda: [
            s2v.generate_slices_psf(table, vs, None, w2i, params, ofs_l,
                                    tgt.shape[1:], o)
            for o in cfg.through_plane_offsets]),
        ("- reg_blur x3", lambda: [s2v.reg_blur(g, sigma) for g in gens]),
        ("- NCC x3", lambda: [s2v._ncc(tgt, mean, b, sub)
                              for b in blurred]),
    ]
    print(f"slice-to-volume level 0, {n} slices of {tuple(tgt.shape[1:])} "
          f"against {vs}, each part timed alone, ms [{card}]:", flush=True)
    for label, fn in parts:
        print(f"  {label:<42s} {time_ms(fn):9.3f}", flush=True)

    step = torch.tensor(cfg.step0, dtype=torch.float32, device=dev)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    best = cost(params)
    coord_sweep(cost, params, active, best, step, cfg.epsilon)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        coord_sweep(cost, params, active, best, step, cfg.epsilon)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"profiler, one level-0 sweep (12 cost evals): {dev_ms:.3f} ms "
          f"device time, {len(kernels)} kernels, {wall:.3f} ms wall under "
          f"the profiler [{card}]", flush=True)
    if dev_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    by_name = {}
    for e in kernels:
        k, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (k + 1, t + e.self_device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:TOP_KERNELS]
    print("profiler, top kernels of the sweep by device time:", flush=True)
    for kname, (k, t) in top:
        print(f"  {t:8.3f} ms {t / dev_ms:6.1%} {k:5d} x {kname[:90]}",
              flush=True)


def kernel_bounds(plan, pay, acc, dense):
    """Each kernel's least time on this card for this call: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its float32 operations over the non-tensor-core peak.
    B1 reads the plan (pix, wts, rows, row_ptr) and the two payloads at its
    pixels, and writes the whole accumulator (zero fill included); one
    multiply and one add per corner and payload.  B2 reads the
    accumulator and writes the dense volumes; 7 adds per output value."""
    n_slots = plan.pix.numel()
    b1_bytes = (plan.pix.numel() * plan.pix.element_size()
                + plan.wts.numel() * plan.wts.element_size()
                + plan.rows.numel() * plan.rows.element_size()
                + plan.row_ptr.numel() * plan.row_ptr.element_size()
                + 2 * n_slots * pay.element_size()
                + acc.numel() * acc.element_size())
    b1_ops = n_slots * 8 * 2 * 2
    b2_bytes = (acc.numel() * acc.element_size()
                + dense.numel() * dense.element_size())
    b2_ops = dense.numel() * 7

    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
        return dict(bound_ms=max(t_b, t_o) * 1e3,
                    bound_by="bytes" if t_b >= t_o else "operations")

    return bound(b1_bytes, b1_ops), bound(b2_bytes, b2_ops)


def time_ms(fn, reps=KERNEL_REPS):
    import torch
    fn()
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main():
    import torch
    from fetalreconstruction_tpu_torch import _kernels, native
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.pipeline import svr_core
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        canonical_problem)

    # ---- 1. device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: this smoke run needs a "
                           "GPU")
    torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls
    torch.backends.cudnn.allow_tf32 = False        # (no pass uses cuDNN)
    card = card_line()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(0)
    print(f"device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; tf32 matmul/cudnn "
          f"{torch.backends.cuda.matmul.allow_tf32}/"
          f"{torch.backends.cudnn.allow_tf32}", flush=True)

    # ---- 2. build
    t0 = time.perf_counter()
    _kernels.library()
    built = ("reused build" if _kernels.build_seconds is None
             else f"nvcc {_kernels.build_seconds:.2f} s")
    print(f"build: {built}, {time.perf_counter() - t0:.2f} s to load "
          f"({_kernels.build_key()})", flush=True)
    t0 = time.perf_counter()
    host = "C++ (g++)" if native.get_lib() is not None else "numpy"
    print(f"host library (SLIC, NIfTI codec): {host}, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    prob = canonical_problem(dev)
    ctx = prob.ctx
    vs = ctx.vol_shape
    S = ctx.fast.n_stacks
    print(f"problem: {prob.slices.shape[0]} slices of "
          f"{tuple(prob.slices.shape[1:])}, volume {vs}, {S} stacks, "
          f"PSF support {ctx.fast.support}, triads per stack "
          f"{[len(t) for t in ctx.fast.terms]}", flush=True)

    # ---- 3. kernels vs plain versions at the canonical shape
    geom, sume = svr_core.build_geometry(
        ctx, prob.recon_w2i, prob.transforms, prob.slice_i2w, prob.valid,
        prob.mask_flat, stack_id=prob.stack_id)
    plan = geom.plan
    pos = sume > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, sume, 1.0), 0.0)
    pa = (prob.slices * inv).contiguous()
    pb = (pos * inv).contiguous()
    print(f"plan: {plan.pix.numel()} in-support pixels of "
          f"{prob.slices.numel()}, {plan.rows.numel()} touched rows of "
          f"{scatter.acc_rows(vs, S)}", flush=True)
    acc_k = scatter.splat2_blocked(plan, pa, pb)
    acc_p = scatter.splat2_blocked_plain(plan.xp, pa, pb, vs, plan.sid, S)
    torch.cuda.synchronize()
    b1_err = float((acc_k - acc_p).abs().max())
    b1_lim = KERNEL_TOL * float(acc_p.abs().max())
    print(f"B1 splat2_rows vs plain: max|diff| {b1_err:.3e} "
          f"(limit {b1_lim:.3e})", flush=True)
    if not b1_err <= b1_lim:
        raise RuntimeError("B1 disagrees with its plain version")
    dense_k = scatter.unblock2(acc_p, vs)
    dense_p = scatter.unblock2_plain(acc_p, vs)
    torch.cuda.synchronize()
    b2_err = float((dense_k - dense_p).abs().max())
    b2_lim = KERNEL_TOL * float(dense_p.abs().max())
    print(f"B2 unblock2 vs plain: max|diff| {b2_err:.3e} "
          f"(limit {b2_lim:.3e})", flush=True)
    if not b2_err <= b2_lim:
        raise RuntimeError("B2 disagrees with its plain version")
    again = scatter.unblock2(scatter.splat2_blocked(plan, pa, pb), vs)
    first = scatter.unblock2(acc_k, vs)
    torch.cuda.synchronize()
    if not torch.equal(again, first):
        raise RuntimeError("two B1+B2 runs differ")
    print("determinism: two B1+B2 runs bitwise equal", flush=True)
    b1_ms = time_ms(lambda: scatter.splat2_blocked(plan, pa, pb))
    b1_plain_ms = time_ms(lambda: scatter.splat2_blocked_plain(
        plan.xp, pa, pb, vs, plan.sid, S))
    plan_plain = plan_splat_plain(plan, vs, S)
    pp_err = float((plan_plain(pa, pb) - acc_p.reshape(-1, 16)).abs().max())
    if not pp_err <= b1_lim:
        raise RuntimeError("the plan's index_add_ disagrees with B1's plain "
                           "version")
    b1_plan_plain_ms = time_ms(lambda: plan_plain(pa, pb))
    b2_ms = time_ms(lambda: scatter.unblock2(acc_p, vs))
    b2_plain_ms = time_ms(lambda: scatter.unblock2_plain(acc_p, vs))
    print(f"B1 {b1_ms:.3f} ms (incl. zero fill) vs plain {b1_plain_ms:.3f} "
          f"ms (index_add_ on the plan's slots {b1_plan_plain_ms:.3f} ms, "
          f"max|diff| {pp_err:.3e}); B2 {b2_ms:.3f} ms vs plain "
          f"{b2_plain_ms:.3f} ms [{card}]", flush=True)
    b1_bound, b2_bound = kernel_bounds(plan, pa, acc_p, dense_p)
    for kname, bd, ms in (("B1", b1_bound, b1_ms), ("B2", b2_bound, b2_ms)):
        print(f"{kname} bound {bd['bound_ms']:.3f} ms by {bd['bound_by']} "
              f"({bd['bound_ms'] / ms:.1%} of it reached; HBM "
              f"{HBM_BYTES_PER_S / 1e12} TB/s, f32 {F32_OPS_PER_S / 1e12} "
              f"TFLOP/s) [{card}]", flush=True)
    del acc_k, acc_p, dense_k, dense_p, again, first, geom, sume, plan
    del plan_plain
    torch.cuda.empty_cache()

    # ---- 4. the slice on the kernel path
    scatter.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    recon, em, sim, excluded, state = run_slice(prob)
    torch.cuda.synchronize()
    slice_s = time.perf_counter() - t0
    launches = dict(scatter.LAUNCHES)
    print(f"slice (kernel path): {slice_s:.2f} s; launches {launches}; "
          f"excluded slices {int(excluded.sum())}", flush=True)
    for k, v in launches.items():
        if v <= 0:
            raise RuntimeError(f"kernel {k} was not launched by the slice")
    outs = dict(recon=recon, sim=sim.sim, weights=em.weights,
                slice_weight=em.slice_weight, sigma2=em.sigma2, mix=em.mix,
                m=em.m, mix_s=em.mix_s)
    for k, v in outs.items():
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"{k} is not finite")
    if tuple(recon.shape) != vs:
        raise RuntimeError(f"recon shape {tuple(recon.shape)} != {vs}")
    print(f"recon: min {float(recon.min()):.4f} max "
          f"{float(recon.max()):.4f} mean {float(recon.mean()):.4f}; "
          f"sigma2 {float(em.sigma2):.6g} mix {float(em.mix):.6g} "
          f"m {float(em.m):.6g} mix_s {float(em.mix_s):.6g}", flush=True)
    p1, p2 = plain_paths()
    with p1, p2:
        ref = run_slice(prob)
    torch.cuda.synchronize()
    if scatter.LAUNCHES != launches:
        raise RuntimeError("the plain-path slice launched a kernel")
    ref_outs = dict(recon=ref[0], sim=ref[2].sim, weights=ref[1].weights,
                    slice_weight=ref[1].slice_weight, sigma2=ref[1].sigma2,
                    mix=ref[1].mix, m=ref[1].m, mix_s=ref[1].mix_s)
    errs = {k: rel_err(outs[k], ref_outs[k]) for k in outs}
    print("slice vs plain path on the card (max rel): "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()), flush=True)
    bad = {k: v for k, v in errs.items() if not v <= SLICE_TOL}
    if bad:
        raise RuntimeError(f"kernel path disagrees with plain path: {bad}")
    del ref, ref_outs
    torch.cuda.empty_cache()

    # ---- 5. steady-state inner iterations
    st = state
    em, sim, rec = st["em"], st["sim"], st["recon"]
    times = []
    for it in range(TIMED_INNER):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        em, sim, rec = svr_core.inner_iteration(
            ctx, st["geom"], st["sume"], prob.slices, prob.valid, em, sim,
            rec, *st["args"], 2)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = float(np.median(times))
    print(f"inner iteration: median {med * 1e3:.2f} ms over {TIMED_INNER} "
          f"(min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) -> "
          f"{1.0 / med:.4f} iterations/s [{card}]", flush=True)
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB",
          flush=True)

    # ---- 6. where the time goes
    breakdown(prob, state, card)
    del prob, state, em, sim, rec, recon, excluded
    torch.cuda.empty_cache()

    # ---- 7. run_svr end to end; 8. PVR; 9. SVR with bias correction;
    # 10. the exact engine; 11. --manualMask, --bspline and recon-eval
    launches, e2e_volume = end_to_end(dev, card)
    for phase in (pvr_end_to_end, bias_end_to_end, exact_end_to_end,
                  lambda d, c: features_end_to_end(d, c, e2e_volume)):
        for k, v in phase(dev, card).items():
            launches[k] += v
    print(f"launches over phases 7-11: {launches}", flush=True)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    src = "fetalreconstruction_tpu_torch/csrc/scatter.cu"
    rec_b1 = dict(name="splat2_rows", route="cuda", source=src,
                  replaces="fetalreconstruction_tpu/ops/pallas_scatter.py:256",
                  launches=launches["splat2_rows"], max_abs_err=b1_err,
                  ms=b1_ms, plain_ms=b1_plain_ms, **b1_bound,
                  library_ms=b1_plan_plain_ms)
    rec_b2 = dict(name="unblock2", route="cuda", source=src,
                  replaces="fetalreconstruction_tpu/ops/pallas_scatter.py:368",
                  launches=launches["unblock2"], max_abs_err=b2_err,
                  ms=b2_ms, plain_ms=b2_plain_ms, **b2_bound,
                  library_ms=None)
    print(json.dumps({"kernels": [rec_b1, rec_b2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
