"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ (first use), then drives the
port's main path on cuda:0: first one outer iteration of run_svr's body at
the canonical size (4 stacks x 42 slices of 144^2, 160^3 volume;
pipeline/synthetic.canonical_problem) through pipeline/svr_core —
build_geometry, gaussian_reconstruction, small-slice exclusion, simulate,
initialize_robust_statistics, estep, 4 x inner_iteration (lambda 0.08 ->
alpha 0.625, lam 1800), mask_volume — then the whole pipeline, run_svr,
end to end (phase 7), and last the port's bench (phase 15).

Phases, each of which raises on failure (exit code != 0):
1. device: CUDA must be available; prints the card's name and power limit;
2. build: the kernels, with the build time, and whether the host C++
   library (SLIC and the NIfTI codec, g++) built or its numpy versions run;
3. the kernel against its plain version at the canonical shape:
   splat2_dense, max|diff| <= 1e-5 * max|ref|, and two runs bitwise
   equal; 3b, the fused registration cost (reg_ncc_cost) against its
   torch path at the recon cells' shapes (REG_COST_SHAPES): max|diff| <=
   REG_COST_TOL, two calls bitwise equal, 2 kernels a call, each timed
   alone beside its bound;
4. the slice on the kernel path (launch counts read from that run alone),
   outputs finite, recon and EM state within 1e-4 relative of the same
   slice run on the card through the plain versions;
5. times: steady-state inner iterations per second and splat2_dense
   against its plain version, each with the card's name and power limit.
   The plain time is given twice: splat2_dense_plain, which derives floors
   and corner weights from the positions on every call, and one
   index_add_ of the plan's precomputed slots into the dense volumes, the
   same inputs the kernel reads (the library yardstick);
6. breakdown: each part of one inner iteration and of a geometry rebuild
   timed alone, and torch.profiler's device time, kernel count and top
   kernels per inner iteration (from which the device's idle share
   follows);
7. run_svr end to end on pipeline/synthetic.motion_problem(0) at full width
   (4 stacks x 33 slices of 144^2 with per-slice motion, a ~160^3 grid at
   1 mm; 3 outer iterations of 4 inner ones, default registration), with
   every splat2_dense call also run through its plain version on the
   same tensors (max|diff| <= 1e-5 * max|ref|): the per-phase table,
   end-to-end seconds, slices registered per second per registration
   round, PSNR against the truth, peak device memory and the kernels'
   launch counts inside run_svr (splat2_dense > 0; reg_ncc_cost once a
   slice-to-volume cost evaluation, every one of which must be fused:
   check_reg_route, which every checked run of phases 7-14 passes, on
   every rank); then the same run without the plain checks, for its
   peak device memory; then one level-0 slice-to-volume cost evaluation
   timed alone, as the fused kernel pair (held within REG_COST_TOL of
   the torch path) and as the torch path split into generate / reg_blur
   / NCC, and torch.profiler's top kernels over one coordinate sweep of
   the fused cost.  Fails on a non-finite volume or a PSNR under 23.5
   dB;
8. PVR end to end, run_pvr on the same problem at full width: square
   patches of 32 at stride 16 (about 2600 patches of 32^2), 3 outer
   iterations of 4 inner ones at 1 mm, then superpixels (spxSize 64) at
   SPX_ITERATIONS outer iterations, then the hierarchical mode at two
   levels (patches 32/16, then 28/14 seeded with the first level's
   volume) at OPTIONS_ITERATIONS outer iteration a level; every
   splat2_dense call held against its plain version as in phase 7.  Prints
   each run's per-phase table, patch count, patches registered per second
   per round, PSNR, peak device memory, launch counts and whether SLIC ran
   native or in Python.  Fails under 23.5 dB (square patches), 17 dB
   (superpixels) or its OPTIONS_MIN_PSNR (hierarchical);
9. SVR with bias correction on the same problem (BIAS_ITERATIONS outer
   iterations), then with global bias correction, every kernel call
   checked as in phase 7, including the normalise-bias scatter, whose
   splat2_dense launches are counted apart and must be > 0.  Fails under 23.0 dB;
10. run_svr with the exact PSF engine (engine="exact") on the same problem
   with phase 7's config: the per-phase table, end-to-end seconds, slices
   registered per second and PSNR as in phase 7 (floor EXACT_MIN_PSNR);
   splat2_dense may not launch (registration runs reg_ncc_cost as on the
   fast engine).  Then, at the geometry of the stacks'
   slices on its grid, the offset count, the time of one psf_scatter and
   one psf_gather, and the exact engine against the fast one: one
   simulate and one normalised scatter, each within
   tests/test_psf_fast.py's mean relative deviation of 0.03;
11. run_svr with the fast engine, --manualMask (the truth's mask on the
   first stack's grid) and --bspline on the same problem
   (FEATURES_ITERATIONS outer iterations), every kernel call checked as
   in phase 7: the Dice of the manual-mask volume against the truth mask
   and the B-spline volume's PSNR; then fetalrecon-recon-eval-torch on
   the card against phase 7's volume, which prints its metric row;
12. slice-parallel run_svr (parallel/sharded.py) over MESH_RANKS ranks,
   one process each (gloo when they share the card, NCCL when each has
   its own), on motion_problem(0) at full width: a probe of the
   collectives on CUDA tensors; 12a, one outer iteration against the same
   config on one rank (MESH_AGREE_TOL) with the ranks' volumes bitwise
   equal; 12b, phase 7's config with every splat2_dense call on every rank
   checked as in phase 7 and launches > 0 on each: rank 0's per-phase
   table, end-to-end seconds, slices registered per second per round,
   PSNR (floor 23.5 dB and within MESH_PSNR_GAP of phase 7's), peak
   device memory per rank and the all-reduce of two volumes timed alone;
   12c, the speed-up over phase 7 where the ranks have cards of their own
   (else a line saying why it did not run); 12d, `svr-reconstruct-torch
   --mesh 2 --trace --debug` as a subprocess: exit 0, a trace per rank
   naming the kernel, the volume's PSNR; 12e, run_pvr over the ranks
   (square patches 32/16, OPTIONS_ITERATIONS outer iteration) against the
   same run on one rank (MESH_AGREE_TOL), every splat2_dense call on
   every rank checked;
13. the z-slab modes on the same problem (parallel/volume_sharded.py,
   parallel/mesh2d.py), ranks spawned as in phase 12, every splat2_dense
   call on every rank running on its slab's plan and checked as in phase
   7:
   13a, run_svr in volume mode on VOL_RANKS ranks at phase 7's config:
   rank 0's per-phase table, end-to-end seconds, PSNR (floor 23.5 dB and
   within MESH_PSNR_GAP of phase 7's), the ranks' volumes bitwise equal,
   peak device memory, scatter plan cells and dense scatter volumes per
   rank against the whole grid's, the halo exchanges of its inner iterations timed, and
   where its volume differs from phase 7's; 13b, the grid of GRID_RANKS
   ranks (mesh2d.grid_shape) at one outer iteration, held against the
   one-rank run of phase 12a: the grid's z is padded to a multiple of
   the slab count, so every row within PAD_REL_TOL of max|ref| and the
   rows beyond one gather and scatter pass from the pad within
   MESH_AGREE_TOL; 13c, `svr-reconstruct-torch --mesh 2 --mesh-mode
   volume` as a subprocess: exit 0 and the volume's PSNR; 13d, the
   large-area configuration (LARGE_STACKS stacks of the motion problem at
   LARGE_RESOLUTION mm, tools/bench_pvr.py:52-54, through run_svr; an
   even z) at one outer iteration on one rank and in volume mode on
   VOL_RANKS ranks (in 13a's spawn): seconds, peak device memory per
   rank (the one-rank run also once without the plain checks), the ranks
   against the one-rank volume (MESH_AGREE_TOL);
14. the remaining options of run_svr on the same problem, one outer
   iteration a run, every splat2_dense call checked as in phase 7 with
   launches > 0: 14a, svr-reconstruct-torch as a subprocess seeded with
   the truth (--referenceVolume) with -t stack .dof files,
   --force_exclude, --checkpoint and --saveSliceTransformations, then
   with --tfolder reading those transformations (written again, they
   must come out as read), then the first command with --resume; 14b,
   run_svr seeded with the truth with --useNMI, and with
   --useAutoTemplate; 14c, a 4D input stack.  Each fails on a non-finite
   volume or a PSNR under its OPTIONS_MIN_PSNR;
15. the port's bench, `python -m fetalreconstruction_tpu_torch.bench
   --iters BENCH_ITERS --e2e-runs BENCH_E2E_RUNS`, whole, as a
   subprocess: its last line parsed and printed; fails unless it exits
   0 with value > 0, splat2_dense launched in every inner iteration and
   a PSNR within MESH_PSNR_GAP of phase 7's.

The line before the last is the per-kernel JSON record (launch counts
summed over the checked runs of phases 7-14 and the bench's timed loop and
end-to-end run in phase 15, each counted from zero just before its run,
phases 12's and 13's over their ranks; each kernel's bound from
this run's
inputs at the card's data sheet rates); the last line is {"ok": true,
"device": {...}}.  Needs no network and imports no JAX.
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
MESH_RANKS = 2             # phase 12: two ranks (sharing one card here)
MESH_AGREE_ITERATIONS = 1  # 12a: no registration round
MESH_AGREE_TOL = 2e-2      # absolute, tests/test_sharded.py:219-221
PAD_REL_TOL = 5e-2         # of max|ref|: a z-padded slab run against one
                           # device, tests/test_volume_sharded.py:219-224
MESH_PSNR_GAP = 0.3        # dB from phase 7's PSNR in the same run
CLI_ITERATIONS = 1         # 12d, 13c (cut from 2 to keep the script near
                           # 1.5x its time before phase 13)
CLI_TIMEOUT = 600          # s
VOL_RANKS = 2              # 13a, 13c, 13d: two z-slabs
GRID_RANKS = 4             # 13b: mesh2d.grid_shape(4), 2 slices x 2 slabs
GRID_ITERATIONS = 1        # 13b: no registration round
LARGE_STACKS, LARGE_RESOLUTION = 8, 0.75  # 13d: tools/bench_pvr.py:52-54
LARGE_ITERATIONS = 1
LARGE_MIN_PSNR = 15.0      # 13d: against a broken volume (all-zero: about
                           # 5 dB); the ranks are held against one rank
OPTIONS_ITERATIONS = 1     # 14, 12e and phase 8's hierarchical PVR (a
                           # level): one outer iteration a run
# dB, about 0.5 below each run's first H100 reading (at 700 W): 14a 23.987,
# resumed 23.452; 14b seeded + NMI 24.480, auto template 24.107; 14c
# 24.170; 12e 25.621; hierarchical PVR, 2 levels, 25.396 (all-zero: 5)
OPTIONS_MIN_PSNR = {"14a": 23.0, "14b-nmi": 24.0, "14b-auto": 23.5,
                    "14c": 23.5, "12e": 25.0, "hierarchical": 24.9}
BENCH_ITERS = 5            # phase 15: the bench's timed inner iterations
BENCH_E2E_RUNS = 1         # and its end-to-end runs
BENCH_TIMEOUT = 600        # s
T0 = time.perf_counter()
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


def plain_path():
    """Patch fast_scatter2's kernel call with its plain version."""
    from fetalreconstruction_tpu_torch.ops import scatter

    def plain(plan, a, b):
        return scatter.splat2_dense_plain(plan.xp, a, b, plan.vol_shape,
                                          plan.sid, plan.n_stacks)

    return mock.patch.object(scatter, "splat2_dense", plain)


def plan_splat_plain(plan):
    """The splat as one index_add_ of the plan's slots into the dense
    volumes: the same precomputed pixels and corner weights that the kernel
    reads, each slot's 16 dense indices precomputed from its cell, so its
    time compares like with like (splat2_dense_plain also derives floors
    and weights from the positions)."""
    import torch
    from fetalreconstruction_tpu_torch.ops import scatter
    zs, ys, xs = plan.vol_shape
    cells = torch.arange(plan.cell_ptr.numel() - 1,
                         device=plan.cell_ptr.device)
    cell = torch.repeat_interleave(cells, plan.cell_ptr.diff())
    ui = cell % (xs + 1) - 1
    vi = cell // (xs + 1) % (ys + 1) - 1
    wi = cell // ((xs + 1) * (ys + 1)) % (zs + 1) - 1
    s = cell // ((xs + 1) * (ys + 1) * (zs + 1))
    idx = scatter.dense_index(s, wi, vi, ui, plan.vol_shape, plan.n_stacks)
    pix = plan.pix.long()
    del cells, cell, ui, vi, wi, s

    def run(pay_a, pay_b):
        upd = torch.cat([plan.wts * pay_a.reshape(-1)[pix, None],
                         plan.wts * pay_b.reshape(-1)[pix, None]], dim=1)
        return scatter.dense_from_updates(idx, upd, plan.vol_shape,
                                          plan.n_stacks)

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
    dense = scatter.splat2_dense(geom.plan, a, b)
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
        ("-- splat2_dense",
         lambda: scatter.splat2_dense(geom.plan, a, b)),
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
    del dense, addon, cmap, convs, tab
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


# the kernels that checked_path holds against their plain versions
CHECKED = ("splat2_dense",)


def checked_path(errs):
    """Patch fast_scatter2's kernel call so that every call also runs the
    plain version on the same tensors; errs[name] keeps, on the card, the
    worst max|kernel - plain| / max|plain| over the calls (read once,
    after the run, so the checks add no synchronisation)."""
    import torch
    from fetalreconstruction_tpu_torch.ops import scatter
    kernel = scatter.splat2_dense

    def splat(plan, a, b):
        out = kernel(plan, a, b)
        ref = scatter.splat2_dense_plain(plan.xp, a, b, plan.vol_shape,
                                         plan.sid, plan.n_stacks)
        err = ((out - ref).abs().max()
               / ref.abs().max().clamp(min=1e-30)).double()
        name = "splat2_dense"
        errs[name] = torch.maximum(errs[name], err) if name in errs else err
        return out

    return mock.patch.object(scatter, "splat2_dense", splat)


def reset_launches():
    """Set the launch count of every kernel to 0: splat2_dense's
    (ops/scatter.py) and reg_ncc_cost's (register/slice2vol.py)."""
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.register import slice2vol
    scatter.reset_launch_counts()
    slice2vol.reset_launch_counts()


def read_launches():
    """The launch count of every kernel since reset_launches."""
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.register import slice2vol
    return {**scatter.LAUNCHES, **slice2vol.LAUNCHES}


def cost_tally(tally):
    """Patch slice2vol's counter so that, besides the run's PerfStats,
    tally[name] adds up its "cost eval" and "fused cost eval" counts
    (every slice-to-volume cost evaluation, and those of the kernel
    pair)."""
    from fetalreconstruction_tpu_torch.register import slice2vol
    count = slice2vol.count

    def counted(name, n=1):
        tally[name] = tally.get(name, 0) + n
        count(name, n)

    return mock.patch.object(slice2vol, "count", counted)


def check_reg_route(label, launches, tally, registered, nmi=False):
    """Raise unless the slice-to-volume cost evaluations of a run on the
    card (tally, from cost_tally) all ran the fused kernel pair, or with
    NMI none did; unless reg_ncc_cost launched once a fused evaluation;
    and unless a run that registered (NCC) launched it at all."""
    evals, fused = tally.get("cost eval", 0), tally.get("fused cost eval", 0)
    got = launches["reg_ncc_cost"]
    print(f"{label}: {evals} slice-to-volume cost evals, {fused} of them "
          f"the fused kernel pair, reg_ncc_cost launched {got} times"
          f"{' (NMI: the torch path)' if nmi else ''}", flush=True)
    if fused != (0 if nmi else evals) or got != fused or (
            registered and not nmi and got <= 0):
        raise RuntimeError(f"{label}: registration's cost did not run as "
                           f"dispatched ({evals} evals, {fused} fused, "
                           f"{got} reg_ncc_cost launches)")


def checked_run(label, run, truth, min_psnr, dev, card, unit="slices",
                kernels=True, checks=True, nmi=False):
    """Drive one pipeline run with every splat2_dense call held against its
    plain version on the same tensors (phase 7's checks), launch counts
    set to 0 just before and read just after.  Prints the per-phase table,
    the worst kernel error, the units registered per second per round,
    the end-to-end time, PSNR against the truth and peak device memory;
    raises on a disagreeing or unlaunched splat2_dense (with
    kernels=False, the exact engine's path: on any launch of it), on a
    registration whose cost evaluations did not all run reg_ncc_cost
    (with nmi=True: on any that did; check_reg_route), a non-finite or
    misshapen volume, or a PSNR under min_psnr.  With checks=False the
    kernel runs alone (its launches counted, no plain version beside it):
    the peak device memory of the path itself.  Returns (result,
    launches, seconds)."""
    import contextlib
    import torch
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    errs, tally = {}, {}
    patch = checked_path(errs) if checks else contextlib.nullcontext()
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with patch, cost_tally(tally):
        res = run()
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = read_launches()
    out = res.reconstructed
    how = "with the plain checks" if checks else "no plain checks"
    print(f"{label} per-phase table, s ({how}) "
          f"[{card}]:\n{res.stats.table()}", flush=True)
    errs = {k: float(v) for k, v in errs.items()}
    if checks:
        print(f"kernels vs plain versions on every call inside {label} "
              f"(worst max|diff| / max|ref|, limit {KERNEL_TOL:.0e}): "
              f"{errs}", flush=True)
    for k in CHECKED:
        if (kernels and checks
                and not errs.get(k, float("nan")) <= KERNEL_TOL):
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
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB ({how}); "
          f"launches {launches} [{card}]", flush=True)
    for k in CHECKED:
        if kernels and launches[k] <= 0:
            raise RuntimeError(f"kernel {k} was not launched by {label}")
        if not kernels and launches[k] != 0:
            raise RuntimeError(f"{label} launched kernel {k}")
    check_reg_route(label, launches, tally,
                    len(res.stats.samples("registration")) > 0, nmi)
    if not psnr >= min_psnr:
        raise RuntimeError(f"{label}: PSNR {psnr:.3f} dB is below "
                           f"{min_psnr}")
    return res, launches, total


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
    returns the kernels' launch counts inside run_svr, the reconstruction
    (phase 11 evaluates it), the end-to-end seconds and the PSNR."""
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    truth, mask, stacks = motion("end to end")
    cfg = SVRConfig(iterations=E2E_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    no_log=True)
    res, launches, seconds = checked_run(
        "run_svr", lambda: run_svr(cfg, stacks=stacks, mask=mask,
                                   device=dev),
        truth, E2E_MIN_PSNR, dev, card)
    checked_run("run_svr unchecked", lambda: run_svr(
        cfg, stacks=stacks, mask=mask, device=dev), truth, E2E_MIN_PSNR,
        dev, card, checks=False)
    registration_breakdown(stacks, res.reconstructed, dev, card)
    return (launches, res.reconstructed, seconds,
            psnr_vs_truth(res.reconstructed, truth, device=dev))


def pvr_end_to_end(dev, card):
    """Phase 8: run_pvr on motion_problem(0) at full width, square patches
    (tools/bench_pvr.py's defaults), then superpixels, then the
    hierarchical mode at two levels (32/16, then 28/14 seeded with the
    first level's volume; cut from the default three to keep the script
    near half its time limit) at OPTIONS_ITERATIONS outer iteration a
    level; returns the kernels' launch counts over the three runs."""
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
             SPX_MIN_PSNR),
            ("run_pvr, hierarchical 32/16 -> 28/14",
             dict(iterations=OPTIONS_ITERATIONS, patch_size=32,
                  patch_stride=16, hierarchical=True, hier_levels=2),
             OPTIONS_MIN_PSNR["hierarchical"]))
    for label, kw, floor in runs:
        cfg = PVRConfig(resolution=1.0, rec_iterations_first=4,
                        rec_iterations_last=4, no_log=True, **kw)
        _, launches, _ = checked_run(
            label, lambda: run_pvr(cfg, stacks=stacks, mask=mask,
                                   device=dev),
            truth, floor, dev, card, unit="patches")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    print(f"PVR: SLIC ran {slic_backend()}", flush=True)
    return total


def bias_end_to_end(dev, card):
    """Phase 9: run_svr with bias correction, then with global bias
    correction; the splat2_dense launches inside normalise_bias_step are
    counted
    apart.  Returns the kernels' launch counts over both runs."""
    from fetalreconstruction_tpu_torch.ops import scatter
    from fetalreconstruction_tpu_torch.pipeline import svr_core
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    truth, mask, stacks = motion("bias")
    normalise = svr_core.normalise_bias_step
    nb = {"splat2_dense": 0}

    def counted(*a, **kw):
        before = scatter.LAUNCHES["splat2_dense"]
        out = normalise(*a, **kw)
        nb["splat2_dense"] += scatter.LAUNCHES["splat2_dense"] - before
        return out

    total = {}
    for label, kw in (("run_svr, bias correction", {}),
                      ("run_svr, global bias correction",
                       dict(global_bias_correction=True))):
        cfg = SVRConfig(iterations=BIAS_ITERATIONS, resolution=1.0,
                        rec_iterations_first=4, rec_iterations_last=4,
                        disable_bias_correction=False, no_log=True, **kw)
        nb["splat2_dense"] = 0
        with mock.patch.object(svr_core, "normalise_bias_step", counted):
            _, launches, _ = checked_run(
                label, lambda: run_svr(cfg, stacks=stacks, mask=mask,
                                       device=dev),
                truth, BIAS_MIN_PSNR, dev, card)
        print(f"{label}: splat2_dense launches inside normalise_bias_step "
              f"{nb['splat2_dense']}", flush=True)
        if not kw and nb["splat2_dense"] <= 0:
            raise RuntimeError("the normalise-bias scatter launched no "
                               "splat2_dense")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
    return total


def exact_end_to_end(dev, card):
    """Phase 10: run_svr with the exact PSF engine on motion_problem(0) at
    full width with phase 7's config (splat2_dense does not run on this
    path; registration's cost is reg_ncc_cost, as in phase 7);
    then, at the geometry of the stacks' slices on its grid, the time of
    one psf_scatter and one psf_gather and the exact engine against the
    fast one (test_psf_fast.py's limits)."""
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    truth, mask, stacks = motion("exact engine")
    cfg = SVRConfig(iterations=EXACT_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    engine="exact", no_log=True)
    res, launches, _ = checked_run(
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
        res, launches, _ = checked_run(
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


def host_ms(fn, reps=KERNEL_REPS):
    """Host time of fn between two synchronises, per call (for calls that
    block the host, such as a collective)."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def checked_rank_run(mesh, run):
    """Drive run() on this rank with every splat2_dense call held against
    its plain version (checked_path), the launch counts set to 0 just before
    and read just after, and the peak device memory counted from just
    before.  Returns (result, dict of what the parent checks and
    prints)."""
    import torch

    dev = mesh.device
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    errs, tally = {}, {}
    patch = checked_path(errs)
    reset_launches()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    with patch, cost_tally(tally):
        res = run()
    torch.cuda.synchronize(dev)
    seconds = time.perf_counter() - t0
    return res, dict(
        recon=res.reconstructed.data, transforms=res.transforms,
        launches=json.dumps(read_launches()), tally=json.dumps(tally),
        errs=json.dumps({k: float(v) for k, v in errs.items()}),
        seconds=seconds, peak=torch.cuda.max_memory_allocated(dev),
        table=res.stats.table(),
        reg=np.asarray(res.stats.samples("registration")),
        n=len(res.slice_weights), device=str(dev))


def check_ranks(label, ranks, card, keys=("recon", "transforms")):
    """Print each rank's launches, kernel errors, seconds and peak device
    memory; raise where a rank launched no splat2_dense or it disagrees
    with its plain version, where a rank's registration did not run
    reg_ncc_cost (check_reg_route), or where the ranks' `keys` differ.
    Returns the launch counts summed over the ranks."""
    for r in ranks[1:]:
        for k in keys:
            if not np.array_equal(r[k], ranks[0][k]):
                raise RuntimeError(f"{label}: the ranks' {k} differ")
    launches = {}
    for i, r in enumerate(ranks):
        got, errs = json.loads(str(r["launches"])), json.loads(str(r["errs"]))
        print(f"{label} rank {i} on {r['device']}: {float(r['seconds']):.3f} "
              f"s, launches {got}, kernels vs plain versions {errs} (limit "
              f"{KERNEL_TOL:.0e}), peak device memory "
              f"{float(r['peak']) / 2 ** 30:.2f} GiB [{card}]", flush=True)
        for k in CHECKED:
            if got[k] <= 0:
                raise RuntimeError(f"{label}: rank {i} launched no {k}")
            if not errs.get(k, float("nan")) <= KERNEL_TOL:
                raise RuntimeError(f"{label}: kernel {k} disagrees with its "
                                   f"plain version on rank {i}")
        check_reg_route(f"{label} rank {i}", got,
                        json.loads(str(r["tally"])), len(r["reg"]) > 0)
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    return launches


def _mesh_rank(mesh, stacks, mask, out):
    """Phase 12's rank, started by parallel.sharded.spawn: a probe of every
    collective the port uses on this rank's CUDA tensors; the agreement
    run (phase 7's config at MESH_AGREE_ITERATIONS outer iteration); the
    full run, every splat2_dense call checked as in phase 7 and the launch
    counts set to 0 just before it and read just after; then the
    all-reduce of one inner iteration's two volumes, and of one EM scalar,
    timed alone.  Writes its results to out/mesh_rank<r>.npz."""
    import torch
    import torch.distributed as dist
    from fetalreconstruction_tpu_torch.parallel import sharded
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev, g = mesh.device, mesh.group
    backend = dist.get_backend(g)
    x = torch.full((3,), float(mesh.rank + 1), device=dev)
    got = [float(sharded.psum(x.clone(), g)[0]),
           float(sharded.pmin(x.clone(), g)[0]),
           float(sharded.pmax(x.clone(), g)[0]),
           float(sharded.broadcast(mesh, x * 7.0)[0])]
    want = [mesh.size * (mesh.size + 1) / 2.0, 1.0, float(mesh.size), 7.0]
    if got != want:
        raise RuntimeError(f"rank {mesh.rank}: {backend} collectives on "
                           f"{dev} gave {got}, expected {want}")
    if mesh.rank == 0:
        print(f"12 probe: {backend} all_reduce SUM / MIN / MAX and "
              f"broadcast on {dev} tensors over {mesh.size} ranks: {got}",
              flush=True)

    kw = dict(resolution=1.0, rec_iterations_first=4, rec_iterations_last=4,
              no_log=True)
    agree = run_svr(SVRConfig(iterations=MESH_AGREE_ITERATIONS, **kw),
                    stacks=stacks, mask=mask, device=dev, mesh=mesh)
    _, rec = checked_rank_run(mesh, lambda: run_svr(
        SVRConfig(iterations=E2E_ITERATIONS, **kw), stacks=stacks, mask=mask,
        device=dev, mesh=mesh))
    vols = [torch.zeros(rec["recon"].shape, device=dev) for _ in range(2)]
    scalar = torch.zeros((), device=dev)
    allreduce_ms = host_ms(lambda: [sharded.psum(v, g) for v in vols])
    scalar_ms = host_ms(lambda: sharded.psum(scalar, g))
    np.savez(f"{out}/mesh_rank{mesh.rank}.npz",
             agree=agree.reconstructed.data,
             backend=backend, allreduce_ms=allreduce_ms, scalar_ms=scalar_ms,
             **rec)


def multi_rank(dev, card, e2e_volume, e2e_seconds):
    """Phase 12: run_svr slice-parallel over MESH_RANKS ranks on
    motion_problem(0) at full width (parallel/sharded.py; gloo when the
    ranks share a card, NCCL when each has its own).  12a: the volume of
    the agreement run against the same config on one rank in this
    process, and the ranks' volumes bitwise equal; 12b: the full run,
    every kernel call on every rank checked, launches > 0 on each rank,
    the PSNR within MESH_PSNR_GAP of phase 7's; 12c: the speed-up over
    phase 7 where the ranks have cards of their own; 12d: the CLI.
    Returns the kernels' launch counts of 12b, summed over the ranks, and
    the one-rank agreement volume (phase 13 reads it)."""
    import torch
    from fetalreconstruction_tpu_torch.core.image import Image
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    truth, mask, stacks = motion("multi-rank")
    e2e_psnr = psnr_vs_truth(e2e_volume, truth, device=dev)
    ref = run_svr(SVRConfig(iterations=MESH_AGREE_ITERATIONS, resolution=1.0,
                            rec_iterations_first=4, rec_iterations_last=4,
                            no_log=True),
                  stacks=stacks, mask=mask, device=dev).reconstructed
    torch.cuda.empty_cache()
    ranks, wall = spawn_ranks(_mesh_rank, MESH_RANKS, ("mesh",), stacks,
                              mask)
    ranks = ranks["mesh"]
    backend = str(ranks[0]["backend"])
    devices = [str(r["device"]) for r in ranks]
    launches = check_ranks("12b", ranks, card,
                           keys=("agree", "recon", "transforms"))
    err = float(np.abs(ranks[0]["agree"] - ref.data).max())
    print(f"12a agreement, {MESH_RANKS} ranks ({backend} on {devices}) vs "
          f"one rank, {MESH_AGREE_ITERATIONS} outer iteration: max|diff| "
          f"{err:.3e} ({err / float(np.abs(ref.data).max()):.3e} of "
          f"max|ref|; limit {MESH_AGREE_TOL} absolute, tests/test_sharded.py"
          f":219-221's limit on the volume after an inner iteration); the "
          f"ranks' volumes and transforms bitwise equal", flush=True)
    if not err <= MESH_AGREE_TOL:
        raise RuntimeError("the multi-rank volume disagrees with one rank's")

    r0 = ranks[0]
    print(f"12b rank 0 per-phase table, s (with the plain checks) "
          f"[{card}]:\n{r0['table']}", flush=True)
    n = int(r0["n"])
    for i, t in enumerate(r0["reg"]):
        print(f"12b registration round {i + 1}: {n} slices in {t:.3f} s = "
              f"{n / t:.2f} slices registered/s [{card}]", flush=True)
    vol = Image(r0["recon"], ref.attr.copy())
    if not np.isfinite(vol.data).all() or vol.data.shape != ref.data.shape:
        raise RuntimeError("the multi-rank volume is not finite or "
                           "misshapen")
    psnr = psnr_vs_truth(vol, truth, device=dev)
    seconds = float(r0["seconds"])
    shared = len(set(devices)) < len(devices)
    print(f"12b run_svr on {MESH_RANKS} ranks: {seconds:.3f} s end to end "
          f"on rank 0 ({wall:.3f} s for the whole spawn); PSNR vs truth "
          f"{psnr:.3f} dB (phase 7: {e2e_psnr:.3f}; floor {E2E_MIN_PSNR}, "
          f"at most {MESH_PSNR_GAP} dB apart); all-reduce of 2 x "
          f"{ref.data.shape} f32 {float(r0['allreduce_ms']):.3f} ms, of "
          f"one scalar {float(r0['scalar_ms']):.3f} ms ({backend})"
          + ("; the ranks share one card, so this run gives no scaling "
             "figure" if shared else "") + f" [{card}]", flush=True)
    if not (psnr >= E2E_MIN_PSNR and abs(psnr - e2e_psnr) <= MESH_PSNR_GAP):
        raise RuntimeError(f"the multi-rank PSNR {psnr:.3f} dB is off")
    if not shared:
        print(f"12c: {MESH_RANKS} ranks on {devices} with {backend}: "
              f"{e2e_seconds / seconds:.3f}x the speed of phase 7's "
              f"{e2e_seconds:.3f} s [{card}]", flush=True)
    else:
        print(f"12c did not run: {torch.cuda.device_count()} card(s), so "
              f"the {MESH_RANKS} ranks share {devices[0]} (gloo) and no "
              "run over several cards with NCCL was possible", flush=True)
    cli_mesh(dev, card, truth, mask, stacks)
    return launches, ref


def run_cli(label, tmp, stacks, mask, flags, iterations):
    """svr-reconstruct-torch on the stacks and mask (written to tmp) with
    `flags`, at phase 7's config and `iterations` outer iterations, as a
    subprocess; raises unless it exits 0.  Returns (volume, seconds)."""
    from pathlib import Path
    from fetalreconstruction_tpu_torch.io.nifti import read_nifti, write_nifti

    paths = [f"{tmp}/stack{i}.nii.gz" for i in range(len(stacks))]
    for pth, st in zip(paths, stacks):
        write_nifti(st, pth)
    write_nifti(mask, f"{tmp}/mask.nii.gz")
    out = f"{tmp}/recon.nii.gz"
    cmd = [sys.executable, "-m", "fetalreconstruction_tpu_torch.cli.svr_main",
           "-o", out, "-i", *paths, "-m", f"{tmp}/mask.nii.gz", *flags,
           "--iterations", str(iterations), "--resolution", "1.0",
           "--rec_iterations_first", "4", "--rec_iterations_last", "4",
           "--log_prefix", f"{tmp}/"]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        raise RuntimeError(f"{label} exited {res.returncode}")
    vol = read_nifti(out)
    if not np.isfinite(vol.data).all():
        raise RuntimeError(f"{label}: the volume is not finite")
    return vol, wall


def cli_mesh(dev, card, truth, mask, stacks):
    """Phase 12d: `svr-reconstruct-torch --mesh MESH_RANKS --trace DIR
    --debug` at CLI_ITERATIONS outer iterations, as a subprocess: exit 0,
    one trace per rank that names the kernel, the volume's PSNR."""
    import tempfile
    from pathlib import Path
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = f"{tmp}/trace"
        vol, wall = run_cli("svr-reconstruct-torch --mesh", tmp, stacks, mask,
                            ["--mesh", str(MESH_RANKS), "--trace", trace_dir,
                             "--debug"], CLI_ITERATIONS)
        sizes = []
        for r in range(MESH_RANKS):
            data = Path(f"{trace_dir}/trace_rank{r}.json").read_bytes()
            sizes.append(len(data))
            if b"splat2_dense" not in data:
                raise RuntimeError(f"rank {r}'s trace names no "
                                   "splat2_dense")
    psnr = psnr_vs_truth(vol, truth, device=dev)
    print(f"12d svr-reconstruct-torch --mesh {MESH_RANKS} --trace "
          f"--debug, {CLI_ITERATIONS} outer iterations: exit 0 in "
          f"{wall:.3f} s; traces {[s / 2 ** 20 for s in sizes]} MiB, "
          f"each naming splat2_dense; PSNR vs truth "
          f"{psnr:.3f} dB (floor {FEATURES_MIN_PSNR}) [{card}]", flush=True)
    if not psnr >= FEATURES_MIN_PSNR:
        raise RuntimeError(f"the CLI's PSNR {psnr:.3f} dB is off")


def halo_timers(dev, stats):
    """Patches that time, inside each volume-sharded inner iteration, every
    halo.exchange (the one all-reduce of each halo exchange), with a
    synchronise on both sides, and the inner iteration as a whole, and
    that keep the largest z reach of the PSF's convolutions
    (volume_sharded.conv_terms_radius); the counts, seconds and reach go
    to `stats`."""
    import torch
    from fetalreconstruction_tpu_torch.parallel import halo
    from fetalreconstruction_tpu_torch.parallel import volume_sharded as vsd
    exchange, inner = halo.exchange, vsd.vs_inner_iteration
    radius = vsd.conv_terms_radius
    inside = [False]

    def timed_exchange(t, mesh):
        if not inside[0]:
            return exchange(t, mesh)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = exchange(t, mesh)
        torch.cuda.synchronize(dev)
        stats["halo_s"] += time.perf_counter() - t0
        stats["halo_n"] += 1
        stats["halo_bytes"] += out.numel() * out.element_size()
        return out

    def timed_inner(*a, **kw):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        inside[0] = True
        try:
            out = inner(*a, **kw)
        finally:
            inside[0] = False
        torch.cuda.synchronize(dev)
        stats["inner_s"] += time.perf_counter() - t0
        stats["inner_n"] += 1
        return out

    def kept_radius(terms):
        h = radius(terms)
        stats["conv_reach"] = max(stats["conv_reach"], h)
        return h

    return (mock.patch.object(halo, "exchange", timed_exchange),
            mock.patch.object(vsd, "vs_inner_iteration", timed_inner),
            mock.patch.object(vsd, "conv_terms_radius", kept_radius))


def slab_sizes(vol_shape, n_slabs, n_stacks):
    """Text: the scatter plan's cells and the splat's dense volumes (MiB)
    of one z-slab, against the whole volume's: a slab's plan and volumes
    cover lz + 1 rows of the grid padded to a multiple of n_slabs."""
    from fetalreconstruction_tpu_torch.ops import scatter
    zs, ys, xs = vol_shape
    lz = (zs + (-zs) % n_slabs) // n_slabs

    def sizes(shape):
        mib = n_stacks * 2 * int(np.prod(shape)) * 4 / 2 ** 20
        return f"{scatter.n_cells(shape, n_stacks)} cells, {mib:.1f} MiB"

    return (f"scatter plan and dense volumes {sizes((lz + 1, ys, xs))} per "
            f"rank against {sizes(tuple(vol_shape))} for the whole grid")


def against_one_rank(label, got, ref, n_slabs, reach, card):
    """Print where a z-slab run's volume differs from the one-rank volume
    `ref` and return whether it agrees.  The slab modes pad the grid's z
    to a multiple of n_slabs at the top and crop the pad off; the pad's
    rows take part in the PSF normalisation (conv of ones) and the
    scatter, so the rows near them differ, as in the JAX package.  With a
    pad, every row is held within PAD_REL_TOL of max|ref| (the JAX
    package's limit for a padded run against one device,
    tests/test_volume_sharded.py:219-224) and the rows more than `reach`
    below the pad within MESH_AGREE_TOL; without one, every row within
    MESH_AGREE_TOL."""
    zs = ref.shape[0]
    pad = (-zs) % n_slabs
    diff = np.abs(np.asarray(got) - np.asarray(ref)).max(axis=(1, 2))
    worst = int(diff.argmax())
    over = np.nonzero(diff > MESH_AGREE_TOL)[0]
    if not pad:
        print(f"{label} against one rank (no z pad): max|diff| "
              f"{diff.max():.3e} in z row {worst} of {zs} (limit "
              f"{MESH_AGREE_TOL}) [{card}]", flush=True)
        return bool(diff.max() <= MESH_AGREE_TOL)
    far = float(diff[:zs - reach].max())
    lim = PAD_REL_TOL * float(np.abs(ref).max())
    spread = ("none" if not over.size else
              f"{zs - over.max()} to {zs - over.min()} rows below it")
    print(f"{label} against one rank ({pad} z pad row(s) above row "
          f"{zs - 1}): max|diff| {diff.max():.3e} in z row {worst}, "
          f"{zs - worst} row(s) below the pad (limit {lim:.3e}, "
          f"{PAD_REL_TOL} x max|ref|); rows more than {reach} below the pad "
          f"(one gather and scatter pass at the PSF's z reach) max|diff| "
          f"{far:.3e} (limit {MESH_AGREE_TOL}); rows over {MESH_AGREE_TOL}: "
          f"{spread} [{card}]", flush=True)
    return bool(diff.max() <= lim and far <= MESH_AGREE_TOL)


def _slab_rank(mesh, stacks, mask, stacks8, mask8, out):
    """Phase 13a's and 13d's rank: run_svr in volume mode at phase 7's
    config with the halo exchanges of its inner iterations timed (13a),
    then the large-area configuration (13d), every splat2_dense call of both
    checked.  Writes out/volume_rank<r>.npz and out/large_rank<r>.npz."""
    import torch
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    cfg = SVRConfig(iterations=E2E_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    no_log=True)
    stats = dict.fromkeys(("halo_s", "halo_n", "halo_bytes", "inner_s",
                           "inner_n", "conv_reach"), 0)
    p1, p2, p3 = halo_timers(dev, stats)
    with p1, p2, p3:
        _, rec = checked_rank_run(mesh, lambda: run_svr(
            cfg, stacks=stacks, mask=mask, device=dev, mesh=mesh,
            mesh_mode="volume"))
    np.savez(f"{out}/volume_rank{mesh.rank}.npz", **stats, **rec)
    _, rec = checked_rank_run(mesh, lambda: run_svr(
        large_config(), stacks=stacks8, mask=mask8, device=dev, mesh=mesh,
        mesh_mode="volume"))
    np.savez(f"{out}/large_rank{mesh.rank}.npz", **rec)


def _grid_rank(mesh, stacks, mask, out):
    """Phase 13b's rank: run_svr on the grid of GRID_RANKS ranks at
    GRID_ITERATIONS outer iteration, every splat2_dense call checked."""
    import torch
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = SVRConfig(iterations=GRID_ITERATIONS, resolution=1.0,
                    rec_iterations_first=4, rec_iterations_last=4,
                    no_log=True)
    _, rec = checked_rank_run(mesh, lambda: run_svr(
        cfg, stacks=stacks, mask=mask, device=mesh.device, mesh=mesh,
        mesh_mode="grid"))
    np.savez(f"{out}/grid_rank{mesh.rank}.npz", **rec)


def large_config():
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig
    return SVRConfig(iterations=LARGE_ITERATIONS, resolution=LARGE_RESOLUTION,
                     rec_iterations_first=4, rec_iterations_last=4,
                     no_log=True)


def spawn_ranks(fn, n, tags, *args):
    """parallel.sharded.spawn(fn, n, *args, tmp) and the ranks' npz files,
    tmp/<tag>_rank<r>.npz for each tag; returns ({tag: ranks}, seconds of
    the spawn)."""
    import tempfile
    from fetalreconstruction_tpu_torch.parallel import sharded
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        sharded.spawn(fn, n, *args, tmp)
        wall = time.perf_counter() - t0
        return {tag: [dict(np.load(f"{tmp}/{tag}_rank{r}.npz"))
                      for r in range(n)] for tag in tags}, wall


def slab_modes(dev, card, e2e_volume, one_rank):
    """Phase 13: the z-slab modes on motion_problem(0) at full width, the
    ranks sharing the card over gloo (NCCL where each has its own).
    13d's one-rank run comes first, as its volume-mode run shares 13a's
    ranks.  13a, run_svr in volume mode on VOL_RANKS ranks at phase 7's
    config, every splat2_dense call on every rank checked: per-phase table,
    seconds, PSNR (floor and MESH_PSNR_GAP from phase 7's), ranks bitwise
    equal, peak device memory and accumulator rows per rank, the halo
    exchanges of its inner iterations timed, and where it differs from
    phase 7's volume; 13b, the grid of GRID_RANKS ranks at one outer
    iteration, held against `one_rank` (phase 12a's run at that depth;
    against_one_rank); 13c, svr-reconstruct-torch --mesh-mode volume;
    13d, the large-area configuration in volume mode on VOL_RANKS ranks
    against one rank.  Returns the kernels' launch counts of 13a, 13b and
    13d, summed over the ranks."""
    import tempfile
    import torch
    from fetalreconstruction_tpu_torch.core.image import Image
    from fetalreconstruction_tpu_torch.parallel import mesh2d
    from fetalreconstruction_tpu_torch.pipeline.svr import run_svr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        motion_problem, psnr_vs_truth)

    truth, mask, stacks = motion("z-slab modes")
    e2e_psnr = psnr_vs_truth(e2e_volume, truth, device=dev)
    print(f"13 depth: 13a at phase 7's {E2E_ITERATIONS} outer iterations; "
          f"cut to {GRID_ITERATIONS} in 13b, {CLI_ITERATIONS} in 12d and 13c "
          f"(from 2) and {LARGE_ITERATIONS} in 13d", flush=True)
    t0 = time.perf_counter()
    truth8, mask8, stacks8 = motion_problem(0, n_stacks=LARGE_STACKS)
    print(f"13d: large-area problem built in {time.perf_counter() - t0:.2f} "
          f"s: {len(stacks8)} stacks of {stacks8[0].data.shape} at "
          f"{LARGE_RESOLUTION} mm", flush=True)
    one, launches, s_one = checked_run(
        "13d run_svr, one rank", lambda: run_svr(
            large_config(), stacks=stacks8, mask=mask8, device=dev),
        truth8, LARGE_MIN_PSNR, dev, card)
    peak_one = torch.cuda.max_memory_allocated()
    one = one.reconstructed.data
    checked_run("13d run_svr, one rank, unchecked", lambda: run_svr(
        large_config(), stacks=stacks8, mask=mask8, device=dev), truth8,
        LARGE_MIN_PSNR, dev, card, checks=False)
    peak_unchecked = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    ranks, wall = spawn_ranks(_slab_rank, VOL_RANKS, ("volume", "large"),
                              stacks, mask, stacks8, mask8)
    vranks, lranks = ranks["volume"], ranks["large"]
    for k, v in check_ranks("13a", vranks, card).items():
        launches[k] += v
    r0 = vranks[0]
    print(f"13a rank 0 per-phase table, s (with the plain checks and the "
          f"halo timers) [{card}]:\n{r0['table']}", flush=True)
    n = int(r0["n"])
    for i, t in enumerate(r0["reg"]):
        print(f"13a registration round {i + 1}: {n} slices in {t:.3f} s = "
              f"{n / t:.2f} slices registered/s [{card}]", flush=True)
    vol = Image(r0["recon"], e2e_volume.attr.copy())
    if (not np.isfinite(vol.data).all()
            or vol.data.shape != e2e_volume.data.shape):
        raise RuntimeError("the volume-mode volume is not finite or "
                           "misshapen")
    psnr = psnr_vs_truth(vol, truth, device=dev)
    inner_n = max(int(r0["inner_n"]), 1)
    print(f"13a run_svr, volume mode on {VOL_RANKS} ranks: "
          f"{float(r0['seconds']):.3f} s end to end on rank 0 "
          f"({wall:.3f} s for the spawn, 13d's run included); PSNR vs truth "
          f"{psnr:.3f} dB (phase 7: {e2e_psnr:.3f}; floor {E2E_MIN_PSNR}, at "
          f"most {MESH_PSNR_GAP} dB apart); peak device memory per rank "
          f"{[round(float(r['peak']) / 2 ** 30, 2) for r in vranks]} GiB; "
          f"{slab_sizes(vol.data.shape, VOL_RANKS, len(stacks))} (phase 7) "
          f"[{card}]", flush=True)
    print(f"13a halo exchanges of one inner iteration (rank 0, mean of "
          f"{inner_n}): {int(r0['halo_n']) / inner_n:.1f} exchanges, "
          f"{float(r0['halo_s']) * 1e3 / inner_n:.3f} ms, "
          f"{float(r0['halo_bytes']) / inner_n / 2 ** 20:.2f} MiB summed over "
          f"the ranks, against {float(r0['inner_s']) * 1e3 / inner_n:.3f} ms "
          f"per inner iteration (each timed between synchronises) [{card}]",
          flush=True)
    # the PSF's z reach h: the pad reaches h rows through the conv of ones
    # and h + 1 more through a gather and scatter pass
    reach = 2 * int(r0["conv_reach"]) + 1
    against_one_rank("13a (read, not held: the registration rounds turn "
                     "the top rows' difference into other accepted steps)",
                     vol.data, e2e_volume.data, VOL_RANKS, reach, card)
    if not (psnr >= E2E_MIN_PSNR and abs(psnr - e2e_psnr) <= MESH_PSNR_GAP):
        raise RuntimeError(f"the volume-mode PSNR {psnr:.3f} dB is off")

    granks, gwall = spawn_ranks(_grid_rank, GRID_RANKS, ("grid",), stacks,
                                mask)
    granks = granks["grid"]
    for k, v in check_ranks("13b", granks, card).items():
        launches[k] += v
    s_, v_ = mesh2d.grid_shape(GRID_RANKS)
    print(f"13b grid {s_} x {v_}, {GRID_ITERATIONS} outer iteration: "
          f"{float(granks[0]['seconds']):.3f} s on rank 0 ({gwall:.3f} s for "
          f"the whole spawn) [{card}]", flush=True)
    if not against_one_rank("13b", granks[0]["recon"], one_rank.data, v_,
                            reach, card):
        raise RuntimeError("the grid-mode volume disagrees with one rank's")

    with tempfile.TemporaryDirectory() as tmp:
        cvol, cwall = run_cli("svr-reconstruct-torch --mesh-mode volume", tmp,
                              stacks, mask, ["--mesh", str(VOL_RANKS),
                                             "--mesh-mode", "volume"],
                              CLI_ITERATIONS)
    c_psnr = psnr_vs_truth(cvol, truth, device=dev)
    print(f"13c svr-reconstruct-torch --mesh {VOL_RANKS} --mesh-mode volume, "
          f"{CLI_ITERATIONS} outer iterations: exit 0 in {cwall:.3f} s; PSNR "
          f"vs truth {c_psnr:.3f} dB (floor {FEATURES_MIN_PSNR}) [{card}]",
          flush=True)
    if not c_psnr >= FEATURES_MIN_PSNR:
        raise RuntimeError(f"the volume-mode CLI's PSNR {c_psnr:.3f} dB is "
                           "off")

    for k, v in check_ranks("13d", lranks, card).items():
        launches[k] += v
    print(f"13d large-area, {LARGE_STACKS} stacks at {LARGE_RESOLUTION} mm, "
          f"grid {one.shape} ({(-one.shape[0]) % VOL_RANKS} pad rows), "
          f"{LARGE_ITERATIONS} outer iteration: one rank {s_one:.3f} s, peak "
          f"device memory {peak_one / 2 ** 30:.2f} GiB with the plain-version "
          f"checks, {peak_unchecked / 2 ** 30:.2f} GiB without; volume mode "
          f"on {VOL_RANKS} ranks {float(lranks[0]['seconds']):.3f} s on rank "
          f"0, peak per rank "
          f"{[round(float(r['peak']) / 2 ** 30, 2) for r in lranks]} GiB with "
          f"the checks; {slab_sizes(one.shape, VOL_RANKS, LARGE_STACKS)} "
          f"[{card}]", flush=True)
    if not against_one_rank("13d", lranks[0]["recon"], one, VOL_RANKS, reach,
                            card):
        raise RuntimeError("the large-area volume mode disagrees with one "
                           "rank")
    return launches


def _pvr_rank(mesh, stacks, mask, out):
    """Phase 12e's rank: run_pvr over square patches 32/16 at
    OPTIONS_ITERATIONS outer iteration, every splat2_dense call checked.
    Writes out/pvr_rank<r>.npz."""
    import torch
    from fetalreconstruction_tpu_torch.pipeline.pvr import run_pvr

    torch.backends.cuda.matmul.allow_tf32 = False
    _, rec = checked_rank_run(mesh, lambda: run_pvr(
        pvr_options_config(), stacks=stacks, mask=mask, mesh=mesh,
        device=mesh.device))
    np.savez(f"{out}/pvr_rank{mesh.rank}.npz", **rec)


def pvr_options_config():
    from fetalreconstruction_tpu_torch.pipeline.pvr import PVRConfig
    return PVRConfig(iterations=OPTIONS_ITERATIONS, resolution=1.0,
                     rec_iterations_first=4, rec_iterations_last=4,
                     patch_size=32, patch_stride=16, no_log=True)


def pvr_multi_rank(dev, card):
    """Phase 12e: run_pvr(mesh=) over MESH_RANKS ranks (square patches
    32/16, OPTIONS_ITERATIONS outer iteration) against the same run on one
    rank in this process (MESH_AGREE_TOL), the ranks' volumes bitwise
    equal, every splat2_dense call on every rank checked.  Returns the launch
    counts summed over the ranks."""
    from fetalreconstruction_tpu_torch.core.image import Image
    from fetalreconstruction_tpu_torch.pipeline.pvr import run_pvr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    truth, mask, stacks = motion("12e PVR on ranks")
    t0 = time.perf_counter()
    ref = run_pvr(pvr_options_config(), stacks=stacks, mask=mask,
                  device=dev).reconstructed
    one_s = time.perf_counter() - t0
    ranks, wall = spawn_ranks(_pvr_rank, MESH_RANKS, ("pvr",), stacks, mask)
    ranks = ranks["pvr"]
    launches = check_ranks("12e", ranks, card)
    vol = Image(ranks[0]["recon"], ref.attr.copy())
    if not np.isfinite(vol.data).all() or vol.data.shape != ref.data.shape:
        raise RuntimeError("12e: the multi-rank PVR volume is not finite or "
                           "misshapen")
    err = float(np.abs(vol.data - ref.data).max())
    rel = err / float(np.abs(ref.data).max())
    psnr = psnr_vs_truth(vol, truth, device=dev)
    print(f"12e run_pvr 32/16 on {MESH_RANKS} ranks, {OPTIONS_ITERATIONS} "
          f"outer iteration, {int(ranks[0]['n'])} patches: "
          f"{float(ranks[0]['seconds']):.3f} s on rank 0 ({wall:.3f} s for "
          f"the whole spawn; one rank {one_s:.3f} s unchecked); max|diff| "
          f"against one rank {err:.3e} ({rel:.3e} of max|ref|; limit "
          f"{MESH_AGREE_TOL} absolute); the ranks' "
          f"volumes and transforms bitwise equal; PSNR vs truth {psnr:.3f} "
          f"dB (floor {OPTIONS_MIN_PSNR['12e']}) [{card}]", flush=True)
    if not err <= MESH_AGREE_TOL:
        raise RuntimeError("12e: the multi-rank PVR volume disagrees with "
                           "one rank's")
    if not psnr >= OPTIONS_MIN_PSNR["12e"]:
        raise RuntimeError(f"12e: PSNR {psnr:.3f} dB is below "
                           f"{OPTIONS_MIN_PSNR['12e']}")
    return launches


# the child process of phase 14a: the CLI under phase 7's kernel checks
CLI_CHILD = ("import sys, chip_smoke; "
             "sys.exit(chip_smoke.checked_cli(sys.argv[1], sys.argv[2:]))")


def checked_cli(record, argv):
    """Phase 14a's child process: svr-reconstruct-torch's main(argv) on the
    card with every splat2_dense call held against its plain version, the
    launch counts set to 0 just before and read just after; writes the
    exit code, the counts, slice2vol's cost tally (cost_tally), the worst
    kernel errors and the peak device memory to `record` (JSON).  Returns
    the exit code."""
    import torch
    from fetalreconstruction_tpu_torch.cli import svr_main

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, tally = {}, {}
    patch = checked_path(errs)
    reset_launches()
    with patch, cost_tally(tally):
        rc = svr_main.main(argv)
    torch.cuda.synchronize()
    with open(record, "w") as f:
        json.dump(dict(rc=rc, launches=read_launches(), tally=tally,
                       errs={k: float(v) for k, v in errs.items()},
                       peak=torch.cuda.max_memory_allocated()), f)
    return rc


def cli_options(label, tmp, name, flags, truth, dev, card):
    """Phase 14a: one svr-reconstruct-torch run as a subprocess (CLI_CHILD)
    on the stacks and mask in tmp at phase 7's config and
    OPTIONS_ITERATIONS outer iteration with `flags`, writing
    tmp/<name>.nii.gz; raises unless it exits 0 with splat2_dense launched
    and within KERNEL_TOL of its plain version, registration's cost
    evaluations on reg_ncc_cost (check_reg_route), and a finite volume
    above OPTIONS_MIN_PSNR["14a"].  Returns the launch counts."""
    import glob
    from pathlib import Path
    from fetalreconstruction_tpu_torch.io.nifti import read_nifti
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        psnr_vs_truth)

    out, record = f"{tmp}/{name}.nii.gz", f"{tmp}/{name}.json"
    argv = ["-o", out, "-i", *sorted(glob.glob(f"{tmp}/stack*.nii.gz")),
            "-m", f"{tmp}/mask.nii.gz", *flags,
            "--iterations", str(OPTIONS_ITERATIONS), "--resolution", "1.0",
            "--rec_iterations_first", "4", "--rec_iterations_last", "4",
            "--log_prefix", f"{tmp}/{name}_"]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", CLI_CHILD, record, *argv],
                         cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True, timeout=CLI_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        raise RuntimeError(f"{label} exited {res.returncode}")
    with open(record) as f:
        rec = json.load(f)
    vol = read_nifti(out)
    if not np.isfinite(vol.data).all():
        raise RuntimeError(f"{label}: the volume is not finite")
    psnr = psnr_vs_truth(vol, truth, device=dev)
    print(f"{label}: exit 0 in {wall:.3f} s; launches {rec['launches']}, "
          f"kernels vs plain versions on every call {rec['errs']} (limit "
          f"{KERNEL_TOL:.0e}); PSNR vs truth {psnr:.3f} dB (floor "
          f"{OPTIONS_MIN_PSNR['14a']}); peak device memory "
          f"{rec['peak'] / 2 ** 30:.2f} GiB [{card}]", flush=True)
    for k in CHECKED:
        if rec["launches"][k] <= 0:
            raise RuntimeError(f"{label} launched no {k}")
        if not rec["errs"].get(k, float("nan")) <= KERNEL_TOL:
            raise RuntimeError(f"{label}: kernel {k} disagrees with its "
                               "plain version")
    check_reg_route(label, rec["launches"], rec["tally"],
                    rec["tally"].get("cost eval", 0) > 0)
    if not psnr >= OPTIONS_MIN_PSNR["14a"]:
        raise RuntimeError(f"{label}: PSNR {psnr:.3f} dB is below "
                           f"{OPTIONS_MIN_PSNR['14a']}")
    return rec["launches"]


def options_end_to_end(dev, card):
    """Phase 14: the options of run_svr that phases 7-13 leave out, on
    motion_problem(0) at full width, OPTIONS_ITERATIONS outer iteration a
    run, every splat2_dense call checked as in phase 7.  14a,
    svr-reconstruct-torch as a subprocess, three times on the same NIfTI
    inputs: seeded with the truth (--referenceVolume, so a registration
    round runs) with -t stack .dof files, --force_exclude, --checkpoint
    and --saveSliceTransformations; then with --tfolder reading the
    transformations that run wrote (written again, they must come out as
    read); then the first command with --resume.  14b, run_svr seeded with
    the truth with --useNMI, and with --useAutoTemplate; 14c, run_svr with
    a 4D input stack (stack 0 of seeds 0 and 1, which share a grid)
    beside stacks 1-3.  Returns the launch counts summed over the runs."""
    import os
    import tempfile
    from fetalreconstruction_tpu_torch.core.geometry import rigid_matrix
    from fetalreconstruction_tpu_torch.core.image import Image
    from fetalreconstruction_tpu_torch.io.dof import (read_transformations,
                                                      write_dof)
    from fetalreconstruction_tpu_torch.io.nifti import write_nifti
    from fetalreconstruction_tpu_torch.pipeline.svr import SVRConfig, run_svr
    from fetalreconstruction_tpu_torch.pipeline.synthetic import (
        motion_problem)

    truth, mask, stacks = motion("14 options")
    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    with tempfile.TemporaryDirectory() as tmp:
        for i, st in enumerate(stacks):
            write_nifti(st, f"{tmp}/stack{i}.nii.gz")
        write_nifti(mask, f"{tmp}/mask.nii.gz")
        write_nifti(truth, f"{tmp}/truth.nii.gz")
        # stack 0 is the template; the others start 0.5 mm / deg off
        dofs = ["id"]
        for i in range(1, len(stacks)):
            dofs.append(f"{tmp}/stack{i}.dof")
            write_dof(dofs[-1], rigid_matrix([0.5, -0.5, 0.5, 0.5, 0.5,
                                              -0.5]))
        ck = f"{tmp}/ck"
        common = ["-t", *dofs, "--force_exclude", "3", "5",
                  "--saveSliceTransformations"]
        first = common + ["--referenceVolume", f"{tmp}/truth.nii.gz",
                          "--checkpoint", ck]
        add(cli_options(
            "14a svr-reconstruct-torch --referenceVolume -t --force_exclude "
            "--checkpoint --saveSliceTransformations", tmp, "a", first,
            truth, dev, card))
        n = len(os.listdir(f"{tmp}/a.nii.gz.transforms"))
        cps = sorted(os.listdir(ck))
        if cps != ["checkpoint_iter000.npz"]:
            raise RuntimeError(f"14a: checkpoints {cps}")
        add(cli_options(
            "14a svr-reconstruct-torch --tfolder (those transformations) -t "
            "--force_exclude --saveSliceTransformations", tmp, "b",
            common + ["--tfolder", f"{tmp}/a.nii.gz.transforms"], truth,
            dev, card))
        read = read_transformations(f"{tmp}/a.nii.gz.transforms", n)
        written = read_transformations(f"{tmp}/b.nii.gz.transforms", n)
        change = float(np.abs(written - read).max())
        print(f"14a: {n} slice transformations read through --tfolder and "
              f"written again (no registration round at one outer "
              f"iteration without a seed): largest change {change:.3e}; "
              f"checkpoints {cps}", flush=True)
        if not change <= 1e-6:
            raise RuntimeError("14a: the written transformations are not "
                               "the ones --tfolder read")
        add(cli_options("14a the first command with --resume", tmp, "c",
                        first + ["--resume"], truth, dev, card))

    kw = dict(iterations=OPTIONS_ITERATIONS, resolution=1.0,
              rec_iterations_first=4, rec_iterations_last=4, no_log=True)
    _, launches, _ = checked_run(
        "14b run_svr --referenceVolume (the truth) --useNMI",
        lambda: run_svr(SVRConfig(use_nmi=True, **kw), stacks=stacks,
                        mask=mask, reference_volume=truth, device=dev),
        truth, OPTIONS_MIN_PSNR["14b-nmi"], dev, card, nmi=True)
    add(launches)
    _, launches, _ = checked_run(
        "14b run_svr --useAutoTemplate",
        lambda: run_svr(SVRConfig(use_auto_template=True, **kw),
                        stacks=stacks, mask=mask, device=dev),
        truth, OPTIONS_MIN_PSNR["14b-auto"], dev, card)
    add(launches)

    other = motion_problem(1)[2][0]
    if other.attr != stacks[0].attr:
        raise RuntimeError("14c: seed 1's stack 0 is on another grid")
    four = Image(np.stack([stacks[0].data, other.data]),
                 stacks[0].attr.copy())
    res, launches, _ = checked_run(
        "14c run_svr with a 4D stack (2 volumes) and stacks 1-3",
        lambda: run_svr(SVRConfig(**kw), stacks=[four] + stacks[1:],
                        mask=mask, device=dev),
        truth, OPTIONS_MIN_PSNR["14c"], dev, card)
    add(launches)
    if len(res.stack_factors) != len(stacks) + 1:
        raise RuntimeError(f"14c: {len(res.stack_factors)} stacks after the "
                           "4D split")
    return total


def registration_breakdown(stacks, recon_img, dev, card):
    """One level-0 slice-to-volume cost evaluation timed alone: the fused
    kernel pair that run_svr runs, and its plain version (the torch path)
    split into its parts; then torch.profiler over one coordinate sweep of
    the fused cost.  Run on all slices of the uncropped stacks against the
    reconstruction, from identity transforms."""
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
    plain = s2v.make_cost_fn(cfg, None, w2i, ofs_l, tgt, mean,
                             tgt.shape[1:], 0, sigma, psf_table=table,
                             vol_shape=vs)
    cost = s2v.make_cost_fn(cfg, recon, w2i, ofs_l, tgt, mean,
                            tgt.shape[1:], 0, sigma)
    err = float((cost(params) - plain(params)).abs().max())
    print(f"fused cost vs torch path, level 0: max|diff| {err:.3e} "
          f"(limit {REG_COST_TOL:.0e})", flush=True)
    if not err <= REG_COST_TOL:
        raise RuntimeError("the fused cost disagrees with the torch path")
    sub = torch.ones(tgt.shape[1:], dtype=torch.bool, device=dev)
    gens = [s2v.generate_slices_psf(table, vs, None, w2i, params, ofs_l,
                                    tgt.shape[1:], o)
            for o in cfg.through_plane_offsets]
    blurred = [s2v.reg_blur(g, sigma) for g in gens]
    parts = [
        ("registration table (make_shingle + bf16)",
         lambda: s2v.make_reg_table(recon, cfg.table_dtype)),
        ("cost eval, level 0, fused kernel pair", lambda: cost(params)),
        ("cost eval, level 0, torch path", lambda: plain(params)),
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


REG_COST_SHAPES = [  # (label, units, H = W, sigma_pix): the recon cells'
    ("SVR level 0", 132, 180, 0.5),       # slices (r = 2) and PVR's
    ("PVR level 0", 2600, 40, 0.5),       # patches at each level (r = 2,
    ("PVR level 1", 2600, 40, 1.0),       # 4, 8)
    ("PVR level 2", 2600, 40, 2.0),
]
REG_COST_TOL = 2e-5  # max|fused - torch path| of the summed NCC


def reg_cost_case(device, n, hw, sigma_pix, vol_n=64, spacing=None,
                  seed=0):
    """A registration cost problem from a seed: a volume of smooth blobs,
    n slices of hw (H = W, or (H, W)) through it (pixels `spacing` voxels
    apart, by default so that a slice's longer side spans 0.9 of the
    volume; each slice shifted in its plane within that span), targets
    generated at the true params with noise, -1 outside an ellipse (as a
    patch is -1 padded), then blurred as level_arrays blurs them, and
    params moved off the truth.  Row 0's target is all -1, row 1 samples
    only outside the volume, row 2 half outside."""
    import torch
    from fetalreconstruction_tpu_torch.register import slice2vol as s2v

    rng = np.random.default_rng(seed)
    g = np.arange(vol_n, dtype=np.float64)
    z, y, x = np.meshgrid(g, g, g, indexing="ij")
    vol = np.zeros((vol_n,) * 3)
    for _ in range(12):
        c = rng.uniform(0.2, 0.8, 3) * vol_n
        s = rng.uniform(0.05, 0.2) * vol_n
        vol += rng.uniform(50, 200) * np.exp(
            -((x - c[0]) ** 2 + (y - c[1]) ** 2 + (z - c[2]) ** 2)
            / (2 * s * s))
    w2i = np.eye(4)
    w2i[:3, 3] = (vol_n - 1) / 2.0
    h, w = (hw, hw) if np.ndim(hw) == 0 else hw
    sp = 0.9 * vol_n / max(h, w) if spacing is None else spacing
    span = np.maximum(0.9 * vol_n - sp * np.array([w, h]), 0.0) / 2
    ofs = np.tile(np.eye(4), (n, 1, 1))
    ofs[:, 0, 0] = ofs[:, 1, 1] = sp
    ofs[:, 2, 2] = 0.5
    ofs[:, :2, 3] = (-sp * (np.array([w, h]) - 1) / 2
                     + rng.uniform(-span, span, (n, 2)))
    ofs[:, 2, 3] = rng.uniform(-vol_n / 3, vol_n / 3, n)
    truth = np.concatenate([rng.uniform(-3, 3, (n, 3)),
                            rng.uniform(-10, 10, (n, 3))], 1)
    params = truth + np.concatenate([rng.uniform(-2, 2, (n, 3)),
                                     rng.uniform(-4, 4, (n, 3))], 1)
    params[1 % n, 0] += 1000.0
    params[2 % n, 0] += vol_n / 2.0

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    volt, w2it, ofst = t(vol), t(w2i), t(ofs)
    gen = s2v.generate_slices(volt, w2it, t(truth), ofst, (h, w), 0)
    noisy = gen + t(rng.normal(0, 2.0, (n, h, w)))
    yy, xx = np.mgrid[:h, :w]
    disc = t(((yy - h / 2) / h) ** 2 + ((xx - w / 2) / w) ** 2
             <= 0.45 ** 2) > 0
    tgt = torch.where(disc & (noisy >= 0), torch.clamp(noisy, min=0), -1.0)
    tgt[0] = -1.0
    tgt = s2v.reg_blur(tgt, sigma_pix)
    mean, _ = s2v._masked_mean(tgt)
    return dict(vol=volt, w2i=w2it, ofs=ofst, tgt=tgt, mean=mean,
                params=t(params))


def reg_cost_fns(case, sigma_pix, level=0, dtype="bf16"):
    """(fused, torch path) cost functions of a reg_cost_case; on the card
    the first is the kernel pair, the second its plain version."""
    from fetalreconstruction_tpu_torch.register import slice2vol as s2v

    cfg = s2v.SliceRegConfig(table_dtype=dtype)
    args = (case["w2i"], case["ofs"], case["tgt"], case["mean"],
            tuple(case["tgt"].shape[1:]), level, sigma_pix)
    fused = s2v.make_cost_fn(cfg, case["vol"], *args)
    plain = s2v.make_cost_fn(
        cfg, None, *args, psf_table=s2v.make_reg_table(case["vol"], dtype),
        vol_shape=tuple(case["vol"].shape))
    return fused, plain


def reg_cost_bound(n, hw, sigma_pix, n_ofs, vol_bytes):
    """The fused cost's least time on this card for one call: the larger of
    its bytes (targets, volume, params and maps read once, the strips'
    moments written and read, the output written) over the memory rate and
    its float32 operations over the non-tensor-core peak.  Operations a
    pixel and offset: 15 for the raster, 14 for the floors and weights'
    factors, 16 for the 8 weights, 16 for the corner products and sums,
    4r + 2 for each blur pass, 8 for the moments."""
    from fetalreconstruction_tpu_torch.register.slice2vol import (
        _gauss_kernel_taps)
    r = (len(_gauss_kernel_taps(sigma_pix)) - 1) // 2 if sigma_pix > 0 \
        else 0
    px = n * hw * hw * n_ofs
    ops = px * (15 + 14 + 16 + 16 + 2 * (4 * r + 2) + 8)
    nbytes = (n * hw * hw * 4 + vol_bytes + n * (6 + 16 + 1) * 4
              + 2 * n * n_ofs * 8 * 8 + n * 4)
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations")


def reg_cost_kernel(dev, card):
    """Phase 3b: the fused registration cost (csrc/register.cu) against
    its plain version, the torch path, at the recon cells' shapes
    (REG_COST_SHAPES, a 169^3 volume): max|diff| within REG_COST_TOL, two
    calls bitwise equal, exactly 2 kernels a call, then each timed alone
    (the kernel pair's card time, CUDA events) beside its bound.  Returns
    one record a shape."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = []
    for label, n, hw, sigma in REG_COST_SHAPES:
        case = reg_cost_case(dev, n, hw, sigma, vol_n=169, spacing=1.0)
        fused, plain = reg_cost_fns(case, sigma)
        got, ref = fused(case["params"]), plain(case["params"])
        err = float((got - ref).abs().max())
        same = torch.equal(got, fused(case["params"]))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fused(case["params"])
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        ms = time_ms(lambda: fused(case["params"]))
        plain_ms = time_ms(lambda: plain(case["params"]))
        bound = reg_cost_bound(n, hw, sigma, 3,
                               case["vol"].numel() * 2)
        rec = dict(shape=label, units=n, hw=hw, sigma_pix=sigma,
                   max_abs_err=err, bitwise_repeat=same,
                   kernels_per_call=len(kernels), ms=ms, plain_ms=plain_ms,
                   **bound)
        print(f"reg_ncc_cost {label} ({n} x {hw}^2, sigma {sigma} px): "
              f"{ms:.3f} ms vs torch path {plain_ms:.3f} ms, bound "
              f"{bound['bound_ms']:.4f} ms by {bound['bound_by']} "
              f"({bound['bound_ms'] / ms:.1%} of it reached); max|diff| "
              f"{err:.3e} (limit {REG_COST_TOL:.0e}), repeat bitwise "
              f"{same}, {len(kernels)} kernels a call {sorted(kernels)} "
              f"[{card}]", flush=True)
        if not (err <= REG_COST_TOL and same and len(kernels) == 2):
            raise RuntimeError(f"reg_ncc_cost at {label}: {rec}")
        out.append(rec)
        del case, fused, plain, got, ref
        torch.cuda.empty_cache()
    return out


def bench_run(card, e2e_psnr):
    """Phase 15: the port's bench whole, as a subprocess (BENCH_ITERS
    timed inner iterations, BENCH_E2E_RUNS end-to-end runs); prints its
    last line and fails unless it exits 0 with value > 0, splat2_dense
    launched in every inner iteration and a PSNR within MESH_PSNR_GAP of
    phase 7's.  Returns the kernel's launches in its timed loop and end
    to end."""
    from pathlib import Path
    cmd = [sys.executable, "-m", "fetalreconstruction_tpu_torch.bench",
           "--iters", str(BENCH_ITERS), "--e2e-runs", str(BENCH_E2E_RUNS)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=Path(__file__).resolve().parent,
                         capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-4000:], flush=True)
        raise RuntimeError(f"the bench exited {res.returncode}")
    row = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"15 bench, {wall:.1f} s as a subprocess [{card}]; its last line: "
          f"{json.dumps(row)}", flush=True)
    per_it = row["splat2_dense_launches_per_iteration"]
    if not (row["value"] > 0 and per_it >= 1):
        raise RuntimeError(f"the bench gave value {row['value']} with "
                           f"{per_it} splat2_dense launches an iteration")
    if not abs(row["psnr_db"] - e2e_psnr) <= MESH_PSNR_GAP:
        raise RuntimeError(f"the bench's PSNR {row['psnr_db']:.3f} dB is "
                           f"not within {MESH_PSNR_GAP} of phase 7's "
                           f"{e2e_psnr:.3f}")
    return {"splat2_dense": round(per_it * row["inner_iters"])
            + row["e2e_splat2_dense_launches"]}


def kernel_bound(plan, pay, dense):
    """splat2_dense's least time on this card for this call: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its float32 operations over the non-tensor-core peak.
    It reads the plan (pix, wts, cell_ptr) and the two payloads at its
    slots, and writes the dense volumes; one multiply and one add per
    slot, corner and payload, and 8 adds per output value (the run
    totals)."""
    n_slots = plan.pix.numel()
    nbytes = (plan.pix.numel() * plan.pix.element_size()
              + plan.wts.numel() * plan.wts.element_size()
              + plan.cell_ptr.numel() * plan.cell_ptr.element_size()
              + 2 * n_slots * pay.element_size()
              + dense.numel() * dense.element_size())
    ops = n_slots * 8 * 2 * 2 + dense.numel() * 8
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return dict(bound_ms=max(t_b, t_o) * 1e3,
                bound_by="bytes" if t_b >= t_o else "operations"), nbytes


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

    # ---- 3. the kernel vs its plain version at the canonical shape
    geom, sume = svr_core.build_geometry(
        ctx, prob.recon_w2i, prob.transforms, prob.slice_i2w, prob.valid,
        prob.mask_flat, stack_id=prob.stack_id)
    plan = geom.plan
    pos = sume > 0
    inv = torch.where(pos, 1.0 / torch.where(pos, sume, 1.0), 0.0)
    pa = (prob.slices * inv).contiguous()
    pb = (pos * inv).contiguous()
    runs = plan.cell_ptr.diff()
    print(f"plan: {plan.pix.numel()} in-support pixels of "
          f"{prob.slices.numel()} in {runs.numel()} floor cells "
          f"({int((runs > 0).sum())} non-empty, longest run "
          f"{int(runs.max())}); no accumulator", flush=True)
    del runs
    dense_k = scatter.splat2_dense(plan, pa, pb)
    dense_p = scatter.splat2_dense_plain(plan.xp, pa, pb, vs, plan.sid, S)
    torch.cuda.synchronize()
    k_err = float((dense_k - dense_p).abs().max())
    k_lim = KERNEL_TOL * float(dense_p.abs().max())
    print(f"splat2_dense vs plain: max|diff| {k_err:.3e} "
          f"(limit {k_lim:.3e}; bitwise equal: "
          f"{torch.equal(dense_k, dense_p)})", flush=True)
    if not k_err <= k_lim:
        raise RuntimeError("splat2_dense disagrees with its plain version")
    again = scatter.splat2_dense(plan, pa, pb)
    torch.cuda.synchronize()
    if not torch.equal(again, dense_k):
        raise RuntimeError("two splat2_dense runs differ")
    print("determinism: two splat2_dense runs bitwise equal", flush=True)
    k_ms = time_ms(lambda: scatter.splat2_dense(plan, pa, pb))
    plain_ms = time_ms(lambda: scatter.splat2_dense_plain(
        plan.xp, pa, pb, vs, plan.sid, S))
    lib = plan_splat_plain(plan)
    lib_err = float((lib(pa, pb) - dense_p).abs().max())
    if not lib_err <= k_lim:
        raise RuntimeError("the plan's index_add_ disagrees with the plain "
                           "version")
    lib_ms = time_ms(lambda: lib(pa, pb))
    print(f"splat2_dense {k_ms:.3f} ms vs plain {plain_ms:.3f} ms "
          f"(index_add_ of the plan's slots into the dense volumes "
          f"{lib_ms:.3f} ms, max|diff| {lib_err:.3e}) [{card}]", flush=True)
    k_bound, k_bytes = kernel_bound(plan, pa, dense_p)
    print(f"splat2_dense bound {k_bound['bound_ms']:.3f} ms by "
          f"{k_bound['bound_by']}, {k_bytes / 1e6:.1f} MB "
          f"({k_bound['bound_ms'] / k_ms:.1%} of it reached; HBM "
          f"{HBM_BYTES_PER_S / 1e12} TB/s, f32 {F32_OPS_PER_S / 1e12} "
          f"TFLOP/s) [{card}]", flush=True)
    del dense_k, dense_p, again, geom, sume, plan, lib
    torch.cuda.empty_cache()
    reg_recs = reg_cost_kernel(dev, card)

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
    with plain_path():
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
    # 10. the exact engine; 11. --manualMask, --bspline and recon-eval;
    # 12. slice-parallel ranks (12e: PVR); 13. the z-slab modes; 14. the
    # remaining run_svr options
    launches, e2e_volume, e2e_seconds, e2e_psnr = end_to_end(dev, card)
    counts = [pvr_end_to_end(dev, card), bias_end_to_end(dev, card),
              exact_end_to_end(dev, card),
              features_end_to_end(dev, card, e2e_volume)]
    mesh_launches, one_rank = multi_rank(dev, card, e2e_volume, e2e_seconds)
    counts += [mesh_launches, pvr_multi_rank(dev, card),
               slab_modes(dev, card, e2e_volume, one_rank),
               options_end_to_end(dev, card)]
    del e2e_volume, one_rank
    torch.cuda.empty_cache()
    # ---- 15. the port's bench, whole
    counts.append(bench_run(card, e2e_psnr))
    for phase_counts in counts:
        for k, v in phase_counts.items():
            launches[k] += v
    print(f"launches over phases 7-15: {launches}", flush=True)
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")

    tpu = "fetalreconstruction_tpu/ops/pallas_scatter.py"
    rec = dict(name="splat2_dense", route="cuda",
               source="fetalreconstruction_tpu_torch/csrc/scatter.cu",
               replaces=f"{tpu}:256, {tpu}:368",
               launches=launches["splat2_dense"], max_abs_err=k_err,
               ms=k_ms, plain_ms=plain_ms, **k_bound, library_ms=lib_ms)
    reg = dict(name="reg_ncc_cost", route="cuda",
               source="fetalreconstruction_tpu_torch/csrc/register.cu",
               replaces="none (slice2vol.make_cost_fn's torch path)",
               launches=launches["reg_ncc_cost"], shapes=reg_recs)
    print(f"whole script: {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": [rec, reg]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
