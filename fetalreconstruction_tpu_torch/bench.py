"""Benchmark of the port: SVR EM/SR inner-iteration throughput and SVR end
to end, on one GPU.

    python -m fetalreconstruction_tpu_torch.bench [--size full|small]
        [--engine fast|exact] [--iters N] [--e2e-runs N] [--no-e2e]
        [--device cuda|cpu]

The counterpart of the JAX package's bench.py, with flags for its
environment variables (--size small for BENCH_SIZE=small, --engine exact
for BENCH_ENGINE=exact, --iters for BENCH_ITERS, --no-e2e for BENCH_E2E=0).

Inner loop: the canonical problem (pipeline/synthetic.canonical_problem:
4 stacks x 42 slices of 144^2 at 1.25 mm in-plane and 5 mm thick,
reconstructed at 1.0 mm on a 160^3 grid; --size small: 2 x 12 slices of
64^2 on a 64^3 grid), its geometry, then init_em_state,
gaussian_reconstruction, simulate and initialize_robust_statistics; one
iteration is svr_core.inner_iteration (scale, SR scatter + regularise,
simulate, M-step, E-step).  One warm-up iteration, then --iters timed ones,
each synchronised, so each has its own wall time; on the card
torch.profiler sums the kernels' device time over the timed loop.

End to end (full size only): run_svr on synthetic.motion_problem(0) (4
stacks x 33 slices of 144^2 with per-slice motion, ~160^3 at 1 mm) at 3
outer iterations of 4 inner ones, --e2e-runs times, without the
plain-version checks of chip_smoke.py.

Runs on cuda:0 unless --device cpu is given; a machine without a CUDA
device is refused.  Prints the card's name and power limit and each end to
end run's per-phase table; the last line is ONE JSON object with the JAX
bench's keys (metric, value, unit, vs_baseline; e2e_minutes,
e2e_iterations, e2e_n_slices, slices_per_s, registration_s_per_round) and
the inner loop's spread, device time and idle share, the kernel's
launches, the runs' spread, PSNR and peak memory.  There is no fallback:
an end-to-end failure, a kernel that never launched on the card or a PSNR
under MIN_PSNR ends the run with a non-zero exit.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from .ops import scatter
from .pipeline import svr, svr_core, synthetic

# the anchor of vs_baseline: this bench's first median at the canonical
# size on the card, 38.292 ms an iteration (nvidia-smi: "NVIDIA H100 80GB
# HBM3, 700.00 W")
BASELINE_ITERS_PER_S = 26.11514
SIZES = {"full": {},
         "small": dict(n_stacks=2, stack_slices=12, hw=64, vol=64)}
# inner_iteration's arguments in the JAX bench (bench.py:135-139)
ALPHA, LAM, SR_ITERATION = 1.0, 450.0, 2
MAX_INTENSITY, MIN_INTENSITY = 700.0, 100.0
E2E_ITERATIONS = 3
MIN_PSNR = 23.5  # dB, chip_smoke.E2E_MIN_PSNR; the H100 gives 23.842


def build_problem(device, size: str = "full", engine: str = "fast"):
    """The canonical problem and its geometry, as bench.py:33-85 builds
    them (no stack_id: the fast engine derives it from its ranges)."""
    prob = synthetic.canonical_problem(device, engine=engine, **SIZES[size])
    geom, sume = svr_core.build_geometry(
        prob.ctx, prob.recon_w2i, prob.transforms, prob.slice_i2w,
        prob.valid, prob.mask_flat, slice_dims=prob.slice_dims)
    return prob.ctx, dict(slices=prob.slices, valid=prob.valid, geom=geom,
                          sume=sume, mask_flat=prob.mask_flat,
                          n=prob.slices.shape[0])


def setup(ctx, p):
    """The state the inner loop starts from (bench.py:115-126)."""
    em = svr_core.init_em_state(p["n"], p["valid"])
    recon, wts, _ = svr_core.gaussian_reconstruction(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em.bias,
        em.scale, p["mask_flat"])
    sim = svr_core.simulate(ctx, p["geom"], p["sume"], recon, p["mask_flat"])
    excluded = torch.zeros(p["n"], dtype=torch.bool,
                           device=p["slices"].device)
    em = svr_core.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], sim, em, MAX_INTENSITY, MIN_INTENSITY,
        excluded)
    return dict(em=em, sim=sim, recon=recon, wts=wts, excluded=excluded,
                mask=p["mask_flat"].reshape(ctx.vol_shape))


def iterate(ctx, p, st):
    """One inner SR/EM iteration on st, in place (bench.py:133-139)."""
    st["em"], st["sim"], st["recon"] = svr_core.inner_iteration(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], st["em"],
        st["sim"], st["recon"], st["wts"], st["mask"], p["mask_flat"],
        st["excluded"], ALPHA, LAM, MIN_INTENSITY, MAX_INTENSITY,
        SR_ITERATION, do_bias=False, do_scale=True, do_normalise_bias=False)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def time_inner(ctx, p, st, iters: int, dev):
    """One warm-up iteration, then `iters` timed ones, each synchronised;
    on the card under torch.profiler (CUDA activity only), whose kernel
    time over the loop gives the device time and idle share.  On the card
    the fast engine must launch splat2_dense in every iteration."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    iterate(ctx, p, st)
    _sync(dev)
    cuda = dev.type == "cuda"
    prof = (profile(activities=[ProfilerActivity.CUDA]) if cuda
            else contextlib.nullcontext())
    scatter.reset_launch_counts()
    times, launches = [], []
    with prof:
        for _ in range(iters):
            t0 = time.perf_counter()
            iterate(ctx, p, st)
            _sync(dev)
            times.append(time.perf_counter() - t0)
            launches.append(scatter.LAUNCHES["splat2_dense"]
                            - sum(launches))
    if cuda and ctx.fast is not None and min(launches) < 1:
        raise RuntimeError(f"splat2_dense launches by iteration: {launches}")
    wall_ms = sum(times) * 1e3
    med = float(np.median(times))
    out = dict(value=1.0 / med, inner_ms_median=med * 1e3,
               inner_ms_min=min(times) * 1e3, inner_ms_max=max(times) * 1e3,
               inner_device_ms=None, device_idle_share=None,
               splat2_dense_launches_per_iteration=sum(launches) / iters)
    if cuda:
        dev_ms = sum(e.self_device_time_total for e in prof.events()
                     if e.device_type == DeviceType.CUDA) / 1e3
        if not dev_ms > 0:
            raise RuntimeError("the profiler recorded no device time")
        out.update(inner_device_ms=dev_ms / iters,
                   device_idle_share=1.0 - dev_ms / wall_ms)
    for k in ("recon", "sim"):
        v = st[k] if k == "recon" else st[k].sim
        if not bool(torch.isfinite(v).all()):
            raise RuntimeError(f"the inner loop's {k} is not finite")
    return out


def run_e2e(dev, runs: int):
    """run_svr on motion_problem(0) at bench.py:186-188's config, `runs`
    times (bench.py:173-201); each run's per-phase table printed, its
    volume checked finite and held to MIN_PSNR, and on the card
    splat2_dense launched in it."""
    truth, mask, stacks = synthetic.motion_problem(0)
    cfg = svr.SVRConfig(iterations=E2E_ITERATIONS, resolution=1.0,
                        rec_iterations_first=4, rec_iterations_last=4,
                        no_log=True)
    cuda = dev.type == "cuda"
    seconds, psnrs, peaks, reg, launches = [], [], [], [], 0
    for r in range(runs):
        if cuda:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        scatter.reset_launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        res = svr.run_svr(cfg, stacks=stacks, mask=mask, device=dev)
        _sync(dev)
        seconds.append(time.perf_counter() - t0)
        launches += scatter.LAUNCHES["splat2_dense"]
        if cuda:
            peaks.append(torch.cuda.max_memory_allocated(dev) / 2 ** 30)
            if not scatter.LAUNCHES["splat2_dense"] > 0:
                raise RuntimeError(f"e2e run {r + 1}: splat2_dense was "
                                   "not launched")
        vol = res.reconstructed
        if not np.isfinite(vol.data).all():
            raise RuntimeError(f"e2e run {r + 1}: the volume is not finite")
        psnrs.append(synthetic.psnr_vs_truth(vol, truth, device=dev))
        reg += res.stats.samples("registration")
        print(f"e2e run {r + 1}/{runs}: {seconds[-1]:.3f} s, PSNR "
              f"{psnrs[-1]:.3f} dB; per-phase table, s:\n"
              f"{res.stats.table()}", flush=True)
        if not psnrs[-1] >= MIN_PSNR:
            raise RuntimeError(f"e2e run {r + 1}: PSNR {psnrs[-1]:.3f} dB "
                               f"is under {MIN_PSNR}")
    n = len(res.slice_weights)
    out = dict(e2e_minutes=float(np.median(seconds)) / 60.0,
               e2e_s_min=min(seconds), e2e_s_max=max(seconds),
               e2e_runs=runs, e2e_iterations=E2E_ITERATIONS,
               e2e_n_slices=n, psnr_db=min(psnrs),
               peak_memory_gib=max(peaks) if peaks else None,
               e2e_splat2_dense_launches=launches)
    if reg:
        out.update(slices_per_s=n * len(reg) / sum(reg),
                   registration_s_per_round=sum(reg) / len(reg))
    return out


def card_line() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def build_parser():
    ap = argparse.ArgumentParser(
        prog="python -m fetalreconstruction_tpu_torch.bench",
        description="SVR inner-iteration throughput and SVR end to end on "
                    "one GPU; the last line is one JSON object.")
    ap.add_argument("--size", choices=sorted(SIZES), default="full")
    ap.add_argument("--engine", choices=("fast", "exact"), default="fast")
    ap.add_argument("--iters", type=int, default=10,
                    help="timed inner iterations after one warm-up")
    ap.add_argument("--e2e-runs", type=int, default=3)
    ap.add_argument("--no-e2e", action="store_true",
                    help="skip the end-to-end runs")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.iters < 1 or args.e2e_runs < 1:
        raise SystemExit("bench: --iters and --e2e-runs must be >= 1")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device: the bench runs on a GPU "
                         "(pass --device cpu to run on the CPU)")
    dev = (torch.device("cuda", 0) if args.device == "cuda"
           else torch.device("cpu"))
    card = None
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False  # full f32 matmuls
        torch.backends.cudnn.allow_tf32 = False
        card = card_line()
        print(card, flush=True)
    print(f"device: {dev}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; size {args.size}, engine {args.engine}",
          flush=True)

    ctx, p = build_problem(dev, args.size, args.engine)
    st = setup(ctx, p)
    inner = time_inner(ctx, p, st, args.iters, dev)
    value = inner.pop("value")
    row = dict(metric="svr_em_sr_inner_iterations_per_s", value=value,
               unit="iterations/s", vs_baseline=value / BASELINE_ITERS_PER_S,
               card=card, size=args.size, engine=args.engine,
               inner_iters=args.iters, **inner)
    print(f"inner iteration: median {row['inner_ms_median']:.3f} ms over "
          f"{args.iters} (min {row['inner_ms_min']:.3f}, max "
          f"{row['inner_ms_max']:.3f}); device {row['inner_device_ms']} ms, "
          f"idle share {row['device_idle_share']}", flush=True)
    del ctx, p, st
    if not args.no_e2e and args.size != "small":
        row.update(run_e2e(dev, args.e2e_runs))
    print(json.dumps(row))


if __name__ == "__main__":
    main()
