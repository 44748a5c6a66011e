"""The port's bench (fetalreconstruction_tpu_torch/bench.py) against the
JAX package's bench.py, and its command line, at --size small on the CPU.

Parity: bench.py's build_problem (its main is not called: it configures a
compile cache) and the port's build_problem at the small size give the
same slices, identity transforms, PSF taps and geometry; the warm-up plus
2 inner iterations with bench.py's arguments, through the JAX package's
svr_core and through the bench's own setup / iterate, agree within 1e-4
relative to max|ref| for recon, sim, weights and slice_weight and relative
for the EM scalars (tests/test_torch_svr_core.py's limit for
inner_iteration: f32 sums in another order over the sequence).  The JAX
side runs on the CPU as its own tests run it, the fast engine's XLA path.
"""
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu_torch import bench as tbench
from fetalreconstruction_tpu_torch.core.image import Image
from fetalreconstruction_tpu_torch.pipeline import synthetic
from fetalreconstruction_tpu_torch.utils.perfstats import PerfStats

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import bench as jbench  # noqa: E402

TOL = 1e-4
ITERATIONS = 1 + 2  # the warm-up and two timed ones
SMALL = dict(n_stacks=2, stack_slices=12, hw=64, vol=64)
JAX_KEYS = ("metric", "value", "unit", "vs_baseline")
E2E_KEYS = ("e2e_minutes", "e2e_iterations", "e2e_n_slices",
            "slices_per_s", "registration_s_per_round")


def _run_jax(ctx, p):
    """bench.py:115-158 at the small size, ITERATIONS inner iterations."""
    em = jcore.init_em_state(p["n"], p["valid"])
    recon, wts, _ = jcore.gaussian_reconstruction(
        ctx, p["geom"], p["sume"], p["slices"], p["valid"], em.bias,
        em.scale, p["mask_flat"])
    sim = jcore.simulate(ctx, p["geom"], p["sume"], recon, p["mask_flat"])
    excluded = jnp.zeros((p["n"],), bool)
    em = jcore.initialize_robust_statistics(
        ctx, p["slices"], p["valid"], sim, em, 700.0, 100.0, excluded)
    mask = p["mask_flat"].reshape(tuple(ctx.vol_shape))
    for _ in range(ITERATIONS):
        em, sim, recon = jcore.inner_iteration(
            ctx, p["geom"], p["sume"], p["slices"], p["valid"], em, sim,
            recon, wts, mask, p["mask_flat"], excluded, 1.0, 450.0, 100.0,
            700.0, 2, do_bias=False, do_scale=True, do_normalise_bias=False)
    return dict(em=em, sim=sim, recon=recon)


@pytest.fixture(scope="module")
def both():
    old = os.environ.pop("BENCH_ENGINE", None)
    try:
        jctx, jp = jbench.build_problem(**SMALL)
    finally:
        if old is not None:
            os.environ["BENCH_ENGINE"] = old
    ctx, p = tbench.build_problem(torch.device("cpu"), "small")
    problems = (jctx, jp), (ctx, p)
    st = tbench.setup(ctx, p)
    for _ in range(ITERATIONS):
        tbench.iterate(ctx, p, st)
    return problems, _run_jax(jctx, jp), st


def _close(out, ref, tol=TOL):
    out = np.asarray(out, np.float64)
    ref = np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err <= tol, err


def test_problem_matches_jax_bench(both):
    (jctx, jp), (ctx, p) = both[0]
    assert p["n"] == jp["n"] == 24
    assert tuple(ctx.vol_shape) == tuple(jctx.vol_shape) == (64, 64, 64)
    np.testing.assert_array_equal(p["slices"].numpy(),
                                  np.asarray(jp["slices"]))
    np.testing.assert_array_equal(p["valid"].numpy(), np.asarray(jp["valid"]))
    # bench.py:77's transforms: identity for every slice
    prob = synthetic.canonical_problem(torch.device("cpu"), **SMALL)
    np.testing.assert_array_equal(prob.transforms.numpy(),
                                  np.tile(np.eye(4, dtype=np.float32),
                                          (24, 1, 1)))
    assert ctx.fast.support == jctx.fast.support
    assert ctx.fast.ranges == jctx.fast.ranges
    for tt, jt in zip(ctx.fast.terms, jctx.fast.terms):
        assert len(tt) == len(jt)
        for a, b in zip(tt, jt):
            for u, v in zip(a, b):
                # float32 taps of the same decomposition, the last bits
                # rounded apart
                _close(u, v, 1e-6)
    _close(p["geom"].xp.numpy(), jp["geom"].xp, 1e-6)
    _close(p["sume"].numpy(), jp["sume"], 1e-5)


@pytest.mark.parametrize("name", ["recon", "sim", "weights", "slice_weight",
                                  "sigma2", "mix", "m"])
def test_inner_iterations_match_jax(both, name):
    _, ref, st = both
    if name == "recon":
        out, r = st["recon"], ref["recon"]
    elif name == "sim":
        out, r = st["sim"].sim, ref["sim"].sim
    else:
        out, r = getattr(st["em"], name), getattr(ref["em"], name)
    assert bool(torch.isfinite(out).all())
    _close(out.numpy(), r)
    if name == "recon":
        assert float(out.std()) > 0


def _bench(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "fetalreconstruction_tpu_torch.bench", *args],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)


def test_cli_small_on_cpu():
    res = _bench("--device", "cpu", "--size", "small", "--iters", "2")
    assert res.returncode == 0, res.stderr
    row = json.loads(res.stdout.strip().splitlines()[-1])
    assert all(k in row for k in JAX_KEYS), row
    assert row["metric"] == "svr_em_sr_inner_iterations_per_s"
    assert row["unit"] == "iterations/s"
    assert row["value"] > 0
    assert row["inner_iters"] == 2
    assert row["inner_ms_min"] <= row["inner_ms_median"] <= row["inner_ms_max"]
    assert abs(row["value"] * row["inner_ms_median"] - 1e3) < 1e-6
    # the small size runs no end-to-end part, and no e2e_error key exists
    assert not [k for k in row if k.startswith("e2e") or k in E2E_KEYS]


def test_cli_refuses_a_machine_without_cuda():
    # hide any card, so the claim is tested on every machine
    res = _bench("--size", "small", "--iters", "1",
                 env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0
    assert "--device cpu" in res.stderr
    assert "metric" not in res.stdout


_MOTION_PROBLEM = synthetic.motion_problem


def _tiny_motion_problem(seed):
    return _MOTION_PROBLEM(seed, n_stacks=2, hw=16, gn=24)


@pytest.mark.parametrize("failure", ["run-raises", "psnr-under-floor"])
def test_e2e_failure_ends_the_run(monkeypatch, failure):
    """An end-to-end run that raises, or whose volume falls under the
    PSNR floor, ends the bench: no error key, no result line."""
    truth, _, _ = _tiny_motion_problem(0)

    def run_svr(cfg, stacks, mask, device):
        if failure == "run-raises":
            raise RuntimeError("registration failed")
        stats = PerfStats()
        stats.sample("registration")
        return SimpleNamespace(
            reconstructed=Image(np.zeros_like(truth.data), truth.attr),
            stats=stats, slice_weights=np.ones(4))

    monkeypatch.setattr(synthetic, "motion_problem", _tiny_motion_problem)
    monkeypatch.setattr(tbench.svr, "run_svr", run_svr)
    with pytest.raises(RuntimeError,
                       match="registration failed|under 23.5"):
        tbench.run_e2e(torch.device("cpu"), 1)
