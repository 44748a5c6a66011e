"""The port's slice-parallel stages at world size 2 vs the JAX package's.

test_sharded.py's problem (phantom n=20 at 2.4 mm, two noisy stacks,
slices padded to a multiple of the world size) through the JAX package's
`sharded_*` stages on a 2-device slice of the 8-device CPU mesh that
conftest.py provides, and through the port's svr_core stages on two gloo
ranks (parallel/sharded.spawn, one CPU process per rank, each with its
block of slices and a `group`): build_geometry, gaussian_reconstruction,
simulate, initialize_robust_statistics, estep and one inner_iteration
(bias, scale and, on the fast engine, normalise-bias steps), on both PSF
engines.  Limits are test_sharded.py's (:189-224): sume 1e-4, the
Gaussian reconstruction and simulate 1e-3, voxel counts exact, sigma2
1e-4 / 1e-3 relative, voxel weights 1e-4, the volume after the inner
iteration 2e-2 and slice weights 1e-3, all absolute unless relative.

The JAX package's exact-engine normalise-bias step sums no partial fields
under a mesh (svr_core.py:293-296 passes no axis_name), so there the port
is held against its own single-rank run instead.  Slice registration
under the mesh (test_sharded.py's motion problem, "coord-scan") is held
against single-device registration at test_sharded.py's limits.  Every
rank must hold the same volumes, bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.ops import psf as psf_ops
from fetalreconstruction_tpu.ops import psf_fast as jpf
from fetalreconstruction_tpu.ops.sampling import resample_to_grid
from fetalreconstruction_tpu.parallel import sharded as jsharded
from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu.register.prepare import \
    prepare_registration_slices
from fetalreconstruction_tpu.sr.superresolution import smoothing_parameters
from fetalreconstruction_tpu_torch.parallel import sharded
from fetalreconstruction_tpu_torch.register import slice2vol as s2v

from phantom import make_ground_truth, mask_slices, recon_mask, \
    simulate_stacks
from torch_sharded_ranks import failing_rank, run_stages, stage_rank
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
SIGMA_BIAS = 12.0
# stage -> [(field, tolerance, relative?)]
STAGES = {
    "build_geometry": [("sume", 1e-4, False)],
    "gaussian_reconstruction": [("recon", 1e-3, False),
                                ("wts", 1e-3, False), ("vc", 0.0, False)],
    "simulate": [("sim", 1e-3, False)],
    "initialize_robust_statistics": [("sigma2_0", 1e-4, True)],
    "estep": [("weights", 1e-4, False)],
    "inner_iteration": [("recon2", 2e-2, False),
                        ("slice_weight2", 1e-3, False),
                        ("sigma2_2", 1e-3, True)],
}
PER_SLICE = {"sume", "vc", "sim", "weights", "slice_weight2", "sim2"}


def _stage_problem():
    gt = make_ground_truth(n=20, spacing=2.4)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.5, dz=4.0,
                                noise=1.0)
    batch = mask_slices(create_slices(stacks, [8.0, 8.0]))
    n0 = batch.n_slices
    batch, _ = sharded.pad_batch(batch, np.tile(np.eye(4), (n0, 1, 1)),
                                 WORLD)
    n = batch.n_slices
    ra = gt.attr
    support = psf_ops.reference_support(batch.dims[:n0], ra.dx, 1.0, 10)
    fast = jpf.FastPSF.from_batch(batch, ra.w2i(), support)
    alpha, lam = smoothing_parameters(150.0, 0.02)
    pos = batch.data[batch.data > 0]
    return fast, dict(
        slices=batch.data, valid=batch.data != -1.0,
        i2w=batch.i2w.astype(np.float32),
        dims=batch.dims.astype(np.float32),
        stack_id=batch.stack_index.astype(np.int32),
        transforms=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
        w2i=ra.w2i().astype(np.float32),
        mask_flat=np.asarray(recon_mask(gt), np.float32).reshape(-1),
        vol_shape=np.asarray(ra.shape_zyx),
        vol_spacing=np.asarray((ra.dx, ra.dy, ra.dz)),
        offsets=psf_ops.make_offsets(support), terms=fast.terms,
        ranges=fast.ranges, support=fast.support, sigma_bias=SIGMA_BIAS,
        mx=float(pos.max()), mn=float(pos.min()), alpha=float(alpha),
        lam=float(lam))


def _jax_stages(p, fast, engine, mesh):
    """The JAX package's sharded stages on the problem (global arrays)."""
    ra_shape = tuple(int(v) for v in p["vol_shape"])
    ctx = jcore.SVRContext(
        vol_shape=ra_shape, vol_spacing=tuple(p["vol_spacing"]),
        offsets=p["offsets"], slice_spacing_xy=(2.5, 2.5),
        sigma_bias=SIGMA_BIAS, disable_bias=engine == "exact",
        fast=fast if engine == "fast" else None)
    n = p["slices"].shape[0]
    slices, valid = jnp.asarray(p["slices"]), jnp.asarray(p["valid"])
    mask_flat = jnp.asarray(p["mask_flat"])
    geom, sume = jsharded.sharded_build_geometry(ctx, mesh)(
        jnp.asarray(p["w2i"]), jnp.asarray(p["transforms"]),
        jnp.asarray(p["i2w"]), jnp.asarray(p["dims"]), valid, mask_flat,
        jnp.asarray(p["stack_id"]))
    em = jcore.init_em_state(n, valid)
    recon, wts, vc = jsharded.sharded_gaussian_reconstruction(ctx, mesh)(
        slices, valid, geom, sume, em.bias, em.scale, mask_flat)
    sim = jsharded.sharded_simulate(ctx, mesh)(geom, sume, recon, mask_flat)
    excluded = jnp.zeros((n,), bool)
    em0 = jsharded.sharded_initialize_robust_statistics(ctx, mesh)(
        slices, valid, sim, em, jnp.float32(p["mx"]), jnp.float32(p["mn"]),
        excluded)
    em1, _ = jsharded.sharded_estep(ctx, mesh)(slices, valid, sume, sim,
                                               em0, excluded)
    em2, sim2, recon2 = jsharded.sharded_inner_iteration(
        ctx, mesh, do_bias=True, do_scale=True,
        do_normalise_bias=engine == "fast", donate=False)(
        geom, sume, slices, valid, em1, sim, recon, wts,
        mask_flat.reshape(ra_shape), mask_flat, excluded,
        jnp.float32(p["alpha"]), jnp.float32(p["lam"]),
        jnp.float32(p["mn"]), jnp.float32(p["mx"]), jnp.int32(1))
    out = dict(sume=sume, recon=recon, wts=wts, vc=vc, sim=sim.sim,
               sigma2_0=em0.sigma2, weights=em1.weights, recon2=recon2,
               slice_weight2=em2.slice_weight, sigma2_2=em2.sigma2,
               sim2=sim2.sim)
    return {k: np.asarray(v) for k, v in out.items()}


def _reg_problem():
    """test_sharded.py's registration problem: per-slice motion, the true
    volume as the target."""
    gt = make_ground_truth(n=24, spacing=1.8)
    rng = np.random.default_rng(5)
    nz = int(24 * 1.8 / 3.0)
    motions = np.zeros((nz, 6))
    motions[::2, :3] = rng.uniform(-1.5, 1.5, (len(motions[::2]), 3))
    motions[::2, 3:] = rng.uniform(-2.0, 2.0, (len(motions[::2]), 3))
    stacks, _ = simulate_stacks(gt, n_stacks=1, in_plane=2.0, dz=3.0,
                                noise=0.5, slice_motions=[motions])
    batch = create_slices(stacks, [6.0])
    n0 = batch.n_slices
    batch, _ = sharded.pad_batch(batch, np.tile(np.eye(4), (n0, 1, 1)),
                                 WORLD)
    ra = gt.attr.with_spacing(1.8, 1.8, 1.8)
    recon = resample_to_grid(
        jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
        ra.shape_zyx, jnp.asarray(ra.i2w(), jnp.float32), interp="linear",
        padding=0.0)
    targets, mo, ofs = prepare_registration_slices(batch, ra.dx)
    n = batch.n_slices
    return dict(recon=np.asarray(recon), w2i=ra.w2i().astype(np.float32),
                t0=np.tile(np.eye(4, dtype=np.float32), (n, 1, 1)),
                mo=np.asarray(mo), ofs=np.asarray(ofs),
                targets=np.asarray(targets), dx=float(ra.dx))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jax.device_count() >= WORLD
    (fast, p), reg = _stage_problem(), _reg_problem()
    mesh = jsharded.make_mesh(jax.devices()[:WORLD])
    ref = {e: _jax_stages(p, fast, e, mesh) for e in ("fast", "exact")}
    out = tmp_path_factory.mktemp("stages")
    sharded.spawn(stage_rank, WORLD, p, reg, str(out), use_cpu=True)
    ranks = [dict(np.load(out / f"stages_rank{r}.npz"))
             for r in range(WORLD)]
    return p, reg, ref, ranks


def _port(ranks, key):
    """The port's value of `key`: per-slice arrays assembled from the
    ranks' blocks, the rest as rank 0 holds them."""
    if key.split("_", 1)[1] in PER_SLICE:
        return np.concatenate([r[key] for r in ranks])
    return ranks[0][key]


@pytest.mark.parametrize("engine", ["fast", "exact"])
@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_jax_sharded(runs, engine, stage):
    _, _, ref, ranks = runs
    for field, tol, relative in STAGES[stage]:
        out = _port(ranks, f"{engine}_{field}").astype(np.float64)
        want = ref[engine][field].astype(np.float64)
        assert out.shape == want.shape, field
        err = np.abs(out - want).max()
        if relative:
            err /= max(np.abs(want).max(), 1e-30)
        assert err <= tol, (field, err)


def test_exact_normalise_bias_matches_single_rank(runs):
    p, _, _, ranks = runs
    single = run_stages(p, "exact", 0, p["slices"].shape[0],
                        normalise_bias=True)["recon2"]
    err = np.abs(ranks[0]["exact_nb_recon2"] - np.asarray(single)).max()
    assert err <= 2e-2, err


def test_ranks_hold_bitwise_equal_volumes(runs):
    _, _, _, ranks = runs
    keys = [k for k in ranks[0]
            if k.split("_", 1)[1] not in PER_SLICE]
    assert "fast_recon2" in keys and "reg_t" in keys
    for r in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=k)


def test_registration_matches_single_rank(runs):
    _, reg, _, ranks = runs
    cfg = s2v.SliceRegConfig(levels=1, iterations=3, psf_matched=False,
                             optimizer="coord-scan")
    t = {k: torch.as_tensor(np.array(reg[k]))
         for k in ("recon", "w2i", "t0", "mo", "ofs", "targets")}
    single_t, single_sim = s2v.register_slices_to_volume(
        cfg, t["recon"], t["w2i"], t["t0"], t["mo"], t["ofs"],
        t["targets"], reg["dx"])
    single_t, single_sim = single_t.numpy(), single_sim.numpy()
    # a non-trivial problem, and the mesh within far below a voxel
    assert np.abs(single_t - reg["t0"]).max() > 1e-3
    np.testing.assert_allclose(ranks[0]["reg_t"], single_t, atol=5e-2)
    np.testing.assert_allclose(ranks[0]["reg_sim"], single_sim, atol=1e-2)


def test_a_failing_rank_fails_the_run():
    """The run raises (rank 1's error, or rank 0's failed collective,
    whichever the parent sees first) and no rank is left running."""
    with pytest.raises(torch.multiprocessing.ProcessRaisedException):
        sharded.spawn(failing_rank, WORLD, use_cpu=True)


def test_no_fallback_without_cuda_or_launcher(monkeypatch):
    """A rank that asked for a card and has none raises, and so does
    --distributed without the launcher's environment."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sharded.make_mesh(0, 1, "file:///nonexistent/rdzv")
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="RANK, WORLD_SIZE"):
        sharded.mesh_from_env(use_cpu=True)


def test_blocks_and_padding():
    """Each rank owns the contiguous block [r N / W, (r + 1) N / W) of the
    padded batch, as shard_map's P("slices") splits it."""
    assert sharded.pad_slices_for_mesh(16, 3) == \
        jsharded.pad_slices_for_mesh(16, 3) == 18
    blocks = [sharded.Mesh(None, r, 3, torch.device("cpu")).block(18)
              for r in range(3)]
    assert blocks == [(0, 6), (6, 12), (12, 18)]
    with pytest.raises(ValueError, match="pad them first"):
        sharded.Mesh(None, 0, 3, torch.device("cpu")).block(16)
