"""The port's 2-D grid stages on 2 x 2 ranks vs the JAX package's.

test_mesh2d.py's problem (phantom n=24 at 2.0 mm, two stacks of 4 mm
slices padded to a multiple of 4) through the JAX package's `g2_*`
stages on make_mesh2d(2, 2) over conftest.py's CPU devices, and through
parallel/volume_sharded.py's stages on a parallel/mesh2d.Grid of four gloo
ranks (rank (s, v) holds slice block s and z-slab v): geometry, the
Gaussian reconstruction, simulate, initialize_robust_statistics, estep,
one inner iteration and slice registration ("coord-scan").  Limits are
test_mesh2d.py's (:81-127, :159-162): sume and den 1e-3, the Gaussian
reconstruction and the volume after the inner iteration 2e-3 of
max|ref|, voxel counts 0.5, sim 2e-2, slice weights 1e-3, sigma2 1e-3
relative, registration 1e-4; and the EM stages at test_sharded.py's
(sigma2 1e-4 relative, voxel weights 1e-4).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.ops import psf as psf_ops
from fetalreconstruction_tpu.ops import psf_fast as jpf
from fetalreconstruction_tpu.parallel import mesh2d as jg2
from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu.register import slice2vol as js2v
from fetalreconstruction_tpu_torch.parallel import mesh2d, sharded

from phantom import make_ground_truth, mask_slices, recon_mask, \
    simulate_stacks
from torch_sharded_ranks import EM_FIELDS, SIM_FIELDS, grid_stage_rank
from torch_threads import one_torch_thread  # noqa: F401

SHAPE = (2, 2)
REG_CFG = dict(levels=1, steps=2, iterations=2, psf_matched=False,
               optimizer="coord-scan")
# a rigid motion of every slice, so that slice pixels fall between the
# grid's z rows and 2x2x2 windows straddle the slabs (identity transforms
# put these slices on whole rows, where a window's top corner weighs 0)
MOTION = rigid_matrix([0.3, -0.2, 0.7, 2.0, -1.5, 1.0]).astype(np.float32)
# stage -> {field: (tolerance, scaled by max|ref|?, relative?, per slice?)}
STAGES = {
    "geometry": {"sume": (1e-3, False, False, True),
                 "den": (1e-3, False, False, True)},
    "gaussian_reconstruction": {"recon": (2e-3, True, False, False),
                                "vc": (0.5, False, False, True)},
    "simulate": {"sim": (2e-2, False, False, True)},
    "initialize_robust_statistics": {"sigma2_0": (1e-4, False, True,
                                                  False)},
    "estep": {"weights": (1e-4, False, False, True)},
    "inner_iteration": {"recon2": (2e-3, True, False, False),
                        "slice_weight2": (1e-3, False, False, True),
                        "sigma2_2": (1e-3, False, True, False)},
    "registration": {"reg_t": (1e-4, False, False, False),
                     "reg_sim": (1e-4, False, False, False)},
}
VOLUMES = {"recon", "recon2"}


def _problem():
    gt = make_ground_truth(n=24, spacing=2.0)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.5, dz=4.0,
                                noise=1.0)
    batch = mask_slices(create_slices(stacks, [8.0, 8.0]))
    ra = gt.attr
    support = psf_ops.reference_support(batch.dims, ra.dx, 1.0, 8)
    fast = jpf.FastPSF.from_batch(batch, ra.w2i(), support)
    ctx = jcore.SVRContext(
        vol_shape=ra.shape_zyx, vol_spacing=(ra.dx, ra.dy, ra.dz),
        offsets=psf_ops.make_offsets(support), slice_spacing_xy=(2.5, 2.5),
        disable_bias=True, fast=fast)
    pad = (-batch.n_slices) % 4
    data = np.concatenate([batch.data, np.full(
        (pad,) + batch.data.shape[1:], -1.0, np.float32)])
    n = data.shape[0]
    eye = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    motion = np.tile(MOTION, (n, 1, 1))
    p = dict(slices=data, valid=data != -1.0,
             i2w=np.concatenate([batch.i2w, np.tile(batch.i2w[-1:],
                                                    (pad, 1, 1))]
                                ).astype(np.float32),
             stack_id=np.concatenate([batch.stack_index, np.full(
                 (pad,), batch.stack_index[-1])]).astype(np.int32),
             transforms=motion, mo=eye, w2i=ra.w2i().astype(np.float32),
             mask=np.asarray(recon_mask(gt), np.float32),
             recon=np.maximum(gt.data, 0.0).astype(np.float32),
             excluded=np.zeros((n,), bool), mx=120.0, mn=1.0,
             dx=float(ra.dx), vol_shape=np.asarray(ra.shape_zyx),
             vol_spacing=np.asarray((ra.dx, ra.dy, ra.dz)),
             terms=fast.terms, ranges=fast.ranges, support=fast.support)
    return ctx, p


def _jax_stages(ctx, p, mesh):
    """The JAX package's g2_* stages, as test_mesh2d.py drives them: the
    EM stages and the inner iteration start from the single-device
    Gaussian reconstruction and simulate."""
    j = {k: jnp.asarray(v) for k, v in p.items()
         if isinstance(v, np.ndarray) and k not in ("vol_shape",
                                                    "vol_spacing")}
    n = p["slices"].shape[0]
    geom = jg2.g2_build_geometry_fn(ctx, mesh)(
        j["w2i"], j["transforms"], j["i2w"], j["valid"], j["mask"],
        j["stack_id"])
    em = jcore.init_em_state(n, j["valid"])
    recon, wts, vc = jg2.g2_gaussian_reconstruction_fn(ctx, mesh)(
        j["slices"], j["valid"], geom, em.bias, em.scale, j["mask"])
    sim = jg2.g2_simulate_fn(ctx, mesh)(geom, recon, j["mask"])

    fwd = jcore.slice_forward_matrices(j["w2i"], j["transforms"], j["i2w"])
    geom_1 = jpf.make_fast_geom(ctx.fast, fwd, j["valid"], ctx.vol_shape,
                                j["mask"].reshape(-1),
                                stack_id=j["stack_id"])
    mask_flat = j["mask"].reshape(-1)
    recon0, wts0, _ = jcore.gaussian_reconstruction(
        ctx, geom_1, geom_1.sume, j["slices"], j["valid"], em.bias,
        em.scale, mask_flat)
    sim0 = jcore.simulate(ctx, geom_1, geom_1.sume, recon0, mask_flat)
    mx, mn = jnp.float32(p["mx"]), jnp.float32(p["mn"])
    em0 = jg2.g2_initialize_robust_statistics_fn(ctx, mesh)(
        j["slices"], j["valid"], sim0, em, mx, mn, j["excluded"])
    em1, _ = jg2.g2_estep_fn(ctx, mesh)(j["slices"], j["valid"], geom.sume,
                                        sim0, em0, j["excluded"])
    em_r = jcore.initialize_robust_statistics(
        ctx, j["slices"], j["valid"], sim0, em, p["mx"], p["mn"],
        j["excluded"])
    args = (1.0, 450.0, 1.0, 120.0, 2)
    p.update(recon0=np.asarray(recon0), wts0=np.asarray(wts0), args=args,
             **{"em_" + f: np.asarray(getattr(em_r, f)) for f in EM_FIELDS},
             **{"sim_" + f: np.asarray(getattr(sim0, f))
                for f in SIM_FIELDS})
    em2, _, recon2 = jg2.g2_inner_iteration_fn(
        ctx, mesh, do_bias=False, do_scale=True)(
        geom, j["slices"], j["valid"], em_r, sim0, recon0, wts0, j["mask"],
        j["excluded"], *(jnp.float32(a) for a in args[:4]),
        jnp.int32(args[4]))
    reg_t, reg_sim = jg2.g2_register_slices_fn(
        js2v.SliceRegConfig(**REG_CFG), mesh, p["dx"])(
        j["recon"], j["w2i"], j["transforms"], j["mo"], j["i2w"],
        j["slices"], j["stack_id"])
    out = dict(sume=geom.sume, den=geom.den, recon=recon, vc=vc,
               sim=sim.sim, sigma2_0=em0.sigma2, weights=em1.weights,
               recon2=recon2, slice_weight2=em2.slice_weight,
               sigma2_2=em2.sigma2, reg_t=reg_t, reg_sim=reg_sim)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jax.device_count() >= 4
    ctx, p = _problem()
    ref = _jax_stages(ctx, p, jg2.make_mesh2d(*SHAPE, jax.devices()[:4]))
    out = tmp_path_factory.mktemp("grid")
    sharded.spawn(grid_stage_rank, 4, p, REG_CFG, str(out), use_cpu=True)
    return ref, [dict(np.load(out / f"grid_rank{r}.npz")) for r in range(4)]


def _port(ranks, field, per_slice):
    """The port's value: per-slice rows from the ranks of column 0 (one
    per slice block), slabs from the ranks of row 0 (one per slab), the
    rest as rank 0 holds it."""
    s_, v_ = SHAPE
    if per_slice:
        return np.concatenate([ranks[s * v_][field] for s in range(s_)])
    if field in VOLUMES:
        return np.concatenate([ranks[v][field] for v in range(v_)])
    return ranks[0][field]


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_jax_grid(runs, stage):
    ref, ranks = runs
    for field, (tol, scaled, relative, per_slice) in STAGES[stage].items():
        out = _port(ranks, field, per_slice).astype(np.float64)
        want = ref[field].astype(np.float64)
        assert out.shape == want.shape, field
        err = np.abs(out - want).max()
        if scaled:
            tol *= max(float(np.abs(want).max()), 1.0)
        if relative:
            err /= max(float(np.abs(want).max()), 1e-30)
        assert err <= tol, (field, err, tol)


def test_grid_layout_and_replicas(runs):
    """Rank s V + v holds slice block s and slab v: the ranks of one
    column hold the same slab, those of one row the same slice values."""
    _, ranks = runs
    s_, v_ = SHAPE
    for s in range(s_):
        for v in range(v_):
            r = ranks[s * v_ + v]
            for field in VOLUMES:
                np.testing.assert_array_equal(r[field], ranks[v][field])
            for field in ("sume", "sim", "weights", "slice_weight2"):
                np.testing.assert_array_equal(r[field], ranks[s * v_][field])


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
def test_grid_shape_matches_jax(n):
    assert mesh2d.grid_shape(n) == jg2.grid_shape(n)
