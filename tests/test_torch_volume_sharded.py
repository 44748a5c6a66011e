"""The port's volume-sharded stages at world size 4 vs the JAX package's.

test_volume_sharded.py's problem (phantom n=24 at 2.0 mm, two stacks of
4 mm slices; the 24-row grid splits into slabs of lz = 6) through the JAX
package's `vs_*` stages on a 4-device vol_z mesh of conftest.py's CPU
devices, and through parallel/volume_sharded.py on four gloo ranks
(parallel/sharded.spawn, one CPU process per rank, each holding every
slice and one z-slab).  Limits are test_volume_sharded.py's (:72-84,
:121-126, :162-168): sume 1e-3; sim 2e-2, simw 1e-3 and `inside` exact;
the scatter 2e-3 of max|ref| under a random mask that reaches the
volume's borders (an interior mask once hid an index wrap at the slab
edges); one inner iteration with normalise-bias, whose 12 mm blur reaches
24 rows, past three slabs (the multi-hop halo): the volume 2e-3 of
max|ref|, slice weights 1e-3, sigma2 1e-3 relative.  The halo exchange
is held against np.pad of the whole volume for h < lz, h = lz and
h > lz, and every rank must hold the same per-slice values, bit for bit.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.ops import psf as psf_ops
from fetalreconstruction_tpu.ops import psf_fast as jpf
from fetalreconstruction_tpu.parallel import volume_sharded as jvs
from fetalreconstruction_tpu.pipeline import svr_core as jcore
from fetalreconstruction_tpu.pipeline.state import create_slices
from fetalreconstruction_tpu_torch.parallel import sharded

from phantom import make_ground_truth, mask_slices, recon_mask, \
    simulate_stacks
from torch_sharded_ranks import EM_FIELDS, SIM_FIELDS, halo_rank, \
    vs_stage_rank
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
HALOS = (2, 6, 9)   # h < lz, h = lz, h > lz (two hops) on lz = 6
# a rigid motion of every slice, so that slice pixels fall between the
# grid's z rows and 2x2x2 windows straddle the slabs (identity transforms
# put these slices on whole rows, where a window's top corner weighs 0)
MOTION = rigid_matrix([0.3, -0.2, 0.7, 2.0, -1.5, 1.0]).astype(np.float32)
# field -> (tolerance, scaled by max|ref|?, relative?, per slice?)
STAGES = {
    "geometry": {"sume": (1e-3, False, False, True)},
    "simulate": {"sim": (2e-2, False, False, True),
                 "simw": (1e-3, False, False, True),
                 "inside": (0.0, False, False, True)},
    "scatter": {"scatter_a": (2e-3, True, False, False),
                "scatter_b": (2e-3, True, False, False)},
    "inner_iteration": {"recon2": (2e-3, True, False, False),
                        "slice_weight2": (1e-3, False, False, True),
                        "sigma2_2": (1e-3, False, True, True)},
}


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
    n = batch.n_slices
    rng = np.random.default_rng(0)
    p = dict(slices=batch.data, valid=batch.data != -1.0,
             i2w=batch.i2w.astype(np.float32),
             stack_id=batch.stack_index.astype(np.int32),
             transforms=np.tile(MOTION, (n, 1, 1)),
             w2i=ra.w2i().astype(np.float32),
             mask=np.asarray(recon_mask(gt), np.float32),
             mask_rand=(np.random.default_rng(7).uniform(
                 0, 1, ra.shape_zyx) > 0.2).astype(np.float32),
             recon=np.maximum(gt.data, 0.0).astype(np.float32),
             pay_a=rng.uniform(0, 50, batch.data.shape).astype(np.float32),
             excluded=np.zeros((n,), bool),
             vol_shape=np.asarray(ra.shape_zyx),
             vol_spacing=np.asarray((ra.dx, ra.dy, ra.dz)),
             terms=fast.terms, ranges=fast.ranges, support=fast.support)
    return ctx, p


def _jax_stages(ctx, p, mesh):
    """The JAX package's vs_* stages (and the single-device state that the
    inner iteration starts from, as test_volume_sharded.py builds it)."""
    j = {k: jnp.asarray(v) for k, v in p.items()
         if isinstance(v, np.ndarray) and k not in ("vol_shape",
                                                    "vol_spacing")}
    geom_fn = jvs.vs_build_geometry_fn(ctx, mesh)

    def geometry(mask):
        return geom_fn(j["w2i"], j["transforms"], j["i2w"], j["valid"],
                       mask, j["stack_id"])

    geom = geometry(j["mask"])
    ss = jvs.vs_simulate_fn(ctx, mesh)(geom, j["recon"], j["mask"])
    # the scatter under the random mask: payloads gated by the replicated
    # geometry's sume, as test_volume_sharded.py gates them
    fwd = jcore.slice_forward_matrices(j["w2i"], j["transforms"], j["i2w"])
    geom_r = jpf.make_fast_geom(ctx.fast, fwd, j["valid"], ctx.vol_shape,
                                j["mask_rand"].reshape(-1),
                                stack_id=j["stack_id"])
    gate = np.asarray(j["valid"] & (geom_r.sume > 0))
    p["pay_a"] = p["pay_a"] * gate
    p["pay_b"] = gate.astype(np.float32)
    geom_v = geometry(j["mask_rand"])

    def body(g, a, b, m):
        return jvs.vs_fast_scatter2(ctx.fast, g, a, b, m, ctx.vol_shape,
                                    jvs.AXIS_V)

    scatter = jax.jit(jvs._smap(body, mesh,
                                in_specs=(jvs.GEOM_SPEC, P(), P(), jvs.SLAB),
                                out_specs=(jvs.SLAB, jvs.SLAB)))
    a, b = scatter(geom_v, jnp.asarray(p["pay_a"]), jnp.asarray(p["pay_b"]),
                   j["mask_rand"])

    # the inner iteration's start: the single-device Gaussian
    # reconstruction, simulate and robust statistics
    geom_1 = jpf.make_fast_geom(ctx.fast, fwd, j["valid"], ctx.vol_shape,
                                j["mask"].reshape(-1),
                                stack_id=j["stack_id"])
    mask_flat = j["mask"].reshape(-1)
    em = jcore.init_em_state(p["slices"].shape[0], j["valid"])
    recon0, wts0, _ = jcore.gaussian_reconstruction(
        ctx, geom_1, geom_1.sume, j["slices"], j["valid"], em.bias,
        em.scale, mask_flat)
    sim0 = jcore.simulate(ctx, geom_1, geom_1.sume, recon0, mask_flat)
    em = jcore.initialize_robust_statistics(
        ctx, j["slices"], j["valid"], sim0, em, 120.0, 1.0, j["excluded"])
    args = (1.0, 450.0, 1.0, 120.0, 2)
    p.update(recon0=np.asarray(recon0), wts0=np.asarray(wts0), args=args,
             **{"em_" + f: np.asarray(getattr(em, f)) for f in EM_FIELDS},
             **{"sim_" + f: np.asarray(getattr(sim0, f))
                for f in SIM_FIELDS})
    step = jvs.vs_inner_iteration_fn(ctx, mesh, do_bias=False,
                                     do_scale=True, do_normalise_bias=True)
    em2, _, recon2 = step(geom, j["slices"], j["valid"], em, sim0, recon0,
                          wts0, j["mask"], j["excluded"], jnp.float32(1.0),
                          jnp.float32(450.0), jnp.float32(1.0),
                          jnp.float32(120.0), jnp.int32(2))
    out = dict(sume=geom.sume, sim=ss.sim, simw=ss.simw, inside=ss.inside,
               scatter_a=a, scatter_b=b, recon2=recon2,
               slice_weight2=em2.slice_weight, sigma2_2=em2.sigma2)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    assert jax.device_count() >= WORLD
    ctx, p = _problem()
    ref = _jax_stages(ctx, p, jvs.make_vol_mesh(jax.devices()[:WORLD]))
    vol = np.random.default_rng(3).standard_normal(
        (WORLD * 6, 3, 4)).astype(np.float32)
    out = tmp_path_factory.mktemp("vs")
    sharded.spawn(vs_stage_rank, WORLD, p, str(out), use_cpu=True)
    sharded.spawn(halo_rank, WORLD, vol, HALOS, str(out), use_cpu=True)
    ranks = [dict(np.load(out / f"vs_rank{r}.npz")) for r in range(WORLD)]
    halos = [dict(np.load(out / f"halo_rank{r}.npz")) for r in range(WORLD)]
    return ref, ranks, vol, halos


@pytest.mark.parametrize("stage", list(STAGES))
def test_stage_matches_jax_volume_sharded(runs, stage):
    ref, ranks, _, _ = runs
    for field, (tol, scaled, relative, per_slice) in STAGES[stage].items():
        out = (ranks[0][field] if per_slice
               else np.concatenate([r[field] for r in ranks]))
        want = ref[field]
        assert out.shape == want.shape, field
        if want.dtype == bool:
            np.testing.assert_array_equal(out, want, err_msg=field)
            continue
        err = np.abs(out.astype(np.float64) - want).max()
        if scaled:
            tol *= max(float(np.abs(want).max()), 1.0)
        if relative:
            err /= max(float(np.abs(want).max()), 1e-30)
        assert err <= tol, (field, err, tol)


def test_ranks_hold_the_same_slice_values(runs):
    _, ranks, _, _ = runs
    for field in ("sume", "den", "sim", "simw", "inside", "slice_weight2",
                  "sigma2_2"):
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[field], ranks[0][field],
                                          err_msg=field)


@pytest.mark.parametrize("h", HALOS)
def test_halo_exchange_matches_padded_volume(runs, h):
    _, _, vol, halos = runs
    lz = vol.shape[0] // WORLD
    padded = np.pad(vol, ((h, h), (0, 0), (0, 0)))
    for r, got in enumerate(halos):
        np.testing.assert_array_equal(got[f"halo{h}"],
                                      padded[r * lz:(r + 1) * lz + 2 * h])


def test_assembly_and_shift(runs):
    _, _, vol, halos = runs
    lz = vol.shape[0] // WORLD
    for r, got in enumerate(halos):
        np.testing.assert_array_equal(got["whole"], vol)
        want = vol[r * lz - 1] if r else np.zeros_like(vol[0])
        np.testing.assert_array_equal(got["below"], want)
