"""Rank functions of the port's multi-rank CPU tests.

`parallel.sharded.spawn` starts each rank in a fresh interpreter that
imports its function by name, so they live here, in a module that imports
torch and the port but not JAX (the JAX side runs in the test process).
Each rank gets numpy inputs and writes what it computed to
<out>/<tag>_rank<r>.npz for the test to compare.
"""
import numpy as np
import torch

from fetalreconstruction_tpu_torch.parallel import mesh2d, sharded
from fetalreconstruction_tpu_torch.parallel import volume_sharded as vsd
from fetalreconstruction_tpu_torch.parallel.halo import (from_below,
                                                         halo_exchange_z)
from fetalreconstruction_tpu_torch.pipeline import svr_core
from fetalreconstruction_tpu_torch.pipeline.config import SVRConfig
from fetalreconstruction_tpu_torch.pipeline.pvr import PVRConfig, run_pvr
from fetalreconstruction_tpu_torch.pipeline.svr import run_svr
from fetalreconstruction_tpu_torch.register import slice2vol as s2v
from fetalreconstruction_tpu_torch.utils import convert


def stage_context(p, engine):
    """The port's SVRContext of the stage problem `p` (numpy dict) on one
    engine; the fast engine takes the JAX side's separable taps."""
    kw = dict(vol_shape=tuple(p["vol_shape"]),
              vol_spacing=tuple(p["vol_spacing"]),
              slice_spacing_xy=(2.5, 2.5), sigma_bias=p["sigma_bias"],
              disable_bias=engine == "exact", offsets=p["offsets"])
    if engine == "fast":
        kw["fast"] = convert.fast_psf(p["terms"], p["ranges"], p["support"])
    return svr_core.SVRContext(**kw)


def run_stages(p, engine, lo, hi, group=None, normalise_bias=None):
    """build_geometry, gaussian_reconstruction, simulate,
    initialize_robust_statistics, estep and one inner_iteration (bias and
    scale steps; the normalise-bias step on the fast engine, or as asked)
    on rows [lo, hi) of the stage problem.  Returns a dict of numpy
    arrays: per-slice ones cover [lo, hi), volumes and scalars are
    whole."""
    ctx = stage_context(p, engine)

    def t(name, dtype=None):
        return torch.as_tensor(p[name][lo:hi], dtype=dtype)

    slices, valid = t("slices"), t("valid")
    mask_flat = torch.as_tensor(p["mask_flat"])
    mask = mask_flat.reshape(ctx.vol_shape)
    geom, sume = svr_core.build_geometry(
        ctx, torch.as_tensor(p["w2i"]), t("transforms"), t("i2w"), valid,
        mask_flat, stack_id=t("stack_id", torch.int64),
        slice_dims=t("dims"))
    em = svr_core.init_em_state(hi - lo, valid)
    recon, wts, vc = svr_core.gaussian_reconstruction(
        ctx, geom, sume, slices, valid, em.bias, em.scale, mask_flat, group)
    sim = svr_core.simulate(ctx, geom, sume, recon, mask_flat)
    excluded = torch.zeros((hi - lo,), dtype=torch.bool)
    em0 = svr_core.initialize_robust_statistics(
        ctx, slices, valid, sim, em, p["mx"], p["mn"], excluded, group)
    em1, _ = svr_core.estep(ctx, slices, valid, sume, sim, em0, excluded,
                            group)
    if normalise_bias is None:
        normalise_bias = engine == "fast"
    em2, sim2, recon2 = svr_core.inner_iteration(
        ctx, geom, sume, slices, valid, em1, sim, recon, wts, mask,
        mask_flat, excluded, p["alpha"], p["lam"], p["mn"], p["mx"], 1,
        do_bias=True, do_scale=True, do_normalise_bias=normalise_bias,
        group=group)
    return dict(sume=sume, recon=recon, wts=wts, vc=vc, sim=sim.sim,
                sigma2_0=em0.sigma2, weights=em1.weights, recon2=recon2,
                slice_weight2=em2.slice_weight, sigma2_2=em2.sigma2,
                sim2=sim2.sim)


def stage_rank(mesh, p, reg, out):
    """The stages on both engines (and the exact engine's normalise-bias
    step), then slice registration, under the mesh."""
    torch.set_num_threads(1)
    n = p["slices"].shape[0]
    lo, hi = mesh.block(n)
    res = {}
    for engine in ("fast", "exact"):
        for k, v in run_stages(p, engine, lo, hi, mesh.group).items():
            res[f"{engine}_{k}"] = v
    nb = run_stages(p, "exact", lo, hi, mesh.group, normalise_bias=True)
    res["exact_nb_recon2"] = nb["recon2"]

    lo, hi = mesh.block(reg["targets"].shape[0])
    cfg = s2v.SliceRegConfig(levels=1, iterations=3, psf_matched=False,
                             optimizer="coord-scan")
    a = {k: torch.as_tensor(reg[k][lo:hi]) for k in ("t0", "mo", "ofs",
                                                     "targets")}
    res["reg_t"], res["reg_sim"] = sharded.register_slices(
        cfg, mesh, reg["targets"].shape[0], torch.as_tensor(reg["recon"]),
        torch.as_tensor(reg["w2i"]), a["t0"], a["mo"], a["ofs"],
        a["targets"], reg["dx"])
    np.savez(f"{out}/stages_rank{mesh.rank}.npz",
             **{k: np.asarray(v) for k, v in res.items()})


def _result(r):
    out = dict(recon=r.reconstructed.data, transforms=r.transforms,
               slice_weights=r.slice_weights, slice_inside=r.slice_inside,
               excluded=np.asarray(r.excluded_slices, np.int64))
    if r.bspline_reconstructed is not None:
        out["bspline"] = r.bspline_reconstructed.data
    return out


def svr_rank(mesh, cfg_kw, stacks, mask, out, tag, files_kw=None,
             pvr_kw=None, mode="slices"):
    """run_svr under the mesh (mesh_mode `mode`) on the given stacks (the
    port's Images); with files_kw also a run that reads its inputs from
    files (the CLI's config), with pvr_kw a run_pvr."""
    torch.set_num_threads(1)
    dev = mesh.device
    runs = {tag: lambda: run_svr(SVRConfig(**cfg_kw), stacks=stacks,
                                 mask=mask, device=dev, mesh=mesh,
                                 mesh_mode=mode)}
    if files_kw is not None:
        runs[tag + "_files"] = lambda: run_svr(SVRConfig(**files_kw),
                                               device=dev, mesh=mesh,
                                               mesh_mode=mode)
    if pvr_kw is not None:
        runs[tag + "_pvr"] = lambda: run_pvr(PVRConfig(**pvr_kw),
                                             stacks=stacks, mask=mask,
                                             mesh=mesh, device=dev)
    for name, run in runs.items():
        np.savez(f"{out}/{name}_rank{mesh.rank}.npz", **_result(run()))


def failing_rank(mesh):
    """Rank 1 raises while rank 0 waits in a collective."""
    if mesh.rank == 1:
        raise RuntimeError("rank 1 fails")
    sharded.psum(torch.ones(1), mesh.group)


def no_jax_rank(mesh):
    """Fails if the rank's fresh interpreter loaded JAX or the JAX
    package."""
    import sys
    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "fetalreconstruction_tpu")]
    if bad:
        raise RuntimeError(f"rank {mesh.rank} imported {bad}")
    sharded.psum(torch.ones(1), mesh.group)


# ---------------------------------------------------------------------------
# the z-slab modes
# ---------------------------------------------------------------------------

EM_FIELDS = ("weights", "bias", "scale", "slice_weight", "sigma2", "m",
             "mix", "mix_s")
SIM_FIELDS = ("sim", "simw", "inside", "slice_inside")


def slab_context(p):
    """The port's fast-engine SVRContext of a slab stage problem."""
    return svr_core.SVRContext(
        vol_shape=tuple(int(v) for v in p["vol_shape"]),
        vol_spacing=tuple(p["vol_spacing"]), slice_spacing_xy=(2.5, 2.5),
        disable_bias=True,
        fast=convert.fast_psf(p["terms"], p["ranges"], p["support"]))


def halo_rank(mesh, vol, hs, out):
    """halo_exchange_z of this rank's slab of `vol` for each h in hs, the
    slab from below's last row, and the assembled volume."""
    lz = vol.shape[0] // mesh.size
    slab = torch.as_tensor(vol[mesh.rank * lz:(mesh.rank + 1) * lz])
    res = {f"halo{h}": halo_exchange_z(slab, h, mesh) for h in hs}
    res["below"] = from_below(slab[-1], mesh)
    res["whole"] = sharded.gather_rows(mesh, slab, vol.shape[0])
    np.savez(f"{out}/halo_rank{mesh.rank}.npz",
             **{k: v.numpy() for k, v in res.items()})


def vs_stage_rank(mesh, p, out):
    """volume_sharded's stages on this rank's slabs (slices replicated):
    geometry, simulate, the scatter under a random border-reaching mask
    and one inner iteration with normalise-bias."""
    torch.set_num_threads(1)
    ctx = slab_context(p)
    z0, z1 = mesh.block(ctx.vol_shape[0])

    def slab(name):
        return torch.as_tensor(p[name][z0:z1])

    def t(name, dtype=None):
        return torch.as_tensor(p[name], dtype=dtype)

    def geometry(mask_name):
        return vsd.vs_build_geometry(
            ctx, t("w2i"), t("transforms"), t("i2w"), t("valid"),
            slab(mask_name), t("stack_id", torch.int64), mesh)

    geom = geometry("mask")
    sim = vsd.vs_simulate(ctx, geom, slab("recon"), slab("mask"), mesh)
    geom_r = geometry("mask_rand")
    a, b = vsd.vs_fast_scatter2(ctx.fast, geom_r, t("pay_a"), t("pay_b"),
                                slab("mask_rand"), ctx.vol_shape, mesh)
    em = convert.em_state(*(p["em_" + f] for f in EM_FIELDS), device="cpu")
    ss = convert.sim_state(*(p["sim_" + f] for f in SIM_FIELDS),
                           device="cpu")
    em2, _, recon2 = vsd.vs_inner_iteration(
        ctx, geom, t("slices"), t("valid"), em, ss, slab("recon0"),
        slab("wts0"), slab("mask"), t("excluded"), *p["args"], mesh,
        do_bias=False, do_scale=True, do_normalise_bias=True)
    res = dict(sume=geom.sume, den=geom.den, sim=sim.sim, simw=sim.simw,
               inside=sim.inside, scatter_a=a, scatter_b=b, recon2=recon2,
               slice_weight2=em2.slice_weight, sigma2_2=em2.sigma2)
    np.savez(f"{out}/vs_rank{mesh.rank}.npz",
             **{k: v.numpy() for k, v in res.items()})


def grid_stage_rank(mesh, p, reg_cfg_kw, out):
    """The 2-D grid's stages on a 2 x 2 grid: geometry, the Gaussian
    reconstruction, simulate, initialize_robust_statistics, estep, one
    inner iteration and slice registration, each on this rank's slice
    block and slab."""
    torch.set_num_threads(1)
    grid = mesh2d.make_grid(mesh)
    ctx = slab_context(p)
    n = p["slices"].shape[0]
    lo, hi = grid.slices.block(n)
    z0, z1 = grid.vol.block(ctx.vol_shape[0])
    g = grid.slices.group

    def slab(name):
        return torch.as_tensor(p[name][z0:z1])

    def t(name, dtype=None):
        return torch.as_tensor(p[name][lo:hi], dtype=dtype)

    mask = slab("mask")
    geom = vsd.vs_build_geometry(
        ctx, torch.as_tensor(p["w2i"]), t("transforms"), t("i2w"),
        t("valid"), mask, t("stack_id", torch.int64), grid.vol)
    em = svr_core.init_em_state(hi - lo, t("valid"))
    recon, wts, vc = vsd.vs_gaussian_reconstruction(
        ctx, geom, t("slices"), t("valid"), em.bias, em.scale, mask,
        grid.vol, g)
    sim = vsd.vs_simulate(ctx, geom, recon, mask, grid.vol)
    # the EM stages and the inner iteration start from the JAX side's
    # single-device state (as tests/test_mesh2d.py does)
    em_r = convert.em_state(*(p["em_" + f][lo:hi] if p["em_" + f].ndim
                              else p["em_" + f] for f in EM_FIELDS),
                            device="cpu")
    ss_r = convert.sim_state(*(p["sim_" + f][lo:hi] for f in SIM_FIELDS),
                             device="cpu")
    excluded = t("excluded")
    em0 = svr_core.initialize_robust_statistics(
        ctx, t("slices"), t("valid"), ss_r, em, p["mx"], p["mn"], excluded,
        g)
    em1, _ = svr_core.estep(ctx, t("slices"), t("valid"), geom.sume, ss_r,
                            em0, excluded, g)
    em2, _, recon2 = vsd.vs_inner_iteration(
        ctx, geom, t("slices"), t("valid"), em_r, ss_r, slab("recon0"),
        slab("wts0"), mask, excluded, *p["args"], grid.vol, g,
        do_bias=False, do_scale=True)
    reg_cfg = s2v.SliceRegConfig(**reg_cfg_kw)
    reg_t, reg_sim = sharded.register_slices(
        reg_cfg, grid.slices, n,
        sharded.gather_rows(grid.vol, slab("recon"), ctx.vol_shape[0]),
        torch.as_tensor(p["w2i"]), t("transforms"), t("mo"), t("i2w"),
        t("slices"), p["dx"])
    res = dict(sume=geom.sume, den=geom.den, recon=recon, wts=wts, vc=vc,
               sim=sim.sim, sigma2_0=em0.sigma2, weights=em1.weights,
               recon2=recon2, slice_weight2=em2.slice_weight,
               sigma2_2=em2.sigma2, reg_t=reg_t, reg_sim=reg_sim)
    np.savez(f"{out}/grid_rank{mesh.rank}.npz",
             **{k: v.numpy() for k, v in res.items()})
