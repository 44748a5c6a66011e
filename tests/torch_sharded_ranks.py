"""Rank functions of the port's multi-rank CPU tests.

`parallel.sharded.spawn` starts each rank in a fresh interpreter that
imports its function by name, so they live here, in a module that imports
torch and the port but not JAX (the JAX side runs in the test process).
Each rank gets numpy inputs and writes what it computed to
<out>/<tag>_rank<r>.npz for the test to compare.
"""
import numpy as np
import torch

from fetalreconstruction_tpu_torch.parallel import sharded
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
    return dict(recon=r.reconstructed.data, transforms=r.transforms,
                slice_weights=r.slice_weights,
                slice_inside=r.slice_inside,
                excluded=np.asarray(r.excluded_slices, np.int64))


def svr_rank(mesh, cfg_kw, stacks, mask, out, tag, files_kw=None,
             pvr_kw=None):
    """run_svr under the mesh on the given stacks (the port's Images); with
    files_kw also a run that reads its inputs from files (the CLI's
    config), with pvr_kw a run_pvr."""
    torch.set_num_threads(1)
    dev = mesh.device
    runs = {tag: lambda: run_svr(SVRConfig(**cfg_kw), stacks=stacks,
                                 mask=mask, device=dev, mesh=mesh)}
    if files_kw is not None:
        runs[tag + "_files"] = lambda: run_svr(SVRConfig(**files_kw),
                                               device=dev, mesh=mesh)
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
