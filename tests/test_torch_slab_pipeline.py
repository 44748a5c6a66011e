"""The port's run_svr and CLI in the z-slab modes, on the CPU.

test_torch_sharded_pipeline.py's problem (phantom n=24 at 1.8 mm, two
noisy stacks of 3.6 mm slices; 2 outer iterations, one "coord-scan"
registration round), reconstructed at 2.0 mm: a 19-row grid, which both
modes pad to 20 rows and crop back.  On gloo ranks (parallel/sharded.
spawn, one CPU process per rank):

- run_svr(mesh_mode="volume") at world size 2 against the JAX package's
  run_svr on a 2-device vol_z mesh of conftest.py's CPU devices, and
  mesh_mode="grid" on a 2 x 2 grid against the JAX package's on
  make_mesh2d(2, 2), at test_torch_svr_pipeline.py's limits (the volume
  within 1e-3 of max|ref|, slice transforms within 0.05 mm / deg, slice
  weights within 1e-3), with --bspline, whose volume is held at the same
  limit, and in volume mode a checkpoint per outer iteration, whose
  padded volume is held to the JAX package's;
- every rank returns the same result, bit for bit;
- `svr-reconstruct-torch --mesh 2 --mesh-mode volume --useCPU --debug`,
  and two processes started as a launcher would (`--distributed`), write
  the volume of run_svr at world size 2 on the same files, and the debug
  dumps on the padded grid;
- engine="exact" is refused as the JAX package refuses it, and
  --manualMask, on which the JAX package's slab modes fail, is refused.
"""
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.core.geometry import matrix_to_params
from fetalreconstruction_tpu.core.image import Image as JImage
from fetalreconstruction_tpu.io.nifti import write_nifti
from fetalreconstruction_tpu.ops.manual_mask import \
    transform_manual_mask as jax_manual_mask
from fetalreconstruction_tpu.parallel import mesh2d as jg2
from fetalreconstruction_tpu.parallel import volume_sharded as jvs
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu.pipeline.checkpoint import \
    load_checkpoint as jax_load_checkpoint
from fetalreconstruction_tpu.pipeline.config import SVRConfig as JConfig
from fetalreconstruction_tpu_torch.cli import svr_main
from fetalreconstruction_tpu_torch.io.nifti import read_nifti
from fetalreconstruction_tpu_torch.parallel import sharded
from fetalreconstruction_tpu_torch.pipeline import svr
from fetalreconstruction_tpu_torch.pipeline.checkpoint import load_checkpoint
from fetalreconstruction_tpu_torch.pipeline.config import SVRConfig
from fetalreconstruction_tpu_torch.utils.convert import image_from

from phantom import make_ground_truth, simulate_stacks
from test_torch_sharded_pipeline import ROOT, _free_port
from test_torch_svr_pipeline import PARAM_TOL, REC_TOL
from torch_sharded_ranks import svr_rank
from torch_threads import one_torch_thread  # noqa: F401

BASE = dict(iterations=2, resolution=2.0, rec_iterations_first=3,
            rec_iterations_last=4, smooth_mask=2.0, multires_levels=2,
            reg_levels=1, reg_iterations=2, reg_optimizer="coord-scan",
            no_log=True)
SLAB = dict(BASE, bspline=True)
CLI_FLAGS = ["--iterations", "1", "--resolution", "2.0", "--smooth_mask",
             "2.0", "--multires", "2", "--rec_iterations_first", "3",
             "--rec_iterations_last", "4", "--no_log"]
CLI_KW = dict(iterations=1, resolution=2.0, smooth_mask=2.0,
              multires_levels=2, rec_iterations_first=3,
              rec_iterations_last=4, no_log=True)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    gt = make_ground_truth(n=24, spacing=1.8)
    jstacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.2, dz=3.6,
                                 noise=1.0)
    jmask = JImage((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    d = tmp_path_factory.mktemp("inputs")
    paths = [str(d / f"stack{i}.nii.gz") for i in range(len(jstacks))]
    for p, st in zip(paths, jstacks):
        write_nifti(st, p)
    mpath = str(d / "mask.nii.gz")
    write_nifti(jmask, mpath)
    return ((jstacks, jmask), [image_from(s) for s in jstacks],
            image_from(jmask), paths, mpath)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    (jstacks, jmask), stacks, mask, paths, mpath = data
    out = tmp_path_factory.mktemp("ranks")
    ckpt = {side: str(out / f"{side}_checkpoints") for side in ("port", "jax")}
    sharded.spawn(svr_rank, 2, dict(SLAB, checkpoint_dir=ckpt["port"]),
                  stacks, mask, str(out), "volume",
                  dict(CLI_KW, input_stacks=paths, mask=mpath), None,
                  "volume", use_cpu=True)
    sharded.spawn(svr_rank, 4, SLAB, stacks, mask, str(out), "grid", None,
                  None, "grid", use_cpu=True)
    ranks = {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                    for r in range(world)]
             for name, world in (("volume", 2), ("volume_files", 2),
                                 ("grid", 4))}
    meshes = dict(volume=jvs.make_vol_mesh(jax.devices()[:2]),
                  grid=jg2.make_mesh2d(2, 2, jax.devices()[:4]))
    ref = {mode: jsvr.run_svr(
        JConfig(**SLAB, checkpoint_dir=ckpt["jax"] if mode == "volume"
                else ""), stacks=jstacks, mask=jmask, mesh=mesh,
        mesh_mode=mode) for mode, mesh in meshes.items()}
    return ranks, ref, ckpt


@pytest.mark.parametrize("mode", ["volume", "grid"])
def test_run_svr_slab_mode_matches_jax(runs, mode):
    ranks, ref, _ = runs
    out, want = ranks[mode][0], ref[mode]
    assert out["recon"].shape == want.reconstructed.data.shape == (19, 16, 18)
    assert np.isfinite(out["recon"]).all()
    for got, ok in ((out["recon"], want.reconstructed.data),
                    (out["bspline"], want.bspline_reconstructed.data)):
        assert got.shape == ok.shape
        err = np.abs(got - ok).max()
        assert err <= REC_TOL * np.abs(ok).max(), err
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(out["transforms"], want.transforms))
    assert d <= PARAM_TOL, d
    np.testing.assert_allclose(out["slice_weights"], want.slice_weights,
                               atol=1e-3)
    np.testing.assert_array_equal(out["slice_inside"], want.slice_inside)
    assert list(out["excluded"]) == list(want.excluded_slices)


def test_checkpoints_hold_the_padded_volume(runs):
    _, _, ckpt = runs
    for it in range(BASE["iterations"]):
        name = f"checkpoint_iter{it:03d}.npz"
        got = load_checkpoint(f"{ckpt['port']}/{name}")
        want = jax_load_checkpoint(f"{ckpt['jax']}/{name}")
        assert got["recon"].data.shape == (20, 16, 18)
        err = np.abs(got["recon"].data - want["recon"].data).max()
        assert err <= REC_TOL * np.abs(want["recon"].data).max(), err


def test_ranks_return_bitwise_equal_results(runs):
    ranks, _, _ = runs
    for name, per_rank in ranks.items():
        for r in per_rank[1:]:
            for k, v in per_rank[0].items():
                np.testing.assert_array_equal(r[k], v, err_msg=name + k)


def test_cli_volume_mode_writes_the_library_volume(data, runs, tmp_path,
                                                   monkeypatch):
    _, _, _, paths, mpath = data
    ranks, _, _ = runs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "recon.nii.gz")
    rc = svr_main.main(["-o", out, "-i", *paths, "-m", mpath, "--useCPU",
                        "--mesh", "2", "--mesh-mode", "volume", "--debug",
                        "--log_prefix", str(tmp_path / "p_"), *CLI_FLAGS])
    assert rc == 0
    vol = read_nifti(out).data
    np.testing.assert_array_equal(vol, ranks["volume_files"][0]["recon"])
    zs, ys, xs = vol.shape
    assert zs % 2  # the dumps hold the grid padded to 2 slabs
    for dump in ("image0", "confidence_map0"):
        assert read_nifti(str(tmp_path / f"p_{dump}.nii.gz")).data.shape \
            == (zs + 1, ys, xs)


def test_cli_distributed_volume_mode(data, runs, tmp_path):
    _, _, _, paths, mpath = data
    ranks, _, _ = runs
    out = str(tmp_path / "recon.nii.gz")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "fetalreconstruction_tpu_torch.cli.svr_main",
           "-o", out, "-i", *paths, "-m", mpath, "--useCPU",
           "--distributed", "--mesh-mode", "volume", "--log_prefix",
           str(tmp_path / "p_"), *CLI_FLAGS]
    procs = [subprocess.Popen(cmd, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    np.testing.assert_array_equal(read_nifti(out).data,
                                  ranks["volume_files"][0]["recon"])


@pytest.mark.parametrize("mode", ["volume", "grid"])
def test_exact_engine_is_refused_as_in_jax(data, mode):
    (jstacks, jmask), stacks, mask, _, _ = data
    cfg = dict(BASE, engine="exact", iterations=1)
    fake = sharded.Mesh(None, 0, 4, torch.device("cpu"))
    with pytest.raises(ValueError, match="requires engine='fast'"):
        svr.run_svr(SVRConfig(**cfg), stacks=stacks, mask=mask,
                    device="cpu", mesh=fake, mesh_mode=mode)
    jmesh = jvs.make_vol_mesh(jax.devices()[:2])
    with pytest.raises(ValueError, match="requires engine='fast'"):
        jsvr.run_svr(JConfig(**cfg), stacks=jstacks, mask=jmask, mesh=jmesh,
                     mesh_mode="volume")


def test_manual_mask_is_refused_where_jax_fails(data):
    """The JAX package's slab geometry has no scatter plan, so its
    --manualMask step fails there; the port refuses the flag up front."""
    _, stacks, mask, _, _ = data
    geom = jvs.VSGeom(*(jnp.ones((1, 2, 2)) for _ in range(5)))
    with pytest.raises(AttributeError, match="plan"):
        jax_manual_mask(types.SimpleNamespace(fast=types.SimpleNamespace(
            terms=[]), vol_shape=(2, 2, 2)), geom, geom.sume, geom.sume,
            geom.valid > 0, jnp.ones(8))
    cfg = SVRConfig(**dict(BASE, manual_mask="manual.nii.gz"))
    with pytest.raises(ValueError, match="--manualMask"):
        svr.run_svr(cfg, stacks=stacks, mask=mask, device="cpu",
                    mesh=sharded.Mesh(None, 0, 2, torch.device("cpu")),
                    mesh_mode="volume")
