"""The port's run_svr, run_pvr and CLIs under a slice mesh, on the CPU.

test_torch_pvr.py's problem (phantom n=24 at 1.8 mm, two noisy stacks of
9 slices after cropping; 2 outer iterations, one "coord-scan"
registration round) on gloo ranks (parallel/sharded.spawn, one CPU
process per rank):

- run_svr at world size 2 against the JAX package's run_svr on a
  2-device mesh of conftest.py's CPU devices, and against the port's
  single-rank run, at test_torch_svr_pipeline.py's limits (the volume
  within 1e-3 of max|ref|, slice transforms within 0.05 mm / deg, slice
  weights within 1e-3);
- world size 3 on the same phantom with 4 mm slices (16 slices, so two
  pad slices) against the single-rank run;
- run_pvr (square patches 10/5) at world size 2 against its single-rank
  run, at the same limits;
- `svr-reconstruct-torch --mesh 2 --useCPU --trace` and two processes
  started as a launcher would (`--distributed`, RANK / WORLD_SIZE /
  MASTER_ADDR / MASTER_PORT) against run_svr at world size 2 on the same
  files: the same volume, one trace per rank, rank 0 alone writing.

Every rank returns the same volume, bit for bit.  All ranks and the
library runs use one intra-op thread, so the CLI volumes equal the
library's exactly.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

from fetalreconstruction_tpu.core.geometry import matrix_to_params
from fetalreconstruction_tpu.core.image import Image as JImage
from fetalreconstruction_tpu.io.nifti import write_nifti
from fetalreconstruction_tpu.parallel import sharded as jsharded
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu.pipeline.config import SVRConfig as JConfig
from fetalreconstruction_tpu_torch.cli import svr_main
from fetalreconstruction_tpu_torch.io.nifti import read_nifti
from fetalreconstruction_tpu_torch.parallel import sharded
from fetalreconstruction_tpu_torch.pipeline import pvr, svr
from fetalreconstruction_tpu_torch.pipeline.config import SVRConfig
from fetalreconstruction_tpu_torch.utils.convert import image_from

from phantom import make_ground_truth, simulate_stacks
from test_torch_svr_pipeline import PARAM_TOL, REC_TOL
from torch_sharded_ranks import svr_rank
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]
BASE = dict(iterations=2, resolution=1.8, rec_iterations_first=3,
            rec_iterations_last=4, smooth_mask=2.0, multires_levels=2,
            reg_levels=1, reg_iterations=2, reg_optimizer="coord-scan",
            no_log=True)
PVR = dict(BASE, patch_size=10, patch_stride=5)
# the CLI's flags and the same configuration for the library
CLI_FLAGS = ["--iterations", "1", "--resolution", "1.8", "--smooth_mask",
             "2.0", "--multires", "2", "--rec_iterations_first", "3",
             "--rec_iterations_last", "4", "--no_log"]
CLI_KW = dict(iterations=1, resolution=1.8, smooth_mask=2.0,
              multires_levels=2, rec_iterations_first=3,
              rec_iterations_last=4, no_log=True)


def _problem(dz):
    """(JAX stacks, JAX mask, the port's stacks, the port's mask)."""
    gt = make_ground_truth(n=24, spacing=1.8)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.2, dz=dz,
                                noise=1.0)
    mask = JImage((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    return (stacks, mask, [image_from(s) for s in stacks],
            image_from(mask))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    jstacks, jmask, stacks, mask = _problem(3.6)
    d = tmp_path_factory.mktemp("inputs")
    paths = [str(d / f"stack{i}.nii.gz") for i in range(len(jstacks))]
    for p, st in zip(paths, jstacks):
        write_nifti(st, p)
    mpath = str(d / "mask.nii.gz")
    write_nifti(jmask, mpath)
    return (jstacks, jmask), stacks, mask, paths, mpath


def _spawn(world, tag, out, stacks, mask, **kw):
    sharded.spawn(svr_rank, world, BASE, stacks, mask, str(out), tag,
                  kw.get("files_kw"), kw.get("pvr_kw"), use_cpu=True)
    return {name: [dict(np.load(out / f"{name}_rank{r}.npz"))
                   for r in range(world)]
            for name in [tag] + [tag + s for s, k in
                                 (("_files", "files_kw"), ("_pvr", "pvr_kw"))
                                 if kw.get(k) is not None]}


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    (jstacks, jmask), stacks, mask, paths, mpath = data
    out = tmp_path_factory.mktemp("ranks")
    ranks = _spawn(2, "w2", out, stacks, mask,
                   files_kw=dict(CLI_KW, input_stacks=paths, mask=mpath),
                   pvr_kw=PVR)
    jmesh = jsharded.make_mesh(jax.devices()[:2])
    ref = jsvr.run_svr(JConfig(**BASE), stacks=jstacks, mask=jmask,
                       mesh=jmesh)
    single = svr.run_svr(SVRConfig(**BASE), stacks=stacks, mask=mask,
                         device="cpu")
    return ranks, ref, single


def _close(a, b, tol=REC_TOL):
    assert a.shape == b.shape
    err = np.abs(a - b).max() / np.abs(b).max()
    assert err <= tol, err


def _params_close(a, b):
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(a, b))
    assert d <= PARAM_TOL, d


def test_run_svr_mesh_matches_jax_mesh(runs):
    ranks, ref, _ = runs
    out = ranks["w2"][0]
    assert np.isfinite(out["recon"]).all()
    _close(out["recon"], ref.reconstructed.data)
    _params_close(out["transforms"], ref.transforms)
    np.testing.assert_allclose(out["slice_weights"], ref.slice_weights,
                               atol=1e-3)
    np.testing.assert_array_equal(out["slice_inside"], ref.slice_inside)
    assert list(out["excluded"]) == list(ref.excluded_slices)


def test_run_svr_mesh_matches_single_rank(runs):
    ranks, _, single = runs
    out = ranks["w2"][0]
    _close(out["recon"], single.reconstructed.data)
    _params_close(out["transforms"], single.transforms)
    np.testing.assert_allclose(out["slice_weights"], single.slice_weights,
                               atol=1e-3)


def test_ranks_return_bitwise_equal_results(runs):
    ranks, _, _ = runs
    for name, per_rank in ranks.items():
        for r in per_rank[1:]:
            for k, v in per_rank[0].items():
                np.testing.assert_array_equal(r[k], v, err_msg=name + k)


def test_world_size_three_pads_slices(tmp_path):
    _, _, stacks, mask = _problem(4.0)
    single = svr.run_svr(SVRConfig(**BASE), stacks=stacks, mask=mask,
                         device="cpu")
    n0 = len(single.slice_weights)
    assert n0 % 3, n0  # the world size must force pad slices
    (out,) = _spawn(3, "w3", tmp_path, stacks, mask).values()
    for r in out[1:]:
        np.testing.assert_array_equal(r["recon"], out[0]["recon"])
    out = out[0]
    n = sharded.pad_slices_for_mesh(n0, 3)
    assert out["transforms"].shape == (n, 4, 4)
    assert (out["slice_weights"][n0:] == 0).all()  # pads take no weight
    assert not out["slice_inside"][n0:].any()
    _close(out["recon"], single.reconstructed.data)
    _params_close(out["transforms"][:n0], single.transforms)
    np.testing.assert_allclose(out["slice_weights"][:n0],
                               single.slice_weights, atol=1e-3)


def test_run_pvr_mesh_matches_single_rank(data, runs):
    _, stacks, mask, _, _ = data
    ranks, _, _ = runs
    single = pvr.run_pvr(pvr.PVRConfig(**PVR), stacks=stacks, mask=mask,
                         device="cpu")
    out = ranks["w2_pvr"][0]
    n0 = len(single.slice_weights)
    assert n0 > 18  # patches, not slices
    _close(out["recon"], single.reconstructed.data)
    _params_close(out["transforms"][:n0], single.transforms)


def test_cli_mesh_writes_the_library_volume(data, runs, tmp_path,
                                            monkeypatch):
    """--mesh 2 --useCPU --trace --debug, with the logs on: rank 0 writes
    the volume (the library run's at world size 2), the logs, the debug
    dumps (whose per-slice rows every rank gathers) and one performance
    table, each rank a trace."""
    _, _, _, paths, mpath = data
    ranks, _, _ = runs
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = str(tmp_path / "recon.nii.gz")
    flags = [f for f in CLI_FLAGS if f != "--no_log"]
    rc = svr_main.main(["-o", out, "-i", *paths, "-m", mpath, "--useCPU",
                        "--mesh", "2", "--trace", str(tmp_path / "trace"),
                        "--debug", "--log_prefix", str(tmp_path / "p_"),
                        *flags])
    assert rc == 0
    np.testing.assert_array_equal(read_nifti(out).data,
                                  ranks["w2_files"][0]["recon"])
    assert sorted(os.listdir(tmp_path / "trace")) == ["trace_rank0.json",
                                                      "trace_rank1.json"]
    assert len([f for f in os.listdir(tmp_path)
                if f.startswith("p_performance_")]) == 1
    log = (tmp_path / "p_log-evaluation.txt").read_text()
    assert log.count("Iteration 0:") == 1
    dump = np.load(tmp_path / "p_em_state0.npz")
    n = len(ranks["w2_files"][0]["slice_weights"])
    assert dump["scales"].shape == (n,) and dump["bias"].shape[0] == n


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_cli_distributed_runs_as_launched_ranks(data, runs, tmp_path):
    """Two processes with a launcher's environment, as torchrun starts
    them: the same volume as run_svr at world size 2."""
    _, _, _, paths, mpath = data
    ranks, _, _ = runs
    out = str(tmp_path / "recon.nii.gz")
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="localhost",
               MASTER_PORT=str(_free_port()), OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    cmd = [sys.executable, "-m", "fetalreconstruction_tpu_torch.cli.svr_main",
           "-o", out, "-i", *paths, "-m", mpath, "--useCPU",
           "--distributed", "--log_prefix", str(tmp_path / "p_"), *CLI_FLAGS]
    procs = [subprocess.Popen(cmd, cwd=tmp_path, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(2)]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], logs
    np.testing.assert_array_equal(read_nifti(out).data,
                                  ranks["w2_files"][0]["recon"])
