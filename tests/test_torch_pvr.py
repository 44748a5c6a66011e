"""The port's PVR and patch modes vs the JAX package, and its CLI.

test_pvr.py's problem (phantom n=24 at 1.8 mm, two noisy stacks; the
fast engine, reg_levels=1, reg_iterations=2, the "coord-scan"
registration) through both packages on the CPU:

- run_svr in the SVR tool's patch (10/5) and superpixel modes;
- run_pvr with square patches (10/5) and the evaluation harness
  (--evaluateGt, --evaluation with the per-patch 2D battery,
  --evaluateBaseline, --patchExtraction), whole slices, superpixels,
  two hierarchical levels (14/7 then 10/5) and --resample.

With the mask given, JAX's run_pvr with square patches is its run_svr in
patch mode: the same extract_patches call as slice factory
(pipeline/pvr.py:131-136 and pipeline/svr.py:418-424 of the JAX package),
and the evaluation hook only reads the volume.  So the port's run_svr in
patch mode is held against that one JAX run, which saves a pipeline run.

The whole-slice run dilates the mask (--dilateMask 1) and the --resample
run takes PVR's default mask, the stacks' overlap.  Runs with two outer
iterations register the patches once; the others run
one (hierarchical: one per level, so the second level registers at its
iteration 0 against the first level's volume).  Limits as in
test_torch_svr_pipeline.py: the reconstruction within 1e-3 of max|ref|,
patch transforms within 0.05 mm / deg, PSNR within 0.1 dB; the
evaluation files agree to 1e-4 of each column's largest value (the CSVs
print 6 significant digits).  PVRConfig and the CLI's flags equal JAX's;
`pvr-reconstruct-torch --useCPU` and its refusals run on the port alone.
"""
import dataclasses
import os

import numpy as np
import pytest

import torch

from fetalreconstruction_tpu.cli import pvr_main as jcli
from fetalreconstruction_tpu.core.geometry import matrix_to_params
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.io.nifti import read_nifti, write_nifti
from fetalreconstruction_tpu.pipeline import pvr as jpvr
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu.pipeline.config import SVRConfig
from fetalreconstruction_tpu_torch.cli import pvr_main
from fetalreconstruction_tpu_torch.pipeline import pvr, svr

from phantom import make_ground_truth, simulate_stacks
from test_torch_svr_pipeline import PARAM_TOL, PSNR_TOL, REC_TOL, _psnr
from torch_threads import one_torch_thread  # noqa: F401

CSV_TOL = 1e-4
BASE = dict(iterations=2, resolution=1.8, rec_iterations_first=3,
            rec_iterations_last=4, smooth_mask=2.0, multires_levels=2,
            reg_levels=1, reg_iterations=2, reg_optimizer="coord-scan",
            patch_size=10, patch_stride=5, no_log=True)
MODES = {
    "svr_patch": ("svr", dict(patch_based=True)),
    "svr_superpixel": ("svr", dict(superpixel_based=True,
                                   num_superpixels=12.0, iterations=1)),
    "square": ("pvr", dict(patch_extraction=True, evaluate_2d=True,
                           evaluate_baseline=True)),
    "full_slices": ("pvr", dict(use_full_slices=True, iterations=1,
                                dilate_mask=1)),
    "superpixel": ("pvr", dict(superpixel=True, spx_size=8)),
    "hierarchical": ("pvr", dict(hierarchical=True, hier_levels=2,
                                 patch_size=14, patch_stride=7,
                                 iterations=1)),
    "resample": ("pvr", dict(resample=True, iterations=1)),
}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    gt = make_ground_truth(n=24, spacing=1.8)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.2, dz=3.6,
                                noise=1.0)
    mask = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    d = tmp_path_factory.mktemp("inputs")
    write_nifti(gt, str(d / "gt.nii.gz"))
    write_nifti(mask, str(d / "evalmask.nii.gz"))
    return gt, stacks, mask, d


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """Lazily run each mode through both packages, each in a working
    directory of its own (the evaluation harness writes there)."""
    gt, stacks, mask, inputs = data
    cache = {}

    def get(mode):
        if mode not in cache:
            entry, kw = MODES[mode]
            kw = dict(BASE, **kw)
            # PVR's default mask, the stacks' overlap, in one mode
            m = None if mode == "resample" else mask
            if mode == "square":
                kw.update(evaluate_gt=str(inputs / "gt.nii.gz"),
                          evaluation_masks=[str(inputs / "evalmask.nii.gz")])
            dirs = [tmp_path_factory.mktemp(f"{mode}_{side}")
                    for side in ("jax", "port")]
            here = os.getcwd()
            try:
                os.chdir(dirs[0])
                if mode == "svr_patch":
                    ref = get("square")[0]
                elif entry == "svr":
                    ref = jsvr.run_svr(SVRConfig(**kw), stacks=stacks,
                                       mask=m)
                else:
                    ref = jpvr.run_pvr(jpvr.PVRConfig(**kw), stacks=stacks,
                                       mask=m)
                os.chdir(dirs[1])
                if entry == "svr":
                    out = svr.run_svr(SVRConfig(**kw), stacks=stacks,
                                      mask=m, device="cpu")
                else:
                    out = pvr.run_pvr(pvr.PVRConfig(**kw), stacks=stacks,
                                      mask=m, device="cpu")
            finally:
                os.chdir(here)
            cache[mode] = (ref, out, dirs)
        return cache[mode]

    return get


@pytest.mark.parametrize("mode", list(MODES))
def test_matches_jax(data, runs, mode):
    ref, out, _ = runs(mode)
    a, b = out.reconstructed, ref.reconstructed
    assert a.attr == b.attr and a.data.shape == b.data.shape
    assert np.isfinite(a.data).all() and a.data.max() > 0
    err = np.abs(a.data - b.data).max() / np.abs(b.data).max()
    assert err <= REC_TOL, err
    assert out.transforms.shape == ref.transforms.shape
    # patches, not slices: more of them than the stacks have slices
    assert out.transforms.shape[0] > sum(s.attr.z for s in data[1]) or \
        mode == "full_slices"
    d = max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
            for p, q in zip(out.transforms, ref.transforms))
    assert d <= PARAM_TOL, d
    np.testing.assert_allclose(out.slice_weights, ref.slice_weights,
                               atol=1e-3)
    p_out, p_ref = _psnr(data[0], a), _psnr(data[0], b)
    assert abs(p_out - p_ref) <= PSNR_TOL, (p_out, p_ref)


def _csv(path):
    rows = [r.rstrip(",").split(",") for r in
            open(path).read().splitlines() if r.strip()]
    return rows[0], [r[0] for r in rows[1:]], \
        np.array([[float(v) for v in r[1:]] for r in rows[1:]])


def test_evaluation_files_match_jax(runs):
    _, _, (jdir, pdir) = runs("square")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(pdir))
    csvs = [n for n in names if n.endswith(".csv")]
    # Gt, the 3D baseline, the mask's 3D rows, the 2D battery per stack
    # and iteration, and the 2D baseline
    assert "log-evaluate-Gt.csv" in csvs and "log-evaluate-evalmask.csv" \
        in csvs and len(csvs) == 3 + 2 * 2 + 1, csvs
    for name in csvs:
        h_ref, lab_ref, v_ref = _csv(jdir / name)
        h_out, lab_out, v_out = _csv(pdir / name)
        assert h_out == h_ref and lab_out == lab_ref, name
        assert v_out.shape == v_ref.shape and v_ref.size > 0, name
        scale = np.maximum(np.abs(v_ref).max(axis=0), 1e-12)
        err = (np.abs(v_out - v_ref) / scale).max()
        assert err <= CSV_TOL, (name, err)
    dssim = [n for n in names if n.startswith("dssim-iter-")]
    assert len(dssim) == 2
    for name in dssim:
        r, o = read_nifti(str(jdir / name)).data, \
            read_nifti(str(pdir / name)).data
        assert np.abs(o - r).max() <= CSV_TOL * max(np.abs(r).max(), 1e-12)
    dumps = [n for n in names if n.endswith(".npz")]
    assert dumps == ["patches_10_5.npz"]
    with np.load(jdir / dumps[0]) as r, np.load(pdir / dumps[0]) as o:
        for k in r.files:
            np.testing.assert_array_equal(o[k], r[k])


def test_config_matches_jax():
    mine = {f.name: f for f in dataclasses.fields(pvr.PVRConfig)}
    ref = {f.name: f for f in dataclasses.fields(jpvr.PVRConfig)}
    assert list(mine) == list(ref)
    assert pvr.PVRConfig() == pvr.PVRConfig(**dataclasses.asdict(
        jpvr.PVRConfig()))
    # the port's own SVRConfig, the same fields and defaults as JAX's
    assert issubclass(pvr.PVRConfig, svr.SVRConfig)
    assert svr.SVRConfig() == svr.SVRConfig(**dataclasses.asdict(
        SVRConfig()))


def test_parser_flags_match_jax():
    def flags(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs,
                         a.type, a.required)
                for a in parser._actions}

    assert flags(pvr_main.build_parser()) == flags(jcli.build_parser())
    args = pvr_main.build_parser().parse_args(
        ["-i", "a.nii.gz", "--thickness", "2.5", "3", "--useCPU"])
    assert args.thickness == [2.5, 3.0] and args.useCPU


def test_cli_use_cpu(data, tmp_path):
    gt, stacks, mask, inputs = data
    paths = []
    for i, st in enumerate(stacks):
        paths.append(str(tmp_path / f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    out = str(tmp_path / "recon.nii.gz")
    rc = pvr_main.main(["-o", out, "-i", *paths, "-m",
                        str(inputs / "evalmask.nii.gz"), "--useCPU",
                        "--iterations", "1", "--resolution", "1.8",
                        "--patchSize", "10", "--patchStride", "5",
                        "--smooth_mask", "2.0", "--rec_iterations_first",
                        "2", "--rec_iterations_last", "2", "--no_log",
                        "--log_prefix", str(tmp_path / "p_")])
    assert rc == 0
    img = read_nifti(out)
    assert img.data.ndim == 3 and np.isfinite(img.data).all()
    assert img.data.max() > 0
    assert any(f.startswith("p_performance_") for f in os.listdir(tmp_path))


@pytest.mark.parametrize("flags,exc,match", [
    (["--mesh", "2"], RuntimeError, "no CUDA device"),
    ([], RuntimeError, "no CUDA device"),
])
def test_cli_refusals(monkeypatch, flags, exc, match):
    # the CLI never falls back to the CPU: without --useCPU it needs a card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(exc, match=match):
        pvr_main.main(["-i", "missing.nii.gz", *flags])


def test_fast_psf_needs_contiguous_stacks(data):
    """FastPSF.from_batch takes each stack's kernel from its first member,
    so the members of a stack must be contiguous in the batch."""
    from fetalreconstruction_tpu.patches.extract import extract_patches
    from fetalreconstruction_tpu_torch.ops.psf_fast import FastPSF
    batch = extract_patches(data[1], [3.6, 3.6], 10, 5)
    w2i = data[0].attr.w2i()
    assert FastPSF.from_batch(batch, w2i, 5).n_stacks == 2
    batch.stack_index = batch.stack_index[::-1].copy()
    batch.stack_index[0], batch.stack_index[1] = 0, 1
    with pytest.raises(ValueError, match="not contiguous"):
        FastPSF.from_batch(batch, w2i, 5)


def test_run_pvr_refuses_a_mesh(data):
    """A mesh whose rank runs on another device than the one asked for."""
    from fetalreconstruction_tpu_torch.parallel.sharded import Mesh
    _, stacks, mask, _ = data
    mesh = Mesh(None, 0, 1, torch.device("cuda", 0))
    with pytest.raises(ValueError, match="runs on cuda:0, not on cpu"):
        pvr.run_pvr(pvr.PVRConfig(**BASE), stacks=stacks, mask=mask,
                    mesh=mesh, device="cpu")
