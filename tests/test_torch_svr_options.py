"""The port's run_svr against the JAX package's, option by option.

On svr_parity's problem and config, both packages' run_svr on the same
inputs, held at svr_parity's limits: per-slice transforms read from a
folder (--tfolder), slice data read from a folder (--sfolder), a 4D input
stack, --num_stacks_tuner, --force_exclude and the reference-volume seed.
The seeded run also writes checkpoints and the evaluation log, which are
held against JAX's; both packages then resume from JAX's checkpoints.
"""
import os
import shutil

import numpy as np
import pytest

from fetalreconstruction_tpu.core.geometry import (ImageAttributes,
                                                   rigid_matrix)
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.io.dof import save_transformations
from fetalreconstruction_tpu.io.nifti import write_nifti
from fetalreconstruction_tpu.pipeline import checkpoint as jckpt
from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu_torch.pipeline import svr

from svr_parity import (assert_same_run, assert_same_volume, make_problem,
                        max_param_diff, moved, PARAM_TOL, svr_cfg)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def data():
    return make_problem()


class _Stop(Exception):
    pass


def _port_slice_batch(data, monkeypatch):
    """The slice batch that run_svr builds on the problem (the port's,
    which test_torch_svr_pipeline holds to JAX's), the run stopped there."""
    gt, stacks, mask_img = data
    seen, build = [], svr.create_slices

    def create_slices(st, th):
        seen.append(build(st, th))
        raise _Stop

    with monkeypatch.context() as m:
        m.setattr(svr, "create_slices", create_slices)
        with pytest.raises(_Stop):
            svr.run_svr(svr_cfg(), stacks=stacks, mask=mask_img,
                        device="cpu")
    return seen[0]


def _tfolder(data, tmp_path, monkeypatch):
    """Per-slice transforms of random 0.5 mm / deg motions, more files than
    slices (the extra ones are not read)."""
    rng = np.random.default_rng(1)
    folder = str(tmp_path / "tf")
    save_transformations(folder, np.stack(
        [rigid_matrix(rng.uniform(-0.5, 0.5, 6)) for _ in range(40)]))
    return dict(cfg=dict(tfolder=folder))


def _sfolder(data, tmp_path, monkeypatch):
    """The batch's slices as 2D NIfTIs, slice 6 shifted by two pixels."""
    batch = _port_slice_batch(data, monkeypatch)
    folder = tmp_path / "sf"
    folder.mkdir()
    _, h, w = batch.data.shape
    for i, sl in enumerate(batch.data):
        if i == 6:
            sl = np.roll(sl, 2, axis=1)
        write_nifti(Image(sl[None].copy(), ImageAttributes(x=w, y=h, z=1)),
                    str(folder / f"slice{i:03d}.nii.gz"))
    return dict(cfg=dict(sfolder=str(folder)))


def _four_d(data, tmp_path, monkeypatch):
    """Both stacks as the two volumes of one 4D image (they share a grid),
    with one thickness and one package entry for it."""
    _, stacks, _ = data
    assert stacks[0].attr == stacks[1].attr
    four = Image(np.stack([stacks[0].data, stacks[1].data]),
                 stacks[0].attr.copy())
    split, thick, pkgs = svr._load_stacks(
        svr_cfg(thickness=[5.0], packages=[1]), [four])
    assert len(split) == 2 and thick == [5.0, 5.0] and pkgs == [1, 1]
    return dict(cfg=dict(thickness=[5.0], packages=[1]), stacks=[four])


def _tuner(data, tmp_path, monkeypatch):
    """Three stacks given, the first one used."""
    _, stacks, _ = data
    third = moved(stacks[0], [-1.0, 1.0, 0.5, -1.0, 0.0, 1.0])
    return dict(cfg=dict(num_stacks_tuner=1), stacks=stacks + [third])


def _force_excluded(data, tmp_path, monkeypatch):
    return dict(cfg=dict(force_excluded=[3, 5]))


CASES = {"tfolder": _tfolder, "sfolder": _sfolder, "4d-stack": _four_d,
         "num-stacks-tuner": _tuner, "force-excluded": _force_excluded}


@pytest.mark.parametrize("case", list(CASES))
def test_option_matches_jax(data, case, tmp_path, monkeypatch):
    gt, stacks, mask_img = data
    kw = CASES[case](data, tmp_path, monkeypatch)
    st = kw.get("stacks", stacks)
    ref = jsvr.run_svr(svr_cfg(**kw["cfg"]), stacks=st, mask=mask_img)
    out = svr.run_svr(svr_cfg(**kw["cfg"]), stacks=st, mask=mask_img,
                      device="cpu")
    assert_same_run(out, ref, gt)


@pytest.fixture(scope="module")
def seeded(data, tmp_path_factory):
    """Both packages seeded with the truth, writing checkpoints and the
    evaluation log: (JAX result, port result, JAX folder, port folder)."""
    gt, stacks, mask_img = data
    out = {}
    for name, run, kw in (("jax", jsvr.run_svr, {}),
                          ("port", svr.run_svr, dict(device="cpu"))):
        d = tmp_path_factory.mktemp(name)
        cfg = svr_cfg(checkpoint_dir=str(d / "ck"), no_log=False,
                      log_prefix=str(d / "run_"))
        out[name] = (run(cfg, stacks=stacks, mask=mask_img,
                         reference_volume=gt, **kw), d)
    return out["jax"][0], out["port"][0], out["jax"][1], out["port"][1]


def test_reference_seed_matches_jax(data, seeded):
    ref, out, jdir, pdir = seeded
    assert_same_run(out, ref, data[0])
    # the evaluation log lists each iteration's slices alike
    assert ((pdir / "run_log-evaluation.txt").read_text()
            == (jdir / "run_log-evaluation.txt").read_text())


def test_checkpoints_match_jax(seeded):
    ref, out, jdir, pdir = seeded
    names = sorted(os.listdir(jdir / "ck"))
    assert names == sorted(os.listdir(pdir / "ck")) == [
        "checkpoint_iter000.npz", "checkpoint_iter001.npz"]
    for name in names:
        a = jckpt.load_checkpoint(str(pdir / "ck" / name))
        b = jckpt.load_checkpoint(str(jdir / "ck" / name))
        assert a.keys() == b.keys() and a["iteration"] == b["iteration"]
        assert_same_volume(a["recon"], b["recon"])
        assert max_param_diff(a["transforms"], b["transforms"]) <= PARAM_TOL
        np.testing.assert_allclose(a["stack_factors"], b["stack_factors"],
                                   rtol=1e-6)
        np.testing.assert_allclose(a["slice_weights"], b["slice_weights"],
                                   atol=1e-3)


def test_resume_from_jax_checkpoints(data, seeded, tmp_path):
    """Both packages resume from JAX's checkpoint folder (each from its own
    copy, as a resume writes there) and redo the last iteration alike."""
    gt, stacks, mask_img = data
    _, _, jdir, _ = seeded
    res = {}
    for name, run, kw in (("jax", jsvr.run_svr, {}),
                          ("port", svr.run_svr, dict(device="cpu"))):
        ck = str(tmp_path / name)
        shutil.copytree(jdir / "ck", ck)
        seen = []
        res[name] = run(svr_cfg(checkpoint_dir=ck, resume=True),
                        stacks=stacks, mask=mask_img,
                        iteration_hook=lambda it, img, t: seen.append(it),
                        **kw)
        assert seen == [1]
    assert_same_run(res["port"], res["jax"], gt)
