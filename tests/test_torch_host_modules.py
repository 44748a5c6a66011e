"""The port's own host modules against their JAX-package originals on the
same inputs: geometry and Image, NIfTI and .dof files crossing between the
two packages, checkpoints, SLIC (native and numpy), patch extraction,
morphology, template selection, slice batches, configs, the CLI parsers,
and the host C++ library's build location."""
import dataclasses

import numpy as np
import pytest

from fetalreconstruction_tpu import native as jnative
from fetalreconstruction_tpu.cli import pvr_main as jpvr_cli
from fetalreconstruction_tpu.cli import svr_main as jsvr_cli
from fetalreconstruction_tpu.core import geometry as jgeo
from fetalreconstruction_tpu.core import image as jimage
from fetalreconstruction_tpu.io import dof as jdof
from fetalreconstruction_tpu.io import nifti as jnifti
from fetalreconstruction_tpu.ops import morphology as jmorph
from fetalreconstruction_tpu.patches import extract as jextract
from fetalreconstruction_tpu.patches import slic as jslic
from fetalreconstruction_tpu.pipeline import checkpoint as jckpt
from fetalreconstruction_tpu.pipeline import config as jconfig
from fetalreconstruction_tpu.pipeline import state as jstate
from fetalreconstruction_tpu.utils import motion as jmotion
from fetalreconstruction_tpu_torch import native
from fetalreconstruction_tpu_torch.cli import pvr_main, svr_main
from fetalreconstruction_tpu_torch.core import geometry, image
from fetalreconstruction_tpu_torch.io import dof, nifti
from fetalreconstruction_tpu_torch.ops import morphology
from fetalreconstruction_tpu_torch.patches import extract, slic
from fetalreconstruction_tpu_torch.pipeline import checkpoint, config, state
from fetalreconstruction_tpu_torch.utils import convert, motion
from fetalreconstruction_tpu_torch.utils.perfstats import PerfStats

from phantom import make_ground_truth, simulate_stacks


def _attr_tuple(a):
    return dataclasses.astuple(a)


@pytest.fixture(scope="module")
def stacks():
    gt = make_ground_truth(n=24, spacing=2.0)
    st, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.0, dz=4.0, noise=1.0)
    return gt, st


def _rotated_image(rng, shape=(6, 7, 8)):
    a = jgeo.ImageAttributes(x=shape[2], y=shape[1], z=shape[0], dx=1.25,
                             dy=1.5, dz=2.0, xorigin=3.0, yorigin=-1.0,
                             zorigin=0.5)
    r = jgeo.rigid_matrix([0, 0, 0, 10.0, -20.0, 5.0])[:3, :3]
    a.xaxis, a.yaxis, a.zaxis = (tuple(r[:, i]) for i in range(3))
    return jimage.Image(rng.normal(50, 10, shape).astype(np.float32), a)


# ---------------------------------------------------------------------------
# geometry, Image, SliceBatch, configs, PerfStats
# ---------------------------------------------------------------------------

def test_geometry_host_half_matches_jax():
    rng = np.random.default_rng(0)
    for _ in range(5):
        p = np.concatenate([rng.uniform(-5, 5, 3), rng.uniform(-40, 40, 3)])
        m = geometry.rigid_matrix(p)
        np.testing.assert_array_equal(m, jgeo.rigid_matrix(p))
        np.testing.assert_array_equal(geometry.matrix_to_params(m),
                                      jgeo.matrix_to_params(m))
        np.testing.assert_array_equal(geometry.invert_rigid(m),
                                      jgeo.invert_rigid(m))
    gimbal = jgeo.rigid_matrix([1, 2, 3, 10, 90, 20])
    np.testing.assert_array_equal(geometry.matrix_to_params(gimbal),
                                  jgeo.matrix_to_params(gimbal))
    img = _rotated_image(rng)
    a = convert.image_from(img).attr
    assert isinstance(a, geometry.ImageAttributes)
    np.testing.assert_array_equal(a.i2w(), img.attr.i2w())
    np.testing.assert_array_equal(a.w2i(), img.attr.w2i())
    pts = rng.uniform(-5, 5, (10, 3))
    np.testing.assert_array_equal(a.image_to_world(pts),
                                  img.attr.image_to_world(pts))
    assert _attr_tuple(a.region(1, 2, 1, 5, 6, 4)) == \
        _attr_tuple(img.attr.region(1, 2, 1, 5, 6, 4))
    assert _attr_tuple(a.with_spacing(0.8, 0.8, 0.8)) == \
        _attr_tuple(img.attr.with_spacing(0.8, 0.8, 0.8))


def test_image_and_split_4d_match_jax():
    rng = np.random.default_rng(1)
    img = _rotated_image(rng)
    mine = convert.image_from(img)
    assert isinstance(mine, image.Image) and mine.data is not img.data
    sub, ref = mine.get_region(1, 1, 1, 6, 5, 4), img.get_region(1, 1, 1,
                                                                 6, 5, 4)
    np.testing.assert_array_equal(sub.data, ref.data)
    assert _attr_tuple(sub.attr) == _attr_tuple(ref.attr)
    mask = jimage.Image((img.data > 50).astype(np.float32), img.attr.copy())
    c, r = mine.crop_to_mask(mask, boundary=1), img.crop_to_mask(mask,
                                                                 boundary=1)
    np.testing.assert_array_equal(c.data, r.data)
    assert mine.min_max(45.0) == img.min_max(45.0)
    d4 = rng.normal(size=(3,) + img.data.shape).astype(np.float32)
    for a, b in zip(image.split_4d(d4, mine.attr),
                    jimage.split_4d(d4, img.attr)):
        np.testing.assert_array_equal(a.data, b.data)
        assert _attr_tuple(a.attr) == _attr_tuple(b.attr)


def test_create_slices_matches_jax(stacks):
    _, st = stacks
    a = state.create_slices(st, [4.0, 5.0], pad_to=(30, 30))
    b = jstate.create_slices(st, [4.0, 5.0], pad_to=(30, 30))
    for f in ("data", "i2w", "dims", "stack_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
    assert [_attr_tuple(x) for x in a.attrs] == \
        [_attr_tuple(x) for x in b.attrs]
    assert [f.name for f in dataclasses.fields(state.SliceBatch)] == \
        [f.name for f in dataclasses.fields(jstate.SliceBatch)]
    assert state.EMState._fields == jstate.EMState._fields
    assert state.SimState._fields == jstate.SimState._fields


def test_config_matches_jax():
    assert [f.name for f in dataclasses.fields(config.SVRConfig)] == \
        [f.name for f in dataclasses.fields(jconfig.SVRConfig)]
    j = jconfig.SVRConfig(iterations=2, engine="exact", thickness=[3.0],
                          manual_mask="m.nii", bspline=True)
    mine = convert.config_from(j)
    assert type(mine) is config.SVRConfig
    assert dataclasses.asdict(mine) == dataclasses.asdict(j)
    assert config.SVRConfig() == convert.config_from(jconfig.SVRConfig())


def test_perfstats_table():
    s = PerfStats()
    s.sample("a")
    s.sample("b")
    s.sample("a")
    assert len(s.samples("a")) == 2 and s.samples("missing") == []
    rows = s.table().splitlines()
    assert rows[0].split() == ["phase", "total[s]", "count", "mean[s]"]
    assert [r.split()[0] for r in rows[1:]] == ["a", "b", "TOTAL"]


# ---------------------------------------------------------------------------
# files across the two packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_nifti_crosses_packages(tmp_path, suffix, writer):
    rng = np.random.default_rng(2)
    img = _rotated_image(rng)
    path = str(tmp_path / ("v" + suffix))
    if writer == "port":
        nifti.write_nifti(convert.image_from(img), path)
        back = jnifti.read_nifti(path)
    else:
        jnifti.write_nifti(img, path)
        back = nifti.read_nifti(path)
    np.testing.assert_array_equal(back.data, img.data)
    np.testing.assert_allclose(back.attr.i2w(), img.attr.i2w(), atol=1e-6)
    np.testing.assert_allclose(nifti.attr_to_affine(back.attr),
                               jnifti.attr_to_affine(img.attr), atol=1e-6)


def test_read_stacks_matches_jax(tmp_path, stacks):
    _, st = stacks
    paths = []
    for i, s in enumerate(st):
        paths.append(str(tmp_path / f"s{i}.nii.gz"))
        jnifti.write_nifti(s, paths[-1])
    for a, b in zip(nifti.read_stacks(paths), jnifti.read_stacks(paths)):
        np.testing.assert_array_equal(a.data, b.data)
        assert _attr_tuple(a.attr) == _attr_tuple(b.attr)


@pytest.mark.parametrize("name", ["t.dof", "t.dof.gz"])
def test_dof_crosses_packages(tmp_path, name):
    m = jgeo.rigid_matrix([1.5, -2.0, 0.25, 12.0, -7.5, 33.0])
    dof.write_dof(str(tmp_path / ("p" + name)), m)
    jdof.write_dof(str(tmp_path / ("j" + name)), m)
    if not name.endswith(".gz"):  # a gzip frame carries a time stamp
        assert (tmp_path / ("p" + name)).read_bytes() == \
            (tmp_path / ("j" + name)).read_bytes()
    np.testing.assert_allclose(jdof.read_dof(str(tmp_path / ("p" + name))),
                               m, atol=1e-12)
    np.testing.assert_array_equal(dof.read_dof(str(tmp_path / ("j" + name))),
                                  jdof.read_dof(str(tmp_path / ("j" + name))))
    ts = np.stack([m, jgeo.invert_rigid(m)])
    dof.save_transformations(str(tmp_path / "f"), ts)
    np.testing.assert_array_equal(
        jdof.read_transformations(str(tmp_path / "f"), 2),
        dof.read_transformations(str(tmp_path / "f"), 2))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    rng = np.random.default_rng(4)
    img = _rotated_image(rng)
    tr = np.stack([jgeo.rigid_matrix(rng.uniform(-3, 3, 6))
                   for _ in range(5)])
    kw = dict(slice_weights=rng.uniform(size=5), scales=rng.uniform(size=5),
              stack_factors=np.ones(2), extra=dict(sigma2=12.5))
    path = str(tmp_path / "ck.npz")
    if writer == "port":
        checkpoint.save_checkpoint(path, 3, convert.image_from(img), tr,
                                   **kw)
        back, again = jckpt.load_checkpoint(path), checkpoint.load_checkpoint(
            path)
    else:
        jckpt.save_checkpoint(path, 3, img, tr, **kw)
        back, again = checkpoint.load_checkpoint(path), jckpt.load_checkpoint(
            path)
    assert back.keys() == again.keys() and back["iteration"] == 3
    np.testing.assert_array_equal(back["recon"].data, img.data)
    np.testing.assert_allclose(back["recon"].attr.i2w(), img.attr.i2w())
    for k in ("transforms", "slice_weights", "scales", "stack_factors",
              "sigma2"):
        np.testing.assert_array_equal(back[k], again[k])


# ---------------------------------------------------------------------------
# SLIC, patches, morphology, template selection
# ---------------------------------------------------------------------------

def _slic_image(h=60, w=52, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = (200.0 * np.exp(-(((yy - h / 2) / (h / 3)) ** 2
                            + ((xx - w / 2) / (w / 3)) ** 2))
           + 30.0 * rng.standard_normal((h, w)))
    return np.maximum(img, 0).astype(np.float32)


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_slic_labels_match_jax(path, monkeypatch):
    if path == "native" and (native.get_lib() is None
                             or jnative.get_lib() is None):
        pytest.skip("no g++ for the host C++ library")
    if path == "numpy":
        for mod in (native, jnative):
            monkeypatch.setattr(mod, "_LIB", None)
            monkeypatch.setattr(mod, "_TRIED", True)
    img = _slic_image()
    for n in (8, 20):
        np.testing.assert_array_equal(
            slic.slic_labels(img, compactness=10.0, num_superpixels=n),
            jslic.slic_labels(img, compactness=10.0, num_superpixels=n))


def test_superpixel_patches_match_jax(stacks):
    _, st = stacks
    kw = dict(spx_size=8, spx_extend=50, max_patch=16)
    a = slic.extract_superpixel_patches(st, [4.0, 4.0], **kw)
    b = jslic.extract_superpixel_patches(st, [4.0, 4.0], **kw)
    assert a.n_slices == b.n_slices > 4
    for f in ("data", "i2w", "dims", "stack_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("full", [False, True])
def test_extract_patches_matches_jax(stacks, full):
    gt, st = stacks
    mask = jimage.Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    tr = np.stack([np.eye(4), jgeo.rigid_matrix([1, 0, -1, 2, 0, 3])])
    a = extract.extract_patches(st, [4.0, 4.0], 10, 5, mask=mask,
                                stack_transforms=tr, use_full_slices=full)
    b = jextract.extract_patches(st, [4.0, 4.0], 10, 5, mask=mask,
                                 stack_transforms=tr, use_full_slices=full)
    assert a.n_slices == b.n_slices > 0
    for f in ("data", "i2w", "dims", "stack_index"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("connectivity", [6, 18, 26])
def test_morphology_matches_jax(connectivity):
    rng = np.random.default_rng(5)
    m = rng.uniform(size=(12, 13, 14)) > 0.9
    for it in (1, 3):
        np.testing.assert_array_equal(
            morphology.dilate(m, it, connectivity),
            jmorph.dilate(m, it, connectivity))
        np.testing.assert_array_equal(
            morphology.erode(~m, it, connectivity),
            jmorph.erode(~m, it, connectivity))


def test_select_template_matches_jax(stacks):
    _, st = stacks
    st = list(st) + [jimage.Image(st[0].data[::-1].copy(),
                                  st[0].attr.copy())]
    assert motion.select_template(st) == jmotion.select_template(st)
    for s in st:
        assert motion.evaluate_stack_motion(s) == \
            jmotion.evaluate_stack_motion(s)


# ---------------------------------------------------------------------------
# the CLI parsers and the host library
# ---------------------------------------------------------------------------

SVR_ARGV = [
    ["-i", "a.nii.gz"],
    ["-i", "a.nii.gz", "b.nii.gz", "-o", "r.nii.gz", "-m", "m.nii.gz",
     "--engine", "exact", "--manualMask", "mm.nii.gz", "--bspline",
     "--useCPU", "--iterations", "3", "--lambda", "0.05",
     "--thickness", "2.5", "3", "-p", "2", "2", "--enableBiasCorrection"],
    ["-i", "a.nii", "--patchBased", "--patchSize", "32", "--patchStride",
     "16", "-t", "x.dof", "id", "--force_exclude", "1", "4",
     "--superpixel", "64", "--checkpoint", "ck", "--resume", "--no_log",
     "--mesh", "2", "--mesh-mode", "volume", "--trace", "tr",
     "--distributed", "-d", "0", "1"],
]
PVR_ARGV = [
    ["-i", "a.nii.gz"],
    ["-i", "a.nii.gz", "b.nii.gz", "--superpixel", "--spxSize", "32",
     "--hierarchical", "--resample", "--dilateMask", "2", "--engine",
     "exact", "--evaluation", "e1.nii", "e2.nii", "--useFullSlicePatches",
     "--useCPU", "--mesh", "2"],
]


@pytest.mark.parametrize("argv", SVR_ARGV)
def test_svr_parser_matches_jax(argv):
    assert vars(svr_main.build_parser().parse_args(argv)) == \
        vars(jsvr_cli.build_parser().parse_args(argv))


@pytest.mark.parametrize("argv", PVR_ARGV)
def test_pvr_parser_matches_jax(argv):
    assert vars(pvr_main.build_parser().parse_args(argv)) == \
        vars(jpvr_cli.build_parser().parse_args(argv))


def test_log_redirect_matches_jax(tmp_path, capsys):
    for mod, tag in ((svr_main, "t"), (jsvr_cli, "j")):
        with mod._LogRedirect(str(tmp_path / f"{tag}_"), True):
            print("to the log")
    assert capsys.readouterr().out == ""
    assert (tmp_path / "t_log-reconstruction.txt").read_text() == \
        (tmp_path / "j_log-reconstruction.txt").read_text() == "to the log\n"


def test_native_library_builds_into_build_dir():
    if native.get_lib() is None:
        pytest.skip("no g++ for the host C++ library")
    so = native._so_path()
    assert so.exists() and so.parent.parent.name == "_build"
    src = so.parents[2] / "csrc"
    assert {p.name for p in src.glob("*.cc")} >= {"slic.cc", "niftiz.cc"}
    assert not list((so.parents[2] / "native").glob("*.so"))
