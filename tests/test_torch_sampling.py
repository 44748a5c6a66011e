"""The port's samplers, resampling and Gaussian blurs vs the JAX package.

Same seeded numpy inputs through both.  Points lie inside the volume, on
its faces and edges (integer coordinates at 0 and n-1), just outside and
far outside, and the volumes carry padding values at corners.

Limits: 1e-5 relative to max|ref| for the linear samplers, resampling and
blurs (float32 arithmetic in the same order; only the libraries' roundings
differ); nearest neighbour must match exactly (it rounds half to even in
both, and the float32 grid matrix is formed the same way).
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from fetalreconstruction_tpu.core.geometry import ImageAttributes, rigid_matrix
from fetalreconstruction_tpu.ops import gaussian as jgauss
from fetalreconstruction_tpu.ops import sampling as jsamp
from fetalreconstruction_tpu_torch.ops import gaussian, sampling

TOL = 1e-5
SHAPE = (7, 9, 11)  # [z, y, x]


def _vol(seed=0, pad=None):
    rng = np.random.default_rng(seed)
    v = rng.uniform(1.0, 50.0, SHAPE).astype(np.float32)
    if pad is not None:
        v[0, 0, 0] = v[-1, -1, -1] = v[0, -1, 0] = pad
        v[3, 4, 5] = pad
    return v


def _points(seed=1):
    rng = np.random.default_rng(seed)
    zs, ys, xs = SHAPE
    inside = rng.uniform(0, 1, (200, 3)) * [xs - 1, ys - 1, zs - 1]
    faces = np.array([[0, 0, 0], [xs - 1, ys - 1, zs - 1], [xs - 1, 0, 3],
                      [0, ys - 1, 2.5], [4.5, 0, zs - 1], [xs - 1.5, 4, 0],
                      [2, 3, 4], [5.5, 6.5, 2.5]])
    outside = np.array([[-0.5, 3, 3], [xs - 0.5, 2, 2], [3, -1.0, 2],
                        [3, ys, 2], [1, 1, -0.25], [1, 1, zs - 0.75],
                        [-7, -7, -7], [40, 3, 3]])
    return np.concatenate([inside, faces, outside]).astype(np.float32)


def _rel(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    return np.abs(out - ref).max() / max(np.abs(ref).max(), 1e-30)


@pytest.mark.parametrize("padding", [0.0, -3.0])
def test_sample_linear(padding):
    v, p = _vol(), _points()
    ref = jsamp.sample_linear(jnp.asarray(v), jnp.asarray(p), padding)
    out = sampling.sample_linear(torch.from_numpy(v), torch.from_numpy(p),
                                 padding)
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("padding", [-1.0, 0.0])
def test_sample_linear_padded(padding):
    v, p = _vol(pad=padding), _points()
    ref = jsamp.sample_linear_padded(jnp.asarray(v), jnp.asarray(p), padding)
    out = sampling.sample_linear_padded(torch.from_numpy(v),
                                        torch.from_numpy(p), padding)
    assert (np.asarray(ref) == padding).sum() > 3  # the rule was exercised
    assert _rel(out, ref) <= TOL


def test_sample_nearest_exact():
    v = _vol()
    p = np.concatenate([_points(), [[2.5, 3.5, 1.5], [0.5, 0.5, 0.5],
                                    [-0.5, 2, 2]]]).astype(np.float32)
    ref = jsamp.sample_nearest(jnp.asarray(v), jnp.asarray(p), -2.0)
    out = sampling.sample_nearest(torch.from_numpy(v), torch.from_numpy(p),
                                  -2.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_batched_samplers_match_per_volume():
    """The port's (M, Z, Y, X) batch form equals M single-volume calls."""
    vols = np.stack([_vol(0, -1.0), _vol(5, -1.0)])
    pts = np.stack([_points(1), _points(2)])
    pads = torch.tensor([-1.0, -1.0])[:, None]
    out = sampling.sample_linear_padded(torch.from_numpy(vols),
                                        torch.from_numpy(pts), pads)
    for i in range(2):
        one = sampling.sample_linear_padded(torch.from_numpy(vols[i]),
                                            torch.from_numpy(pts[i]), -1.0)
        assert torch.equal(out[i], one)


def _grids():
    src = ImageAttributes(x=SHAPE[2], y=SHAPE[1], z=SHAPE[0], dx=1.2,
                          dy=1.1, dz=2.0)
    dst = src.with_spacing(0.9, 0.9, 0.9)
    t = rigid_matrix([0.7, -0.4, 0.3, 8.0, -5.0, 12.0])
    return src, dst, t


@pytest.mark.parametrize("interp,source_padding",
                         [("linear", None), ("linear", -1.0), ("nn", None),
                          ("bspline", None)])
def test_resample_to_grid(interp, source_padding):
    src, dst, t = _grids()
    v = _vol(pad=-1.0 if source_padding is not None else None)
    w2i = (src.w2i() @ t).astype(np.float32)
    i2w = dst.i2w().astype(np.float32)
    ref = jsamp.resample_to_grid(jnp.asarray(v), jnp.asarray(w2i),
                                 dst.shape_zyx, jnp.asarray(i2w),
                                 interp=interp, padding=0.0,
                                 source_padding=source_padding)
    out = sampling.resample_to_grid(torch.from_numpy(v), w2i, dst.shape_zyx,
                                    i2w, interp=interp, padding=0.0,
                                    source_padding=source_padding)
    assert tuple(out.shape) == dst.shape_zyx
    if interp == "nn":
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    else:
        assert _rel(out, ref) <= TOL


def test_resample_nn_axis_aligned_ties_exact():
    """Axis-aligned 1.5 -> 1.0 mm resampling lands grid points on .5 ties:
    the float32 grid matrix and round-half-to-even give JAX's mask."""
    src = ImageAttributes(x=12, y=10, z=8, dx=1.5, dy=1.5, dz=1.5)
    dst = src.with_spacing(1.0, 1.0, 1.0)
    v = (np.random.default_rng(3).uniform(0, 1, src.shape_zyx) > 0.5
         ).astype(np.float32)
    ref = jsamp.resample_to_grid(
        jnp.asarray(v), jnp.asarray(src.w2i(), jnp.float32), dst.shape_zyx,
        jnp.asarray(dst.i2w(), jnp.float32), interp="nn")
    out = sampling.resample_to_grid(
        torch.from_numpy(v), src.w2i().astype(np.float32), dst.shape_zyx,
        dst.i2w().astype(np.float32), interp="nn")
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("sigma,spacing,shape", [
    (1.5, (1.0, 1.2, 2.0), SHAPE),
    (4.0, (1.0, 1.0, 1.0), SHAPE),          # kernel wider than the z axis
    (0.8, (1.25, 1.25), (3, 12, 10)),       # a batch of 2D images
])
def test_gaussian_blur(sigma, spacing, shape):
    v = np.random.default_rng(4).uniform(0, 10, shape).astype(np.float32)
    ref = jgauss.gaussian_blur(jnp.asarray(v), sigma, spacing)
    out = gaussian.gaussian_blur(torch.from_numpy(v), sigma, spacing)
    assert _rel(out, ref) <= TOL


@pytest.mark.parametrize("sigma,spacing,padding", [
    (1.5, (1.0, 1.2, 2.0), -1.0),
    (2.0, (1.0, 1.0, 1e30), 0.0),           # the thick-slice preset: no z
])
def test_gaussian_blur_padded(sigma, spacing, padding):
    v = _vol(6)
    v[:, :2, :] = padding
    v[2, 5:, 3:] = padding
    ref = jgauss.gaussian_blur_padded(jnp.asarray(v), sigma, spacing,
                                      padding)
    out = gaussian.gaussian_blur_padded(torch.from_numpy(v), sigma, spacing,
                                        padding)
    assert (out.numpy() == padding).sum() == (v <= padding).sum()
    assert _rel(out, ref) <= TOL
