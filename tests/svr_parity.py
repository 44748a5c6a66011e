"""The problem and the limits that hold the port's run_svr to the JAX
package's on the CPU.

test_svr_pipeline's phantom (n=32 at 1.5 mm, two noisy stacks, the second
rigidly moved) with iterations=2, reg_levels=1, reg_iterations=5 and the
"coord-scan" registration.  Limits: the reconstruction within 1e-3 of
max|ref| (float32 sums in another order, compounded over stack
registration, two reconstructions and a registration round), slice
transforms within 0.05 mm / deg, the same excluded slices, PSNR against
the truth within 0.1 dB.
"""
import numpy as np

import jax.numpy as jnp

from fetalreconstruction_tpu.core.geometry import (matrix_to_params,
                                                   rigid_matrix)
from fetalreconstruction_tpu.core.image import Image
from fetalreconstruction_tpu.ops.sampling import resample_to_grid
from fetalreconstruction_tpu.pipeline.config import SVRConfig

from phantom import make_ground_truth, psnr, simulate_stacks

REC_TOL = 1e-3
PARAM_TOL = 0.05
PSNR_TOL = 0.1

MOTION = [2.0, -1.5, 1.0, 2.0, -1.5, 1.0]


def moved(stack: Image, motion) -> Image:
    """The stack resampled through a rigid motion, 0 outside."""
    out = resample_to_grid(
        jnp.asarray(stack.data),
        jnp.asarray(stack.attr.w2i() @ rigid_matrix(motion), jnp.float32),
        stack.attr.shape_zyx, jnp.asarray(stack.attr.i2w(), jnp.float32),
        interp="linear", padding=0.0)
    return Image(np.asarray(out), stack.attr)


def make_problem(motion=MOTION, n=32, spacing=1.5):
    """(truth, [stack 0, stack 1 moved by `motion`], truth mask)."""
    gt = make_ground_truth(n=n, spacing=spacing)
    stacks, _ = simulate_stacks(gt, n_stacks=2, in_plane=2.0, dz=3.0,
                                noise=1.0)
    stacks[1] = moved(stacks[1], motion)
    mask_img = Image((gt.data > 1.0).astype(np.float32), gt.attr.copy())
    return gt, stacks, mask_img


def svr_cfg(**kw):
    base = dict(iterations=2, resolution=1.5, rec_iterations_first=3,
                rec_iterations_last=5, smooth_mask=2.0, average_value=700.0,
                multires_levels=2, reg_levels=1, reg_iterations=5,
                reg_optimizer="coord-scan", no_log=True)
    base.update(kw)
    return SVRConfig(**base)


def psnr_vs_truth(gt: Image, img: Image) -> float:
    gt_on = np.asarray(resample_to_grid(
        jnp.asarray(gt.data), jnp.asarray(gt.attr.w2i(), jnp.float32),
        img.attr.shape_zyx, jnp.asarray(img.attr.i2w(), jnp.float32)))
    roi = (gt_on > 1.0) & (img.data > 0)
    return psnr(img.data[roi], gt_on[roi])


def max_param_diff(a: np.ndarray, b: np.ndarray) -> float:
    assert a.shape == b.shape, (a.shape, b.shape)
    return max(np.abs(matrix_to_params(p) - matrix_to_params(q)).max()
               for p, q in zip(a, b))


def assert_same_volume(out: Image, ref: Image, tol=REC_TOL):
    assert out.attr == ref.attr and out.data.shape == ref.data.shape
    assert np.isfinite(out.data).all()
    err = np.abs(out.data - ref.data).max() / np.abs(ref.data).max()
    assert err <= tol, err


def assert_same_run(out, ref, gt: Image):
    """The port's SVRResult against the JAX package's, at the limits."""
    assert_same_volume(out.reconstructed, ref.reconstructed)
    d = max_param_diff(out.transforms, ref.transforms)
    assert d <= PARAM_TOL, d
    assert out.excluded_slices == ref.excluded_slices
    p_out = psnr_vs_truth(gt, out.reconstructed)
    p_ref = psnr_vs_truth(gt, ref.reconstructed)
    assert abs(p_out - p_ref) <= PSNR_TOL, (p_out, p_ref)
