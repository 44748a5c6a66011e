"""--T1PackageSize (every stack split into packages, each registered to the
reference volume with NMI), the port against the JAX package.

On svr_parity's 32^3 phantom both packages refuse alike: at pyramid level
2 (8 mm steps) the NMI sweeps slide the 8-slice, 6 mm packages 40-45 mm
off the reference, toward NMI's maximum of 2 on a near-empty overlap, and
intensity matching then finds a package with no voxel in the ROI
(ROADMAP.md, queue 3).  On a 36^3 phantom at 2 mm (a 72 mm field of view)
the JAX package's run finishes, and the port is held to it at
svr_parity's limits.
"""
import pytest

from fetalreconstruction_tpu.pipeline import svr as jsvr
from fetalreconstruction_tpu_torch.pipeline import svr

from svr_parity import assert_same_run, make_problem, svr_cfg
from torch_threads import one_torch_thread  # noqa: F401


def test_t1_package_size_refused_alike_on_the_phantom():
    gt, stacks, mask_img = make_problem()
    cfg = svr_cfg(t1_package_size=2)
    with pytest.raises(ValueError, match="no overlap with ROI"):
        jsvr.run_svr(cfg, stacks=stacks, mask=mask_img, reference_volume=gt)
    with pytest.raises(ValueError, match="no overlap with ROI"):
        svr.run_svr(cfg, stacks=stacks, mask=mask_img, reference_volume=gt,
                    device="cpu")


def test_t1_package_size_matches_jax():
    gt, stacks, mask_img = make_problem(n=36, spacing=2.0)
    cfg = svr_cfg(t1_package_size=2)
    ref = jsvr.run_svr(cfg, stacks=stacks, mask=mask_img,
                       reference_volume=gt)
    out = svr.run_svr(cfg, stacks=stacks, mask=mask_img,
                      reference_volume=gt, device="cpu")
    assert len(out.stack_factors) == 4  # two packages of each stack
    assert_same_run(out, ref, gt)
