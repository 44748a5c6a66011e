"""svr-reconstruct-torch --useCPU against the JAX package's svr-reconstruct
on the same NIfTI inputs and flags: --saveSliceTransformations with
stack transformations (-t), --tfolder and --force_exclude, at the CLIs'
own registration defaults.  The output volumes and the written per-slice
transformations are held at svr_parity's limits.
"""
import os

import numpy as np

from fetalreconstruction_tpu.cli import svr_main as jcli
from fetalreconstruction_tpu.core.geometry import rigid_matrix
from fetalreconstruction_tpu.io.dof import (read_transformations,
                                            save_transformations, write_dof)
from fetalreconstruction_tpu.io.nifti import read_nifti, write_nifti
from fetalreconstruction_tpu_torch.cli import svr_main

from svr_parity import (assert_same_volume, make_problem, max_param_diff,
                        PARAM_TOL)
from torch_threads import one_torch_thread  # noqa: F401


def test_cli_slice_transformations_match_jax(tmp_path):
    gt, stacks, mask_img = make_problem()
    paths = []
    for i, st in enumerate(stacks):
        paths.append(str(tmp_path / f"stack{i}.nii.gz"))
        write_nifti(st, paths[-1])
    write_nifti(mask_img, str(tmp_path / "mask.nii.gz"))
    # stack 1's .dof (template -> stack) a little off its motion
    write_dof(str(tmp_path / "s1.dof"),
              rigid_matrix([1.5, -1.0, 0.5, 1.5, -1.0, 0.5]))
    rng = np.random.default_rng(2)
    save_transformations(str(tmp_path / "tf"), np.stack(
        [rigid_matrix(rng.uniform(-0.5, 0.5, 6)) for _ in range(40)]))
    flags = ["-i", *paths, "-m", str(tmp_path / "mask.nii.gz"),
             "-t", "id", str(tmp_path / "s1.dof"),
             "--tfolder", str(tmp_path / "tf"), "--force_exclude", "3", "5",
             "--iterations", "2", "--resolution", "1.5", "--smooth_mask",
             "2.0", "--rec_iterations_first", "3", "--rec_iterations_last",
             "5", "--average", "700", "--multires", "2",
             "--saveSliceTransformations", "--useCPU", "--no_log"]
    for name, main in (("j", jcli.main), ("p", svr_main.main)):
        assert main(["-o", str(tmp_path / f"{name}.nii.gz"), "--log_prefix",
                     str(tmp_path / f"{name}_"), *flags]) == 0
    assert_same_volume(read_nifti(str(tmp_path / "p.nii.gz")),
                       read_nifti(str(tmp_path / "j.nii.gz")))
    n = len(os.listdir(tmp_path / "j.nii.gz.transforms"))
    assert n == len(os.listdir(tmp_path / "p.nii.gz.transforms")) > 0
    d = max_param_diff(
        read_transformations(str(tmp_path / "p.nii.gz.transforms"), n),
        read_transformations(str(tmp_path / "j.nii.gz.transforms"), n))
    assert d <= PARAM_TOL, d
