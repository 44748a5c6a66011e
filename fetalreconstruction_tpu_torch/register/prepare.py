"""Host-side preparation for slice-to-volume registration.

Port of fetalreconstruction_tpu/register/prepare.py:44-95
(PrepareRegistrationSlices, irtkReconstructionGPU.cc:2105-2164, with the
origin bookkeeping of .cc:2218-2276): every slice is resampled with -1
padding to an isotropic grid at the reconstruction voxel size, keeping ONE
plane at the slice origin (see the JAX module for why this deviates from
the reference GPU path); targets are packed into one (N, Hr, Wr) batch.
Within a stack every slice shares its in-plane mapping, so the resample
runs once per stack over all its slices.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..ops.sampling import sample_linear_padded
from ..pipeline.state import SliceBatch


def prepare_registration_slices(batch: SliceBatch, recon_dx: float, *,
                                device):
    """Resample every slice to isotropic recon_dx (in-plane), -1 padded,
    on `device`.

    Returns numpy (targets (N, Hr, Wr) f32, mo (N,4,4) f32,
    ofs_i2w (N,4,4) f32).
    """
    n = batch.n_slices
    resampled: List[np.ndarray] = [None] * n
    mo = np.zeros((n, 4, 4))
    ofs_i2w = np.zeros((n, 4, 4))
    shapes = []
    per_stack = {}
    for idx in range(n):
        per_stack.setdefault(int(batch.stack_index[idx]), []).append(idx)

    for members in per_stack.values():
        a0 = batch.attrs[members[0]]
        dst0 = a0.with_spacing(recon_dx, recon_dx, recon_dx)
        dst0.z = 1  # single plane AT the slice origin
        # dst plane-0 pixel -> source slice voxel (origin-independent)
        m = a0.w2i() @ dst0.i2w()
        h, w = dst0.y, dst0.x
        xs, ys = np.meshgrid(np.arange(w, dtype=np.float32),
                             np.arange(h, dtype=np.float32))
        pts = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(-1, 3)
        spts = torch.as_tensor(pts @ m[:3, :3].T + m[:3, 3],
                               dtype=torch.float32, device=device)
        src = torch.as_tensor(batch.data[members][:, None, :, :],
                              device=device)  # (M, 1, H, W) as [z, y, x]
        vals = sample_linear_padded(
            src, spts.expand(len(members), -1, -1), padding=-1.0)
        vals = vals.cpu().numpy().reshape(len(members), h, w)
        for j, idx in enumerate(members):
            resampled[idx] = vals[j]
            dst = batch.attrs[idx].with_spacing(recon_dx, recon_dx, recon_dx)
            dst.z = 1
            mo[idx] = np.eye(4)
            mo[idx, :3, 3] = dst.origin
            dst.xorigin = dst.yorigin = dst.zorigin = 0.0
            ofs_i2w[idx] = dst.i2w()
        shapes.append((h, w))

    hr = max(s[0] for s in shapes)
    wr = max(s[1] for s in shapes)
    targets = np.full((n, hr, wr), -1.0, np.float32)
    for idx in range(n):
        rh, rw = resampled[idx].shape
        targets[idx, :rh, :rw] = resampled[idx]
    return targets, mo.astype(np.float32), ofs_i2w.astype(np.float32)
