"""Checkpoint/resume for the reconstruction state.

The reference only has file-based partial resume (per-slice .dof files via
--tfolder, per-iteration image%i_GPU.nii.gz dumps, --referenceVolume
seeding — SURVEY.md §5).  Here a checkpoint is one .npz capturing the full
state per outer iteration: reconstructed volume, per-slice transforms, EM
state and stack factors, plus the reconstruction grid geometry — enough to
resume the outer loop exactly or to seed a new run.

A copy of fetalreconstruction_tpu/pipeline/checkpoint.py: host code in
numpy, with the same results; it imports only from this package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ..core.geometry import ImageAttributes
from ..core.image import Image


def save_checkpoint(path: str, iteration: int, recon: Image,
                    transforms: np.ndarray,
                    slice_weights: Optional[np.ndarray] = None,
                    scales: Optional[np.ndarray] = None,
                    bias: Optional[np.ndarray] = None,
                    stack_factors: Optional[np.ndarray] = None,
                    extra: Optional[dict] = None) -> None:
    a = recon.attr
    payload = dict(
        iteration=np.int64(iteration),
        recon=np.asarray(recon.data, np.float32),
        attr_sizes=np.asarray([a.x, a.y, a.z], np.int64),
        attr_spacing=np.asarray([a.dx, a.dy, a.dz]),
        attr_origin=np.asarray(a.origin),
        attr_axes=np.asarray(a.axes),
        transforms=np.asarray(transforms, np.float64))
    if slice_weights is not None:
        payload["slice_weights"] = np.asarray(slice_weights, np.float32)
    if scales is not None:
        payload["scales"] = np.asarray(scales, np.float32)
    if bias is not None:
        payload["bias"] = np.asarray(bias, np.float32)
    if stack_factors is not None:
        payload["stack_factors"] = np.asarray(stack_factors, np.float32)
    if extra:
        for k, v in extra.items():
            payload["extra_" + k] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_checkpoint(path: str):
    """Returns dict with 'iteration', 'recon' (Image), 'transforms' and any
    optional EM fields present."""
    z = np.load(path, allow_pickle=False)
    sx, sy, sz = [int(v) for v in z["attr_sizes"]]
    a = ImageAttributes(x=sx, y=sy, z=sz)
    a.dx, a.dy, a.dz = [float(v) for v in z["attr_spacing"]]
    o = z["attr_origin"]
    a.xorigin, a.yorigin, a.zorigin = float(o[0]), float(o[1]), float(o[2])
    axes = z["attr_axes"]
    a.xaxis = tuple(axes[:, 0])
    a.yaxis = tuple(axes[:, 1])
    a.zaxis = tuple(axes[:, 2])
    out = dict(iteration=int(z["iteration"]),
               recon=Image(np.asarray(z["recon"]), a),
               transforms=np.asarray(z["transforms"]))
    for k in ("slice_weights", "scales", "bias", "stack_factors"):
        if k in z:
            out[k] = np.asarray(z[k])
    for k in z.files:
        if k.startswith("extra_"):
            out[k[6:]] = np.asarray(z[k])
    return out
