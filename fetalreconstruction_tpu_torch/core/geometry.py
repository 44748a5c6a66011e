"""Batched rigid-transform helpers on tensors.

Port of the tensor half of fetalreconstruction_tpu/core/geometry.py
(`rigid_matrix_jax`, `invert_rigid_jax`, `transform_points_jax`, :204-240)
and of `register/slice2vol.matrix_to_params_jax` (:170-182).  The host
half (ImageAttributes, the float64 numpy `rigid_matrix`, `invert_rigid`,
`matrix_to_params`) loads no JAX and is imported from the JAX package.

IRTK convention: params (tx, ty, tz, rx, ry, rz), rotations in degrees,
    R[0,:] = ( cy*cz,            cy*sz,           -sy )
    R[1,:] = ( sx*sy*cz - cx*sz, sx*sy*sz + cx*cz, sx*cy )
    R[2,:] = ( cx*sy*cz + sx*sz, cx*sy*sz - sx*cz, cx*cy )
Every function computes on its input's device and dtype.
"""
from __future__ import annotations

import math

import torch


def rigid_matrix(params: torch.Tensor) -> torch.Tensor:
    """(..., 6) params -> (..., 4, 4) rigid matrices."""
    tx, ty, tz = params[..., 0], params[..., 1], params[..., 2]
    r = torch.deg2rad(params[..., 3:6])
    cx, cy, cz = torch.cos(r[..., 0]), torch.cos(r[..., 1]), torch.cos(r[..., 2])
    sx, sy, sz = torch.sin(r[..., 0]), torch.sin(r[..., 1]), torch.sin(r[..., 2])
    zero = torch.zeros_like(tx)
    one = torch.ones_like(tx)
    rows = [
        torch.stack([cy * cz, cy * sz, -sy, tx], dim=-1),
        torch.stack([sx * sy * cz - cx * sz, sx * sy * sz + cx * cz,
                     sx * cy, ty], dim=-1),
        torch.stack([cx * sy * cz + sx * sz, cx * sy * sz - sx * cz,
                     cx * cy, tz], dim=-1),
        torch.stack([zero, zero, zero, one], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def matrix_to_params(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid matrices -> (..., 6) params (degrees), with the
    gimbal branch of irtkRigidTransformation::Matrix2Parameters at
    |cos(ry)| <= 1e-6."""
    tx, ty, tz = m[..., 0, 3], m[..., 1, 3], m[..., 2, 3]
    ry = torch.arcsin(torch.clamp(-m[..., 0, 2], -1.0, 1.0))
    gimbal = torch.abs(torch.cos(ry)) <= 1e-6
    rx = torch.where(gimbal,
                     torch.atan2(-m[..., 0, 2] * m[..., 1, 0],
                                 -m[..., 0, 2] * m[..., 2, 0]),
                     torch.atan2(m[..., 1, 2], m[..., 2, 2]))
    rz = torch.where(gimbal, torch.zeros_like(ry),
                     torch.atan2(m[..., 0, 1], m[..., 0, 0]))
    deg = 180.0 / math.pi
    return torch.stack([tx, ty, tz, rx * deg, ry * deg, rz * deg], dim=-1)


def invert_rigid(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid inverse (R^T, -R^T t)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", rt, m[..., :3, 3])
    top = torch.cat([rt, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(m[..., :1, :4].shape)
    return torch.cat([top, bottom], dim=-2)


def transform_points(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) affines to (..., 3) points (broadcasting)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], pts) \
        + m[..., :3, 3]
