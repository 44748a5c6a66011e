"""Image geometry: attributes, image<->world matrices, rigid transforms.

A copy of fetalreconstruction_tpu/core/geometry.py with its tensor half
rebuilt on torch.  The IRTK geometry conventions of the reference
(bkainz/fetalReconstruction):

- Image-to-world matrix (IRTKSimple2/image++/src/irtkBaseImage.cc:79):
      world = T(origin) @ R(axes) @ S(spacing) @ T(-(size-1)/2) @ index
  i.e. voxel index (0..n-1) is first centred on the image centre, scaled by
  the voxel size, rotated by the direction axes (columns = xaxis|yaxis|
  zaxis) and shifted by the world origin.

- Rigid 6-DOF parameterisation (tx, ty, tz, rx, ry, rz) with rotations in
  DEGREES (packages/transformation/src/irtkRigidTransformation.cc:26):
      R[0,:] = ( cy*cz,            cy*sz,           -sy )
      R[1,:] = ( sx*sy*cz - cx*sz, sx*sy*sz + cx*cz, sx*cy )
      R[2,:] = ( cx*sy*cz + sx*sz, cx*sy*sz - sx*cz, cx*cy )

The host half (`ImageAttributes`, `rigid_matrix`, `matrix_to_params`,
`invert_rigid`) is NumPy in float64, the reference's double host math.  The
`*_torch` functions are their batched tensor forms for the registration
loops (the JAX package's `*_jax` functions, :204-240, and
`register/slice2vol.matrix_to_params_jax`, :170-182); each computes on its
input's device and dtype.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass
class ImageAttributes:
    """Geometry of a 3D (or per-slice 2D) image grid.

    Mirrors the fields of the reference irtkImageAttributes
    (IRTKSimple2/image++/include/irtkImageAttributes.h:9-49): grid size,
    voxel spacing, world origin and direction axes.
    """

    x: int = 1
    y: int = 1
    z: int = 1
    t: int = 1
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 1.0
    dt: float = 1.0
    xorigin: float = 0.0
    yorigin: float = 0.0
    zorigin: float = 0.0
    torigin: float = 0.0
    xaxis: Vec3 = (1.0, 0.0, 0.0)
    yaxis: Vec3 = (0.0, 1.0, 0.0)
    zaxis: Vec3 = (0.0, 0.0, 1.0)

    def copy(self) -> "ImageAttributes":
        return dataclasses.replace(self)

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        """Array shape in [z, y, x] order (x fastest / last axis)."""
        return (self.z, self.y, self.x)

    @property
    def spacing(self) -> np.ndarray:
        return np.array([self.dx, self.dy, self.dz], dtype=np.float64)

    @property
    def origin(self) -> np.ndarray:
        return np.array([self.xorigin, self.yorigin, self.zorigin],
                        dtype=np.float64)

    @property
    def axes(self) -> np.ndarray:
        """3x3 matrix whose COLUMNS are xaxis, yaxis, zaxis."""
        return np.stack([np.asarray(self.xaxis, dtype=np.float64),
                         np.asarray(self.yaxis, dtype=np.float64),
                         np.asarray(self.zaxis, dtype=np.float64)], axis=1)

    def i2w(self) -> np.ndarray:
        """4x4 image-to-world matrix (IRTK convention)."""
        t1 = np.eye(4)
        t1[:3, 3] = [-(self.x - 1) / 2.0, -(self.y - 1) / 2.0,
                     -(self.z - 1) / 2.0]
        s = np.diag([self.dx, self.dy, self.dz, 1.0])
        r = np.eye(4)
        r[:3, :3] = self.axes
        t2 = np.eye(4)
        t2[:3, 3] = self.origin
        return t2 @ r @ s @ t1

    def w2i(self) -> np.ndarray:
        """4x4 world-to-image matrix (exact inverse of i2w)."""
        t1 = np.eye(4)
        t1[:3, 3] = [(self.x - 1) / 2.0, (self.y - 1) / 2.0,
                     (self.z - 1) / 2.0]
        s = np.diag([1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz, 1.0])
        r = np.eye(4)
        r[:3, :3] = self.axes.T
        t2 = np.eye(4)
        t2[:3, 3] = -self.origin
        return t1 @ s @ r @ t2

    def image_to_world(self, idx: np.ndarray) -> np.ndarray:
        """Map (..., 3) voxel indices (x, y, z order) to world mm."""
        idx = np.asarray(idx, dtype=np.float64)
        m = self.i2w()
        return idx @ m[:3, :3].T + m[:3, 3]

    def world_to_image(self, pts: np.ndarray) -> np.ndarray:
        """Map (..., 3) world mm points to continuous voxel indices."""
        pts = np.asarray(pts, dtype=np.float64)
        m = self.w2i()
        return pts @ m[:3, :3].T + m[:3, 3]

    def region(self, x1: int, y1: int, z1: int,
               x2: int, y2: int, z2: int) -> "ImageAttributes":
        """Attributes of the [x1:x2, y1:y2, z1:z2) sub-grid.

        Matches irtkGenericImage::GetRegion: spacing and axes preserved,
        origin moved to the world position of the new grid centre.
        """
        new = self.copy()
        new.x, new.y, new.z = x2 - x1, y2 - y1, z2 - z1
        centre = np.array([x1 + (new.x - 1) / 2.0,
                           y1 + (new.y - 1) / 2.0,
                           z1 + (new.z - 1) / 2.0])
        o = self.image_to_world(centre)
        new.xorigin, new.yorigin, new.zorigin = float(o[0]), float(o[1]), float(o[2])
        return new

    def with_spacing(self, dx: float, dy: float, dz: float,
                     preserve_extent: bool = True) -> "ImageAttributes":
        """New grid with given spacing covering (at least) the same extent,
        keeping the same world centre (matches irtkResampling output grid)."""
        new = self.copy()
        if preserve_extent:
            # irtkResampling: _x = int(old_x * old_dx / new_dx)  (truncation)
            new.x = max(int(self.x * self.dx / dx), 1)
            new.y = max(int(self.y * self.dy / dy), 1)
            new.z = max(int(self.z * self.dz / dz), 1)
        new.dx, new.dy, new.dz = dx, dy, dz
        return new


def rigid_matrix(params: np.ndarray) -> np.ndarray:
    """6-DOF rigid params (tx,ty,tz,rx,ry,rz; rotations in degrees) -> 4x4.

    Matches irtkRigidTransformation::UpdateMatrix exactly.
    """
    tx, ty, tz, rx, ry, rz = np.asarray(params, dtype=np.float64)
    cx, cy, cz = np.cos(np.deg2rad([rx, ry, rz]))
    sx, sy, sz = np.sin(np.deg2rad([rx, ry, rz]))
    m = np.eye(4)
    m[0, 0] = cy * cz
    m[0, 1] = cy * sz
    m[0, 2] = -sy
    m[0, 3] = tx
    m[1, 0] = sx * sy * cz - cx * sz
    m[1, 1] = sx * sy * sz + cx * cz
    m[1, 2] = sx * cy
    m[1, 3] = ty
    m[2, 0] = cx * sy * cz + sx * sz
    m[2, 1] = cx * sy * sz - sx * cz
    m[2, 2] = cx * cy
    m[2, 3] = tz
    return m


def matrix_to_params(m: np.ndarray) -> np.ndarray:
    """4x4 rigid matrix -> 6 params (degrees).

    Matches irtkRigidTransformation::Matrix2Parameters (incl. the gimbal
    branch at |cos(ry)| <= 1e-6).
    """
    m = np.asarray(m, dtype=np.float64)
    tol = 1e-6
    tx, ty, tz = m[0, 3], m[1, 3], m[2, 3]
    ry = np.arcsin(np.clip(-m[0, 2], -1.0, 1.0))
    if abs(np.cos(ry)) > tol:
        rx = np.arctan2(m[1, 2], m[2, 2])
        rz = np.arctan2(m[0, 1], m[0, 0])
    else:
        rx = np.arctan2(-m[0, 2] * m[1, 0], -m[0, 2] * m[2, 0])
        rz = 0.0
    return np.array([tx, ty, tz,
                     np.rad2deg(rx), np.rad2deg(ry), np.rad2deg(rz)])


def invert_rigid(m: np.ndarray) -> np.ndarray:
    """Exact inverse of a rigid 4x4 (R^T, -R^T t)."""
    m = np.asarray(m, dtype=np.float64)
    inv = np.eye(4)
    inv[:3, :3] = m[:3, :3].T
    inv[:3, 3] = -m[:3, :3].T @ m[:3, 3]
    return inv



# ---------------------------------------------------------------------------
# Batched tensor versions (the registration loops)
# ---------------------------------------------------------------------------

def rigid_matrix_torch(params: torch.Tensor) -> torch.Tensor:
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


def matrix_to_params_torch(m: torch.Tensor) -> torch.Tensor:
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


def invert_rigid_torch(m: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) rigid inverse (R^T, -R^T t)."""
    rt = m[..., :3, :3].transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", rt, m[..., :3, 3])
    top = torch.cat([rt, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=m.dtype,
                          device=m.device).expand(m[..., :1, :4].shape)
    return torch.cat([top, bottom], dim=-2)


def transform_points_torch(m: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply (..., 4, 4) affines to (..., 3) points (broadcasting)."""
    return torch.einsum("...ij,...j->...i", m[..., :3, :3], pts) \
        + m[..., :3, 3]
