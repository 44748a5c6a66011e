"""Image grids and rigid matrices in NumPy, the benchmark's own copy.

The IRTK conventions the reconstruction programs use:

    world = T(origin) @ R(axes) @ S(spacing) @ T(-(size - 1) / 2) @ index

with voxel indices in (x, y, z) order and arrays stored [z, y, x]; a rigid
matrix from (tx, ty, tz, rx, ry, rz), rotations in degrees, as
irtkRigidTransformation::UpdateMatrix builds it.  Frozen here so that the
benchmark's cases and its reference do not move when the program's
geometry code does.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Vec3 = Tuple[float, float, float]


@dataclasses.dataclass
class Grid:
    """A 3-D grid: size, spacing, world origin and direction axes.  The
    field names are those of the program's ImageAttributes."""

    x: int = 1
    y: int = 1
    z: int = 1
    dx: float = 1.0
    dy: float = 1.0
    dz: float = 1.0
    xorigin: float = 0.0
    yorigin: float = 0.0
    zorigin: float = 0.0
    xaxis: Vec3 = (1.0, 0.0, 0.0)
    yaxis: Vec3 = (0.0, 1.0, 0.0)
    zaxis: Vec3 = (0.0, 0.0, 1.0)

    def copy(self) -> "Grid":
        return dataclasses.replace(self)

    @property
    def shape_zyx(self) -> Tuple[int, int, int]:
        return (self.z, self.y, self.x)

    def axes(self) -> np.ndarray:
        """3x3 matrix whose columns are the x, y and z axes."""
        return np.stack([np.asarray(a, np.float64)
                         for a in (self.xaxis, self.yaxis, self.zaxis)], 1)

    def i2w(self) -> np.ndarray:
        t1 = np.eye(4)
        t1[:3, 3] = [-(self.x - 1) / 2.0, -(self.y - 1) / 2.0,
                     -(self.z - 1) / 2.0]
        s = np.diag([self.dx, self.dy, self.dz, 1.0])
        r = np.eye(4)
        r[:3, :3] = self.axes()
        t2 = np.eye(4)
        t2[:3, 3] = [self.xorigin, self.yorigin, self.zorigin]
        return t2 @ r @ s @ t1

    def w2i(self) -> np.ndarray:
        """The exact inverse of i2w, factor by factor."""
        t1 = np.eye(4)
        t1[:3, 3] = [(self.x - 1) / 2.0, (self.y - 1) / 2.0,
                     (self.z - 1) / 2.0]
        s = np.diag([1.0 / self.dx, 1.0 / self.dy, 1.0 / self.dz, 1.0])
        r = np.eye(4)
        r[:3, :3] = self.axes().T
        t2 = np.eye(4)
        t2[:3, 3] = [-self.xorigin, -self.yorigin, -self.zorigin]
        return t1 @ s @ r @ t2

    def region(self, x1, y1, z1, x2, y2, z2) -> "Grid":
        """The [x1:x2, y1:y2, z1:z2) sub-grid: spacing and axes kept, the
        origin moved to the world position of its centre."""
        new = self.copy()
        new.x, new.y, new.z = x2 - x1, y2 - y1, z2 - z1
        c = np.array([x1 + (new.x - 1) / 2.0, y1 + (new.y - 1) / 2.0,
                      z1 + (new.z - 1) / 2.0, 1.0])
        o = self.i2w() @ c
        new.xorigin, new.yorigin, new.zorigin = map(float, o[:3])
        return new

    def moved(self, t) -> "Grid":
        """The grid whose i2w is t @ self.i2w() for a rigid t."""
        a = self.copy()
        r = np.asarray(t, np.float64)[:3, :3]
        a.xaxis, a.yaxis, a.zaxis = (
            tuple(float(v) for v in r @ np.asarray(ax, np.float64))
            for ax in (self.xaxis, self.yaxis, self.zaxis))
        o = r @ np.array([self.xorigin, self.yorigin, self.zorigin]) \
            + np.asarray(t, np.float64)[:3, 3]
        a.xorigin, a.yorigin, a.zorigin = map(float, o)
        return a


def rigid_matrix(params) -> np.ndarray:
    """(tx, ty, tz, rx, ry, rz), rotations in degrees -> 4x4."""
    tx, ty, tz, rx, ry, rz = np.asarray(params, dtype=np.float64)
    cx, cy, cz = np.cos(np.deg2rad([rx, ry, rz]))
    sx, sy, sz = np.sin(np.deg2rad([rx, ry, rz]))
    return np.array([
        [cy * cz, cy * sz, -sy, tx],
        [sx * sy * cz - cx * sz, sx * sy * sz + cx * cz, sx * cy, ty],
        [cx * sy * cz + sx * sz, cx * sy * sz - sx * cz, cx * cy, tz],
        [0.0, 0.0, 0.0, 1.0]])


def trilinear(vol: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Trilinear samples of a [z, y, x] volume at (..., 3) continuous voxel
    positions in (x, y, z) order, zero outside the grid; float32."""
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    zs, ys, xs = vol.shape
    u, v, w = (np.floor(c).astype(np.int64) for c in (x, y, z))
    du, dv, dw = x - u, y - v, z - w
    out = np.zeros(x.shape, np.float32)
    for cw in (0, 1):
        for cv in (0, 1):
            for cu in (0, 1):
                xi, yi, zi = u + cu, v + cv, w + cw
                inb = ((xi >= 0) & (xi < xs) & (yi >= 0) & (yi < ys)
                       & (zi >= 0) & (zi < zs))
                val = np.where(inb, vol[np.clip(zi, 0, zs - 1),
                                        np.clip(yi, 0, ys - 1),
                                        np.clip(xi, 0, xs - 1)], 0.0)
                wgt = ((du if cu else 1 - du) * (dv if cv else 1 - dv)
                       * (dw if cw else 1 - dw))
                out += (wgt * val).astype(np.float32)
    return out
