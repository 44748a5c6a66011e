"""IRTK .dof transform file interop.

Reads/writes the reference's rigid transform files so runs can exchange
per-slice transforms with the C++ toolchain (--tfolder resume,
SaveTransformations dumps).  Format (irtkHomogeneousTransformation::Write,
irtkTransformation.h:24-43, via Cofstream which emits BIG-endian and gzips
when the filename ends in .gz/.Z):

    uint32 magic = 815007
    uint32 type  (2 = RIGID, 3 = AFFINE)
    uint32 ndofs (6 rigid: tx ty tz rx ry rz in mm/degrees)
    float64 x ndofs

A copy of fetalreconstruction_tpu/io/dof.py: host code in numpy, with the
same results; it imports only from this package.
"""
from __future__ import annotations

import gzip
import struct

import numpy as np

from ..core.geometry import matrix_to_params, rigid_matrix

MAGIC = 815007
TYPE_RIGID = 2
TYPE_AFFINE = 3


def _opener(path, mode):
    if str(path).endswith((".gz", ".Z")):
        return gzip.open(path, mode)
    return open(path, mode)


def read_dof(path: str) -> np.ndarray:
    """Read a .dof / .dof.gz file -> 4x4 rigid matrix."""
    with _opener(path, "rb") as f:
        raw = f.read()
    magic, ttype, ndofs = struct.unpack(">III", raw[:12])
    if magic != MAGIC:
        raise ValueError(f"not an IRTK transform file (magic {magic})")
    vals = struct.unpack(f">{ndofs}d", raw[12:12 + 8 * ndofs])
    if ttype in (TYPE_RIGID,) and ndofs >= 6:
        return rigid_matrix(np.asarray(vals[:6]))
    if ttype == TYPE_AFFINE and ndofs >= 6:
        # affine stores 12+ DOFs; use the rigid part
        return rigid_matrix(np.asarray(vals[:6]))
    raise ValueError(f"unsupported transform type {ttype} / dofs {ndofs}")


def write_dof(path: str, matrix: np.ndarray) -> None:
    """Write a rigid 4x4 matrix as a .dof / .dof.gz file."""
    params = matrix_to_params(np.asarray(matrix))
    payload = struct.pack(">III", MAGIC, TYPE_RIGID, 6)
    payload += struct.pack(">6d", *[float(v) for v in params])
    with _opener(path, "wb") as f:
        f.write(payload)


def save_transformations(folder: str, transforms: np.ndarray) -> None:
    """SaveTransformations (irtkReconstructionGPU.cc:4903): one
    transformation%i.dof per slice."""
    import os
    os.makedirs(folder, exist_ok=True)
    for i, t in enumerate(np.asarray(transforms)):
        write_dof(os.path.join(folder, f"transformation{i}.dof"), t)


def read_transformations(folder: str, n: int) -> np.ndarray:
    """ReadTransformation (--tfolder, .cc:4733): transformation%i.dof."""
    import os
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        p = os.path.join(folder, f"transformation{i}.dof")
        if not os.path.exists(p):
            p2 = p + ".gz"
            if os.path.exists(p2):
                p = p2
            else:
                raise FileNotFoundError(p)
        out[i] = read_dof(p)
    return out
