"""Pipeline state containers: host-side slice batch + device EM state.

The reference scatters per-slice irtkRealImages across std::vectors
(irtkReconstructionGPU.h:68-144); here the whole slice population is ONE
padded (N, H, W) batch — the unit of data parallelism that shards over the
`slices` mesh axis.

A copy of fetalreconstruction_tpu/pipeline/state.py: host code in numpy,
with the same results; it imports only from this package.
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np

from ..core.geometry import ImageAttributes
from ..core.image import Image


@dataclasses.dataclass
class SliceBatch:
    """Host-side padded slice batch.

    data: (N, H, W) float32 with -1.0 padding (both outside-mask pixels and
          the rectangle padding introduced by batching).
    i2w:  (N, 4, 4) per-slice image-to-world (z size = slice thickness).
    dims: (N, 3) per-slice voxel size (dx, dy, thickness).
    stack_index: (N,) which input stack each slice came from.
    attrs: per-slice ImageAttributes (geometry bookkeeping / IO).
    """
    data: np.ndarray
    i2w: np.ndarray
    dims: np.ndarray
    stack_index: np.ndarray
    attrs: List[ImageAttributes]

    @property
    def n_slices(self) -> int:
        return self.data.shape[0]


def create_slices(stacks: List[Image], thickness: List[float],
                  pad_to: Optional[tuple] = None) -> SliceBatch:
    """Slice every stack into thick 2D slices
    (CreateSlicesAndTransformations, irtkReconstructionGPU.cc:1814-1851):
    slice j of stack i = region [:, :, j:j+1] with dz := thickness[i]
    (origin preserved).  All slices padded to a common (H, W) with -1."""
    imgs, attrs, sidx, dims = [], [], [], []
    for i, st in enumerate(stacks):
        a = st.attr
        for j in range(a.z):
            sa = a.region(0, 0, j, a.x, a.y, j + 1)
            sa.dz = float(thickness[i])
            attrs.append(sa)
            imgs.append(st.data[j])
            sidx.append(i)
            dims.append([a.dx, a.dy, float(thickness[i])])
    h = max(im.shape[0] for im in imgs)
    w = max(im.shape[1] for im in imgs)
    if pad_to is not None:
        h, w = max(h, pad_to[0]), max(w, pad_to[1])
    n = len(imgs)
    data = np.full((n, h, w), -1.0, dtype=np.float32)
    for k, im in enumerate(imgs):
        data[k, :im.shape[0], :im.shape[1]] = im
    i2w = np.stack([sa.i2w() for sa in attrs]).astype(np.float64)
    return SliceBatch(data=data, i2w=i2w,
                      dims=np.asarray(dims, np.float32),
                      stack_index=np.asarray(sidx, np.int32), attrs=attrs)


class EMState(NamedTuple):
    """Per-slice EM state (device arrays)."""
    weights: "np.ndarray"       # (N,H,W) voxel posteriors
    bias: "np.ndarray"          # (N,H,W) log bias fields
    scale: "np.ndarray"         # (N,)
    slice_weight: "np.ndarray"  # (N,)
    sigma2: "np.ndarray"        # () voxel noise variance
    m: "np.ndarray"             # () uniform outlier density
    mix: "np.ndarray"           # () voxel inlier proportion
    mix_s: "np.ndarray"         # () slice inlier proportion


class SimState(NamedTuple):
    """Forward-simulation results (device arrays)."""
    sim: "np.ndarray"        # (N,H,W)
    simw: "np.ndarray"       # (N,H,W)
    inside: "np.ndarray"     # (N,H,W) bool
    slice_inside: "np.ndarray"  # (N,) bool
