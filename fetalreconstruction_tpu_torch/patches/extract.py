"""Square overlapping patch extraction (PVR).

Reimplements patchBasedObject.cuh:176-342 (generate2DPatches) and the
SVR tool's patch mode (CreateSlicesAndTransformationsPatchBased,
irtkReconstructionGPU.cc:1612): every stack slice is tiled with
patch_size^2 patches at the given stride; a patch is kept if more than 1/3
of its pixels carry valid in-mask data.  Patches are "slices" to the
reconstruction engine — the returned SliceBatch feeds the same EM/SR/
registration machinery (per-patch transforms, scales and weights come for
free from the per-slice state).

`use_full_slices` reproduces the --useFullSlices mode (one patch = one
whole slice).

A copy of fetalreconstruction_tpu/patches/extract.py: host code in numpy,
with the same results; it imports only from this package.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.image import Image
from ..pipeline.state import SliceBatch


def extract_patches(stacks: List[Image], thickness: List[float],
                    patch_size: int, stride: int,
                    mask: Optional[Image] = None,
                    stack_transforms: Optional[np.ndarray] = None,
                    use_full_slices: bool = False,
                    min_fill_fraction: float = 1.0 / 3.0) -> SliceBatch:
    """Build a patch batch from stacks.

    mask (optional): reconstruction-space mask; patch pixels whose
    transformed position falls outside it are invalid (-1), and patches
    with <= min_fill_fraction valid pixels are dropped (reference keeps
    setCount > 1/3 * area).
    stack_transforms: (n_stacks, 4, 4) stack->template transforms used for
    the mask test (identity if None).
    """
    datas, attrs, sidx, dims = [], [], [], []
    for s, st in enumerate(stacks):
        a = st.attr
        psize_x = a.x if use_full_slices else patch_size
        psize_y = a.y if use_full_slices else patch_size
        step_x = a.x + 1 if use_full_slices else stride
        step_y = a.y + 1 if use_full_slices else stride
        t = np.eye(4) if stack_transforms is None else stack_transforms[s]
        for z in range(a.z):
            slice_attr = a.region(0, 0, z, a.x, a.y, z + 1)
            slice_attr.dz = float(thickness[s])
            sdata = st.data[z]
            for y0 in range(0, a.y + psize_y, step_y):
                if y0 >= a.y:
                    break
                for x0 in range(0, a.x + psize_x, step_x):
                    if x0 >= a.x:
                        break
                    pa = slice_attr.copy()
                    pa.x, pa.y = psize_x, psize_y
                    # origin: world position consistency with the slice
                    w_slice = slice_attr.image_to_world(
                        [float(x0), float(y0), 0.0])
                    w_patch0 = pa.image_to_world([0.0, 0.0, 0.0])
                    shift = w_slice - w_patch0
                    pa.xorigin += float(shift[0])
                    pa.yorigin += float(shift[1])
                    pa.zorigin += float(shift[2])

                    patch = np.full((psize_y, psize_x), -1.0, np.float32)
                    x1 = min(x0 + psize_x, a.x)
                    y1 = min(y0 + psize_y, a.y)
                    patch[:y1 - y0, :x1 - x0] = sdata[y0:y1, x0:x1]

                    if mask is not None:
                        ys, xs = np.meshgrid(np.arange(psize_y),
                                             np.arange(psize_x),
                                             indexing="ij")
                        pts = np.stack([xs, ys, np.zeros_like(xs)],
                                       -1).reshape(-1, 3)
                        w = pa.image_to_world(pts.astype(np.float64))
                        w = w @ t[:3, :3].T + t[:3, 3]
                        mp = np.round(mask.attr.world_to_image(w)) \
                            .astype(int)
                        inb = ((mp[:, 0] >= 0) & (mp[:, 0] < mask.attr.x)
                               & (mp[:, 1] >= 0) & (mp[:, 1] < mask.attr.y)
                               & (mp[:, 2] >= 0)
                               & (mp[:, 2] < mask.attr.z))
                        mc = np.clip(mp, 0,
                                     [mask.attr.x - 1, mask.attr.y - 1,
                                      mask.attr.z - 1])
                        mv = mask.data[mc[:, 2], mc[:, 1], mc[:, 0]]
                        keep = (inb & (mv > 0)).reshape(psize_y, psize_x)
                        patch[~keep] = -1.0

                    set_count = int(((patch != -1.0) & (patch != 0.0)).sum())
                    if set_count > min_fill_fraction * psize_x * psize_y:
                        datas.append(patch)
                        attrs.append(pa)
                        sidx.append(s)
                        dims.append([a.dx, a.dy, float(thickness[s])])

    if not datas:
        raise ValueError("no patches survived extraction")
    h = max(d.shape[0] for d in datas)
    w = max(d.shape[1] for d in datas)
    n = len(datas)
    data = np.full((n, h, w), -1.0, np.float32)
    for k, d in enumerate(datas):
        data[k, :d.shape[0], :d.shape[1]] = d
    i2w = np.stack([pa.i2w() for pa in attrs]).astype(np.float64)
    return SliceBatch(data=data, i2w=i2w,
                      dims=np.asarray(dims, np.float32),
                      stack_index=np.asarray(sidx, np.int32), attrs=attrs)
