"""SLIC superpixel segmentation + superpixel patch extraction.

Reimplements the reference's SLIC path (runSLIC_2D.c:340-483 +
runStackSLIC.cpp segmentSLIC) and the superpixel patch builder
(CreateSlicesAndTransformationsSuperpixelBased,
irtkReconstructionGPU.cc:1680-1786):

- gray values are lifted to CIELAB L via the gray->RGB->LAB chain the
  reference uses (r,g,b = 0.2989/0.5870/0.1140 * gray); since all three
  channels are proportional to gray, a/b are constant and clustering
  happens on (L, x, y) with compactness m;
- seeds on a hexagonal-ish grid of step sqrt(sz/numSuperpixels),
  numSuperpixels = m * sqrt(w*h/2);
- 5 k-means iterations restricted to 2S x 2S windows, then connectivity
  enforcement (small orphan regions merged into an adjacent label);
- per-label patches (generate2DSuperpixelPatches,
  include/patchBasedObject.cuh:433-700): a FIXED 64x64 window centred on
  the superpixel's bounding box (clamped inside the slice), validity
  mask = the label mask dilated `round(spxExtend/100 * max(bbox_w,
  bbox_h))` times with in-plane 8-connectivity (spxExtend is a 0-100 %
  ratio of the superpixel size, default 50 —
  patchBasedReconMain.cpp:106), outside -> -1; superpixels with fewer
  than max(2, spxSize^2/4) valid pixels are skipped.

A copy of fetalreconstruction_tpu/patches/slic.py: host code in numpy, with
the same results; it imports only from this package.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
from scipy import ndimage

from ..core.image import Image
from ..pipeline.state import SliceBatch
from .. import native


def gray_to_lab_l(gray: np.ndarray) -> np.ndarray:
    """CIELAB L of the reference's gray->RGB->XYZ->LAB chain."""
    r = 0.2989 * gray
    g = 0.5870 * gray
    b = 0.1140 * gray
    # sRGB -> XYZ (D65), reference rgbtolab uses the standard matrix on
    # [0,255] inputs normalized by 255 with gamma correction
    def inv_gamma(c):
        c = c / 255.0
        return np.where(c <= 0.04045, c / 12.92,
                        ((c + 0.055) / 1.055) ** 2.4)
    rr, gg, bb = inv_gamma(r), inv_gamma(g), inv_gamma(b)
    y = 0.212671 * rr + 0.715160 * gg + 0.072169 * bb
    yn = y / 1.0
    fy = np.where(yn > 0.008856, np.cbrt(yn), 7.787 * yn + 16.0 / 116.0)
    return 116.0 * fy - 16.0


def slic_labels(img: np.ndarray, compactness: float = 10.0,
                num_superpixels: Optional[int] = None,
                iterations: int = 5) -> np.ndarray:
    """SLIC segmentation of a 2D image. Returns int labels (H, W).

    Dispatches to the native C++ kernel (native/csrc/slic.cc) when
    available; this NumPy body is the fallback and test oracle."""
    h, w = img.shape
    sz = h * w
    if num_superpixels is None:
        num_superpixels = max(int(compactness * np.sqrt(sz / 2.0)), 4)
    nat = native.slic_segment(img, num_superpixels, compactness,
                              iterations)
    if nat is not None:
        return nat
    lvec = gray_to_lab_l(np.asarray(img, np.float64))

    step = max(int(np.sqrt(sz / float(num_superpixels)) + 0.5), 2)
    ys = np.arange(step // 2, h, step)
    xs = np.arange(step // 2, w, step)
    seeds = [(yy, xx) for yy in ys for xx in xs]
    k = len(seeds)
    if k == 0:
        return np.zeros((h, w), np.int32)
    sy = np.array([s[0] for s in seeds], np.float64)
    sx = np.array([s[1] for s in seeds], np.float64)
    sl = lvec[sy.astype(int), sx.astype(int)]

    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    labels = np.full((h, w), -1, np.int32)
    dists = np.full((h, w), np.inf)
    invwt = (compactness / step) ** 2

    for _ in range(iterations):
        labels.fill(-1)
        dists.fill(np.inf)
        for i in range(k):
            y0, y1 = max(int(sy[i]) - step, 0), min(int(sy[i]) + step, h)
            x0, x1 = max(int(sx[i]) - step, 0), min(int(sx[i]) + step, w)
            if y1 <= y0 or x1 <= x0:
                continue
            dl = (lvec[y0:y1, x0:x1] - sl[i]) ** 2
            dxy = ((yy[y0:y1, x0:x1] - sy[i]) ** 2
                   + (xx[y0:y1, x0:x1] - sx[i]) ** 2)
            d = dl + dxy * invwt
            better = d < dists[y0:y1, x0:x1]
            dists[y0:y1, x0:x1] = np.where(better, d, dists[y0:y1, x0:x1])
            labels[y0:y1, x0:x1] = np.where(better, i,
                                            labels[y0:y1, x0:x1])
        # update seeds
        for i in range(k):
            m = labels == i
            if m.any():
                sy[i] = yy[m].mean()
                sx[i] = xx[m].mean()
                sl[i] = lvec[m].mean()

    labels[labels < 0] = 0
    # enforce connectivity: relabel connected components; merge tiny ones
    out = np.full((h, w), -1, np.int32)
    next_label = 0
    min_size = (step * step) // 4
    for i in range(k):
        comp, ncomp = ndimage.label(labels == i)
        for c in range(1, ncomp + 1):
            m = comp == c
            if m.sum() >= min_size:
                out[m] = next_label
                next_label += 1
    if (out < 0).any():
        # assign orphans to nearest labelled pixel
        ind = ndimage.distance_transform_edt(out < 0, return_distances=False,
                                             return_indices=True)
        out = out[tuple(ind)]
    return out


def extract_superpixel_patches(stacks: List[Image], thickness: List[float],
                               spx_size: int = 64, spx_extend: int = 50,
                               compactness: float = 10.0,
                               dilation_iters: Optional[int] = None,
                               max_patch: int = 64,
                               num_superpixels: Optional[int] = None
                               ) -> SliceBatch:
    """Superpixel patches: per label, a fixed max_patch-square window
    centred on the label bbox, dilated-label validity
    (generate2DSuperpixelPatches, include/patchBasedObject.cuh:433-700).

    spx_extend is the reference's --spxExtend: a 0-100 PERCENT ratio of
    the superpixel size; the label mask dilates
    round(spx_extend/100 * max(bbox_w, bbox_h)) times (default 50 %,
    patchBasedReconMain.cpp:106).  dilation_iters (optional) overrides
    that count with a fixed number of iterations.

    num_superpixels (optional): explicit label count per slice (the SVR
    tool's --superpixel [noLabels] flag, reconstruction.cc:207); default
    derives it from spx_size (the PVR --spxSize convention)."""
    datas, attrs, sidx, dims = [], [], [], []
    struct = ndimage.generate_binary_structure(2, 2)  # 8-connectivity
    for s, st in enumerate(stacks):
        a = st.attr
        num_spx = (int(num_superpixels) if num_superpixels
                   else max(int((a.x * a.y) / float(spx_size * spx_size)),
                            4))
        # batched native SLIC over the whole stack (threaded C++ kernel);
        # per-slice fallback below when the native tier is unavailable
        batch_labels = native.slic_segment_batch(
            np.ascontiguousarray(st.data, np.float32), num_spx,
            compactness)
        for z in range(a.z):
            sdata = st.data[z]
            if batch_labels is not None:
                labels = batch_labels[0][z]
            else:
                labels = slic_labels(sdata, compactness=compactness,
                                     num_superpixels=num_spx)
            slice_attr = a.region(0, 0, z, a.x, a.y, z + 1)
            slice_attr.dz = float(thickness[s])
            for lab in range(labels.max() + 1):
                m = labels == lab
                if not m.any():
                    continue
                # skip background-only superpixels
                if sdata[m].max() <= 0:
                    continue
                ys_idx, xs_idx = np.nonzero(m)
                y_min, y_max = int(ys_idx.min()), int(ys_idx.max())
                x_min, x_max = int(xs_idx.min()), int(xs_idx.max())
                spx_h, spx_w = y_max - y_min, x_max - x_min
                # fixed window (reference forces pbbsize to 64x64,
                # patchBasedObject.cuh:458), clamped to the slice
                pbx = min(max_patch, a.x)
                pby = min(max_patch, a.y)
                ext_x = int(round((pbx - spx_w) / 2.0))
                ext_y = int(round((pby - spx_h) / 2.0))
                if x_min - ext_x < 0:
                    x0, x1 = 0, pbx
                elif x_max + ext_x > a.x:
                    x0, x1 = a.x - pbx, a.x
                else:
                    x0, x1 = x_min - ext_x, x_min - ext_x + pbx
                if y_min - ext_y < 0:
                    y0, y1 = 0, pby
                elif y_max + ext_y > a.y:
                    y0, y1 = a.y - pby, a.y
                else:
                    y0, y1 = y_min - ext_y, y_min - ext_y + pby
                # valid-count gate BEFORE dilation (cuh:668-670): skip
                # superpixels smaller than a quarter initial size
                set_count = int((sdata[m] > 0).sum())
                min_count = (max(2, (spx_size * spx_size) // 4)
                             if num_superpixels is None else 16)
                if set_count < min_count:
                    continue
                # dilation count = spx_extend% of the larger bbox side
                # (cuh:545-548)
                diter = (int(dilation_iters) if dilation_iters is not None
                         else int((spx_extend / 100.0)
                                  * max(spx_w, spx_h)))
                dil = (ndimage.binary_dilation(m, structure=struct,
                                               iterations=diter)
                       if diter > 0 else m)
                patch = np.where(dil, sdata, -1.0)[y0:y1, x0:x1] \
                    .astype(np.float32)
                pa = slice_attr.region(x0, y0, 0, x1, y1, 1)
                pa.dz = float(thickness[s])
                datas.append(patch)
                attrs.append(pa)
                sidx.append(s)
                dims.append([a.dx, a.dy, float(thickness[s])])
    if not datas:
        raise ValueError("no superpixel patches extracted")
    h = max(d.shape[0] for d in datas)
    w = max(d.shape[1] for d in datas)
    n = len(datas)
    data = np.full((n, h, w), -1.0, np.float32)
    for kk, d in enumerate(datas):
        data[kk, :d.shape[0], :d.shape[1]] = d
    i2w = np.stack([pa.i2w() for pa in attrs]).astype(np.float64)
    return SliceBatch(data=data, i2w=i2w,
                      dims=np.asarray(dims, np.float32),
                      stack_index=np.asarray(sidx, np.int32), attrs=attrs)
