"""Binary morphology (host-side, NumPy/SciPy).

Replaces IRTKSimple2/image++/src/irtkDilation.cc / irtkErosion.cc.  The
reference uses CONNECTIVITY_18 or _26 structuring elements; masks are tiny
host-side objects so NumPy is the right tier (the reference also runs these
on CPU).

A copy of fetalreconstruction_tpu/ops/morphology.py: host code in numpy,
with the same results; it imports only from this package.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def _structure(connectivity: int) -> np.ndarray:
    """3x3x3 structuring element for 6/18/26 connectivity."""
    if connectivity == 6:
        return ndimage.generate_binary_structure(3, 1)
    if connectivity == 18:
        return ndimage.generate_binary_structure(3, 2)
    if connectivity == 26:
        return ndimage.generate_binary_structure(3, 3)
    raise ValueError(connectivity)


def dilate(mask: np.ndarray, iterations: int = 1,
           connectivity: int = 26) -> np.ndarray:
    """Binary dilation (irtkDilation semantics: voxel takes neighbourhood
    max)."""
    if iterations <= 0:
        return mask.astype(np.uint8)
    out = ndimage.binary_dilation(mask > 0, structure=_structure(connectivity),
                                  iterations=iterations)
    return out.astype(np.uint8)


def erode(mask: np.ndarray, iterations: int = 1,
          connectivity: int = 26) -> np.ndarray:
    if iterations <= 0:
        return mask.astype(np.uint8)
    out = ndimage.binary_erosion(mask > 0, structure=_structure(connectivity),
                                 iterations=iterations)
    return out.astype(np.uint8)
