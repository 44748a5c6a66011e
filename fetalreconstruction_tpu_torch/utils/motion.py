"""Stack motion scoring via low-rank analysis (auto-template selection).

Reimplements stackMotionEstimator::evaluateStackMotion
(stackMotionEstimator.cpp:67-165, CULA SVD in the reference):

- normalize the stack to [0, 1];
- build the matrix whose COLUMNS are the first third of the slices
  (flattened);
- SVD; find the largest rank r whose leading-singular-value energy
  fraction stays below 0.99 of the total;
- motion score = energy_fraction(r) * r — lower means the stack is closer
  to low-rank (less inter-slice motion), so the stack with the SMALLEST
  score becomes the template (reconstruction.cc:565-591).

A copy of fetalreconstruction_tpu/utils/motion.py: host code in numpy, with
the same results; it imports only from this package.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.image import Image


def evaluate_stack_motion(img: Image) -> float:
    data = np.asarray(img.data, np.float64)
    mn, mx = data.min(), data.max()
    if mx <= mn:
        return 0.0
    norm = (data - mn) / (mx - mn)
    third = max(int(img.attr.z / 3.0), 1)
    a = norm[:third].reshape(third, -1).T  # (pixels, slices)
    s = np.linalg.svd(a, compute_uv=False)
    norm_all = np.sqrt((s ** 2).sum())
    if norm_all == 0:
        return 0.0
    t = 0.99
    et, r_min = 0.0, -1
    cum = np.sqrt(np.cumsum(np.concatenate([[0.0], s ** 2])))
    for r in range(len(s)):
        err = cum[r] / norm_all
        if err < t:
            et, r_min = err, r
    return float(et * r_min)


def select_template(stacks: List[Image]) -> int:
    """Index of the stack with the least estimated motion
    (--useAutoTemplate)."""
    scores = [evaluate_stack_motion(s) for s in stacks]
    return int(np.argmin(scores))
