"""Stack-to-template 3D-3D registration (StackRegistrations).

Port of fetalreconstruction_tpu/register/stack.py:28-74
(irtkReconstructionGPU.cc:849-1001): the template stack, or an external
reference volume, is the target with voxels outside the mask zeroed; every
other stack registers to it with the GuessParameterThickSlices preset (CC,
or NMI for an external target), all of them as one lock-step batch.

Transform convention: the pipeline STORES stack world -> template world;
IRTK's registration output maps template world -> stack world, so stored
initial transforms are inverted going in and the results coming out.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.geometry import invert_rigid
from ..core.image import Image
from .volume import VolRegConfig, register_volumes_batched


def stack_registrations(stacks: List[Image], template_index: int,
                        mask: Optional[Image] = None,
                        external_template: Optional[Image] = None,
                        use_nmi: bool = False,
                        init_transforms: Optional[np.ndarray] = None,
                        cfg: Optional[VolRegConfig] = None,
                        *, device) -> np.ndarray:
    """(n_stacks, 4, 4) stack transforms in the stored convention, the
    registrations running on `device`.  mask (if given) lives on the
    target's grid; init_transforms are in the stored convention."""
    n = len(stacks)
    out = np.tile(np.eye(4), (n, 1, 1))
    if init_transforms is not None:
        out = np.array(init_transforms, copy=True)
    if external_template is not None:
        target = external_template
        use_nmi = True
    else:
        target = stacks[template_index]
    if mask is not None:
        data = np.where(mask.data > 0, target.data, 0.0).astype(np.float32)
        target = Image(data, target.attr.copy())
    if cfg is None:
        cfg = VolRegConfig(metric="nmi" if use_nmi else "cc")
    idx = [i for i in range(n)
           if external_template is not None or i != template_index]
    if not idx:
        return out
    mats, _ = register_volumes_batched(
        cfg, [target] * len(idx), [stacks[i] for i in idx],
        init_matrices=np.stack([invert_rigid(out[i]) for i in idx]),
        device=device)
    for j, i in enumerate(idx):
        out[i] = invert_rigid(mats[j])
    return out
