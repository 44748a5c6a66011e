"""Package splitting and package-to-volume hierarchical motion estimation.

Port of fetalreconstruction_tpu/register/package.py:29-132
(irtkReconstructionGPU.cc: SplitImage :4980, SplitImageEvenOdd :5039,
SplitImageEvenOddHalf :5058, HalfImage :5078, PackageToVolume :5096).  The
splits are host numpy code; every package of every stack then registers to
the current reconstruction as one lock-step batch (register_volumes_
batched, the reconstruction shared by all pairs), and each result is
copied to the transforms of the package's member slices.

The driving schedule (reconstruction.cc:835-866): iteration 1 whole
packages, 2 even/odd, 3 even/odd + half, >= 4 deeper halving.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..core.image import Image
from .volume import VolRegConfig, register_volumes_batched


def split_image(image: Image, packages: int) -> List[Image]:
    """Interleaved z-subsampling into `packages` sub-stacks: slice k of
    package l is stack slice k*packages + l, with dz * packages and the
    origin moved so package voxel (0, 0, 0) lands on stack voxel
    (0, 0, l)."""
    a = image.attr
    pkg_z = a.z // packages
    out = []
    for l in range(packages):
        nz = pkg_z + 1 if (pkg_z * packages + l) < a.z else pkg_z
        na = a.copy()
        na.z = nz
        na.dz = a.dz * packages
        data = np.ascontiguousarray(image.data[l::packages][:nz])
        want = image.attr.image_to_world([0.0, 0.0, float(l)])
        have = na.image_to_world([0.0, 0.0, 0.0])
        na.xorigin += float(want[0] - have[0])
        na.yorigin += float(want[1] - have[1])
        na.zorigin += float(want[2] - have[2])
        out.append(Image(data, na))
    return out


def split_image_even_odd(image: Image, packages: int) -> List[Image]:
    out = []
    for pack in split_image(image, packages):
        out.extend(split_image(pack, 2))
    return out


def half_image(image: Image) -> List[Image]:
    a = image.attr
    if a.z >= 4:
        return [image.get_region(0, 0, 0, a.x, a.y, a.z // 2),
                image.get_region(0, 0, a.z // 2, a.x, a.y, a.z)]
    return [image]


def split_image_even_odd_half(image: Image, packages: int,
                              iterations: int) -> List[Image]:
    if iterations > 1:
        packs = split_image_even_odd_half(image, packages, iterations - 1)
    else:
        packs = split_image_even_odd(image, packages)
    out = []
    for p in packs:
        out.extend(half_image(p))
    return out


def package_to_volume(stacks: List[Image], pack_num: List[int],
                      reconstructed: Image, transforms: np.ndarray,
                      evenodd: bool = False, half: bool = False,
                      half_iter: int = 1, use_nmi: bool = False,
                      cfg: VolRegConfig = None, *,
                      device) -> np.ndarray:
    """Hierarchical package registration on `device`; returns the updated
    (N, 4, 4) per-slice transforms (slices stack-major, as
    CreateSlicesAndTransformations orders them)."""
    if cfg is None:
        cfg = VolRegConfig(metric="nmi" if use_nmi else "cc",
                           source_iso=True)
    transforms = np.array(transforms, dtype=np.float64, copy=True)
    all_pkgs: List[Image] = []
    all_members: List[List[int]] = []
    inits: List[np.ndarray] = []
    first_slice = 0
    for i, stack in enumerate(stacks):
        if evenodd and half:
            packages = split_image_even_odd_half(stack, pack_num[i],
                                                 half_iter)
        elif evenodd:
            packages = split_image_even_odd(stack, pack_num[i])
        else:
            packages = split_image(stack, pack_num[i])
        for pkg in packages:
            members = []
            for k in range(pkg.attr.z):
                wk = pkg.attr.image_to_world([0.0, 0.0, float(k)])
                zk = stack.attr.world_to_image(wk)[2]
                members.append(int(round(zk)) + first_slice)
            all_pkgs.append(pkg)
            all_members.append(members)
            inits.append(transforms[members[0]])
        first_slice += stack.attr.z
    if not all_pkgs:
        return transforms
    mats, _ = register_volumes_batched(
        cfg, all_pkgs, [reconstructed] * len(all_pkgs),
        init_matrices=np.stack(inits), device=device)
    for t_new, members in zip(mats, all_members):
        for idx in members:
            transforms[idx] = t_new
    return transforms
