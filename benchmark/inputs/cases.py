"""The benchmark's cases, made in NumPy from a seed.

`motion_case` is the whole-reconstruction case: a textured ellipsoid on a
gn^3 grid at 1 mm, and n_stacks thick-slice stacks (rotations 0, 90 deg
about x, 90 deg about y, 45/45 deg) of round(gn / (thickness / 2)) // 2
slices of hw^2 pixels, each slice a trilinear sample of the truth, with a
rigid motion of up to +-motion_t mm and +-motion_r deg, drawn from the
seed, on every other slice (the unmoved half anchors the template).  It is
the problem of the repository's end-to-end benches (motion_problem),
frozen here.

`canonical_case` is the inner loop's case: n_stacks x stack_slices slices
of hw^2 pixels at in_plane mm and thickness mm, in the stack orientations
above, reconstructed on a vol^3 grid at recon_dx mm, intensities uniform
in [LOW, HIGH) from the seed; identity motion and an all-ones mask.

Every seed gives the same sizes; only the values and the motion move.
"""
from __future__ import annotations

import numpy as np

from .geometry import Grid, rigid_matrix, trilinear

LOW, HIGH = 100.0, 700.0
STACK_ROTATIONS = ((0, 0, 0), (90, 0, 0), (0, 90, 0), (45, 45, 0))


def rng_for(seed: int) -> np.random.Generator:
    """The case's generator; any whole number is a seed."""
    return np.random.default_rng(int(seed))


def motion_case(seed: int, n_stacks: int = 4, hw: int = 144,
                in_plane: float = 1.25, thickness: float = 5.0,
                motion_t: float = 1.5, motion_r: float = 1.5,
                gn: int = 168) -> dict:
    """Truth, mask and stacks (numpy, with their Grids) and each slice's
    true motion (n_stacks, n_slices, 4, 4)."""
    rng = rng_for(seed)
    ga = Grid(x=gn, y=gn, z=gn)
    lin = np.linspace(-1, 1, gn)
    zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
    r = np.sqrt(xx ** 2 + 1.15 * yy ** 2 + 1.25 * zz ** 2)
    tex = (360.0 + 140.0 * np.cos(9 * np.pi * r)
           + 90.0 * np.sin(7 * xx + 11 * yy - 9 * zz)
           + 70.0 * np.sin(13 * xx * yy + 8 * zz))
    truth = np.where(r < 0.82, np.maximum(tex, 1.0), 0.0).astype(np.float32)
    mask = (r < 0.86).astype(np.float32)
    del zz, yy, xx, tex
    n_sl = int(round(gn / (thickness / 2))) // 2
    px = np.arange(hw, dtype=np.float32)
    gy, gx = np.meshgrid(px, px, indexing="ij")
    stacks, motion = [], np.tile(np.eye(4), (n_stacks, n_sl, 1, 1))
    for s in range(n_stacks):
        srot = rigid_matrix((0, 0, 0) + STACK_ROTATIONS[s % 4])
        a = Grid(x=hw, y=hw, z=n_sl, dx=in_plane, dy=in_plane, dz=thickness)
        data = np.zeros((n_sl, hw, hw), np.float32)
        for j in range(n_sl):
            if j % 2 == 0:
                motion[s, j] = rigid_matrix(
                    list(rng.uniform(-motion_t, motion_t, 3))
                    + list(rng.uniform(-motion_r, motion_r, 3)))
            fwd = (ga.w2i() @ motion[s, j] @ srot
                   @ a.region(0, 0, j, hw, hw, j + 1).i2w())
            pts = (fwd[:3, 0][None, None] * gx[..., None]
                   + fwd[:3, 1][None, None] * gy[..., None]
                   + fwd[:3, 3][None, None])
            data[j] = trilinear(truth, pts)
        stacks.append((data, a.moved(srot)))
    return dict(truth=(truth, ga), mask=(mask, ga.copy()), stacks=stacks,
                motion=motion)


def canonical_case(seed: int, n_stacks: int = 4, stack_slices: int = 42,
                   hw: int = 144, vol: int = 160, recon_dx: float = 1.0,
                   in_plane: float = 1.25, thickness: float = 5.0) -> dict:
    """Slices (N, hw, hw) f32, their image-to-world matrices (N, 4, 4),
    voxel sizes (N, 3), each stack's slice range, and the grid."""
    rng = rng_for(seed)
    n = n_stacks * stack_slices
    i2w = np.zeros((n, 4, 4))
    for s in range(n_stacks):
        t = rigid_matrix((0, 0, 0) + STACK_ROTATIONS[s % 4])
        for j in range(stack_slices):
            a = Grid(x=hw, y=hw, z=1, dx=in_plane, dy=in_plane, dz=thickness)
            a.zorigin = (j - stack_slices / 2) * thickness / 2.0
            i2w[s * stack_slices + j] = t @ a.i2w()
    return dict(
        slices=rng.uniform(LOW, HIGH, (n, hw, hw)).astype(np.float32),
        i2w=i2w, dims=np.tile([[in_plane, in_plane, thickness]], (n, 1)),
        ranges=[(s * stack_slices, (s + 1) * stack_slices)
                for s in range(n_stacks)],
        grid=Grid(x=vol, y=vol, z=vol, dx=recon_dx, dy=recon_dx,
                  dz=recon_dx))
