"""Exchanges along the z axis of a volume split into z-slabs over ranks.

The counterpart of the JAX package's jax.lax.ppermute halo exchange
(parallel/volume_sharded.py:93-127), for one process per rank; the
all_gather of the slabs is sharded.gather_rows over z.  `mesh` is a
parallel/sharded.Mesh whose ranks hold the slabs in order: rank r holds
rows [r lz, (r + 1) lz) of the volume.

Every exchange is ONE all-reduce of a zero-filled (group size, ...)
buffer: each rank writes what it sends into its own slot, the buffer is
summed over the group and each rank reads the slots of its sources.  This
is exact (x + 0 == x) and needs only all_reduce, which gloo runs on CUDA
tensors as NCCL does (a one-card machine runs its ranks over gloo), so
one code path serves both.  Every rank of the group must join every
exchange, in the same order: each function here is one collective.
"""
from __future__ import annotations

import torch

from .sharded import Mesh, gather_rows


def exchange(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(group size, *t.shape): slot r holds rank r's t, on every rank."""
    return gather_rows(mesh, t[None], mesh.size)


def halo_exchange_z(slab: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """(..., lz, ys, xs) -> (..., h + lz + h, ys, xs): the h rows below and
    above the slab from its z-neighbours, over several of them when h
    exceeds lz (hops = ceil(h / lz) neighbours per side).  The ranks at the
    volume's ends receive zeros there, as the zero-padded convolutions of
    the single-device engine see."""
    if h == 0:
        return slab
    ax = slab.ndim - 3
    lz = slab.shape[ax]
    k = min(h, lz)               # rows each rank sends to each side
    hops = -(-h // lz)
    edges = exchange(torch.stack([slab.narrow(ax, 0, k),
                                  slab.narrow(ax, lz - k, k)]), mesh)
    zero = torch.zeros_like(edges[0, 0])

    def part(src: int, side: int):
        return edges[src, side] if 0 <= src < mesh.size else zero

    below = torch.cat([part(mesh.rank - i, 1) for i in range(hops, 0, -1)],
                      dim=ax).narrow(ax, hops * k - h, h)
    above = torch.cat([part(mesh.rank + i, 0) for i in range(1, hops + 1)],
                      dim=ax).narrow(ax, 0, h)
    return torch.cat([below, slab, above], dim=ax)


def from_below(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The t of the rank below (rank - 1); zeros on rank 0."""
    got = exchange(t, mesh)
    return got[mesh.rank - 1] if mesh.rank > 0 else torch.zeros_like(t)
