"""The 2-D grid: slice data parallelism x volume z-slabs, composed.

Port of fetalreconstruction_tpu/parallel/mesh2d.py.  The ranks form an
S x V grid, rank = s V + v (the JAX package's devices.reshape(S, V) with
axes ("slices", "vol_z")):

- the slice batch is split over the S rows of the grid, as in
  parallel/sharded.py: rank (s, v) keeps slice block s;
- every volume is split into V z-slabs over the columns, as in
  parallel/volume_sharded.py: rank (s, v) keeps slab v, the same on every
  row.

Each rank carries two 1-D views of the grid, each a parallel/sharded.Mesh
with a process group of its own: `slices`, the S ranks of its column (the
ranks that hold its slab, one per slice block), and `vol`, the V ranks of
its row (the ranks that hold its slice block, one per slab).  The stages
are volume_sharded's, given the `vol` mesh and the `slices` group:

  JAX package (mesh2d.py)            port
  g2_build_geometry_fn               vs_build_geometry(..., grid.vol)
  _g2_scatter                        vs_fast_scatter2(..., grid.vol,
                                       grid.slices.group)
  g2_gaussian_reconstruction_fn      vs_gaussian_reconstruction(same)
  g2_simulate_fn                     vs_simulate(..., grid.vol)
  g2_initialize_robust_statistics_fn svr_core.initialize_robust_statistics
  g2_estep_fn                          and estep with grid.slices.group
  g2_inner_iteration_fn              vs_inner_iteration(..., grid.vol,
  _g2_normalise_bias                   grid.slices.group)
  g2_register_slices_fn              sharded.gather_rows of the slab
                                       over grid.vol, then
                                       sharded.register_slices on
                                       grid.slices

so a slab gathers over `vol` and a slice block's partial slabs are summed
over `slices`; the EM sums run over `slices` (every column computes the
same statistics).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist

from .sharded import Mesh


@dataclasses.dataclass(frozen=True)
class Grid:
    """One rank's view of an S x V grid: its column (`slices`) and row
    (`vol`)."""
    slices: Mesh
    vol: Mesh


def grid_shape(n_ranks: int):
    """Default (slices, vol_z) factorisation: near-square, slices-major
    (slice parallelism splits the larger share of the work at SVR
    scale)."""
    v = 1
    for cand in range(int(np.sqrt(n_ranks)), 0, -1):
        if n_ranks % cand == 0:
            v = cand
            break
    return n_ranks // v, v


def make_grid(mesh: Mesh) -> Grid:
    """The grid_shape(size) grid over the world `mesh`.  Every rank of the
    world must call it: each column's and each row's process group is
    created on every rank, in the same order."""
    s_, v_ = grid_shape(mesh.size)
    s, v = divmod(mesh.rank, v_)
    columns = [dist.new_group([i * v_ + j for i in range(s_)])
               for j in range(v_)]
    rows = [dist.new_group([i * v_ + j for j in range(v_)])
            for i in range(s_)]
    return Grid(slices=Mesh(columns[v], s, s_, mesh.device),
                vol=Mesh(rows[s], v, v_, mesh.device))
