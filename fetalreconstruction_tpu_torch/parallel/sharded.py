"""Slice data parallelism: the slice batch split over ranks, the volume
replicated on each.

Port of fetalreconstruction_tpu/parallel/sharded.py (the reference's
multi-GPU runtime: contiguous slice ranges per GPU, a volume replica per
device, addon / cmap / weights reduced and the regularised volume shared;
reconstruction_cuda2.cu:1408-1460, 2225-2239, 2368-2373).

JAX is single-controller: one process runs shard_map over its devices.
PyTorch runs one process per rank, so every rank runs the same host
pipeline on the same host inputs, which is what the JAX package already
does across processes (`place_global`, sharded.py:71-87), and keeps only
its own block of the padded slice batch on its device: rows
[r N / W, (r + 1) N / W), the split that shard_map makes with
P("slices").

The compute bodies are not duplicated here: pipeline/svr_core, em/robust,
em/bias and ops/manual_mask take an optional `group` (a torch.distributed
process group; None runs the single-device code) and all-reduce their
partial volumes and EM sums themselves, where the JAX package psums over
`axis_name`.  The volume after each all-reduce, and all that follows from
it on every rank, is bitwise equal across ranks; the pipeline broadcasts
rank 0's transforms after the host-driven stages that every rank runs
(stack and package registration).

Every collective is an all_reduce (SUM, MIN or MAX) or a broadcast: the
collectives that gloo runs on CUDA tensors, as NCCL does.  Per-slice
values that every rank needs are assembled by `gather_rows`: each rank
writes its own rows into a zero-filled global buffer and the buffers are
summed, which is exact (x + 0 == x).

The backend follows from the placement: NCCL when each rank of a host has
a card of its own, gloo when the ranks run on the CPU or share a card
(NCCL refuses two ranks on one card; sharing one is how a one-card machine
runs the multi-rank path at all).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXIS = "slices"  # the mesh axis, and the mesh_mode that shards it


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One rank's view of the slice mesh: its process group, rank, the
    world size and its device."""
    group: Any
    rank: int
    size: int
    device: torch.device

    def block(self, n: int) -> Tuple[int, int]:
        """[lo, hi): the rows of an n-row padded batch (or z rows of a
        slab-split volume) that this rank owns."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             "ranks: pad them first (pad_batch, or "
                             "volume_sharded.pad_attr_z)")
        k = n // self.size
        return self.rank * k, (self.rank + 1) * k


def pad_slices_for_mesh(n_slices: int, n_devices: int) -> int:
    """Slice count padded up to a multiple of the mesh size."""
    return ((n_slices + n_devices - 1) // n_devices) * n_devices


def backend_for(device: torch.device, ranks_per_host: int) -> str:
    """NCCL when every rank of the host has a card of its own, else
    gloo."""
    if device.type == "cuda" and ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def make_mesh(rank: int, size: int, init_method: str, *,
              use_cpu: bool = False, local_rank=None,
              local_size=None) -> Mesh:
    """Join the process group as `rank` of `size` and return the rank's
    mesh.  The rank runs on cuda:(local_rank % device count), or on the
    CPU when the caller asks for it; without use_cpu a rank that finds no
    CUDA device raises.  local_rank / local_size (the rank's index and the
    rank count on its host) default to rank / size, one host."""
    local_rank = rank if local_rank is None else int(local_rank)
    local_size = size if local_size is None else int(local_size)
    if use_cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(f"rank {rank}: no CUDA device (run the ranks "
                               "on the CPU with --useCPU / use_cpu=True)")
        device = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device, local_size),
                            init_method=init_method, rank=rank,
                            world_size=size)
    return Mesh(group=dist.group.WORLD, rank=rank, size=size, device=device)


def mesh_from_env(*, use_cpu: bool = False) -> Mesh:
    """The mesh of a rank started by a launcher such as torchrun, from its
    RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT and (when set) LOCAL_RANK /
    LOCAL_WORLD_SIZE: the counterpart of jax.distributed.initialize()."""
    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                           "MASTER_PORT") if k not in os.environ]
    if missing:
        raise RuntimeError("--distributed needs the launcher's "
                           f"{', '.join(missing)} (as torchrun sets them)")
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    return make_mesh(rank, size, "env://", use_cpu=use_cpu,
                     local_rank=os.environ.get("LOCAL_RANK", rank),
                     local_size=os.environ.get("LOCAL_WORLD_SIZE", size))


def close() -> None:
    """Leave the process group, if this process joined one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def spawn(fn, nprocs: int, *args, use_cpu: bool = False) -> None:
    """Run fn(mesh, *args) on `nprocs` ranks of this host, one process
    each, started with the spawn method (the caller may hold CUDA or JAX
    state), meeting through a file in a fresh temporary directory.
    Returns when every rank has finished; if one fails, the others are
    terminated and its error is raised here.  fn must be importable by
    name (a module-level function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_rank_main, args=(nprocs, f"file://{tmp}/rdzv",
                                             use_cpu, fn, args),
                           nprocs=nprocs, join=True, start_method="spawn")


def _rank_main(index, nprocs, init_method, use_cpu, fn, args):
    """A spawned rank: join the group, run fn, leave the group on every
    exit path.  Ranks on the CPU share the host's cores."""
    if use_cpu:
        torch.set_num_threads(max(1, torch.get_num_threads() // nprocs))
    mesh = make_mesh(index, nprocs, init_method, use_cpu=use_cpu)
    try:
        fn(mesh, *args)
    finally:
        close()


# ---------------------------------------------------------------------------
# collectives (group None: no collective, the single-device code)
# ---------------------------------------------------------------------------

def psum(t: torch.Tensor, group) -> torch.Tensor:
    """t summed over the ranks of `group`, in place."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def pmin(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=group)
    return t


def pmax(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return t


def gather_rows(mesh: Mesh, local: torch.Tensor, n: int) -> torch.Tensor:
    """The (n, ...) tensor whose block of rows each rank holds, on every
    rank (bool tensors travel as int32)."""
    lo, hi = mesh.block(n)
    if local.shape[0] != hi - lo:
        raise ValueError(f"rank {mesh.rank} holds {local.shape[0]} rows, "
                         f"its block is {hi - lo}")
    work = local.to(torch.int32) if local.dtype == torch.bool else local
    out = torch.zeros((n,) + tuple(local.shape[1:]), dtype=work.dtype,
                      device=local.device)
    out[lo:hi] = work
    psum(out, mesh.group)
    return out.to(local.dtype)


def broadcast(mesh: Mesh, t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank src's t on every rank, in place."""
    dist.broadcast(t, src, group=mesh.group)
    return t


def broadcast_array(mesh: Mesh, a: np.ndarray) -> np.ndarray:
    """Rank 0's numpy array on every rank (through the rank's device)."""
    t = torch.as_tensor(np.ascontiguousarray(a), device=mesh.device)
    return broadcast(mesh, t).cpu().numpy()


# ---------------------------------------------------------------------------
# the slice batch and registration under the mesh
# ---------------------------------------------------------------------------

def pad_batch(batch, transforms: np.ndarray, n_ranks: int):
    """Pad the slice batch to a multiple of n_ranks with fully invalid
    (-1) slices that copy the last real slice's attributes, so that
    registration preparation stays well defined (JAX pipeline/svr.py:
    469-496).  Mutates batch; returns (batch, transforms)."""
    n0 = batch.n_slices
    extra = pad_slices_for_mesh(n0, n_ranks) - n0
    if extra == 0:
        return batch, transforms
    batch.data = np.concatenate(
        [batch.data, np.full((extra,) + batch.data.shape[1:], -1.0,
                             np.float32)])
    batch.i2w = np.concatenate([batch.i2w,
                                np.tile(batch.i2w[-1:], (extra, 1, 1))])
    batch.dims = np.concatenate([batch.dims,
                                 np.tile(batch.dims[-1:], (extra, 1))])
    batch.stack_index = np.concatenate(
        [batch.stack_index,
         np.full((extra,), batch.stack_index[-1], np.int32)])
    batch.attrs = batch.attrs + [batch.attrs[-1].copy()
                                 for _ in range(extra)]
    transforms = np.concatenate([transforms,
                                 np.tile(transforms[-1:], (extra, 1, 1))])
    return batch, transforms


def register_slices(reg_cfg, mesh: Mesh, n: int, recon, recon_w2i,
                    transforms, mo, ofs_i2w, targets, recon_dx, fast=None,
                    stack_id=None):
    """Slice-to-volume registration under the mesh
    (sharded_register_slices, JAX sharded.py:231-266).  transforms, mo,
    ofs_i2w, targets and stack_id are the rank's rows; each rank
    registers them against the replicated volume (per-slice problems are
    independent, as in the reference's dev_slice_range_offset split), and
    one all-reduce assembles the result.  With `fast` and
    reg_cfg.psf_matched, each rank builds the PSF-matched tables from the
    replicated volume.

    Returns ((n, 4, 4) transforms, (n,) similarity) on every rank."""
    from ..register import slice2vol as s2v

    kw = {}
    if fast is not None and reg_cfg.psf_matched:
        kw = dict(psf_table=s2v.build_psf_tables(fast, recon),
                  vol_shape=tuple(recon.shape), sid=stack_id)
    t, sim = s2v.register_slices_to_volume(reg_cfg, recon, recon_w2i,
                                           transforms, mo, ofs_i2w, targets,
                                           recon_dx, **kw)
    return gather_rows(mesh, t, n), gather_rows(mesh, sim, n)
