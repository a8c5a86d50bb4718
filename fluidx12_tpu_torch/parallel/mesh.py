"""The device mesh of the multi-device modes (mirror of
fluidx12_tpu/parallel/mesh.py).

The JAX package lays a 1D `Mesh` over the grid's Z axis and names it
`Z_AXIS`; its halos ride `ppermute`, its reductions `psum`.  Here a mesh is
one process per device under torch.distributed: `GridMesh` holds this
process's place on the Z axis, the axis's process group and the device,
and the sharded code (domain.py, light.py, render.py) runs its
collectives over that group.  `ppermute` becomes paired sends and
receives between neighbours, `psum` an `all_reduce`, a gather an
`all_gather`.

`make_grid_mesh` starts the process group when none is running: `gloo` on
the CPU, `nccl` on the card, from a `FileStore` (several processes) or a
`HashStore` (one), so nothing reaches for a network address.  NCCL puts
one rank on a card, so one H100 runs the domain modes at world size 1;
the CPU runs them at any size over gloo.  The device is named by the
caller and never falls back: asking for CUDA without a card raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

Z_AXIS = "z"


@dataclasses.dataclass
class GridMesh:
    """One process's view of a Z-axis mesh: the axis's process group, its
    members' global ranks in Z order, this process's index along Z and the
    device its slab lives on.  `exchanges` counts the halo exchange rounds
    run over this mesh (domain._exchange_z_halo), which tests read."""

    group: object
    ranks: Tuple[int, ...]
    index: int
    device: torch.device
    exchanges: int = 0

    @property
    def size(self) -> int:
        return len(self.ranks)

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """`lax.psum` over the Z axis: `t` (a contiguous copy where it is not
        contiguous) summed over the axis's ranks in place, returned."""
        t = t.contiguous()
        dist.all_reduce(t, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """`lax.all_gather` over the Z axis: (size, *t.shape), the axis's
        tensors in Z order."""
        return all_gather_stacked(t, self.size, self.group)


def all_gather_stacked(t: torch.Tensor, size: int, group) -> torch.Tensor:
    """(size, *t.shape): the group's tensors stacked in group-rank order."""
    parts = [torch.empty_like(t, memory_format=torch.contiguous_format) for _ in range(size)]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.stack(parts)


def init_distributed(rank: int, world_size: int, device, store_path: Optional[str] = None):
    """Start the default process group for `device` unless one is running:
    `gloo` on the CPU, `nccl` on the card, from a `FileStore` at
    `store_path` (each rank passes the same path) or, at world size 1, an
    in-process `HashStore`."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the mesh asks for a CUDA device, and none is available")
    if dist.is_initialized():
        return
    if store_path is not None:
        store = dist.FileStore(store_path, world_size)
    elif world_size == 1:
        store = dist.HashStore()
    else:
        raise ValueError("a process group of several ranks needs a FileStore path")
    dist.init_process_group("gloo" if device.type == "cpu" else "nccl", store=store,
                            rank=rank, world_size=world_size)


def make_grid_mesh(n_devices: Optional[int] = None, device="cuda",
                   store_path: Optional[str] = None, rank: int = 0) -> GridMesh:
    """1D mesh over the grid's Z dimension, spanning the first `n_devices`
    ranks of the default group (all of them by default), which it starts
    when none is running (`init_distributed`; `rank` and `store_path` are
    read only then).  Every rank of the default group calls this, also
    one outside the mesh, as torch's `new_group` requires."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device()
                              if torch.cuda.is_available() else 0)
    init_distributed(rank, n_devices or 1, device, store_path)
    world = dist.get_world_size()
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    ranks = tuple(range(n))
    group = dist.group.WORLD if n == world else dist.new_group(list(ranks))
    me = dist.get_rank()
    return GridMesh(group=group, ranks=ranks, index=ranks.index(me) if me in ranks else -1,
                    device=device)
