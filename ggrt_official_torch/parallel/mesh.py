"""Device mesh over the ranks of a process group (the JAX package's
parallel/mesh.py).

The reference trains with DDP over NCCL, one target view per GPU
(base/trainer.py:115-117). The port keeps the JAX package's two axes:
  * "dp": data parallelism over target views, gradients averaged;
  * "tp": tile parallelism, one view's screen tiles split over ranks.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def make_mesh(data_parallel: int = 0, tile_parallel: int = 1, device_type: str = "cuda") -> DeviceMesh:
    """A (dp, tp) DeviceMesh over the first dp·tp ranks of the default
    process group, which must be initialised; every rank calls it, and on
    a rank outside the mesh `get_coordinate()` is None. data_parallel <= 0
    fills the world: dp = world // tile_parallel, and tile_parallel must
    divide the world. ValueError if dp·tp exceeds the world.

    On a "cuda" mesh rank r takes cuda:{r % count}."""
    world = dist.get_world_size()
    if data_parallel <= 0:
        if world % tile_parallel:
            raise ValueError(f"tile_parallel {tile_parallel} does not divide the world of {world} ranks")
        data_parallel = world // tile_parallel
    if data_parallel * tile_parallel > world:
        raise ValueError(f"mesh {data_parallel}x{tile_parallel} exceeds {world} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    grid = torch.arange(data_parallel * tile_parallel).reshape(data_parallel, tile_parallel)
    return DeviceMesh(device_type, grid, mesh_dim_names=("dp", "tp"))
