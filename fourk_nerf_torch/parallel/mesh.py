"""Mesh construction and placements on ``torch.distributed``.

The JAX package's ``parallel/mesh.py`` builds one ``jax.sharding.Mesh``
with the axes ``data`` (ray and tile batches) and ``grid`` (the voxel
volume along X) and lets XLA insert the collectives. Here the mesh is a
``DeviceMesh`` over the ranks of the default process group, one rank a
device, with the same axis names; placements are DTensor placement lists
(one entry a mesh axis); the collectives are explicit: a grid reader
gathers a sharded grid whole (``models.common.gathered``), a tiled decode
or a frame all-gathers its shares (``sr_esrnet.tile_process_sharded``,
``box_sweep.render_frame_box(tile_mesh=...)``). The reference's own
process-group layer is frozoul/4K-NeRF torch_utils/distributed_utils.py.

A process joins a world through :func:`maybe_initialize_distributed`,
from the environment that ``torchrun --nproc_per_node=N`` sets. Where the
JAX package prints a failed initialisation and carries on in one process,
this raises.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from fourk_nerf_torch.device import resolve_device

AXES = ("data", "grid")
_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def make_mesh(n_data: int | None = None, n_grid: int = 1, device=None):
    """A ``DeviceMesh`` of ``n_data x n_grid`` ranks with the axes
    ``("data", "grid")``, on ``device``'s type (default ``cuda``);
    ``n_data`` defaults to the world size over ``n_grid``. The mesh spans
    the whole world: ``n_data * n_grid`` must be the world size. Needs an
    initialised process group (:func:`maybe_initialize_distributed`)."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "maybe_initialize_distributed first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_grid
    if n_data * n_grid != world:
        raise ValueError(f"a {n_data}x{n_grid} mesh in a world of {world} "
                         "ranks")
    return init_device_mesh(dev.type, (n_data, n_grid), mesh_dim_names=AXES)


def shard_batch(mesh) -> tuple:
    """Rays or pixels split along their leading dim over ``data``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Shard(0), Replicate())


def replicate(mesh) -> tuple:
    """The same tensor on every rank."""
    from torch.distributed.tensor import Replicate

    return (Replicate(),) * mesh.ndim


def grid_sharding(mesh) -> tuple:
    """Voxel grids ``[X, Y, Z, C]`` split along X over ``grid``."""
    from torch.distributed.tensor import Replicate, Shard

    return (Replicate(), Shard(0))


def shard_grid_params(mesh, params: dict) -> dict:
    """The model's params as DTensors: the 4-D ``density`` and ``k0`` grids
    split along X over ``grid``, everything else replicated. Every rank
    passes the same ``params``."""
    from torch.distributed.tensor import distribute_tensor

    def place(name, leaf):
        if isinstance(leaf, dict):
            return {k: place(None, v) for k, v in leaf.items()}
        spec = (grid_sharding(mesh) if name in ("density", "k0")
                and leaf.dim() == 4 else replicate(mesh))
        return distribute_tensor(leaf.detach(), mesh, spec)

    return {k: place(k, v) for k, v in params.items()}


def all_reduce_dict(mesh, d: dict, axis: str = "data") -> dict:
    """The mean of each leaf of ``d`` over the ranks of ``axis``: a leaf is
    this rank's value, a host number or a tensor (its mean is taken
    first); a host number stands for a value replicated on the axis.
    Returns float32 0-d tensors on the mesh's device type."""
    group = mesh.get_group(axis)
    n = mesh.size(AXES.index(axis))
    dev = torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device("cpu")

    def mean(v):
        if isinstance(v, dict):
            return {k: mean(x) for k, x in v.items()}
        t = torch.as_tensor(v, dtype=torch.float32).to(dev).mean()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t / n

    return mean(d)


def maybe_initialize_distributed(enable: bool = False, device=None) -> bool:
    """Join the world of a ``torchrun`` launch when asked (``enable``, the
    CLI's ``--multihost``) or when its environment is set: the process
    group from ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
    ``RANK``, ``nccl`` on ``cuda`` (after ``torch.cuda.set_device`` of
    ``LOCAL_RANK``), ``gloo`` on the CPU. Returns whether a process group
    exists. Raises when asked and the environment is missing, or when the
    rendezvous fails."""
    present = all(k in os.environ for k in _ENV)
    if not (enable or present):
        return False
    if dist.is_initialized():
        return True
    if not present:
        missing = [k for k in _ENV if k not in os.environ]
        raise RuntimeError(
            f"--multihost: {', '.join(missing)} not set; launch with "
            "torchrun --nproc_per_node=N (or set the torchrun environment)")
    dev = resolve_device(device)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method="env://", rank=rank,
                            world_size=world)
    print(f"torch.distributed initialized: rank {rank}/{world} "
          f"({dist.get_backend()})")
    return True


def is_master() -> bool:
    """True on rank 0, or when no process group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0
