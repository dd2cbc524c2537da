"""Parallelism on ``torch.distributed``: a ``DeviceMesh`` over the world's
ranks with the JAX package's axes (``data``: ray and tile batches;
``grid``: the voxel volume along X), DTensor placements, and the
process-group helpers (initialisation from the ``torchrun`` environment, a
mean over an axis). A rank is what a JAX device is there."""

from fourk_nerf_torch.parallel.mesh import (  # noqa: F401
    all_reduce_dict,
    grid_sharding,
    is_master,
    make_mesh,
    maybe_initialize_distributed,
    replicate,
    shard_batch,
    shard_grid_params,
)
