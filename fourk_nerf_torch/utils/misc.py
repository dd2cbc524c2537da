"""Runtime helpers: shape assertions, an endless sampler and a
replica-consistency check (the port's form of the JAX package's
``utils/misc.py``, after frozoul/4K-NeRF torch_utils/misc.py)."""

from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch


def assert_shape(x, ref_shape: Sequence[int | None]) -> None:
    """Raise unless ``x.shape`` matches ``ref_shape`` (None: any size)."""
    shape = tuple(x.shape)
    if len(shape) != len(ref_shape):
        raise AssertionError(f"rank {len(shape)} != {len(ref_shape)}")
    for i, (s, r) in enumerate(zip(shape, ref_shape)):
        if r is not None and s != r:
            raise AssertionError(
                f"dim {i}: {s} != {r} (full: {shape} vs {ref_shape})")


def infinite_sampler(n: int, rng: np.random.Generator, shuffle: bool = True,
                     rank: int = 0, num_replicas: int = 1) -> Iterator[int]:
    """Endless index stream, reshuffled each pass, sharded by ``rank``."""
    order = np.arange(n)
    while True:
        if shuffle:
            order = rng.permutation(n)
        for i in order[rank::num_replicas]:
            yield int(i)


def _leaves(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}/{k}")
    else:
        yield path or "/", tree


def check_replica_consistency(tree) -> None:
    """Raise ``AssertionError`` naming the first leaf of ``tree`` whose
    replicas differ across ranks (frozoul/4K-NeRF torch_utils/misc.py
    ``check_ddp_consistency``). A DTensor leaf is compared over the mesh
    axes it is replicated on (its shards along a split axis differ by
    design); a plain tensor over the whole world. Bitwise; every rank
    raises for the same leaf. Without a process group, or in a world of
    one, there is nothing to compare."""
    import torch.distributed as dist

    if not dist.is_initialized() or dist.get_world_size() == 1:
        return
    for path, leaf in _leaves(tree):
        groups = [None]
        local = leaf
        if hasattr(leaf, "to_local"):
            local = leaf.to_local()
            groups = [leaf.device_mesh.get_group(i)
                      for i, p in enumerate(leaf.placements)
                      if p.is_replicate()]
        flat = local.detach().contiguous().reshape(-1)
        raw = flat.view(torch.uint8) if flat.dtype != torch.bool \
            else flat.to(torch.uint8)
        for group in groups:
            n = dist.get_world_size(group)
            got = [torch.empty_like(raw) for _ in range(n)]
            dist.all_gather(got, raw, group=group)
            if not all(torch.equal(got[0], g) for g in got[1:]):
                raise AssertionError(f"replica mismatch at {path}")
