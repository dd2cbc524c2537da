"""Shared building blocks for the voxel models (torch).

The rgbnet is a plain dict ``{w0, b0, w1, b1, ...}`` with ``w`` of shape
``[Cin, W]``, the JAX package's layout, so parameters carry over as they
are. Grids are channel-last ``[X, Y, Z, C]`` tensors (``DenseGrid``) or
TensoRF factor dicts (``TensoRFGrid``), through the ``grid_*`` dispatch.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.ops import cuda_grid, grid_sample, render, tensorf


def mlp_init(dims: Sequence[int], *, generator: torch.Generator,
             device=None, zero_final_bias: bool = True) -> dict:
    """nn.Linear-style init on ``device`` (default ``cuda``): W, b ~
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the final bias zeroed unless
    ``zero_final_bias`` is false."""
    device = resolve_device(device)
    params = {}
    n_layers = len(dims) - 1
    for li in range(n_layers):
        bound = 1.0 / math.sqrt(dims[li])
        w = torch.rand((dims[li], dims[li + 1]), generator=generator,
                       dtype=torch.float32) * (2 * bound) - bound
        params[f"w{li}"] = w.to(device)
        if zero_final_bias and li == n_layers - 1:
            params[f"b{li}"] = torch.zeros(dims[li + 1], device=device)
        else:
            b = torch.rand((dims[li + 1],), generator=generator,
                           dtype=torch.float32) * (2 * bound) - bound
            params[f"b{li}"] = b.to(device)
    return params


#: activation name -> integer code used by the sweep kernel
ACT_CODES = {"relu": 0, "lkrelu": 1, "gauss": 2}


def gathered(tree):
    """``tree`` with each DTensor leaf (a grid split over a mesh's ``grid``
    axis, or a replicated param: ``parallel.mesh.shard_grid_params``)
    gathered whole by ``full_tensor()``, whose gradient flows back to the
    shards; plain tensors pass as they are. The model forwards read their
    params through it: the collective that XLA inserts for a sharded grid
    in the JAX package."""
    if isinstance(tree, dict):
        return {k: gathered(v) for k, v in tree.items()}
    full = getattr(tree, "full_tensor", None)
    return tree if full is None else full()


def activation(name: str):
    if name == "relu":
        return torch.relu
    if name == "lkrelu":
        return lambda x: torch.where(x >= 0, x, 0.01 * x)
    if name == "gauss":
        # GaussianActivation(a=0.05)
        return lambda x: torch.exp(-(x ** 2) / (2.0 * 0.05 ** 2))
    raise NotImplementedError(name)


def mlp_apply(params: dict, x, act):
    n_layers = len(params) // 2
    for li in range(n_layers):
        x = x @ params[f"w{li}"] + params[f"b{li}"]
        if li < n_layers - 1:
            x = act(x)
    return x


def dmpigo_grid_resolution(xyz_min, xyz_max, num_voxels: int, mpi_depth: int):
    """MPI world size: XY from the voxel budget, Z = mpi_depth."""
    xyz_min = np.asarray(xyz_min, dtype=np.float64)
    xyz_max = np.asarray(xyz_max, dtype=np.float64)
    xy_len = xyz_max[:2] - xyz_min[:2]
    r = math.sqrt(num_voxels / mpi_depth / float(np.prod(xy_len)))
    return (int(xy_len[0] * r), int(xy_len[1] * r), int(mpi_depth))


def mpi_act_shift(mpi_depth: int, voxel_size_ratio: float) -> np.ndarray:
    """Per-plane density bias so every plane starts with equal alpha."""
    g = np.full([mpi_depth], 1.0 / mpi_depth - 1e-6)
    p = [1 - g[0]]
    for i in range(1, len(g)):
        p.append((1 - g[: i + 1].sum()) / (1 - g[:i].sum()))
    return np.array([np.log(pi ** (-1.0 / voxel_size_ratio) - 1.0)
                     for pi in p], dtype=np.float32)


def dvgo_grid_resolution(xyz_min, xyz_max, num_voxels: int):
    """Cubic-voxel world size and voxel size of a bounded scene (float64 on
    the host)."""
    xyz_min = np.asarray(xyz_min, dtype=np.float64)
    xyz_max = np.asarray(xyz_max, dtype=np.float64)
    voxel_size = (np.prod(xyz_max - xyz_min) / num_voxels) ** (1.0 / 3.0)
    world_size = ((xyz_max - xyz_min) / voxel_size).astype(np.int64)
    return tuple(int(w) for w in world_size), float(voxel_size)


# ---------------------------------------------------------------------------
# Grid-type dispatch (DenseGrid | TensoRFGrid), frozoul/4K-NeRF
# lib/grid.py:27-35: a dense grid is a channel-last tensor, a TensoRF grid a
# dict of factors (``ops/tensorf.py``).
# ---------------------------------------------------------------------------

def is_dense(grid_type: str) -> bool:
    if grid_type not in ("DenseGrid", "TensoRFGrid"):
        raise NotImplementedError(grid_type)
    return grid_type == "DenseGrid"


def grid_init(grid_type: str, channels: int, world_size, config=(), *,
              generator: torch.Generator, device=None):
    """A zero dense grid, or TensoRF factors drawn from ``generator``
    (``config`` holds ``n_comp`` and optionally ``n_comp_xy``)."""
    dev = resolve_device(device)
    if is_dense(grid_type):
        X, Y, Z = world_size
        return torch.zeros((X, Y, Z, channels), device=dev)
    cfgd = dict(config)
    return tensorf.init_tensorf(channels, world_size, cfgd["n_comp"],
                                cfgd.get("n_comp_xy"), generator=generator,
                                device=dev)


def grid_query(grid_type: str, gparams, ind01):
    """``[..., C]`` at normalised ``[..., 3]`` coordinates."""
    if is_dense(grid_type):
        return grid_sample.trilinear_sample(gparams, ind01)
    return tensorf.tensorf_query(gparams, ind01)


def grid_resize(grid_type: str, gparams, new_size):
    """The grid resampled onto ``new_size`` (a dense grid in z-slabs)."""
    if is_dense(grid_type):
        return grid_sample.resize_trilinear_chunked(gparams,
                                                    new_size).contiguous()
    return tensorf.tensorf_resize(gparams, new_size)


def grid_dense(grid_type: str, gparams, channels: int):
    """The dense ``[X, Y, Z, C]`` values."""
    if is_dense(grid_type):
        return gparams
    return tensorf.tensorf_dense(gparams, channels)


def grid_tv_grad(grid_type: str, gparams, wx: float, wy: float, wz: float,
                 sparse_grad=None):
    """The TV gradient of a grid: a dense grid's by the reference's rule
    (sparse mode: only where ``sparse_grad`` is non-zero), TensoRF factors'
    as the autograd gradient of the smooth-L1 factor loss (the JAX
    package's ``_tv_dispatch``; it has no sparse mode)."""
    if is_dense(grid_type):
        return render.total_variation_grad(gparams, wx, wy, wz, sparse_grad)
    return tensorf.tensorf_tv_grad(gparams, wx, wy, wz)


def grid_tv_add_(grid_type: str, gparams, grad, wx: float, wy: float,
                 wz: float, dense: bool) -> None:
    """``grad += grid_tv_grad(...)`` in place (without ``dense``, a dense
    grid's only where ``grad`` is non-zero), leaf by leaf for TensoRF
    factors. A dense grid on the card takes one kernel pass
    (``cuda_grid.tv_add_grad_``) and leaves no full-grid temporary."""
    if is_dense(grid_type) and gparams.is_cuda:
        cuda_grid.tv_add_grad_(gparams, grad, wx, wy, wz, dense)
        return
    tv = grid_tv_grad(grid_type, gparams, wx, wy, wz,
                      None if dense else grad)
    if isinstance(grad, dict):
        for k, g in grad.items():
            g.add_(tv[k])
    else:
        grad.add_(tv)
