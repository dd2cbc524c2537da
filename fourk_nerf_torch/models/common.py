"""Shared building blocks for the voxel models (torch).

The rgbnet is a plain dict ``{w0, b0, w1, b1, ...}`` with ``w`` of shape
``[Cin, W]``, the JAX package's layout, so parameters carry over as they
are. Grids are channel-last ``[X, Y, Z, C]``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch


def mlp_init(dims: Sequence[int], *, generator: torch.Generator,
             device="cpu") -> dict:
    """nn.Linear-style init: W, b ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
    final bias zeroed."""
    params = {}
    n_layers = len(dims) - 1
    for li in range(n_layers):
        bound = 1.0 / math.sqrt(dims[li])
        w = torch.rand((dims[li], dims[li + 1]), generator=generator,
                       dtype=torch.float32) * (2 * bound) - bound
        params[f"w{li}"] = w.to(device)
        if li == n_layers - 1:
            params[f"b{li}"] = torch.zeros(dims[li + 1], device=device)
        else:
            b = torch.rand((dims[li + 1],), generator=generator,
                           dtype=torch.float32) * (2 * bound) - bound
            params[f"b{li}"] = b.to(device)
    return params


#: activation name -> integer code used by the sweep kernel
ACT_CODES = {"relu": 0, "lkrelu": 1, "gauss": 2}


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
