"""Trilinear / nearest voxel-grid sampling (torch).

Grids are channel-last ``[X, Y, Z, C]``. Coordinates follow
``align_corners=True``: a normalized ``u in [0, 1]`` maps to voxel index
``u * (size - 1)``; out-of-range corners contribute zero (zeros padding).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def world_to_ind01(xyz, xyz_min, xyz_max):
    """World coordinates -> [0,1]^3 normalized grid coordinates."""
    return (xyz - xyz_min) / (xyz_max - xyz_min)


def trilinear_sample(grid, ind01):
    """Trilinear sample of ``[X,Y,Z,C]`` at ``[..., 3]`` normalized coords,
    zeros padding. Returns ``[..., C]``."""
    X, Y, Z, C = grid.shape
    sizes_f = torch.tensor([X, Y, Z], dtype=ind01.dtype, device=ind01.device)
    pos = (ind01 * (sizes_f - 1)).reshape(-1, 3)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    sizes = torch.tensor([X, Y, Z], dtype=torch.long, device=ind01.device)
    flat = grid.reshape(-1, C)
    out = torch.zeros((pos.shape[0], C), dtype=grid.dtype, device=grid.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = torch.tensor([cx, cy, cz], device=ind01.device)
                idx = i0 + corner
                valid = ((idx >= 0) & (idx < sizes)).all(-1)
                w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
                cidx = torch.minimum(torch.clamp_min(idx, 0), sizes - 1)
                fidx = (cidx[:, 0] * Y + cidx[:, 1]) * Z + cidx[:, 2]
                out = out + torch.where(valid, w, torch.zeros_like(w))[:, None] \
                    * flat[fidx]
    return out.reshape(*ind01.shape[:-1], C)


def trilinear_sample_plane_aligned(grid, ind01_xy):
    """Bilinear sample on plane k for sample k (``[N, K, 2]`` coords with
    K == Z): the MPI geometry where each NDC sample lies on a grid plane."""
    X, Y, Z, C = grid.shape
    N, K, _ = ind01_xy.shape
    if K != Z:
        raise ValueError(f"plane-aligned sampling needs K == Z, got {K}, {Z}")
    dev = ind01_xy.device
    sizes_f = torch.tensor([X, Y], dtype=ind01_xy.dtype, device=dev)
    pos = ind01_xy * (sizes_f - 1)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    plane_k = torch.arange(K, device=dev)[None, :].expand(N, K)
    flat = grid.reshape(-1, C)
    sizes = torch.tensor([X, Y], dtype=torch.long, device=dev)
    out = torch.zeros((N, K, C), dtype=grid.dtype, device=grid.device)
    for cx in (0, 1):
        for cy in (0, 1):
            corner = torch.tensor([cx, cy], device=dev)
            idx = i0 + corner
            valid = ((idx >= 0) & (idx < sizes)).all(-1)
            w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
            cidx = torch.minimum(torch.clamp_min(idx, 0), sizes - 1)
            fidx = (cidx[..., 0] * Y + cidx[..., 1]) * Z + plane_k
            out = out + torch.where(valid, w, torch.zeros_like(w))[..., None] \
                * flat[fidx.reshape(-1)].reshape(N, K, C)
    return out


def nearest_mask_lookup(mask, xyz, xyz_min, xyz_max):
    """Nearest-neighbour occupancy lookup, False outside the grid:
    ``ijk = round(xyz * scale + shift)`` (round half to even)."""
    X, Y, Z = mask.shape
    sizes = torch.tensor([X, Y, Z], dtype=xyz.dtype, device=xyz.device)
    scale = (sizes - 1) / (xyz_max - xyz_min)
    ijk = torch.round(xyz * scale + (-xyz_min * scale)).long()
    isz = sizes.long()
    in_range = ((ijk >= 0) & (ijk < isz)).all(-1)
    cijk = torch.minimum(torch.clamp_min(ijk, 0), isz - 1)
    fidx = (cijk[..., 0] * Y + cijk[..., 1]) * Z + cijk[..., 2]
    vals = mask.reshape(-1)[fidx.reshape(-1)].reshape(fidx.shape)
    return vals & in_range


def resize_trilinear_chunked(grid, new_size, z_chunk: int = 32):
    """Trilinear ``align_corners=True`` resize of ``[X,Y,Z,C]`` to
    ``new_size``, computed in z-slabs of ``z_chunk`` planes so the 8-corner
    temporaries of one slab bound the peak memory (a full-grid eager resize
    at fern scale needs ~11 GB of them)."""
    nx, ny, nz = (int(s) for s in new_size)
    dt, dev = grid.dtype, grid.device

    def axis_u(n):
        return (torch.arange(n, dtype=dt, device=dev) / (n - 1) if n > 1
                else torch.zeros(n, dtype=dt, device=dev))

    ux, uy = axis_u(nx), axis_u(ny)
    slabs = []
    for z0 in range(0, nz, z_chunk):
        uz = (z0 + torch.arange(z_chunk, dtype=dt, device=dev)) / max(nz - 1, 1)
        gx, gy, gz = torch.meshgrid(ux, uy, uz, indexing="ij")
        slabs.append(trilinear_sample(grid, torch.stack([gx, gy, gz], -1)))
    return torch.cat(slabs, dim=2)[:, :, :nz]


def max_pool3d_same(x):
    """3x3x3 max pool, stride 1, 'same' padding over ``[X, Y, Z]``."""
    return F.max_pool3d(x[None, None], kernel_size=3, stride=1,
                        padding=1)[0, 0]
