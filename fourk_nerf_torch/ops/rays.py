"""Camera-ray generation and NDC projection (torch).

Same semantics as the JAX package's ``ops/rays.py``: pixel centres at +0.5,
optional x/y flips, OpenGL (-z forward) vs inverse-y camera conventions, and
the forward-facing NDC warp. Outputs are ``[H, W, 3]`` float32 tensors.
"""

from __future__ import annotations

import torch

from fourk_nerf_torch.device import as_tensor


def get_rays(H: int, W: int, K, c2w, inverse_y: bool, flip_x: bool,
             flip_y: bool, mode: str = "center", *, device="cpu"):
    """Per-pixel camera rays. Returns (rays_o, rays_d), both ``[H, W, 3]``.
    ``mode``: 'lefttop' | 'center' (the JAX package's 'random' jitter is a
    training feature, not ported yet)."""
    K = as_tensor(K, device)
    c2w = as_tensor(c2w, device)
    j, i = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    if mode == "center":
        i, j = i + 0.5, j + 0.5
    elif mode != "lefttop":
        raise NotImplementedError(mode)
    if flip_x:
        i = i.flip(1)
    if flip_y:
        j = j.flip(0)
    if inverse_y:
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0], (j - K[1, 2]) / K[1, 1],
                            torch.ones_like(i)], -1)
    else:
        dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                            -torch.ones_like(i)], -1)
    # rotate into the world frame elementwise, summed in a fixed order
    rot = c2w[:3, :3]
    rays_d = (dirs[..., 0:1] * rot[:, 0] + dirs[..., 1:2] * rot[:, 1]
              + dirs[..., 2:3] * rot[:, 2])
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def ndc_rays(H: int, W: int, focal, near: float, rays_o, rays_d):
    """Warp rays into normalized device coordinates (forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def get_rays_of_a_view(H: int, W: int, K, c2w, ndc: bool, inverse_y: bool,
                       flip_x: bool, flip_y: bool, mode: str = "center", *,
                       device="cpu"):
    """Rays + unit view directions for one pose: (rays_o, rays_d, viewdirs),
    each ``[H, W, 3]``."""
    rays_o, rays_d = get_rays(H, W, K, c2w, inverse_y, flip_x, flip_y, mode,
                              device=device)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    if ndc:
        focal = float(as_tensor(K, "cpu")[0, 0])
        rays_o, rays_d = ndc_rays(H, W, focal, 1.0, rays_o, rays_d)
    return rays_o, rays_d, viewdirs


def positional_encoding(x, n_freqs: int):
    """``[..., C] -> [..., C*(1+2*n_freqs)]``: identity, then the sines
    channel-major, then the cosines channel-major, at frequencies 2^i."""
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[..., None] * freqs).reshape(*x.shape[:-1], x.shape[-1] * n_freqs)
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)
