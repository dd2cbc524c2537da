"""TensoRF vector-matrix decomposed grids (torch).

The port of the JAX package's ``ops/tensorf.py`` (after frozoul/4K-NeRF
lib/grid.py:157-268, ``TensoRFGrid``): a 3D field factorised as three
plane-vector products ``xy*z + xz*y + yz*x`` with an optional fusion matrix
``f_vec`` onto the channels. A query is three bilinear plane samples, three
linear vector samples and one small matrix product. Params are a dict of
channel-last factors (``xy_plane [X, Y, Rxy]``, ``xz_plane [X, Z, R]``,
``yz_plane [Y, Z, R]``, ``x_vec [X, R]``, ``y_vec [Y, R]``, ``z_vec [Z,
Rxy]``, ``f_vec [2R + Rxy, C]`` when C > 1), the JAX package's layout and
names, so checkpoints carry over as they are. Gradients come from autograd
of the same functions; the TV term is a loss whose autograd gradient the
models add to the factors' gradients.
"""

from __future__ import annotations

import math

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.ops import grid_sample


def bilinear_sample(plane, uv01):
    """Bilinear sample of ``[H, W, C]`` at normalised ``[..., 2]``
    coordinates (``align_corners``, zeros padding): the four corners summed
    in the JAX package's order (y corner outer, x corner inner)."""
    H, W, C = plane.shape
    dev = uv01.device
    size = torch.tensor([H, W], dtype=uv01.dtype, device=dev)
    pos = (uv01 * (size - 1)).reshape(-1, 2)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    flat = plane.reshape(-1, C)
    sizes = torch.tensor([H, W], dtype=torch.long, device=dev)
    out = torch.zeros((pos.shape[0], C), dtype=plane.dtype, device=plane.device)
    for cy in (0, 1):
        for cx in (0, 1):
            corner = torch.tensor([cy, cx], device=dev)
            idx = i0 + corner
            valid = ((idx >= 0) & (idx < sizes)).all(-1)
            w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
            cidx = torch.minimum(torch.clamp_min(idx, 0), sizes - 1)
            # index_select: its gradient is an index_add_ (atomics), which
            # takes the many samples of one texel (a vector's entry takes
            # thousands) at once, where advanced indexing's sorted
            # backward walks them one after another
            vals = flat.index_select(0, cidx[:, 0] * W + cidx[:, 1])
            out = out + torch.where(valid, w, torch.zeros_like(w))[:, None] \
                * vals
    return out.reshape(*uv01.shape[:-1], C)


def linear_sample(vec, u01):
    """Linear sample of ``[L, C]`` at normalised ``[...]`` coordinates."""
    return bilinear_sample(vec[:, None, :],
                           torch.stack([u01, torch.zeros_like(u01)], -1))


def init_tensorf(channels: int, world_size, n_comp: int,
                 n_comp_xy: int | None = None, *,
                 generator: torch.Generator, device=None) -> dict:
    """Factors drawn from ``generator`` on the host, then put on ``device``
    (default ``cuda``): N(0, 0.1^2) planes and vectors, ``f_vec``
    kaiming-uniform as the reference's."""
    dev = resolve_device(device)
    X, Y, Z = (int(s) for s in world_size)
    R = int(n_comp)
    Rxy = R if n_comp_xy is None else int(n_comp_xy)

    def normal(*shape):
        return (0.1 * torch.randn(shape, generator=generator)).to(dev)

    params = {
        "xy_plane": normal(X, Y, Rxy),
        "xz_plane": normal(X, Z, R),
        "yz_plane": normal(Y, Z, R),
        "x_vec": normal(X, R),
        "y_vec": normal(Y, R),
        "z_vec": normal(Z, Rxy),
    }
    if channels > 1:
        bound = math.sqrt(6.0 / ((1 + 5) * (R + R + Rxy)))
        params["f_vec"] = (torch.rand((R + R + Rxy, channels),
                                      generator=generator)
                           * (2 * bound) - bound).to(dev)
    return params


def tensorf_query(params: dict, ind01):
    """Query at normalised ``[..., 3]`` coordinates; ``[..., C]`` (C = 1
    without a fusion matrix, lib/grid.py:258-268)."""
    x, y, z = ind01[..., 0], ind01[..., 1], ind01[..., 2]
    xy = bilinear_sample(params["xy_plane"], torch.stack([x, y], -1))
    xz = bilinear_sample(params["xz_plane"], torch.stack([x, z], -1))
    yz = bilinear_sample(params["yz_plane"], torch.stack([y, z], -1))
    xv = linear_sample(params["x_vec"], x)
    yv = linear_sample(params["y_vec"], y)
    zv = linear_sample(params["z_vec"], z)
    if "f_vec" in params:
        feat = torch.cat([xy * zv, xz * yv, yz * xv], dim=-1)
        return feat @ params["f_vec"]
    val = (xy * zv).sum(-1) + (xz * yv).sum(-1) + (yz * xv).sum(-1)
    return val[..., None]


def tensorf_resize(params: dict, new_size) -> dict:
    """Every factor resized bilinearly with ``align_corners``
    (lib/grid.py:198-207): a plane as a ``[H, W, 1, C]`` volume, a vector
    as ``[L, 1, 1, C]``, through the plain trilinear resize."""
    X, Y, Z = (int(s) for s in new_size)

    def resize2d(p, h, w):
        return grid_sample.resize_trilinear(p[:, :, None, :],
                                            (h, w, 1))[:, :, 0, :]

    out = dict(params)
    out["xy_plane"] = resize2d(params["xy_plane"], X, Y)
    out["xz_plane"] = resize2d(params["xz_plane"], X, Z)
    out["yz_plane"] = resize2d(params["yz_plane"], Y, Z)
    out["x_vec"] = resize2d(params["x_vec"][:, None, :], X, 1)[:, 0, :]
    out["y_vec"] = resize2d(params["y_vec"][:, None, :], Y, 1)[:, 0, :]
    out["z_vec"] = resize2d(params["z_vec"][:, None, :], Z, 1)[:, 0, :]
    return out


def tensorf_dense(params: dict, channels: int):
    """The dense ``[X, Y, Z, C]`` grid (lib/grid.py:223-236)."""
    xy, xz, yz = params["xy_plane"], params["xz_plane"], params["yz_plane"]
    xv, yv, zv = params["x_vec"], params["y_vec"], params["z_vec"]
    if channels > 1:
        feat = torch.cat([
            torch.einsum("xyr,zr->xyzr", xy, zv),
            torch.einsum("xzr,yr->xyzr", xz, yv),
            torch.einsum("yzr,xr->xyzr", yz, xv),
        ], dim=-1)
        return torch.einsum("xyzr,rc->xyzc", feat, params["f_vec"])
    dense = (torch.einsum("xyr,zr->xyz", xy, zv)
             + torch.einsum("xzr,yr->xyz", xz, yv)
             + torch.einsum("yzr,xr->xyz", yz, xv))
    return dense[..., None]


def tensorf_tv_loss(params: dict, wx: float, wy: float, wz: float):
    """Smooth-L1 total variation over the factors (lib/grid.py:209-221),
    divided by 6; the models add its autograd gradient to the factors'."""

    def sl1(a, b):
        d = a - b
        ad = d.abs()
        return torch.where(ad < 1, 0.5 * d * d, ad - 0.5).sum()

    p = params
    loss = (wx * sl1(p["xy_plane"][1:], p["xy_plane"][:-1])
            + wy * sl1(p["xy_plane"][:, 1:], p["xy_plane"][:, :-1])
            + wx * sl1(p["xz_plane"][1:], p["xz_plane"][:-1])
            + wz * sl1(p["xz_plane"][:, 1:], p["xz_plane"][:, :-1])
            + wy * sl1(p["yz_plane"][1:], p["yz_plane"][:-1])
            + wz * sl1(p["yz_plane"][:, 1:], p["yz_plane"][:, :-1])
            + wx * sl1(p["x_vec"][1:], p["x_vec"][:-1])
            + wy * sl1(p["y_vec"][1:], p["y_vec"][:-1])
            + wz * sl1(p["z_vec"][1:], p["z_vec"][:-1]))
    return loss / 6.0


def tensorf_tv_grad(params: dict, wx: float, wy: float, wz: float) -> dict:
    """The gradient of :func:`tensorf_tv_loss` with respect to every factor
    (``f_vec``'s is zero), in the layout of ``params``."""
    with torch.enable_grad():
        live = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        grads = torch.autograd.grad(tensorf_tv_loss(live, wx, wy, wz),
                                    list(live.values()), allow_unused=True)
    return {k: torch.zeros_like(v) if g is None else g
            for (k, v), g in zip(live.items(), grads)}
