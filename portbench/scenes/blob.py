"""``blob``: a central ball of volume share ``fill`` with density
N(``inside``, ``density_std``) and ``outside`` around it; the occupancy
mask is the ball."""

import math

import torch


def grids(ws, sc: dict, g, device) -> tuple:
    axes = [torch.linspace(-1, 1, n, device=device) for n in ws]
    gx, gy, gz = torch.meshgrid(*axes, indexing="ij")
    r = (3.0 * sc["fill"] / (4.0 * math.pi) * 8.0) ** (1.0 / 3.0)
    mask = gx ** 2 + gy ** 2 + gz ** 2 < r * r
    density = torch.where(
        mask, torch.randn(ws, generator=g, device=device)
        * sc["density_std"] + sc["inside"],
        torch.full(ws, float(sc["outside"]), device=device))[..., None]
    return density, mask
