"""``noise``: density N(``density_mean``, ``density_std``) and a random
occupancy mask of share ``mask_share``."""

import torch


def grids(ws, sc: dict, g, device) -> tuple:
    density = torch.randn(ws + (1,), generator=g, device=device) \
        * sc["density_std"] + sc["density_mean"]
    mask = torch.rand(ws, generator=g, device=device) < sc["mask_share"]
    return density, mask
