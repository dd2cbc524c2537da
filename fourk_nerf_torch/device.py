"""Device choice for the port's entry points.

The rule: the default is the card. A caller that wants the CPU (the tests,
which run the plain versions of the kernels) says so with ``device="cpu"``.
Nothing drops to the CPU silently when the card is missing.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``. Raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "fourk_nerf_torch: a CUDA device was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    """numpy array / tensor / sequence -> tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, dtype=dtype, device=device)
