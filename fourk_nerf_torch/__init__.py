"""PyTorch + CUDA port of the 4K-NeRF inference path for NVIDIA Hopper.

The package renders the 4K frame of the LLFF fern configuration: a
DirectMPIGO plane sweep at 1008x756 (``ops.cuda_sweep``) followed by the x4
SFTNet decode (``ops.cuda_sr``), each carried by a CUDA kernel written for
``sm_90a`` (``csrc/``). Every kernel has a plain PyTorch version beside it;
a wrapper takes the plain version only for tensors that lie on the CPU.

Importing the package loads no kernel and touches no device. Entry points
take ``device`` and default to ``cuda``; they raise when no card is present
unless the caller asked for ``cpu`` (:func:`fourk_nerf_torch.device.resolve_device`).
"""

from fourk_nerf_torch.device import resolve_device

__all__ = ["resolve_device"]
