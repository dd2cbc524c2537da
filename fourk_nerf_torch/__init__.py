"""PyTorch + CUDA port of 4K-NeRF for NVIDIA Hopper: the inference paths
and the encoder's pretraining (``run.py``, ``train/``).

The package renders the 4K frame of the LLFF fern configuration, a
DirectMPIGO plane sweep at 1008x756 (``ops.cuda_sweep``) followed by the x4
SFTNet decode (``ops.cuda_sr``), and the fly-through of a bounded
DirectVoxGO scene (``ops.cuda_box``, ``train.trainer.render_viewpoints``,
``pipeline.render_video``) with the decoder's RRDBs fused into one launch
each on request. Each is carried by a CUDA kernel written for ``sm_90a``
(``csrc/``). Every kernel has a plain PyTorch version beside it; a wrapper
takes the plain version only for tensors that lie on the CPU.
``python -m fourk_nerf_torch.run`` fits the fine stage of a forward-facing
scene (the fern pretrain config); its eval renders go through the
plane-sweep kernel.

Importing the package loads no kernel and touches no device. Entry points
take ``device`` and default to ``cuda``; they raise when no card is present
unless the caller asked for ``cpu`` (:func:`fourk_nerf_torch.device.resolve_device`).
"""

from fourk_nerf_torch.device import resolve_device

__all__ = ["resolve_device"]
