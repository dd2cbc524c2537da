"""The 4K frame: a DirectMPIGO render through the sweep kernel, then the x4
SFTNet decode through the dense-block kernel.

The frame of the JAX package's ``bench.py`` (one 1008x756 encoder render,
stepsize 1, background 1, then ``sftnet_apply_pallas`` with the dilated
upchain), with none of its fallbacks: a kernel that fails raises.
"""

from __future__ import annotations

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import dmpigo
from fourk_nerf_torch.ops import cuda_sr, cuda_sweep


class FramePipeline:
    """Encoder + decoder for one fixed scene and SR network.

    The grid is packed and the SFTNet's dense-block weights are packed once,
    at construction; each call renders one frame for a camera."""

    def __init__(self, cfg: dmpigo.Config, params: dict, buffers: dict,
                 sr_model, *, use_bf16: bool = True, device=None):
        self.device = resolve_device(device)
        if not dmpigo.plane_aligned_ok(cfg, 1.0, ndc=True):
            raise ValueError("the 4K frame needs the plane-aligned NDC setup")
        self.cfg, self.params = cfg, params
        self.packed = cuda_sweep.pack_grids_kernel(params, buffers,
                                                   use_bf16=use_bf16)
        self.sr = cuda_sr.prepare_sftnet(sr_model)

    def encode(self, H: int, W: int, K, c2w) -> dict:
        """The encoder render: ``rgb_feature [H,W,3]``, ``depth [H,W]``,
        ``rgb_marched``, ``alphainv_last``."""
        return cuda_sweep.render_frame_cuda(
            self.cfg, self.params, None, H, W, K, c2w, stepsize=1.0, bg=1.0,
            device=self.device, packed=self.packed)

    def decode(self, enc: dict) -> torch.Tensor:
        """The SR decode of an encoder output: ``[1, 4H, 4W, 3]`` float32,
        conditioned on depth."""
        return cuda_sr.sftnet_apply_cuda(
            self.sr, enc["rgb_feature"][None], enc["depth"][None, ..., None])

    def __call__(self, H: int, W: int, K, c2w):
        """One frame: returns (sr ``[1, 4H, 4W, 3]``, encoder outputs)."""
        enc = self.encode(H, W, K, c2w)
        return self.decode(enc), enc
