"""Frames and videos: an encoder render through its sweep kernel, then the
SFTNet decode through the dense-block or whole-RRDB kernel (or, for a
video, in tiles through the float32 module).

:class:`FramePipeline` is the frame of the JAX package's ``bench.py`` (one
encoder render, then ``sftnet_apply_pallas`` with the dilated upchain) for a
DirectMPIGO scene (plane sweep, stepsize 1) or a DirectVoxGO scene (box
sweep). :func:`render_video` is the fly-through of its
``run_sr.py --render_video``: every pose through
``trainer.render_viewpoints``, then each frame's condition and decode. It
returns the frames and writes no file. Neither has the JAX package's
fallbacks: a kernel that fails raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fourk_nerf_torch.device import fp32_precision, resolve_device
from fourk_nerf_torch.models import dmpigo, dvgo, sr_esrnet
from fourk_nerf_torch.ops import cuda_box, cuda_sr, cuda_sweep, \
    rays as ray_ops
from fourk_nerf_torch.train import trainer
from fourk_nerf_torch.utils import trace


class FramePipeline:
    """Encoder + decoder for one fixed scene and SR network.

    The grid is packed and the SFTNet's weights are packed once, at
    construction; each call renders one frame for a camera. A
    ``dmpigo.Config`` renders through the plane sweep (stepsize 1), a
    ``dvgo.Config`` through the box sweep with ``stepsize`` and ``near``.
    ``fuse_rrdb`` decodes with one launch per RRDB instead of three. An
    SFTNet of another geometry than the kernels' (64 feat, grow 32)
    decodes through its float32 forward, as the JAX package's video loop
    does; that is decided here, from the geometry. The decode runs in full
    float32 (no TF32)."""

    def __init__(self, cfg, params: dict, buffers: dict, sr_model, *,
                 use_bf16: bool = True, fuse_rrdb: bool = False,
                 stepsize: float = 1.0, near: float = 0.0, bg: float = 1.0,
                 device=None):
        self.device = resolve_device(device)
        self.cfg, self.params = cfg, params
        self.fuse_rrdb = fuse_rrdb
        self.stepsize, self.near, self.bg = stepsize, near, bg
        self.bounded = isinstance(cfg, dvgo.Config)
        if not trainer.dense_grids(cfg) or "k0" not in params:
            raise ValueError("the frame's kernels read dense density and k0 "
                             "grids; a model with a TensoRF grid or a "
                             "codebook (DirectQVGO) renders through "
                             "trainer.render_viewpoints (its chunked "
                             "forward)")
        if getattr(cfg, "dim_rend", 3) > 3:
            raise ValueError("the sweep kernel composites 3 channels; a "
                             "DirectMPIGO with dim_rend > 3 (its rend layer) "
                             "renders through trainer.render_viewpoints (its "
                             "chunked forward)")
        if self.bounded:
            self.packed = cuda_box.pack_box_kernel(cfg, params, buffers,
                                                   use_bf16=use_bf16)
        else:
            if not dmpigo.plane_aligned_ok(cfg, stepsize, ndc=True):
                raise ValueError("the 4K frame needs the plane-aligned NDC "
                                 "setup")
            self.packed = cuda_sweep.pack_grids_kernel(params, buffers,
                                                       use_bf16=use_bf16)
        self.sr = cuda_sr.prepare_sftnet(sr_model) \
            if cuda_sr.fits_kernels(sr_model) else sr_model

    @trace.span("encode")
    def encode(self, H: int, W: int, K, c2w) -> dict:
        """The encoder render: ``rgb_feature [H,W,3]``, ``depth [H,W]``,
        ``rgb_marched``, ``alphainv_last``."""
        if self.bounded:
            return cuda_box.render_frame_box_cuda(
                self.cfg, self.params, None, H, W, K, c2w,
                stepsize=self.stepsize, near=self.near, bg=self.bg,
                device=self.device, packed=self.packed)
        return cuda_sweep.render_frame_cuda(
            self.cfg, self.params, None, H, W, K, c2w, stepsize=self.stepsize,
            bg=self.bg, device=self.device, packed=self.packed)

    @trace.span("decode")
    @fp32_precision()
    def decode(self, enc: dict) -> torch.Tensor:
        """The SR decode of an encoder output: ``[1, sH, sW, 3]`` float32
        at the network's scale, conditioned on depth."""
        feat, cond = enc["rgb_feature"][None], enc["depth"][None, ..., None]
        if not isinstance(self.sr, cuda_sr.PreparedSFTNet):
            with torch.no_grad():
                return self.sr(feat, cond)
        return cuda_sr.sftnet_apply_cuda(self.sr, feat, cond,
                                         fuse_rrdb=self.fuse_rrdb,
                                         upchain="dilated")

    @trace.span("frame", root=True)
    def __call__(self, H: int, W: int, K, c2w):
        """One frame: returns (sr ``[1, sH, sW, 3]``, encoder outputs)."""
        enc = self.encode(H, W, K, c2w)
        return self.decode(enc), enc


def sr_condition(num_cond: int, depth, K, c2w, data: trainer.DataFlags,
                 device):
    """The decoder's condition map ``[1, H, W, num_cond]`` of one frame:
    depth (``num_cond`` 1), the viewdir embedding at 10 frequencies (63),
    or both (64)."""
    conds = []
    if num_cond in (1, 64):
        conds.append(depth[None, ..., None])
    if num_cond in (63, 64):
        H, W = depth.shape
        _, _, vd = ray_ops.get_rays_of_a_view(
            H, W, K, c2w, ndc=data.ndc, inverse_y=data.inverse_y,
            flip_x=data.flip_x, flip_y=data.flip_y, device=device)
        conds.append(ray_ops.positional_encoding(vd, 10)[None])
    if not conds:
        raise ValueError(f"num_cond must be 1, 63 or 64, got {num_cond}")
    return torch.cat(conds, dim=-1)


@fp32_precision()
def render_video(model_mod, model_cfg, params, buffers, sr_model,
                 render_poses, HW, Ks, *, data: trainer.DataFlags,
                 render_kwargs: dict, num_cond: int = 1,
                 fuse_rrdb: bool = False, upchain: str = "dilated",
                 test_tile: int = 0,
                 render_factor: int = 0, render_video_flipy: bool = False,
                 render_video_rot90: int = 0, device=None) -> dict:
    """Render a fly-through: the encoder frames of every pose, then per
    frame the condition and the SFTNet decode, clipped to [0, 1].

    ``HW [2]`` and ``Ks [3,3]`` are one camera's, used for every pose.
    ``sr_model`` is an ``SFTNet`` or a ``PreparedSFTNet``. With
    ``test_tile`` > 0 each frame is decoded in tiles of that size by
    ``sr_esrnet.tile_process`` around the float32 ``SFTNet`` forward (the
    memory-bounded decode of ``run_sr.py --test_tile``; it needs the
    module, not a prepared pack); otherwise by the fused decode (its
    ``upchain``, ``"dilated"`` or ``"materialized"``), or, for
    an SFTNet of another geometry than the kernels', by its float32 forward
    (decided up front, as the JAX package's loop decides). The viewdir
    condition (``num_cond`` 63 or 64) is built, as in that loop, from the
    unscaled ``Ks`` with the frame's own (``render_factor``-reduced) size.
    Returns
    ``frames [N, sH, sW, 3]`` (float32, on the device), ``sr_times``
    (seconds per decode, host clock) and the encoder's result dict under
    ``encoder``. Runs in full float32 (no TF32): the float32 decodes
    compute what the checks compare."""
    dev = resolve_device(device)
    n = len(render_poses)
    HW = np.tile(np.asarray(HW)[None], (n, 1))
    Ks = np.tile(np.asarray(Ks, dtype=np.float32)[None], (n, 1, 1))
    res = trainer.render_viewpoints(
        model_mod, model_cfg, params, buffers, render_poses, HW, Ks,
        data=data, render_kwargs=render_kwargs, render_factor=render_factor,
        render_video_flipy=render_video_flipy,
        render_video_rot90=render_video_rot90, verbose=False, device=dev)
    if test_tile:
        if not isinstance(sr_model, sr_esrnet.SFTNet):
            raise ValueError("render_video: the tiled decode (test_tile) runs "
                             "the float32 SFTNet module, got "
                             f"{type(sr_model).__name__}")

        def decode(feat, cond):
            with torch.no_grad():
                return sr_esrnet.tile_process(
                    sr_model, feat, cond, tile_size=test_tile,
                    scale=sr_model.scale)
    elif not cuda_sr.fits_kernels(sr_model):
        def decode(feat, cond):
            with torch.no_grad():
                return sr_model(feat, cond)
    else:
        prep = cuda_sr.prepare_sftnet(sr_model)

        def decode(feat, cond):
            return cuda_sr.sftnet_apply_cuda(prep, feat, cond,
                                             fuse_rrdb=fuse_rrdb,
                                             upchain=upchain)
    K = Ks[0]
    frames, sr_times = [], []
    for fi in range(n):
        c2w = np.asarray(render_poses[fi], dtype=np.float32)[:3, :4]
        cond = sr_condition(num_cond, res["depths"][fi], K, c2w, data, dev)
        t0 = time.perf_counter()
        sr = decode(res["rgb_features"][fi][None], cond)[0]
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sr_times.append(time.perf_counter() - t0)
        frames.append(sr.clamp(0.0, 1.0))
    return {"frames": torch.stack(frames), "sr_times": sr_times,
            "encoder": res}
