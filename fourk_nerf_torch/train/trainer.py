"""Evaluation rendering: full frames of a trained model for a list of
poses, with PSNR / SSIM against ground truth when it is given.

The eval half of the JAX package's ``train/trainer.py``
(``render_viewpoints``) for the two model families the port has. A frame
goes through the family's kernel where the model fits it:
``cuda_sweep.render_frame_cuda`` for a plane-aligned NDC DirectMPIGO,
``cuda_box.render_frame_box_cuda`` for a dense DirectVoxGO with its mask at
grid resolution. With ground truth (published metrics) the kernels run
their float32 path, without it their bf16 path. Any other model takes the
chunked ``forward`` of its module. Which path a model takes is decided from
its configuration before the first frame; a kernel that fails raises, it is
never replaced by another path. The training step is not ported yet.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import dmpigo, dvgo
from fourk_nerf_torch.ops import cuda_box, cuda_sweep, rays as ray_ops
from fourk_nerf_torch.utils import metrics


@dataclasses.dataclass(frozen=True)
class DataFlags:
    """The camera conventions of a dataset (the ``data`` section of the JAX
    package's configs): NDC rays, inverse-y cameras, pixel flips."""

    ndc: bool = False
    inverse_y: bool = False
    flip_x: bool = False
    flip_y: bool = False


def cfg_box_ok(model_cfg) -> bool:
    """True when the bounded-scene sweep can serve this model: dense grids,
    explicit rgb."""
    return (getattr(model_cfg, "density_type", "") == "DenseGrid"
            and getattr(model_cfg, "k0_type", "") == "DenseGrid"
            and not getattr(model_cfg, "rgbnet_full_implicit", False))


def frame_path(model_mod, model_cfg, params, buffers, data: DataFlags,
               stepsize: float) -> str:
    """Which renderer serves this model: ``"sweep"`` (the NDC plane-sweep
    kernel), ``"box"`` (the bounded-scene kernel) or ``"chunked"`` (the
    module's ``forward`` in ray chunks)."""
    if (model_mod is dmpigo and "rgbnet" in params
            and dmpigo.plane_aligned_ok(model_cfg, stepsize, data.ndc)):
        return "sweep"
    if (model_mod is dvgo and cfg_box_ok(model_cfg) and not data.ndc
            and tuple(buffers["mask_cache"].shape)
            == tuple(model_cfg.world_size)):
        return "box"
    return "chunked"


def render_viewpoints(model_mod, model_cfg, params, buffers, render_poses,
                      HW, Ks, *, data: DataFlags, render_kwargs: dict,
                      gt_imgs=None, chunk: int = 8192, eval_ssim: bool = True,
                      render_factor: int = 0,
                      render_video_flipy: bool = False,
                      render_video_rot90: int = 0, verbose: bool = True,
                      device=None) -> dict:
    """Render every pose and, with ``gt_imgs``, score the frames.

    ``model_mod`` is the model's module (``models.dmpigo`` or
    ``models.dvgo``); ``render_kwargs`` holds ``stepsize``, ``bg`` and, for
    bounded scenes, ``near`` and ``far``. ``render_factor`` divides the
    resolution and the intrinsics for previews and skips the metrics;
    ``render_video_flipy`` / ``render_video_rot90`` flip or rotate the
    finished frames. Returns ``rgbs [N,H,W,3]``, ``rgb_features``,
    ``depths [N,H,W]``, ``bgmaps`` as tensors on the device, the per-frame
    ``psnrs`` / ``ssims`` and ``frame_times`` (seconds, host clock), and the
    ``path`` the frames took."""
    dev = resolve_device(device)
    HW = np.asarray(HW)
    Ks = np.asarray(Ks, dtype=np.float32)
    if render_factor:
        HW = (HW.astype(np.float64) / render_factor).astype(int)
        Ks = Ks.copy()
        Ks[:, :2, :3] = Ks[:, :2, :3] / render_factor
        gt_imgs = None  # previews are not scored
    rk = dict(render_kwargs)
    rk.pop("rand_bkgd", None)
    stepsize, bg = rk["stepsize"], rk["bg"]
    flags = dict(inverse_y=data.inverse_y, flip_x=data.flip_x,
                 flip_y=data.flip_y)
    # published metrics are computed in float32; bf16 is the mode of
    # metric-free rendering (videos, previews)
    use_bf16 = gt_imgs is None
    path = frame_path(model_mod, model_cfg, params, buffers, data, stepsize)
    if path == "sweep":
        packed = cuda_sweep.pack_grids_kernel(params, buffers,
                                              use_bf16=use_bf16)
    elif path == "box":
        packed = cuda_box.pack_box_kernel(model_cfg, params, buffers,
                                          use_bf16=use_bf16)

    def chunked_frame(H, W, K_i, c2w):
        ro, rd, vd = (t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
            H, W, K_i, c2w, ndc=data.ndc, device=dev, **flags))
        kw = dict(stepsize=stepsize, bg=bg, render_depth=True)
        if model_mod is dmpigo:
            kw["ndc_planes"] = dmpigo.plane_aligned_ok(model_cfg, stepsize,
                                                       data.ndc)
        else:
            kw.update(near=rk["near"], far=rk["far"])
        outs = [model_mod.forward(model_cfg, params, buffers, ro[s:s + chunk],
                                  rd[s:s + chunk], vd[s:s + chunk], **kw)
                for s in range(0, ro.shape[0], chunk)]
        return {k: torch.cat([o[k] for o in outs]).reshape(
                    H, W, *outs[0][k].shape[1:])
                for k in ("rgb_marched", "rgb_feature", "depth",
                          "alphainv_last")}

    rgbs, feats, depths, bgmaps = [], [], [], []
    psnrs, ssims, frame_times = [], [], []
    for fi, pose in enumerate(render_poses):
        H, W = int(HW[fi][0]), int(HW[fi][1])
        c2w = np.asarray(pose, dtype=np.float32)[:3, :4]
        t0 = time.perf_counter()
        if path == "sweep":
            out = cuda_sweep.render_frame_cuda(
                model_cfg, params, buffers, H, W, Ks[fi], c2w,
                stepsize=stepsize, bg=bg, device=dev, packed=packed, **flags)
        elif path == "box":
            out = cuda_box.render_frame_box_cuda(
                model_cfg, params, buffers, H, W, Ks[fi], c2w,
                stepsize=stepsize, near=rk["near"], bg=bg, device=dev,
                packed=packed, **flags)
        else:
            out = chunked_frame(H, W, Ks[fi], c2w)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        frame_times.append(time.perf_counter() - t0)
        rgbs.append(out["rgb_marched"])
        feats.append(out["rgb_feature"])
        depths.append(out["depth"])
        bgmaps.append(out["alphainv_last"])
        if gt_imgs is not None:
            rgb, gt = out["rgb_marched"].cpu().numpy(), np.asarray(gt_imgs[fi])
            psnrs.append(metrics.psnr(rgb, gt))
            if eval_ssim:
                ssims.append(metrics.rgb_ssim(rgb, gt))
    if verbose and psnrs:
        print(f"render_viewpoints: psnr {np.mean(psnrs):.2f}"
              + (f" ssim {np.mean(ssims):.4f}" if ssims else ""))
    maps = [rgbs, feats, depths, bgmaps]
    if render_video_flipy:
        maps = [[x.flip(0) for x in m] for m in maps]
    if render_video_rot90 != 0:
        k = int(render_video_rot90)
        maps = [[torch.rot90(x, k, (0, 1)) for x in m] for m in maps]
    rgbs, feats, depths, bgmaps = (torch.stack(m) for m in maps)
    return {"rgbs": rgbs, "rgb_features": feats, "depths": depths,
            "bgmaps": bgmaps, "psnrs": psnrs, "ssims": ssims,
            "frame_times": frame_times, "path": path}
