"""Encoder-training losses on dense ``[N, K]`` render outputs.

The terms of the reference's training loop (frozoul/4K-NeRF
run.py:522-545), as the JAX package's ``train/losses.py`` assembles them:
photometric MSE, background entropy, the per-point rgb loss and the
distortion loss. Masked samples carry weight 0, so the dense sums equal the
reference's ragged ones.
"""

from __future__ import annotations

import torch

from fourk_nerf_torch.ops import render


def photometric_mse(rgb_marched, target):
    return ((rgb_marched - target) ** 2).mean()


def entropy_last_loss(alphainv_last):
    """Binary entropy of the background share (run.py:524-527)."""
    pout = alphainv_last.clamp(1e-6, 1 - 1e-6)
    return -(pout * torch.log(pout) + (1 - pout) * torch.log(1 - pout)).mean()


def rgbper(raw_rgb, weights, target, n_rays: int):
    """Per-point colour loss weighted by the detached compositing weights
    (run.py:542-545): raw_rgb ``[N,K,3]``, weights ``[N,K]``, target
    ``[N,3]``."""
    term = ((raw_rgb - target[:, None, :]) ** 2).sum(-1)
    return (term * weights.detach()).sum() / n_rays


def nearclip_loss(raw_density, t, near_thres: float):
    """Zero-valued penalty whose gradient pushes density down nearer than
    ``near_thres`` (run.py:528-534)."""
    d = torch.where(t < near_thres, raw_density, torch.zeros_like(raw_density))
    return (d - d.detach()).sum()


def encoder_losses(result: dict, target, cfg_train, n_rays: int,
                   near_thres=None):
    """(total loss, dict of the terms) of one encoder training step."""
    terms = {}
    loss = cfg_train.weight_main * photometric_mse(result["rgb_marched"],
                                                   target)
    terms["mse"] = loss
    if cfg_train.weight_entropy_last > 0:
        ent = entropy_last_loss(result["alphainv_last"])
        terms["entropy_last"] = ent
        loss = loss + cfg_train.weight_entropy_last * ent
    if getattr(cfg_train, "weight_nearclip", 0) > 0 and near_thres is not None:
        ncl = nearclip_loss(result["raw_density"], result["t"], near_thres)
        terms["nearclip"] = ncl
        loss = loss + cfg_train.weight_nearclip * ncl
    if cfg_train.weight_distortion > 0:
        ld = render.distortion_loss(result["weights"], result["s"],
                                    1.0 / result["n_max"], n_rays)
        terms["distortion"] = ld
        loss = loss + cfg_train.weight_distortion * ld
    if cfg_train.weight_rgbper > 0:
        lr_ = rgbper(result["raw_rgb"], result["weights"], target, n_rays)
        terms["rgbper"] = lr_
        loss = loss + cfg_train.weight_rgbper * lr_
    terms["total"] = loss
    return loss, terms
