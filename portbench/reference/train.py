"""The reference's encoder training step, as published (frozoul/4K-NeRF
``run.py:500-565``, ``lib/masked_adam.py``, the TV kernels of
``lib/cuda``), in plain float32 PyTorch: the forward of
:mod:`portbench.reference.field` with autograd, the loss (photometric MSE,
background entropy, distortion, per-point rgb), the TV gradients of the
grids (dense or sparse), and MaskedAdam (entries with a zero gradient left
alone in the masked groups, the bias correction in float32).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common as C
from portbench.reference import field

BETA1, BETA2, EPS = 0.9, 0.99, 1e-8


def loss_of(out: dict, target, tr: dict, n: int):
    """The step's total loss from a forward's outputs."""
    loss = tr["weight_main"] * ((out["rgb_marched"] - target) ** 2).mean()
    if tr["weight_entropy_last"] > 0:
        p = out["alphainv_last"].clamp(1e-6, 1 - 1e-6)
        ent = -(p * torch.log(p) + (1 - p) * torch.log(1 - p)).mean()
        loss = loss + tr["weight_entropy_last"] * ent
    if tr["weight_distortion"] > 0:
        w, s = out["weights"], out["s"]
        ws = w * s
        wp = torch.cumsum(w, -1) - w
        wsp = torch.cumsum(ws, -1) - ws
        bi = 2.0 * w * (s * wp - wsp)
        uni = (1.0 / 3.0) * (1.0 / out["n_max"]) * w ** 2
        loss = loss + tr["weight_distortion"] * (bi.sum() + uni.sum()) / n
    if tr["weight_rgbper"] > 0:
        K = out["weights"].shape[1]
        ray = out["sel"] // K
        w = out["weights"].reshape(-1)[out["sel"]].detach()
        term = ((out["rgb_w"] - target[ray]) ** 2).sum(-1)
        loss = loss + tr["weight_rgbper"] * (term * w).sum() / n
    return loss


def tv_grad(grid, wx, wy, wz, sparse_grad=None):
    """Gradient of the clamped total variation of ``grid [X,Y,Z,C]``: per
    axis ``w/6 * (clip(g_i - g_{i+1}) + clip(g_i - g_{i-1}))``; ``wx``
    weighs the Z axis, ``wz`` the X axis. With ``sparse_grad``, voxels
    whose gradient is zero get none."""
    tv = torch.zeros_like(grid)
    for axis, w in ((2, wx / 6.0), (1, wy / 6.0), (0, wz / 6.0)):
        n = grid.shape[axis]
        if n < 2:
            continue
        d = (grid.narrow(axis, 0, n - 1) - grid.narrow(axis, 1, n - 1))
        d = d.clamp(-1.0, 1.0) * w
        tv.narrow(axis, 0, n - 1).add_(d)
        tv.narrow(axis, 1, n - 1).sub_(d)
    if sparse_grad is not None:
        tv = torch.where(sparse_grad == 0, torch.zeros_like(tv), tv)
    return tv


def bias_correction(step: int) -> float:
    t, one = np.float32(step), np.float32(1.0)
    return float(np.sqrt(one - np.float32(BETA2) ** t)
                 / (one - np.float32(BETA1) ** t))


def leaves(tree: dict, prefix: str = ""):
    """(dotted name, tensor) of every leaf."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def adam_init(params: dict) -> dict:
    return {"m": {n: torch.zeros_like(t) for n, t in leaves(params)},
            "v": {n: torch.zeros_like(t) for n, t in leaves(params)},
            "step": 0}


@torch.no_grad()
def adam_step(params: dict, grads: dict, opt: dict, lrs: dict,
              masked: set) -> None:
    """MaskedAdam over the leaves, in place; ``lrs`` by top-level group."""
    opt["step"] += 1
    bc = bias_correction(opt["step"])
    for name, p in leaves(params):
        group = name.split(".")[0]
        if group not in lrs:
            continue
        g = grads[name]
        size = float(np.float32(lrs[group]) * np.float32(bc))
        m, v = opt["m"][name], opt["v"][name]
        m_new = BETA1 * m + (1.0 - BETA1) * g
        v_new = BETA2 * v + (1.0 - BETA2) * g * g
        delta = size * m_new / (v_new.sqrt() + EPS)
        if group in masked:
            nz = g != 0
            delta = torch.where(nz, delta, torch.zeros_like(delta))
            m_new = torch.where(nz, m_new, m)
            v_new = torch.where(nz, v_new, v)
        p.sub_(delta)
        m.copy_(m_new)
        v.copy_(v_new)


def step(family: str, model: dict, tr: dict, params: dict, buffers: dict,
         opt: dict, batch, lrs: dict, *, bg, near: float, apply_tv: bool,
         tv_dense: bool, mm=C.matmul):
    """One training step on ``batch = (rays_o, rays_d, viewdirs, rgb)``;
    updates ``params`` and ``opt`` in place. Returns (loss, the gradients
    as the optimizer gets them by leaf name, the forward's counts)."""
    ro, rd, vd, target = batch
    n = ro.shape[0]
    names = [nm for nm, _ in leaves(params)]
    live = {nm: t.detach().requires_grad_(True) for nm, t in leaves(params)}
    p_live = {"density": live["density"], "k0": live["k0"],
              "rgbnet": {nm.split(".", 1)[1]: t for nm, t in live.items()
                         if nm.startswith("rgbnet.")}}
    out = field.forward(family, model, p_live, buffers, ro, rd, vd, bg=bg,
                        near=near, mm=mm)
    loss = loss_of(out, target, tr, n)
    gs = torch.autograd.grad(loss, [live[nm] for nm in names],
                             allow_unused=True)
    grads = {nm: torch.zeros_like(live[nm]) if g is None else g
             for nm, g in zip(names, gs)}
    if apply_tv:
        ws = params["density"].shape[:3]
        for grp, wkey in (("density", "weight_tv_density"),
                          ("k0", "weight_tv_k0")):
            if tr[wkey] > 0:
                wx, wy, wz = C.family(family).tv_weights(model, ws, tr[wkey],
                                                         n)
                grads[grp] = grads[grp] + tv_grad(
                    params[grp].detach(), wx, wy, wz,
                    None if tv_dense else grads[grp])
    adam_step(params, grads, opt, lrs, set(tr["skip_zero_grad_fields"]))
    counts = {"valid": out["valid"], "weighted": out["weighted"]}
    return float(loss.detach()), grads, counts


def group_lr(lr0: float, steps_since_reset: int, lrate_decay: float) -> float:
    return lr0 * (0.1 ** (1.0 / (lrate_decay * 1000.0))) ** steps_since_reset
