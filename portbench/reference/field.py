"""The reference's radiance field, as published (frozoul/4K-NeRF
``lib/dmpigo.py``, ``lib/dvgo.py``), in plain float32 PyTorch: the
compositing common to every family, with each family's samples, density
and colour from its module (``reference/<family>.py``).

:func:`forward` renders a batch of rays with autograd (training) or
without (frames). The rgbnet runs only on the samples with a non-zero
weight: the colour of any other sample enters the composite and the
per-point loss multiplied by a zero weight, so the outputs and gradients
are those of the dense forward. :func:`render_frame` renders a whole
frame in ray chunks.
"""

from __future__ import annotations

import torch

from portbench.reference import common as C


def _lohi(model: dict, dev):
    return (torch.tensor(model["xyz_min"], dtype=torch.float32, device=dev),
            torch.tensor(model["xyz_max"], dtype=torch.float32, device=dev))


def forward(family: str, model: dict, params: dict, buffers: dict, ro, rd,
            vd, *, bg, near: float = 0.0, rnd=C.identity,
            mm=C.matmul) -> dict:
    """Render rays ``ro, rd, vd [N, 3]``; ``bg`` a float or ``[N, 3]``;
    ``near`` clips a bounded scene's rays. ``rnd`` rounds the rgbnet's
    operands (the grids come rounded, if at all, from the caller).

    Returns ``rgb_marched``, ``rgb_feature [N,3]``, ``depth``,
    ``alphainv_last [N]``, the dense ``weights [N,K]`` and ``s [N,K]``,
    ``n_max``, the colours ``rgb_w`` of the weighted samples ``sel``
    (flat indices into ``[N*K]``), and the counts ``valid`` and
    ``weighted``."""
    fam = C.family(family)
    dev = ro.device
    K = fam.n_samples(model, params["density"].shape[:3])
    N = ro.shape[0]
    lo, hi = _lohi(model, dev)
    thres = model["fast_color_thres"]
    ind, valid, alpha, n_ref = fam.alpha(model, params, buffers, ro, rd,
                                         near=near, K=K, lo=lo, hi=hi)
    if thres > 0:
        valid = valid & (alpha > thres)
    weights, ail = C.alpha2weight(alpha, valid)
    if thres > 0:
        weights = torch.where(weights > thres, weights,
                              torch.zeros_like(weights))

    sel = (weights.detach().reshape(-1) > 0).nonzero().squeeze(1)
    ray = sel // K
    rgb_w = fam.colour(model, params, ind, sel, K, vd, rnd=rnd, mm=mm)
    w_sel = weights.reshape(-1)[sel]
    rgb_feature = torch.zeros((N, 3), device=dev, dtype=rgb_w.dtype) \
        .index_add(0, ray, w_sel[:, None] * rgb_w)
    s = ((torch.arange(K, dtype=torch.float32, device=dev) + 0.5)
         / n_ref)[None, :].expand(N, K)
    depth = (weights * s).sum(-1)
    bg_t = (bg if isinstance(bg, torch.Tensor)
            else torch.full_like(rgb_feature, bg))
    return {"rgb_marched": rgb_feature + ail[:, None] * bg_t,
            "rgb_feature": rgb_feature, "depth": depth, "alphainv_last": ail,
            "weights": weights, "s": s, "n_max": n_ref, "rgb_w": rgb_w,
            "sel": sel, "valid": int(valid.sum()),
            "weighted": int(sel.numel())}


@torch.no_grad()
def render_frame(family: str, model: dict, cam: dict, params: dict,
                 buffers: dict, K, c2w, *, bg: float, rnd=C.identity) -> dict:
    """A whole frame in ray chunks: ``rgb_feature [H,W,3]``, ``depth
    [H,W]``, and the samples ``valid`` and ``weighted`` counted."""
    dev = params["density"].device
    params = {**params, "density": rnd(params["density"]),
              "k0": rnd(params["k0"])}
    ro, rd, vd = C.view_rays(cam, K, c2w, dev)
    feats, depths, nv, nw = [], [], 0, 0
    step = C.family(family).CHUNK
    for s in range(0, ro.shape[0], step):
        out = forward(family, model, params, buffers, ro[s:s + step],
                      rd[s:s + step], vd[s:s + step], bg=bg,
                      near=cam.get("near", 0.0), rnd=rnd)
        feats.append(out["rgb_feature"])
        depths.append(out["depth"])
        nv += out["valid"]
        nw += out["weighted"]
    H, W = cam["H"], cam["W"]
    return {"rgb_feature": torch.cat(feats).reshape(H, W, 3),
            "depth": torch.cat(depths).reshape(H, W), "valid": nv,
            "weighted": nw}
