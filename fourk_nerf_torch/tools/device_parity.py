"""The secondary models on two devices: tiny DirectBiVoxGO and TensoRF
scenes whose forward and training-loss gradients are computed from the
same CPU params on the card and on the CPU, for the card tests
(``tests/test_torch_gpu.py``) and chip_smoke.py phase 18 (c). A CUDA
tensor divided by a Python number is multiplied by its reciprocal, an ulp
off the CPU's division; where that moves a sample across a grid plane or a
mask voxel, the two devices part by more than rounding, and these
comparisons show it."""

from __future__ import annotations

import numpy as np
import torch

#: the training loss the gradients are taken of
TRAIN = dict(weight_main=1.0, weight_entropy_last=0.01, weight_nearclip=0,
             weight_distortion=0.01, weight_rgbper=0.01)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


def _on(tree, dev, grad=False):
    if isinstance(tree, dict):
        return {k: _on(v, dev, grad) for k, v in tree.items()}
    t = tree.detach().to(dev)
    return t.requires_grad_(True) if grad and t.is_floating_point() else t


def compare(devices, forward, params, buffers, rays, keys) -> dict:
    """``forward(params, buffers, rays_o, rays_d, viewdirs)`` on each of
    the two ``devices`` from the same CPU params, then the gradients of
    its training loss (:data:`TRAIN`) against a fixed target. Returns the
    outputs ``keys`` of the first device (on the CPU), ``out_diff`` (the
    largest absolute difference of each output) and ``grad_rel`` (each
    leaf's largest gradient difference over its largest entry on the first
    device)."""
    from fourk_nerf_torch.config import ConfigDict
    from fourk_nerf_torch.train import losses
    target = torch.as_tensor(np.random.default_rng(3).uniform(
        0, 1, (rays[0].shape[0], 3)).astype(np.float32))
    res = []
    for dev in devices:
        p = _on(params, dev, grad=True)
        out = forward(p, _on(buffers, dev), *(r.to(dev) for r in rays))
        loss, _ = losses.encoder_losses(out, target.to(dev),
                                        ConfigDict(TRAIN), rays[0].shape[0])
        grads = torch.autograd.grad(loss, _leaves(p))
        res.append(({k: out[k].detach().cpu() for k in keys},
                    [g.cpu() for g in grads]))
    (o_a, g_a), (o_b, g_b) = res
    return {"outputs": o_a,
            "out_diff": {k: float((o_a[k] - o_b[k]).abs().max())
                         for k in keys},
            "grad_rel": [float((a - b).abs().max() / a.abs().max())
                         for a, b in zip(g_a, g_b)]}


def dbvgo_case():
    """A 10^3-voxel DirectBiVoxGO (both fields, the background on its own
    90% mask) and the rays of a 16x16 view from the Blender sphere:
    (forward, params, buffers, rays, keys)."""
    from fourk_nerf_torch.models import dbvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    from fourk_nerf_torch.tools import tiny_scene

    f = tiny_scene.blender_focal(16)
    K = np.array([[f, 0, 8.0], [0, f, 8.0], [0, 0, 1]], np.float32)
    rays = [t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
        16, 16, K, tiny_scene.bounded_poses(2)[1][:3, :4], ndc=False,
        inverse_y=False, flip_x=False, flip_y=False, device="cpu")]
    cfg = dbvgo.make_config(
        xyz_min=[-1.5, -1.4, -1.6], xyz_max=[1.5, 1.6, 1.4],
        num_voxels=10 ** 3, num_voxels_base=10 ** 3, alpha_init=1e-2,
        rgbnet_dim=4, rgbnet_width=16, viewbase_pe=2, fast_color_thres=1e-4)
    params, buffers = dbvgo.init(cfg, generator=torch.Generator()
                                 .manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    for fl in ("fg", "bg"):
        for k, mu in (("density", -1.0), ("k0", 0.0)):
            params[fl][k] = torch.as_tensor(rng.normal(
                mu, 2 if k == "density" else 1,
                params[fl][k].shape).astype(np.float32))
    buffers["mask_cache_bg"] = torch.as_tensor(
        rng.uniform(size=buffers["mask_cache_bg"].shape) < 0.9)

    def forward(p, b, ro, rd, vd):
        return dbvgo.forward(cfg, p, b, ro, rd, vd, stepsize=0.5, bg=1.0,
                             render_depth=True)

    return forward, params, buffers, rays, ("rgb_marched", "alphainv_last",
                                            "depth", "alphainv_last_bg")


def dbvgo_bg_samples(device, ns=(40, 100, 255)) -> float:
    """The largest difference between DirectBiVoxGO's background samples
    ``t_max - 1 + 1 / (1 - k/K)`` on ``device`` and on the CPU, for the
    rays of :func:`dbvgo_case` and each count ``K`` in ``ns``."""
    from fourk_nerf_torch.models import dbvgo
    from fourk_nerf_torch.ops import render
    _, _, _, rays, _ = dbvgo_case()
    o = rays[0] / 1.5
    d = rays[1] / rays[1].norm(dim=-1, keepdim=True)
    _, t_max = render.ray_aabb(o, d, -torch.ones(3), torch.ones(3), 0.0,
                               2 * np.sqrt(3))
    dev = torch.device(device)
    return max(float((dbvgo.sample_bg_pts(o, d, t_max, 0.5, n)
                      - dbvgo.sample_bg_pts(o.to(dev), d.to(dev),
                                            t_max.to(dev), 0.5, n).cpu())
                     .abs().max()) for n in ns)


def tensorf_case(family: str):
    """A TensoRF DirectMPIGO (``family`` "dmpigo": NDC rays, 12x12x8,
    ranks 4 / 6) or DirectVoxGO ("dvgo": 12^3) and 64 rays of the tiny
    scene's second view: (forward, params, buffers, rays, keys)."""
    from fourk_nerf_torch.models import dmpigo, dvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    from fourk_nerf_torch.tools import tiny_scene

    grids = dict(density_type="TensoRFGrid", k0_type="TensoRFGrid",
                 density_config={"n_comp": 4}, k0_config={"n_comp": 6})
    data = tiny_scene.scene(0)
    ndc = family == "dmpigo"
    rays = [t.reshape(-1, 3)[::3][:64] for t in ray_ops.get_rays_of_a_view(
        24, 32, data["Ks"][1], data["poses"][1], ndc=ndc, inverse_y=False,
        flip_x=False, flip_y=False, device="cpu")]
    if ndc:
        mod = dmpigo
        cfg = mod.make_config(xyz_min=[-1.3, -1.2, -1.0],
                              xyz_max=[1.3, 1.2, 1.0], num_voxels=12 * 12 * 8,
                              mpi_depth=8, rgbnet_dim=6, rgbnet_width=16,
                              fast_color_thres=1.0 / 40, **grids)
        fkw = dict(stepsize=1.0, bg=0.5, ndc_planes=True)
    else:
        mod = dvgo
        cfg = mod.make_config(xyz_min=[-0.6, -0.5, -0.4],
                              xyz_max=[0.5, 0.6, 0.7], num_voxels=12 ** 3,
                              num_voxels_base=12 ** 3, alpha_init=1e-2,
                              rgbnet_dim=6, rgbnet_width=16,
                              fast_color_thres=1e-4, **grids)
        fkw = dict(stepsize=0.5, near=0.2, far=3.0, bg=1.0)
    params, buffers = mod.init(cfg, generator=torch.Generator()
                               .manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    for g in ("density", "k0"):
        params[g] = {k: torch.as_tensor(rng.normal(0, 0.5, v.shape).astype(
            np.float32)) for k, v in params[g].items()}
    params["density"]["xy_plane"] += 1.0

    def forward(p, b, ro, rd, vd):
        return mod.forward(cfg, p, b, ro, rd, vd, render_depth=True,
                           is_train=True, **fkw)

    return forward, params, buffers, rays, ("rgb_marched", "alphainv_last",
                                            "depth")
