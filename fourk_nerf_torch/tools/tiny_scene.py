"""Tiny scenes and the configs cut to their size, for the CPU tests of
the trainers and the card's CPU-vs-CUDA checks.

:func:`scene` builds an LLFF-shaped ``data_dict`` in memory from a seed
(smooth colour fields seen by NDC cameras shifted a few hundredths in x
and y); :data:`OVERRIDES` and :func:`apply_overrides` cut a loaded config
(of this package or of the JAX package: the same keys) to that scene.
:func:`sr_scene` adds the x4 ground truth of the joint trainer, and
:data:`JOINT_OVERRIDES` cuts ``configs/llff/fern_lg_joint_l1.py`` to it.
:func:`bounded_scene` is a Blender-shaped bounded scene (a density blob
seen from a sphere of cameras, :func:`bounded_poses`) and
:data:`BOUNDED_OVERRIDES` cuts ``configs/syn/syn_default.py`` to it.
:func:`unbounded_scene` is a 360-degree inward-facing one (the same blob
on black before an environment that depends on the ray direction,
:func:`environment`, with the NeRF++ loader's near / far rule);
:data:`UNBOUNDED_OVERRIDES` turns ``configs/syn/syn_default.py`` into an
unbounded (DirectContractedVoxGO) config and :data:`UNBOUNDED_TINY` cuts
it to the tiny scene.
"""

from __future__ import annotations

import numpy as np

H, W, FOCAL = 24, 32, 30.0
N_VIEWS = 6
LLFFHOLD = 4  # views 0 and 4 are held out; i_val = [0]

#: section -> key -> value, set over ``configs/llff/fern_lg_pretrain.py``
OVERRIDES = {
    "data": {"rand_bkgd": False},
    "fine_train": {"N_iters": 10, "N_rand": 128, "pg_scale": [5],
                   "tv_dense_before": 4},
    "fine_model_and_render": {"num_voxels": 16 * 16 * 8, "mpi_depth": 8,
                              "rgbnet_width": 16,
                              "fast_color_thres": 1.0 / 8 / 5},
}


def apply_overrides(cfg, basedir: str, expname: str = "tiny",
                    overrides: dict = OVERRIDES):
    """Set ``overrides`` (and the run directory) on a loaded config."""
    cfg.basedir = basedir
    cfg.expname = expname
    for section, kv in overrides.items():
        for k, v in kv.items():
            cfg[section][k] = v
    return cfg


def poses(n: int = N_VIEWS) -> np.ndarray:
    """``[n, 3, 4]`` camera-to-world: the identity rotation at z = 1,
    shifted by up to 0.04 in x and 0.03 in y."""
    out = np.zeros((n, 3, 4), np.float32)
    for i in range(n):
        out[i, :, :3] = np.eye(3)
        out[i, :, 3] = (0.08 * (i / max(n - 1, 1) - 0.5),
                        0.03 * np.cos(i), 1.0)
    return out


def scene(seed: int = 0, n_views: int = N_VIEWS) -> dict:
    """The ``data_dict`` of the LLFF loader for the tiny scene."""
    rng = np.random.default_rng(seed)
    c2w = poses(n_views)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W),
                         indexing="ij")
    freq = rng.uniform(1.0, 4.0, (3, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    images = []
    for v in range(n_views):
        shift = c2w[v, 0, 3]
        img = [0.5 + 0.4 * np.sin(2 * np.pi * (freq[c, 0] * (xx + shift)
                                               + freq[c, 1] * yy) + phase[c])
               for c in range(3)]
        images.append(np.stack(img, -1).astype(np.float32))
    images = np.stack(images)
    i_test = np.arange(n_views)[::LLFFHOLD]
    i_val = [i_test[0]]
    i_train = np.array([i for i in range(n_views)
                        if i not in i_test and i not in i_val])
    K = np.array([[FOCAL, 0, 0.5 * W], [0, FOCAL, 0.5 * H], [0, 0, 1]])
    return dict(
        hwf=[H, W, FOCAL], HW=np.array([[H, W]] * n_views),
        Ks=K[None].repeat(n_views, 0), near=0.0, far=1.0, near_clip=None,
        i_train=i_train, i_val=i_val, i_test=i_test, poses=c2w,
        render_poses=c2w.copy(), images=images, irregular_shape=False)


#: section -> key -> value, set over ``configs/llff/fern_lg_joint_l1.py``
#: for :func:`sr_scene`: a 64x64x16 grid, 8-pixel patches, TV through step
#: 4, the published SFTNet (the trainer fixes its width and depth)
JOINT_OVERRIDES = {
    "data": {"rand_bkgd": False, "load_sr": 1, "factor": 4},
    "fine_train": {"N_iters": 6, "N_patch": 8, "pg_scale": [],
                   "tv_before": 5, "weight_tv_density": 1e-4,
                   "weight_tv_k0": 1e-5},
    "fine_model_and_render": {"num_voxels": 64 * 64 * 16, "mpi_depth": 16,
                              "rgbnet_dim": 6, "rgbnet_width": 16,
                              "fast_color_thres": 1.0 / 16 / 5},
}
#: the scene box of :func:`sr_scene` (xyz_min, xyz_max)
SR_BOX = ([-2.0, -2.0, -1.0], [2.0, 2.0, 1.0])


def sr_scene(seed: int = 0, n_views: int = 3, h: int = 32,
             w: int = 32) -> dict:
    """An LLFF-shaped ``data_dict`` for the joint trainer: ``n_views``
    views of smooth colour fields seen by NDC cameras a few hundredths
    apart in x, the last held out; ``srgt`` the x4 fields (NCHW, as the
    LLFF loader gives it) and ``images`` their 4x4 means."""
    rng = np.random.default_rng(seed)
    f = 40.0
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    c2w = np.zeros((n_views, 3, 4), np.float32)
    for i, dx in enumerate(np.linspace(-0.05, 0.05, n_views)):
        c2w[i, :, :3] = np.eye(3)
        c2w[i, :, 3] = (dx, 0.0, 1.0)
    yy, xx = np.meshgrid(np.linspace(0, 1, 4 * h), np.linspace(0, 1, 4 * w),
                         indexing="ij")
    freq = rng.uniform(1.0, 4.0, (3, 2))
    phase = rng.uniform(0, 2 * np.pi, 3)
    hr = np.stack([np.stack(
        [0.5 + 0.4 * np.sin(2 * np.pi * (freq[c, 0] * (xx + c2w[v, 0, 3])
                                         + freq[c, 1] * yy) + phase[c])
         for c in range(3)], -1) for v in range(n_views)]).astype(np.float32)
    lr = hr.reshape(n_views, h, 4, w, 4, 3).mean((2, 4))
    return dict(hwf=[h, w, f], HW=np.array([[h, w]] * n_views),
                Ks=np.stack([K] * n_views), near=0.0, far=1.0,
                near_clip=None, i_train=np.arange(n_views - 1),
                i_val=[n_views - 1], i_test=np.array([n_views - 1]),
                poses=c2w, render_poses=c2w.copy(), images=lr,
                irregular_shape=False, srgt=np.moveaxis(hr, -1, 1).copy(),
                w2c=np.stack([np.eye(3, dtype=np.float32)] * n_views))


#: section -> key -> value, set over ``configs/syn/syn_default.py`` for
#: :func:`bounded_scene`: coarse 60 steps on a 12^3 grid (per-voxel lr,
#: a learnable alpha_init), fine 40 steps on 16^3 with one grid doubling
#: at step 20 (``in_maskcache``), a 16-wide rgbnet
BOUNDED_OVERRIDES = {
    "coarse_train": {"N_iters": 60, "N_rand": 256, "pervoxel_lr": True,
                     "pg_scale": []},
    "fine_train": {"N_iters": 40, "N_rand": 256, "pg_scale": [20],
                   "ray_sampler": "in_maskcache"},
    "coarse_model_and_render": {"num_voxels": 12 ** 3,
                                "num_voxels_base": 12 ** 3,
                                "alpha_init": 1e-2},
    "fine_model_and_render": {"num_voxels": 16 ** 3,
                              "num_voxels_base": 16 ** 3, "rgbnet_dim": 6,
                              "rgbnet_width": 16, "world_bound_scale": 1.05},
}
#: the field of view of the published Blender scenes (``nerf_synthetic``'s
#: ``camera_angle_x``)
CAMERA_ANGLE_X = 0.6911112070083618


def blender_focal(w: int) -> float:
    """The focal length of a ``w``-pixel-wide Blender frame."""
    return float(0.5 * w / np.tan(0.5 * CAMERA_ANGLE_X))


def bounded_poses(n: int, step: float = 15.0) -> np.ndarray:
    """``[n, 4, 4]`` camera-to-world of the Blender scenes' sphere: radius
    4, azimuth ``step`` degrees apart, elevation -30, -40 or -50
    degrees."""
    from fourk_nerf_torch.data.blender import pose_spherical
    return np.stack([pose_spherical(step * i, -30.0 - 10.0 * (i % 3), 4.0)
                     for i in range(n)]).astype(np.float32)


def bounded_teacher(device="cpu"):
    """(cfg, params, buffers) of a DirectVoxGO that the bounded scene's
    views are rendered from: a 16^3 grid over [-1.5, 1.5]^3 holding a
    Gaussian density blob coloured by its radius, no rgbnet."""
    import torch

    from fourk_nerf_torch.models import dvgo
    cfg = dvgo.make_config(xyz_min=[-1.5] * 3, xyz_max=[1.5] * 3,
                           num_voxels=16 ** 3, num_voxels_base=16 ** 3,
                           alpha_init=1e-2, rgbnet_dim=0,
                           fast_color_thres=1e-4)
    params, buffers = dvgo.init(cfg, device=device)
    X, Y, Z = cfg.world_size
    g = np.stack(np.meshgrid(np.linspace(-1.5, 1.5, X),
                             np.linspace(-1.5, 1.5, Y),
                             np.linspace(-1.5, 1.5, Z), indexing="ij"), -1)
    r2 = np.sum(g ** 2, -1)
    dens = 20.0 * np.exp(-r2 / 0.3) - 2.0
    k0 = np.stack([2.0 - 4.0 * r2, 4.0 * g[..., 2], -2.0 + 4.0 * r2], -1)
    params["density"] = torch.as_tensor(dens[..., None].astype(np.float32),
                                        device=device)
    params["k0"] = torch.as_tensor(k0.astype(np.float32), device=device)
    return cfg, params, buffers


def bounded_scene(h: int = 16, w: int = 16, n_train: int = 6,
                  n_val: int = 1, n_test: int = 2) -> dict:
    """The ``data_dict`` of the Blender loader (white background, near 2,
    far 6, ``srgt`` the images) for views of :func:`bounded_teacher` at
    :func:`bounded_poses`, rendered on the CPU by ``dvgo.forward``."""
    import torch

    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    n = n_train + n_val + n_test
    c2w = bounded_poses(n, 360.0 / n)
    i_split = interleaved_split(n, n_val, n_test)
    f = blender_focal(w)
    K = np.array([[f, 0, 0.5 * w], [0, f, 0.5 * h], [0, 0, 1]])
    cfg, params, buffers = bounded_teacher()
    images = []
    for v in range(n):
        ro, rd, vd = (t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
            h, w, K, c2w[v], ndc=False, inverse_y=False, flip_x=False,
            flip_y=False, device="cpu"))
        with torch.no_grad():
            out = dvgo.forward(cfg, params, buffers, ro, rd, vd, stepsize=0.5,
                               near=2.0, far=6.0, bg=1.0)
        images.append(out["rgb_marched"].clamp(0, 1).reshape(h, w, 3).numpy())
    images = np.stack(images).astype(np.float32)
    i_split = np.split(np.arange(n), [n_train, n_train + n_val])
    return dict(hwf=[h, w, f], HW=np.array([[h, w]] * n),
                Ks=K[None].repeat(n, 0), near=2.0, far=6.0, near_clip=None,
                i_train=i_split[0], i_val=i_split[1], i_test=i_split[2],
                poses=c2w, render_poses=c2w.copy(), images=images,
                irregular_shape=False, srgt=images, w2c=0)


#: section -> key -> value, set over ``configs/syn/syn_default.py`` to make
#: it an unbounded inward-facing config (DirectContractedVoxGO): no coarse
#: stage, the ``flatten`` sampler, no per-voxel lr, the near-clip and
#: distortion losses, no near-camera mask-out
UNBOUNDED_OVERRIDES = {
    "data": {"unbounded_inward": True, "unbounded_inner_r": 1.0},
    "coarse_train": {"N_iters": 0},
    "fine_train": {"ray_sampler": "flatten", "pervoxel_lr": False,
                   "weight_nearclip": 0.01, "weight_distortion": 0.01},
    "fine_model_and_render": {"maskout_near_cam_vox": False},
}
#: set after :data:`UNBOUNDED_OVERRIDES` for :func:`unbounded_scene`: 30
#: steps of 256 rays on a 16^3 grid that doubles at step 15, a 16-wide
#: rgbnet on 6 features
UNBOUNDED_TINY = {
    "fine_train": {"N_iters": 30, "N_rand": 256, "pg_scale": [15]},
    "fine_model_and_render": {"num_voxels": 16 ** 3,
                              "num_voxels_base": 16 ** 3, "rgbnet_dim": 6,
                              "rgbnet_width": 16},
}


def environment(viewdirs):
    """``[..., 3]`` colour of the far surroundings seen along the unit
    directions ``viewdirs [..., 3]`` (numpy): smooth in the direction, in
    [0.1, 0.9]."""
    v = np.asarray(viewdirs, dtype=np.float32)
    return (0.5 + 0.4 * np.sin(np.stack([2.0 * v[..., 0] + 1.0 * v[..., 2],
                                         3.0 * v[..., 1] - 1.0,
                                         2.5 * v[..., 2] + v[..., 0]],
                                        -1))).astype(np.float32)


def interleaved_split(n: int, n_val: int, n_test: int):
    """[i_train, i_val, i_test] of ``n`` views around a circle, the held-out
    ones spread evenly between training ones."""
    k = n_val + n_test
    held = (np.arange(k) * n) // k + n // (2 * k)
    return [np.setdiff1d(np.arange(n), held), held[:n_val], held[n_val:]]


def unbounded_scene(h: int = 16, w: int = 16, n_train: int = 6,
                    n_val: int = 1, n_test: int = 2) -> dict:
    """The ``data_dict`` of the NeRF++ loader for views of
    :func:`bounded_teacher` from :func:`bounded_poses` spread around the
    whole circle (held out: :func:`interleaved_split`), rendered on black
    on
    the CPU by ``dvgo.forward``, plus the background share of each pixel
    times :func:`environment` of its direction; ``near`` 0 and
    ``near_clip``, ``far`` from the spread of the training cameras
    (``inward_nearfar_heuristic(..., ratio=0.02)``)."""
    import torch

    from fourk_nerf_torch.data import inward_nearfar_heuristic
    from fourk_nerf_torch.models import dvgo
    from fourk_nerf_torch.ops import rays as ray_ops
    n = n_train + n_val + n_test
    c2w = bounded_poses(n, 360.0 / n)
    i_split = interleaved_split(n, n_val, n_test)
    f = blender_focal(w)
    K = np.array([[f, 0, 0.5 * w], [0, f, 0.5 * h], [0, 0, 1]])
    cfg, params, buffers = bounded_teacher()
    images = []
    for v in range(n):
        ro, rd, vd = (t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
            h, w, K, c2w[v], ndc=False, inverse_y=False, flip_x=False,
            flip_y=False, device="cpu"))
        with torch.no_grad():
            out = dvgo.forward(cfg, params, buffers, ro, rd, vd, stepsize=0.5,
                               near=0.2, far=1e9, bg=0.0)
        rgb = (out["rgb_marched"].numpy() + out["alphainv_last"].numpy()
               [:, None] * environment(vd.numpy()))
        images.append(np.clip(rgb, 0, 1).reshape(h, w, 3))
    images = np.stack(images).astype(np.float32)
    near_clip, far = inward_nearfar_heuristic(c2w[i_split[0], :3, 3],
                                              ratio=0.02)
    return dict(hwf=[h, w, f], HW=np.array([[h, w]] * n),
                Ks=K[None].repeat(n, 0), near=0, far=far,
                near_clip=near_clip, i_train=i_split[0], i_val=i_split[1],
                i_test=i_split[2], poses=c2w, render_poses=c2w.copy(),
                images=images, irregular_shape=False)
