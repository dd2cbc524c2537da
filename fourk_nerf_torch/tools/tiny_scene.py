"""A tiny forward-facing scene and the fern pretrain config cut to its size,
for the CPU tests of the trainer and the card's CPU-vs-CUDA check.

:func:`scene` builds an LLFF-shaped ``data_dict`` in memory from a seed
(smooth colour fields seen by NDC cameras shifted a few hundredths in x
and y); :data:`OVERRIDES` and :func:`apply_overrides` cut a loaded config
(of this package or of the JAX package: the same keys) to that scene.
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
