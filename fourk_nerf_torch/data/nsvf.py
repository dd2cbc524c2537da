"""NSVF-format dataset loader.

The port's copy of the JAX package's ``data/nsvf.py``, after
frozoul/4K-NeRF lib/load_nsvf.py. Layout: ``pose/*.txt`` 4x4
camera-to-world matrices, ``rgb/*.png`` whose file name starts with the
split digit (0 train, 1 val, 2 test), ``intrinsics.txt`` whose first
number is the focal length.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from fourk_nerf_torch.data.blender import pose_spherical
from fourk_nerf_torch.data.blender import _imread


def _pose_spherical_nsvf(theta, phi, radius):
    c2w = pose_spherical(theta, phi, radius).copy()
    c2w[:, [1, 2]] *= -1  # the NSVF camera axes
    return c2w


def load_nsvf_data(basedir):
    """(images ``[N, H, W, C]`` float32, poses ``[N, 4, 4]``, 200 render
    poses on the cameras' mean radius at -30 degrees, [H, W, focal],
    [i_train, i_val, i_test])."""
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))

    all_poses, all_imgs = [], []
    i_split = [[], [], []]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.basename(rgb_path)[0])
        all_imgs.append((_imread(rgb_path) / 255.0).astype(np.float32))
        all_poses.append(np.loadtxt(pose_path).astype(np.float32))
        i_split[i_set].append(i)

    imgs = np.stack(all_imgs, 0)
    poses = np.stack(all_poses, 0)
    H, W = imgs[0].shape[:2]
    with open(os.path.join(basedir, "intrinsics.txt")) as f:
        focal = float(f.readline().split()[0])

    radius = float(np.sqrt((poses[..., :3, 3] ** 2).sum(-1)).mean())
    render_poses = np.stack([_pose_spherical_nsvf(a, -30.0, radius)
                             for a in np.linspace(-180, 180, 201)[:-1]], 0)
    return imgs, poses, render_poses, [H, W, focal], i_split
