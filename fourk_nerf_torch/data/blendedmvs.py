"""BlendedMVS dataset loader.

The port's copy of the JAX package's ``data/blendedmvs.py``, after
frozoul/4K-NeRF lib/load_blendedmvs.py: NSVF's pose / rgb layout with two
splits (the test split is also the val split), ``intrinsics.txt`` a 4x4
matrix and ``test_traj.txt`` the fly-through.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from fourk_nerf_torch.data.blender import _imread


def load_blendedmvs_data(basedir):
    """(images, poses, render_poses, [H, W, focal], K, [i_train, i_test,
    i_test])."""
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))

    all_poses, all_imgs = [], []
    i_split = [[], []]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.basename(rgb_path)[0])
        all_imgs.append((_imread(rgb_path) / 255.0).astype(np.float32))
        all_poses.append(np.loadtxt(pose_path).astype(np.float32))
        i_split[i_set].append(i)

    imgs = np.stack(all_imgs, 0)
    poses = np.stack(all_poses, 0)
    i_split.append(i_split[-1])

    H, W = imgs[0].shape[:2]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    focal = float(K[0, 0])
    render_poses = np.loadtxt(os.path.join(basedir, "test_traj.txt")) \
        .reshape(-1, 4, 4).astype(np.float32)
    return imgs, poses, render_poses, [H, W, focal], K, i_split
