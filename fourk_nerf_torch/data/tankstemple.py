"""Tanks and Temples dataset loader.

The port's copy of the JAX package's ``data/tankstemple.py``, after
frozoul/4K-NeRF lib/load_tankstemple.py: NSVF's pose / rgb layout with
two splits, ``intrinsics.txt`` a 4x4 matrix, and a generated circular
fly-through about the cameras' centroid (``movie_render_kwargs``:
``scale_r``, ``shift_x/y/z``, ``pitch_deg``, ``flip_up_vec``).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from fourk_nerf_torch.data.blender import _imread


def _normalize(v):
    return v / np.linalg.norm(v)


def load_tankstemple_data(basedir, movie_render_kwargs=None):
    """(images, poses, 200 render poses ``[200, 3, 5]``, [H, W, focal], K,
    [i_train, i_test, i_test])."""
    movie_render_kwargs = movie_render_kwargs or {}
    pose_paths = sorted(glob.glob(os.path.join(basedir, "pose", "*txt")))
    rgb_paths = sorted(glob.glob(os.path.join(basedir, "rgb", "*png")))

    all_poses, all_imgs = [], []
    i_split = [[], []]
    for i, (pose_path, rgb_path) in enumerate(zip(pose_paths, rgb_paths)):
        i_set = int(os.path.basename(rgb_path)[0])
        all_poses.append(np.loadtxt(pose_path).astype(np.float32))
        all_imgs.append((_imread(rgb_path) / 255.0).astype(np.float32))
        i_split[i_set].append(i)

    imgs = np.stack(all_imgs, 0)
    poses = np.stack(all_poses, 0)
    i_split.append(i_split[-1])

    H, W = imgs[0].shape[:2]
    K = np.loadtxt(os.path.join(basedir, "intrinsics.txt"))
    focal = float(K[0, 0])

    # the circular fly-through (lib/load_tankstemple.py:38-70)
    centroid = poses[:, :3, 3].mean(0)
    radcircle = movie_render_kwargs.get("scale_r", 1.0) * np.linalg.norm(
        poses[:, :3, 3] - centroid, axis=-1).mean()
    centroid[0] += movie_render_kwargs.get("shift_x", 0)
    centroid[1] += movie_render_kwargs.get("shift_y", 0)
    centroid[2] += movie_render_kwargs.get("shift_z", 0)
    target_y = radcircle * np.tan(
        movie_render_kwargs.get("pitch_deg", 0) * np.pi / 180)

    render_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 200):
        camorigin = np.array([radcircle * np.cos(th), 0,
                              radcircle * np.sin(th)])
        up = (np.array([0, -1.0, 0]) if movie_render_kwargs.get("flip_up_vec")
              else np.array([0, 1.0, 0]))
        vec2 = _normalize(camorigin)
        vec0 = _normalize(np.cross(vec2, up))
        lookat = -vec2
        lookat[1] = target_y
        lookat = _normalize(lookat) * -1
        vec2 = -lookat
        vec1 = _normalize(np.cross(vec2, vec0))
        render_poses.append(np.stack([vec0, vec1, vec2,
                                      camorigin + centroid], 1))
    render_poses = np.stack(render_poses, 0)
    render_poses = np.concatenate(
        [render_poses, np.broadcast_to(poses[0, :3, -1:],
                                       render_poses[:, :3, -1:].shape)], -1)
    return imgs, poses, render_poses, [H, W, focal], K, i_split
