"""DeepVoxels dataset loader.

The port's copy of the JAX package's ``data/deepvoxels.py``, after
frozoul/4K-NeRF lib/load_deepvoxels.py: 512x512 views of a scene under
``{train,validation,test}/<scene>/{rgb,pose}`` and the training split's
``intrinsics.txt``; the test poses are the fly-through.
"""

from __future__ import annotations

import os

import numpy as np

from fourk_nerf_torch.data.blender import _imread


def _parse_intrinsics(filepath, trgt_sidelength):
    with open(filepath) as f:
        focal, cx, cy = list(map(float, f.readline().split()))[:3]
        grid_barycenter = np.array(list(map(float, f.readline().split())))
        near_plane = float(f.readline())
        scale = float(f.readline())
        height, width = map(float, f.readline().split())
        try:
            world2cam = bool(int(f.readline()))
        except (ValueError, TypeError):
            world2cam = False
    cx = cx / width * trgt_sidelength
    cy = cy / height * trgt_sidelength
    f_scaled = trgt_sidelength / height * focal
    intrinsic = np.array([[f_scaled, 0.0, cx, 0.0], [0.0, f_scaled, cy, 0],
                          [0.0, 0, 1, 0], [0, 0, 0, 1]])
    return intrinsic, grid_barycenter, scale, near_plane, world2cam


def _dir2poses(posedir):
    def load_pose(fn):
        with open(fn) as f:
            return np.array([float(x) for x in f.read().split()]).reshape(4, 4)

    poses = np.stack([load_pose(os.path.join(posedir, f))
                      for f in sorted(os.listdir(posedir))
                      if f.endswith("txt")], 0)
    transf = np.diag([1.0, -1.0, -1.0, 1.0])
    return (poses @ transf)[:, :3, :4].astype(np.float32)


def load_dv_data(scene="cube", basedir="/data/deepvoxels", testskip=1):
    """(images, poses ``[N, 3, 4]``, the test poses, [512, 512, focal],
    [i_train, i_val, i_test])."""
    H = W = 512
    base = os.path.join(basedir, "train", scene)
    intrinsic, *_ = _parse_intrinsics(os.path.join(base, "intrinsics.txt"),
                                      H)
    focal = intrinsic[0, 0]

    poses = _dir2poses(os.path.join(base, "pose"))
    testposes = _dir2poses(os.path.join(basedir, "test", scene,
                                        "pose"))[::testskip]
    valposes = _dir2poses(os.path.join(basedir, "validation", scene,
                                       "pose"))[::testskip]

    def load_split(d, skip=1):
        files = [f for f in sorted(os.listdir(d)) if f.endswith("png")][::skip]
        return np.stack([_imread(os.path.join(d, f)) / 255.0 for f in files],
                        0).astype(np.float32)

    imgs = load_split(os.path.join(base, "rgb"))
    testimgs = load_split(os.path.join(basedir, "test", scene, "rgb"),
                          testskip)
    valimgs = load_split(os.path.join(basedir, "validation", scene, "rgb"),
                         testskip)

    all_imgs = [imgs, valimgs, testimgs]
    counts = np.cumsum([0] + [x.shape[0] for x in all_imgs])
    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate([poses, valposes, testposes], 0)
    return imgs, poses, testposes, [H, W, focal], i_split
