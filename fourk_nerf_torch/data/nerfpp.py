"""NeRF++ (unbounded 360-degree) dataset loader.

The port's copy of the JAX package's ``data/nerfpp.py``, after
frozoul/4K-NeRF lib/load_nerfpp.py. Layout: ``{train,test}/intrinsics``,
``pose`` (4x4 camera-to-world, OpenCV axes) and ``rgb``, and an optional
``camera_path/{intrinsics,pose}`` fly-through (else the test poses).
``rerotate`` turns the cameras' plane to face y-up (the smallest
principal axis of the camera centres).
"""

from __future__ import annotations

import glob
import os

import numpy as np

from fourk_nerf_torch.data.blender import _imread


def _find(d, exts):
    if not os.path.isdir(d):
        return []
    files = []
    for e in exts:
        files.extend(glob.glob(os.path.join(d, e)))
    return sorted(files)


def _load_split(split_dir):
    return (_find(os.path.join(split_dir, "intrinsics"), ["*.txt"]),
            _find(os.path.join(split_dir, "pose"), ["*.txt"]),
            _find(os.path.join(split_dir, "rgb"), ["*.png", "*.jpg"]))


def rerotate_poses(poses, render_poses):
    """Rotate the cameras and the render path about the centroid of the
    camera centres so that the normal of their plane (the eigenvector of
    the smallest eigenvalue of their covariance, pointing to +y) becomes
    -y."""
    import scipy.spatial.transform

    poses = np.copy(poses)
    centroid = poses[:, :3, 3].mean(0)
    poses[:, :3, 3] -= centroid
    x = poses[:, :3, 3]
    cov = np.cov((x - x.mean(0)).T)
    ev, eig = np.linalg.eig(cov)
    cams_up = eig[:, np.argmin(ev)]
    if cams_up[1] < 0:
        cams_up = -cams_up
    R = scipy.spatial.transform.Rotation.align_vectors(
        [[0, -1, 0]], cams_up[None])[0].as_matrix()
    poses[:, :3, :3] = R @ poses[:, :3, :3]
    poses[:, :3, [3]] = R @ poses[:, :3, [3]]
    poses[:, :3, 3] += centroid
    render_poses = np.copy(render_poses)
    render_poses[:, :3, 3] -= centroid
    render_poses[:, :3, :3] = R @ render_poses[:, :3, :3]
    render_poses[:, :3, [3]] = R @ render_poses[:, :3, [3]]
    render_poses[:, :3, 3] += centroid
    return poses, render_poses


def load_nerfpp_data(basedir, rerotate=True):
    """(images ``[N, H, W, C]`` float32 in [0, 1], poses ``[N, 4, 4]``,
    render_poses, [H, W, focal], K ``[3, 3]`` of the first training view,
    [i_train, i_test, i_test])."""
    tr_K, tr_c2w, tr_im = _load_split(os.path.join(basedir, "train"))
    te_K, te_c2w, te_im = _load_split(os.path.join(basedir, "test"))

    i_split = [list(range(len(tr_c2w))),
               list(range(len(tr_c2w), len(tr_c2w) + len(te_c2w)))]

    K = np.loadtxt(tr_K[0]).reshape(4, 4)[:3, :3]
    poses = np.stack([np.loadtxt(p).reshape(4, 4) for p in tr_c2w + te_c2w],
                     0)
    imgs = np.stack([_imread(p) / 255.0 for p in tr_im + te_im], 0)
    i_split.append(i_split[1])
    H, W = imgs.shape[1:3]
    focal = K[[0, 1], [0, 1]].mean()

    rp_files = sorted(glob.glob(os.path.join(basedir, "camera_path", "pose",
                                             "*txt")))
    render_poses = np.array([np.loadtxt(p).reshape(4, 4) for p in rp_files])
    rk_files = glob.glob(os.path.join(basedir, "camera_path", "intrinsics",
                                      "*txt"))
    if len(render_poses) and rk_files:
        render_K = np.loadtxt(rk_files[0]).reshape(4, 4)[:3, :3]
        render_poses[:, :, 0] *= K[0, 0] / render_K[0, 0]
        render_poses[:, :, 1] *= K[1, 1] / render_K[1, 1]
    if len(render_poses) == 0:
        render_poses = poses[i_split[1]]
    if rerotate:
        poses, render_poses = rerotate_poses(poses, render_poses)

    return (imgs.astype(np.float32), poses.astype(np.float32),
            render_poses.astype(np.float32), [H, W, focal], K, i_split)
