"""NeRF-synthetic (Blender) dataset loader.

The port's copy of the JAX package's ``data/blender.py``, after
frozoul/4K-NeRF lib/load_blender.py: reads ``transforms_{train,val,test}.json``
and the RGBA PNGs they list (train every frame, val every 50th, test every
``testskip``-th), and makes the spherical render path of the video.
``half_res`` halves the frames by an area mean (OpenCV's ``INTER_AREA``
rule, computed here with numpy so that no image library but the PNG reader
is needed).
"""

from __future__ import annotations

import json
import os

import numpy as np


def _trans_t(t):
    return np.array([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, t], [0, 0, 0, 1]],
                    dtype=np.float32)


def _rot_phi(phi):
    c, s = np.cos(phi), np.sin(phi)
    return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def _rot_theta(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, 0, -s, 0], [0, 1, 0, 0], [s, 0, c, 0], [0, 0, 0, 1]],
                    dtype=np.float32)


def pose_spherical(theta, phi, radius):
    """The camera-to-world matrix of a camera ``radius`` from the origin at
    azimuth ``theta`` and elevation ``phi`` (degrees), looking at the
    origin, in the Blender scenes' axes."""
    c2w = _trans_t(radius)
    c2w = _rot_phi(phi / 180.0 * np.pi) @ c2w
    c2w = _rot_theta(theta / 180.0 * np.pi) @ c2w
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
                    dtype=np.float32)
    return flip @ c2w


def _imread(path):
    import imageio.v2 as imageio  # imported here: only reading images needs it

    return imageio.imread(path)


def _area_matrix(n_in: int, n_out: int) -> np.ndarray:
    """``[n_out, n_in]`` weights of an area-mean resize along one axis:
    output pixel i averages the input interval ``[i s, (i + 1) s)``,
    ``s = n_in / n_out``, each input pixel weighted by its overlap."""
    s = n_in / n_out
    m = np.zeros((n_out, n_in), dtype=np.float64)
    for i in range(n_out):
        lo, hi = i * s, (i + 1) * s
        for j in range(int(np.floor(lo)), min(int(np.ceil(hi)), n_in)):
            m[i, j] = min(hi, j + 1) - max(lo, j)
    return m / s


def area_resize(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Downsize ``[H, W, C]`` to ``[h, w, C]`` by area means (float32)."""
    ry = _area_matrix(img.shape[0], h)
    rx = _area_matrix(img.shape[1], w)
    rows = np.tensordot(ry, img.astype(np.float64), axes=(1, 0))  # [h,W,C]
    out = np.tensordot(rx, rows, axes=(1, 1))                     # [w,h,C]
    return out.transpose(1, 0, 2).astype(np.float32)


def load_blender_data(basedir, half_res=False, testskip=1):
    """(images ``[N, H, W, 4]`` float32 RGBA in [0, 1], poses ``[N, 4, 4]``,
    render_poses ``[160, 4, 4]``, [H, W, focal], [i_train, i_val, i_test])."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        meta = metas[s]
        if s == "train" or testskip == 0:
            skip = 1
        elif s == "val":
            skip = 50  # load_blender.py:53-54 subsamples val hard
        else:
            skip = testskip
        imgs, poses = [], []
        for frame in meta["frames"][::skip]:
            imgs.append(_imread(os.path.join(basedir,
                                             frame["file_path"] + ".png")))
            poses.append(np.array(frame["transform_matrix"]))
        imgs = (np.array(imgs) / 255.0).astype(np.float32)  # RGBA kept
        poses = np.array(poses).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    H, W = imgs[0].shape[:2]
    camera_angle_x = float(metas["test"]["camera_angle_x"])
    focal = 0.5 * W / np.tan(0.5 * camera_angle_x)
    render_poses = np.stack([pose_spherical(angle, -30.0, 4.0) for angle in
                             np.linspace(-180, 180, 161)[:-1]], 0)
    if half_res:
        H, W, focal = H // 2, W // 2, focal / 2.0
        imgs = np.stack([area_resize(img, H, W) for img in imgs])
    return imgs, poses, render_poses, [H, W, focal], i_split
