"""CO3D dataset loader.

The port's copy of the JAX package's ``data/co3d.py``, after
frozoul/4K-NeRF lib/load_co3d.py: the frames of one sequence
(``cfg.sequence_name``) from the gzipped frame annotations
(``cfg.annot_path``) split by ``cfg.split_path`` ("known" frames train),
frames with an empty mask dropped, each frame's NDC-style intrinsics
turned into a pixel-space K; frames of different sizes come as an object
array.
"""

from __future__ import annotations

import gzip
import json
import os

import numpy as np

from fourk_nerf_torch.data.blender import _imread


def load_co3d_data(cfg):
    """(images, masks, poses ``[N, 4, 4]``, render_poses (the test poses),
    [H, W, focal] (means), Ks ``[N, 3, 3]``, [i_train, i_test, i_test])."""
    with gzip.open(cfg.annot_path, "rt", encoding="utf8") as zf:
        annot = [v for v in json.load(zf)
                 if v["sequence_name"] == cfg.sequence_name]
    with open(cfg.split_path) as f:
        split = json.load(f)
    train_im, test_im = set(), set()
    for k, lst in split.items():
        for v in lst:
            if v[0] == cfg.sequence_name:
                (train_im if "known" in k else test_im).add(v[-1])
    assert len(annot) == len(train_im) + len(test_im)

    imgs, masks, poses, Ks = [], [], [], []
    i_split = [[], []]
    dropped = [0, 0]
    for meta in annot:
        fname = meta["image"]["path"]
        sid = 0 if fname in train_im else 1
        if meta["mask"]["mass"] == 0:
            dropped[sid] += 1
            continue
        mask = _imread(os.path.join(cfg.datadir, meta["mask"]["path"])) / 255.0
        if mask.max() < 0.5:
            dropped[sid] += 1
            continue
        rt = np.concatenate([meta["viewpoint"]["R"],
                             np.array(meta["viewpoint"]["T"])[:, None]], 1)
        pose = np.linalg.inv(np.concatenate([rt, [[0, 0, 0, 1]]]))
        imgs.append(_imread(os.path.join(cfg.datadir, fname)) / 255.0)
        masks.append(mask)
        poses.append(pose)
        half_wh = np.float32(meta["image"]["size"][::-1]) * 0.5
        pp = np.float32(meta["viewpoint"]["principal_point"])
        fl = np.float32(meta["viewpoint"]["focal_length"])
        pp_px = -1.0 * (pp - 1.0) * half_wh
        fl_px = fl * half_wh
        Ks.append(np.array([[fl_px[0], 0, pp_px[0]], [0, fl_px[1], pp_px[1]],
                            [0, 0, 1]]))
        i_split[sid].append(len(imgs) - 1)

    if sum(dropped):
        print(f"load_co3d_data: dropped {dropped[0]} train / {dropped[1]} "
              "test (empty masks)")

    imgs = (np.array(imgs, dtype=object) if len({im.shape for im in imgs}) > 1
            else np.array(imgs))
    masks = (np.array(masks, dtype=object) if len({m.shape for m in masks}) > 1
             else np.array(masks))
    poses = np.stack(poses, 0)
    Ks = np.stack(Ks, 0)
    render_poses = poses[i_split[-1]]
    i_split.append(i_split[-1])
    H, W = np.array([im.shape[:2] for im in imgs]).mean(0).astype(int)
    focal = Ks[:, [0, 1], [0, 1]].mean()
    return imgs, masks, poses, render_poses, [H, W, focal], Ks, i_split
