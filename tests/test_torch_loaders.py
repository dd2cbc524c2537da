"""Port parity of the six other dataset loaders (NeRF++, NSVF, BlendedMVS,
Tanks and Temples, DeepVoxels, CO3D) and their branches of ``load_data``:
a tiny scene written to tmp in each one's layout loads to a ``data_dict``
whose every key equals the JAX package's (bitwise: both are the same
numpy code), on white and on black where the branch composites RGBA or
masks."""

import gzip
import json
import os

import numpy as np
import pytest

from fourk_nerf_tpu import config as jconfig
from fourk_nerf_tpu.data import load_data as jload_data
from fourk_nerf_torch import config as tconfig
from fourk_nerf_torch.data import load_data as tload_data
from fourk_nerf_torch.tools import tiny_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")


def _png(path, img):
    import imageio.v2 as imageio

    os.makedirs(os.path.dirname(path), exist_ok=True)
    imageio.imwrite(path, img)


def _txt(path, a):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savetxt(path, np.asarray(a).reshape(-1, 4) if np.size(a) % 4 == 0
               else np.asarray(a))


def _draw(rng, n, h=8, w=10, c=3):
    return rng.integers(0, 256, (n, h, w, c), dtype=np.uint8)


def _poses(n, seed=0):
    """``n`` camera-to-world matrices about the origin, a little jittered
    (so the NeRF++ rerotation has a plane to find)."""
    rng = np.random.default_rng(seed)
    c2w = tiny_scene.bounded_poses(n, 360.0 / n).astype(np.float64)
    c2w[:, :3, 3] += rng.normal(0, 0.05, (n, 3))
    return c2w


def write_nerfpp(root, images, poses, K, i_train, i_test, path_poses=None):
    """A NeRF++ scene: ``{train,test}/{intrinsics,pose,rgb}`` (4x4 text
    matrices, PNGs) and, with ``path_poses``, ``camera_path`` at twice the
    focal length."""
    K4 = np.eye(4)
    K4[:3, :3] = K
    for split, idx in (("train", i_train), ("test", i_test)):
        for j, i in enumerate(idx):
            name = f"{j:05d}"
            _txt(os.path.join(root, split, "intrinsics", name + ".txt"), K4)
            _txt(os.path.join(root, split, "pose", name + ".txt"), poses[i])
            _png(os.path.join(root, split, "rgb", name + ".png"), images[i])
    for j, c2w in enumerate([] if path_poses is None else path_poses):
        K2 = K4.copy()
        K2[0, 0] *= 2
        K2[1, 1] *= 2
        _txt(os.path.join(root, "camera_path", "intrinsics", f"{j:05d}.txt"),
             K2)
        _txt(os.path.join(root, "camera_path", "pose", f"{j:05d}.txt"), c2w)


def _nsvf_layout(root, rng, splits, rgba, k_lines):
    """NSVF's ``pose/`` and ``rgb/<split>_<i>.png``; ``intrinsics.txt``
    holds ``k_lines``."""
    n = len(splits)
    c2w = _poses(n)
    imgs = _draw(rng, n, c=4 if rgba else 3)
    for i, s in enumerate(splits):
        _txt(os.path.join(root, "pose", f"{s}_{i:04d}.txt"), c2w[i])
        _png(os.path.join(root, "rgb", f"{s}_{i:04d}.png"), imgs[i])
    with open(os.path.join(root, "intrinsics.txt"), "w") as f:
        f.write(k_lines)


def _scene(kind, root):
    rng = np.random.default_rng(len(kind))
    cfg = {"dataset_type": kind, "datadir": root}
    if kind == "nerfpp":
        n = 6
        K = np.array([[12.0, 0, 5], [0, 11.0, 4], [0, 0, 1]])
        write_nerfpp(root, _draw(rng, n), _poses(n), K, [0, 1, 2, 4],
                     [3, 5], path_poses=_poses(3, seed=1))
    elif kind == "nsvf":
        _nsvf_layout(root, rng, [0, 0, 1, 0, 2, 0, 2], True,
                     "12.5 5 4 0\n0 0 0\n1\n")
    elif kind in ("blendedmvs", "tankstemple"):
        K = "11 0 5 0\n0 11 4 0\n0 0 1 0\n0 0 0 1\n"
        _nsvf_layout(root, rng, [0, 0, 1, 0, 1, 0], kind == "tankstemple", K)
        if kind == "blendedmvs":
            _txt(os.path.join(root, "test_traj.txt"),
                 _poses(4, seed=2).reshape(-1, 4))
        else:
            cfg["movie_render_kwargs"] = dict(scale_r=1.1, shift_y=0.2,
                                              pitch_deg=15, flip_up_vec=True)
    elif kind == "deepvoxels":
        scene = "cube"
        for split, n in (("train", 3), ("validation", 2), ("test", 2)):
            for i, (img, c2w) in enumerate(zip(_draw(rng, n), _poses(n))):
                _png(os.path.join(root, split, scene, "rgb", f"{i:04d}.png"),
                     img)
                _txt(os.path.join(root, split, scene, "pose", f"{i:04d}.txt"),
                     c2w)
        with open(os.path.join(root, "train", scene, "intrinsics.txt"),
                  "w") as f:
            f.write("100.0 240.0 250.0 0\n0. 0. 0.\n0.\n1.\n480 512\n")
        cfg.update(scene=scene, testskip=1)
    elif kind == "co3d":
        seq, frames, split = "seq_a", [], {"train_known": [],
                                          "test_unseen": []}
        imgs = _draw(rng, 6)
        for i in range(6):
            h, w = imgs[i].shape[:2]
            if i == 5:  # a frame of another size: an object array
                img = _draw(rng, 1, h=6, w=10)[0]
            else:
                img = imgs[i]
            mask = (rng.uniform(size=img.shape[:2]) * 255).astype(np.uint8)
            mask[0, 0] = 255
            if i == 2:
                mask[:] = 10  # under half everywhere: dropped
            _png(os.path.join(root, "images", f"{i}.png"), img)
            _png(os.path.join(root, "masks", f"{i}.png"), mask)
            c2w = _poses(6)[i]
            w2c = np.linalg.inv(np.concatenate([c2w[:3], [[0, 0, 0, 1]]]))
            frames.append({
                "sequence_name": seq,
                "image": {"path": f"images/{i}.png",
                          "size": list(img.shape[:2])},
                "mask": {"path": f"masks/{i}.png", "mass": 0 if i == 4
                         else int(mask.sum())},
                "viewpoint": {"R": w2c[:3, :3].tolist(),
                              "T": w2c[:3, 3].tolist(),
                              "principal_point": [0.05, -0.02],
                              "focal_length": [1.8, 1.9]}})
            split["train_known" if i % 3 else "test_unseen"].append(
                [seq, i, f"images/{i}.png"])
        frames.append(dict(frames[0], sequence_name="seq_b"))
        with gzip.open(os.path.join(root, "annot.json.gz"), "wt") as f:
            json.dump(frames, f)
        with open(os.path.join(root, "split.json"), "w") as f:
            json.dump(split, f)
        cfg.update(annot_path=os.path.join(root, "annot.json.gz"),
                   split_path=os.path.join(root, "split.json"),
                   sequence_name=seq)
    return cfg


def _data_cfg(config_mod, data):
    cfg = config_mod.load_config(os.path.join(
        ROOT, config_mod.__name__.split(".")[0], "configs", "syn",
        "syn_default.py"))
    for k, v in data.items():
        cfg.data[k] = v
    return cfg.data


def _equal(got, want, key):
    if isinstance(want, np.ndarray) and want.dtype == object:
        assert got.dtype == object and len(got) == len(want), key
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=key)
    elif isinstance(want, (list, tuple)) and want and isinstance(
            want[0], np.ndarray):
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=key)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=key)


@pytest.mark.parametrize("kind, white", [
    ("nerfpp", False), ("nsvf", True), ("nsvf", False), ("blendedmvs", False),
    ("tankstemple", True), ("deepvoxels", False), ("co3d", True),
    ("co3d", False)])
def test_loader_matches_jax(tmp_path, kind, white):
    data = _scene(kind, str(tmp_path / kind))
    data["white_bkgd"] = white
    j = jload_data(_data_cfg(jconfig, data))
    t = tload_data(_data_cfg(tconfig, data))
    assert set(t) == set(j)
    for k in j:
        _equal(t[k], j[k], k)
    assert len(t["i_train"]) and len(t["i_test"]) and len(t["images"])
    if kind == "nerfpp":
        # near 0; near_clip and far from the training cameras' spread
        assert t["near"] == 0 and 0 < t["near_clip"] < 0.05 * t["far"]
        assert len(t["render_poses"]) == 3
    if kind == "co3d":
        assert t["images"].dtype == object and len(t["images"]) == 4
