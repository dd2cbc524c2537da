"""Port parity of the Blender loader (``fourk_nerf_torch/data/blender.py``
and the ``blender`` branch of ``data.load_data``) against the JAX
package's, on a tiny scene written to tmp: three ``transforms_*.json`` and
RGBA PNGs (imageio).

Tolerances: every key of ``load_data`` equal (arrays exactly; the
images composited on white or on black are the same float32 operations);
the ``half_res`` area mean within 1e-6 of OpenCV's ``INTER_AREA`` (float64
weights here, OpenCV's own order of float32 sums there) and of the JAX
loader's images; ``pose_spherical`` exactly."""

import json
import os

import numpy as np
import pytest

from fourk_nerf_tpu.config import ConfigDict
from fourk_nerf_tpu.data import blender as jblender, load_data as jload
from fourk_nerf_torch.data import blender as tblender, load_data as tload

#: views per split: val keeps every 50th, so it needs more than 50 frames
#: to keep two
SPLITS = {"train": 3, "val": 52, "test": 5}


def _write_scene(root, h, w, seed=0):
    import imageio.v2 as imageio

    rng = np.random.default_rng(seed)
    for split, n in SPLITS.items():
        os.makedirs(os.path.join(root, split), exist_ok=True)
        frames = []
        for i in range(n):
            img = rng.integers(0, 256, (h, w, 4), dtype=np.uint8)
            img[0, 0, 3] = 0      # a transparent and an opaque pixel
            img[0, 1, 3] = 255
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"), img)
            c2w = tblender.pose_spherical(37.0 * i, -30.0 - 5.0 * (i % 3),
                                          4.0)
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618,
                       "frames": frames}, f)


@pytest.fixture(scope="module")
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("blender"))
    _write_scene(root, 8, 8)
    return root


def _args(datadir, **kw):
    base = dict(dataset_type="blender", datadir=datadir, half_res=False,
                testskip=1, white_bkgd=True, load_sr=0, inverse_y=False,
                flip_x=False, flip_y=False)
    return ConfigDict({**base, **kw})


def _assert_same(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(w, (list, tuple)) and not isinstance(w, np.ndarray):
            assert len(g) == len(w), k
            for a, b in zip(g, w):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=k)
        elif w is None or isinstance(w, (bool, int, float)):
            assert g == w, k
        else:
            assert np.asarray(g).dtype == np.asarray(w).dtype, k
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                          err_msg=k)


@pytest.mark.parametrize("white_bkgd,testskip,load_sr", [
    (True, 1, 0), (False, 1, 0), (True, 2, 1), (False, 0, 1)])
def test_load_data_matches_jax(scene_dir, white_bkgd, testskip, load_sr):
    kw = dict(white_bkgd=white_bkgd, testskip=testskip, load_sr=load_sr)
    want = jload(_args(scene_dir, **kw))
    got = tload(_args(scene_dir, **kw))
    _assert_same(got, want)
    n_test = len(range(0, SPLITS["test"], max(testskip, 1)))
    n_val = SPLITS["val"] if testskip == 0 else 2
    assert [len(got[k]) for k in ("i_train", "i_val", "i_test")] == \
        [SPLITS["train"], n_val, n_test]
    assert (got["near"], got["far"]) == (2.0, 6.0)
    img = got["images"][0]
    assert img.shape == (8, 8, 3) and img.dtype == np.float32
    # the transparent pixel is the background, the opaque one its colour
    np.testing.assert_allclose(img[0, 0], 1.0 if white_bkgd else 0.0)
    if load_sr:
        np.testing.assert_array_equal(got["srgt"], got["images"])
    assert got["w2c"] == 0


def test_half_res_matches_cv2_and_jax(tmp_path):
    import cv2

    root = str(tmp_path / "odd")
    _write_scene(root, 10, 14, seed=1)
    rng = np.random.default_rng(2)
    for h, w in ((10, 14), (9, 13), (800, 800)):
        img = rng.uniform(0, 1, (h, w, 4)).astype(np.float32)
        ref = cv2.resize(img, (w // 2, h // 2), interpolation=cv2.INTER_AREA)
        got = tblender.area_resize(img, h // 2, w // 2)
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
    want = jblender.load_blender_data(root, half_res=True)
    got = tblender.load_blender_data(root, half_res=True)
    np.testing.assert_allclose(got[0], want[0], atol=1e-6, rtol=0)
    assert got[0].shape == (len(got[1]), 5, 7, 4)
    for a, b in zip(got[1:], want[1:]):
        if isinstance(b, list):
            assert [np.asarray(x).tolist() for x in a] == \
                [np.asarray(x).tolist() for x in b]
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("theta,phi,radius", [
    (0.0, -30.0, 4.0), (-180.0, -30.0, 4.0), (123.4, -75.0, 2.5),
    (15.0, 10.0, 4.0)])
def test_pose_spherical_matches_jax(theta, phi, radius):
    got = tblender.pose_spherical(theta, phi, radius)
    want = jblender.pose_spherical(theta, phi, radius)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # a camera `radius` from the origin looking at it (-z forward)
    np.testing.assert_allclose(np.linalg.norm(got[:3, 3]), radius, rtol=1e-6)
    np.testing.assert_allclose(-got[:3, 2], -got[:3, 3] / radius, atol=1e-6)
