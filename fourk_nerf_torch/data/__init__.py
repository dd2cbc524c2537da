"""Dataset layer: a loader turns a dataset into one ``data_dict``.

Keys (frozoul/4K-NeRF lib/load_data.py:166-174): hwf, HW, Ks, near, far,
near_clip, i_train / i_val / i_test, poses, render_poses, images, depths,
irregular_shape, srgt (high-resolution SR ground truth), w2c. Numpy only;
the trainer moves what it needs to the device.

The loaders: LLFF forward-facing scenes (``data/llff.py``), Blender
synthetic scenes (``data/blender.py``), NSVF, BlendedMVS, Tanks and
Temples, DeepVoxels, CO3D and the unbounded NeRF++ captures
(``data/nerfpp.py``: ``near`` 0, ``near_clip`` and ``far`` from the
cameras' spread, for DirectContractedVoxGO with ``unbounded_inward``).
Each branch's near / far rule and RGBA or mask compositing are those of
the JAX package's ``data/__init__.py``.
"""

from __future__ import annotations

import numpy as np


def _composite(rgba: np.ndarray, white_bkgd: bool) -> np.ndarray:
    """RGB of an RGBA image on white or on black."""
    rgb, a = rgba[..., :3], rgba[..., -1:]
    return rgb * a + (1.0 - a) if white_bkgd else rgb * a


def load_data(args) -> dict:
    """Load the dataset that ``args`` (a config's ``data`` section) names."""
    K, depths = None, None
    near_clip = None
    srgt_pack = [0, 0]

    if args.dataset_type == "llff":
        from fourk_nerf_torch.data import llff

        images, depths, poses, bds, render_poses, i_test, srgt, w2c = \
            llff.load_llff_data(
                args.datadir, args.factor, args.width, args.height,
                recenter=True, bd_factor=args.bd_factor,
                spherify=args.spherify, load_depths=args.load_depths,
                load_sr=args.load_sr,
                movie_render_kwargs=dict(args.movie_render_kwargs))
        srgt_pack = [srgt, w2c]
        hwf = poses[0, :3, -1]
        poses = poses[:, :3, :4]
        if not isinstance(i_test, (list, np.ndarray)):
            i_test = [i_test]
        if args.llffhold > 0:
            i_test = np.arange(images.shape[0])[:: args.llffhold]
        i_val = [i_test[0]]
        i_train = np.array([i for i in np.arange(int(images.shape[0]))
                            if i not in i_test and i not in i_val])
        if args.ndc:
            near, far = 0.0, 1.0
        else:
            near_clip = max(np.min(bds) * 0.9, 0)
            near = 0
            far = inward_nearfar_heuristic(poses[i_train, :3, 3])[1]
    elif args.dataset_type == "blender":
        from fourk_nerf_torch.data import blender

        images, poses, render_poses, hwf, i_split = blender.load_blender_data(
            args.datadir, args.half_res, args.testskip)
        i_train, i_val, i_test = i_split
        near, far = 2.0, 6.0
        if images.shape[-1] == 4:
            images = _composite(images, args.white_bkgd)
        srgt_pack = [images, 0]
    elif args.dataset_type == "nsvf":
        from fourk_nerf_torch.data import nsvf

        images, poses, render_poses, hwf, i_split = nsvf.load_nsvf_data(
            args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
        if images.shape[-1] == 4:
            images = _composite(images, args.white_bkgd)
    elif args.dataset_type == "blendedmvs":
        from fourk_nerf_torch.data import blendedmvs

        images, poses, render_poses, hwf, K, i_split = \
            blendedmvs.load_blendedmvs_data(args.datadir)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3])
    elif args.dataset_type == "tankstemple":
        from fourk_nerf_torch.data import tankstemple

        images, poses, render_poses, hwf, K, i_split = \
            tankstemple.load_tankstemple_data(
                args.datadir,
                movie_render_kwargs=dict(args.movie_render_kwargs))
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        if images.shape[-1] == 4:
            images = _composite(images, args.white_bkgd)
    elif args.dataset_type == "deepvoxels":
        from fourk_nerf_torch.data import deepvoxels

        images, poses, render_poses, hwf, i_split = deepvoxels.load_dv_data(
            scene=args.get("scene", "greek"), basedir=args.datadir,
            testskip=args.testskip)
        i_train, i_val, i_test = i_split
        hemi_r = float(np.mean(np.linalg.norm(poses[:, :3, -1], axis=-1)))
        near, far = hemi_r - 1, hemi_r + 1
    elif args.dataset_type == "co3d":
        from fourk_nerf_torch.data import co3d

        images, masks, poses, render_poses, hwf, K, i_split = \
            co3d.load_co3d_data(args)
        i_train, i_val, i_test = i_split
        near, far = inward_nearfar_heuristic(poses[i_train, :3, 3], ratio=0)
        for i in range(len(images)):
            m = masks[i][..., None]
            images[i] = (images[i] * m + (1.0 - m) if args.white_bkgd
                         else images[i] * m)
    elif args.dataset_type == "nerfpp":
        from fourk_nerf_torch.data import nerfpp

        images, poses, render_poses, hwf, K, i_split = \
            nerfpp.load_nerfpp_data(args.datadir)
        i_train, i_val, i_test = i_split
        near_clip, far = inward_nearfar_heuristic(poses[i_train, :3, 3],
                                                  ratio=0.02)
        near = 0
    else:
        raise NotImplementedError(f"Unknown dataset type {args.dataset_type}")

    H, W, focal = hwf
    H, W = int(H), int(W)
    hwf = [H, W, focal]
    HW = np.array([im.shape[:2] for im in images])
    irregular_shape = images.dtype is np.dtype("object")

    if K is None:
        K = np.array([[focal, 0, 0.5 * W], [0, focal, 0.5 * H], [0, 0, 1]])
    Ks = K[None].repeat(len(poses), axis=0) if len(K.shape) == 2 else K
    render_poses = render_poses[..., :4]

    srgt, w2c = (srgt_pack[0], srgt_pack[1]) if args.load_sr else (0, 0)

    return dict(
        hwf=hwf, HW=HW, Ks=Ks,
        near=near, far=far, near_clip=near_clip,
        i_train=i_train, i_val=i_val, i_test=i_test,
        poses=poses, render_poses=render_poses,
        images=images, depths=depths,
        irregular_shape=irregular_shape,
        srgt=srgt, w2c=w2c,
    )


def inward_nearfar_heuristic(cam_o: np.ndarray, ratio: float = 0.05):
    """near / far from the spread of the cameras (frozoul/4K-NeRF
    lib/load_data.py:178-184)."""
    dist = np.linalg.norm(cam_o[:, None] - cam_o, axis=-1)
    far = float(dist.max())
    return far * ratio, far
