"""LLFF forward-facing dataset loader.

The port's copy of the JAX package's ``data/llff.py``, a rebuild of
frozoul/4K-NeRF lib/load_llff.py (the ``:n`` below are its lines): parses
``poses_bounds.npy``, minifies images on demand (``images_{factor}``
directories; ImageMagick if present, OpenCV otherwise), recenters poses,
optionally spherifies, generates a spiral render path, and supports
**dual-resolution SR loading** -- low-res training images from
``images_{factor}`` plus high-res ground truth from ``images_{load_sr}``
(reference :160-178). Also emits per-view w2c rotations for the
pose-conditioned discriminator (reference :222-235).
"""

from __future__ import annotations

import os
import shutil
import subprocess

import numpy as np


def _imread(path):
    import imageio.v2 as imageio  # imported here: only reading images needs it

    return imageio.imread(path)


def _list_images(d):
    exts = (".jpg", ".jpeg", ".png")
    return [
        os.path.join(d, f) for f in sorted(os.listdir(d)) if f.lower().endswith(exts)
    ]


def _minify(basedir, factors=(), resolutions=()):
    """Create images_{r} / images_{WxH} downsampled copies if missing
    (reference :32-81). Uses ImageMagick ``mogrify`` when available, else cv2."""
    todo = []
    for r in factors:
        out = os.path.join(basedir, f"images_{r}")
        if not os.path.exists(out):
            todo.append((out, ("factor", r)))
    for h, w in resolutions:
        out = os.path.join(basedir, f"images_{w}x{h}")
        if not os.path.exists(out):
            todo.append((out, ("res", (w, h))))
    if not todo:
        return

    srcdir = os.path.join(basedir, "images")
    srcs = _list_images(srcdir)
    have_magick = shutil.which("mogrify") is not None

    for out, (kind, spec) in todo:
        print(f"minifying -> {out}")
        os.makedirs(out)
        if have_magick:
            for f in srcs:
                shutil.copy(f, out)
            if kind == "factor":
                resize = f"{100.0 / spec}%"
            else:
                resize = f"{spec[0]}x{spec[1]}"
            ext = os.path.splitext(srcs[0])[1].lstrip(".")
            subprocess.check_output(
                f"mogrify -resize {resize} -format png *.{ext}", shell=True, cwd=out
            )
            if ext.lower() != "png":
                subprocess.check_output(f"rm {out}/*.{ext}", shell=True)
        else:
            import cv2

            for f in srcs:
                img = _imread(f)
                h0, w0 = img.shape[:2]
                if kind == "factor":
                    wh = (int(round(w0 / spec)), int(round(h0 / spec)))
                else:
                    wh = spec
                small = cv2.resize(img, wh, interpolation=cv2.INTER_AREA)
                name = os.path.splitext(os.path.basename(f))[0] + ".png"
                cv2.imwrite(os.path.join(out, name), small[..., ::-1] if small.ndim == 3 else small)


def _read_poses_bounds(basedir):
    arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    if arr.shape[1] == 17:
        poses = arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    elif arr.shape[1] == 14:
        poses = arr[:, :-2].reshape([-1, 3, 4]).transpose([1, 2, 0])
    else:
        raise NotImplementedError(f"poses_bounds row length {arr.shape[1]}")
    bds = arr[:, -2:].transpose([1, 0])
    return poses, bds


def _load_images_and_poses(basedir, factor=None, width=None, height=None, load_sr=0):
    poses, bds = _read_poses_bounds(basedir)

    img0 = _list_images(os.path.join(basedir, "images"))[0]
    sh = _imread(img0).shape

    sfx = ""
    if height is not None and width is not None:
        _minify(basedir, resolutions=[(height, width)])
        sfx = f"_{width}x{height}"
    elif factor is not None and factor != 1:
        _minify(basedir, factors=[factor])
        sfx = f"_{factor}"
    elif height is not None:
        factor = sh[0] / float(height)
        width = int(sh[1] / factor)
        _minify(basedir, resolutions=[(height, width)])
        sfx = f"_{width}x{height}"
    elif width is not None:
        factor = sh[1] / float(width)
        height = int(sh[0] / factor)
        _minify(basedir, resolutions=[(height, width)])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(imgdir)
    imgfiles = _list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        # skip SfM-failed frames recorded in poses_names.npy (reference :128-141)
        names = set(
            os.path.splitext(n)[0]
            for n in np.load(os.path.join(basedir, "poses_names.npy"))
        )
        imgfiles = [
            f for f in imgfiles if os.path.splitext(os.path.basename(f))[0] in names
        ]
    assert len(imgfiles) >= 3, "too few LLFF images"

    sh = _imread(imgfiles[0]).shape
    if poses.shape[1] == 4:
        poses = np.concatenate([poses, np.zeros_like(poses[:, [0]])], 1)
        poses[2, 4, :] = np.load(os.path.join(basedir, "hwf_cxcy.npy"))[2]
    poses[:2, 4, :] = np.array(sh[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor

    imgs = np.stack([_imread(f)[..., :3] / 255.0 for f in imgfiles], -1)

    imgs_sr = None
    if load_sr:
        sr_dir = os.path.join(basedir, "images" if load_sr == 1 else f"images_{load_sr}")
        sr_files = _list_images(sr_dir)
        imgs_sr = np.stack([_imread(f)[..., :3] / 255.0 for f in sr_files], -1)

    return poses, bds, imgs, imgs_sr


# --- pose math (textbook LLFF conventions, reference :195-265) --------------

def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    vec2 = _normalize(z)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], 1)


def poses_avg(poses):
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([_viewmatrix(vec2, up, center), hwf], 1)


def w2c_gen(poses):
    """Per-view world-to-camera rotations for the pose-conditioned
    discriminator (reference :222-235)."""
    out = []
    for pose in poses:
        z = _normalize(pose[:3, 2])
        up = pose[:3, 1]
        vec0 = _normalize(np.cross(up, z))
        vec1 = _normalize(np.cross(z, vec0))
        out.append(np.linalg.inv(np.stack([vec0, vec1, z], 1)))
    return np.stack(out, 0)


def recenter_poses(poses):
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    p44 = np.concatenate([poses[:, :3, :4], bottom], -2)
    p44 = np.linalg.inv(c2w) @ p44
    poses_[:, :3, :4] = p44[:, :3, :4]
    return poses_


def render_path_spiral(c2w, up, rads, focal, zdelta, zrate, rots, N):
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate) * zdelta, 1.0]) * rads,
        )
        z = _normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([_viewmatrix(z, up, c), hwf], 1))
    return render_poses


def spherify_poses(poses, bds, depths):
    """Inward-facing normalization (reference :296-332)."""
    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1
        )

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]

    a_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -a_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(a_i, [0, 2, 1]) @ a_i).mean(0)) @ (b_i).mean(0)
    )

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = _normalize(up)
    vec1 = _normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    radius = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / radius
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    depths = depths * sc
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4], np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)],
        -1,
    )
    return poses_reset, radius * sc, bds, depths


def load_llff_data(basedir, factor=8, width=None, height=None, recenter=True,
                   bd_factor=0.75, spherify=False, path_zflat=False,
                   load_depths=False, load_sr=0, movie_render_kwargs=None):
    """Returns (images [N,H,W,3], depths, poses [N,3,5], bds, render_poses,
    i_test, srgt or None, w2c). srgt layout is NCHW like the reference
    (reference :462-463)."""
    movie_render_kwargs = movie_render_kwargs or {}
    poses, bds, imgs, imgs_sr = _load_images_and_poses(
        basedir, factor=factor, width=width, height=height, load_sr=load_sr
    )
    depths = 0

    # rotation-order fix + view axis to front (reference :352-356)
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    imgs = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    assert bds.min() > 0 or bd_factor is None, "negative SfM depth bounds"
    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds *= sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, _radius, bds, depths = spherify_poses(poses, bds, depths)
        centroid = poses[:, :3, 3].mean(0)
        radcircle = movie_render_kwargs.get("scale_r", 1) * np.linalg.norm(
            poses[:, :3, 3] - centroid, axis=-1
        ).mean()
        centroid[0] += movie_render_kwargs.get("shift_x", 0)
        centroid[1] += movie_render_kwargs.get("shift_y", 0)
        centroid[2] += movie_render_kwargs.get("shift_z", 0)
        target_y = radcircle * np.tan(movie_render_kwargs.get("pitch_deg", 0) * np.pi / 180)
        render_poses = []
        for th in np.linspace(0.0, 2.0 * np.pi, 200):
            camorigin = np.array([radcircle * np.cos(th), 0, radcircle * np.sin(th)])
            up = np.array([0, 1.0, 0]) if movie_render_kwargs.get("flip_up") else np.array([0, -1.0, 0])
            vec2 = _normalize(camorigin)
            vec0 = _normalize(np.cross(vec2, up))
            lookat = -vec2
            lookat[1] = target_y
            lookat = _normalize(lookat)
            vec2 = -lookat
            vec1 = _normalize(np.cross(vec2, vec0))
            render_poses.append(np.stack([vec0, vec1, vec2, camorigin + centroid], 1))
        render_poses = np.stack(render_poses, 0)
        render_poses = np.concatenate(
            [render_poses, np.broadcast_to(poses[0, :3, -1:], render_poses[:, :3, -1:].shape)], -1
        )
    else:
        c2w = poses_avg(poses)
        up = _normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        mean_dz = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
        focal = mean_dz * movie_render_kwargs.get("scale_f", 1)
        zdelta = movie_render_kwargs.get("zdelta", 0.5)
        zrate = movie_render_kwargs.get("zrate", 1.0)
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0) * movie_render_kwargs.get("scale_r", 1)
        c2w_path = c2w
        n_views, n_rots = 120, movie_render_kwargs.get("N_rots", 1)
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            n_rots, n_views = 1, n_views // 2
        render_poses = np.stack(
            render_path_spiral(c2w_path, up, rads, focal, zdelta, zrate=zrate, rots=n_rots, N=n_views),
            0,
        )

    c2w = poses_avg(poses)
    w2c = w2c_gen(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))

    images = imgs.astype(np.float32)
    poses = poses.astype(np.float32)
    if load_sr:
        srgt = np.moveaxis(imgs_sr, [-1, -2], [0, 1]).astype(np.float32)  # NCHW
    else:
        srgt = None
    return images, depths, poses, bds, render_poses.astype(np.float32), i_test, srgt, w2c
