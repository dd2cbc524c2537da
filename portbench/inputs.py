"""The benchmark's inputs, made from ``--seed``: configurations and traffic
mixes read by name, the scene's grids and the decoder's weights drawn on
the device, the camera paths and the training views.

One general generator serves every mix: a mix file (``traffic/<mix>.json``)
names its ``kind`` (``render``: frames back to back along a camera path;
``train``: training steps on seeded views) and the parameters of its
path; a configuration file (``configs/<config>.json``) holds the sizes.
Both sides of the comparison (the program and the reference) get the same
tensors from here.
"""

from __future__ import annotations

import importlib
import json
import math
import os

import numpy as np
import torch

from portbench.reference import common as C
from portbench.reference import sftnet

HERE = os.path.dirname(os.path.abspath(__file__))


def _read(kind: str, name: str) -> dict:
    path = os.path.join(HERE, kind, f"{name}.json")
    with open(path) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _read("configs", name)


def traffic(name: str) -> dict:
    return _read("traffic", name)


def generator(seed: int, salt: int, device) -> torch.Generator:
    """A generator on ``device`` for one use of the seed (``salt`` keeps
    the grids, the weights and the noise apart)."""
    s = np.random.SeedSequence((int(seed), int(salt))).generate_state(2)
    g = torch.Generator(device=device)
    g.manual_seed(int(s[0]) << 31 ^ int(s[1]))
    return g


# --- the scene ---------------------------------------------------------------

def _uniform(shape, bound, g, dev):
    return (torch.rand(shape, generator=g, device=dev) * 2 - 1) * bound


def rgbnet(dims, g, dev) -> dict:
    """nn.Linear's init, the last bias zero (the published model's)."""
    p = {}
    for i in range(len(dims) - 1):
        bound = 1.0 / math.sqrt(dims[i])
        p[f"w{i}"] = _uniform((dims[i], dims[i + 1]), bound, g, dev)
        p[f"b{i}"] = (_uniform((dims[i + 1],), bound, g, dev)
                      if i < len(dims) - 2
                      else torch.zeros(dims[i + 1], device=dev))
    return p


def scene(cfg: dict, seed: int, device) -> tuple:
    """(params, buffers) of the configuration's encoder at its published
    size, from the seed: ``density`` and the occupancy ``mask_cache`` from
    the scene's kind (``scenes/<kind>.py``), ``k0`` N(0, ``k0_std``), the
    ``rgbnet``, and the family's own buffers (a DirectMPIGO's per-plane
    ``act_shift``)."""
    fam, m, sc = cfg["family"], cfg["model"], cfg["scene"]
    ws = C.world_size(fam, m)
    g = generator(seed, 1, device)
    kind = importlib.import_module(f"portbench.scenes.{sc['kind']}")
    density, mask = kind.grids(ws, sc, g, device)
    k0 = torch.randn(ws + (m["rgbnet_dim"],), generator=g, device=device) \
        * sc["k0_std"]
    params = {"density": density.contiguous(), "k0": k0,
              "rgbnet": rgbnet(C.rgbnet_dims(fam, m), g, device)}
    buffers = {"mask_cache": mask, **C.family(fam).buffers(m, device)}
    return params, buffers


def decoder(cfg: dict, seed: int, device) -> dict:
    """The SFTNet's raw weights from the seed, in two draws: weights
    normal (a dense-block conv's std 0.1 * sqrt(2 / fan_in), any other
    1 / sqrt(fan_in)), biases uniform in +-0.1."""
    shapes = sftnet.param_shapes(cfg["decoder"])
    g = generator(seed, 2, device)
    ws = {n: s for n, s in shapes.items() if n.endswith(".weight")}
    bs = {n: s for n, s in shapes.items() if n.endswith(".bias")}
    flat_w = torch.randn(sum(math.prod(s) for s in ws.values()), generator=g,
                         device=device)
    flat_b = torch.rand(sum(math.prod(s) for s in bs.values()), generator=g,
                        device=device) * 0.2 - 0.1
    out, o = {}, 0
    for n, s in ws.items():
        fan_in = s[1] * s[2] * s[3]
        std = (0.1 * (2.0 / fan_in) ** 0.5 if sftnet.is_dense_conv(n[:-7])
               else fan_in ** -0.5)
        out[n] = flat_w[o:o + math.prod(s)].reshape(s) * std
        o += math.prod(s)
    o = 0
    for n, s in bs.items():
        out[n] = flat_b[o:o + math.prod(s)].reshape(s)
        o += math.prod(s)
    return {n: out[n] for n in shapes}


# --- cameras -----------------------------------------------------------------

def intrinsics(cam: dict) -> np.ndarray:
    f = cam["focal"]
    return np.array([[f, 0, cam["W"] / 2], [0, f, cam["H"] / 2], [0, 0, 1]],
                    np.float32)


def _normalize(v):
    return v / np.linalg.norm(v)


def _viewmatrix(z, up, pos):
    z = _normalize(z)
    x = _normalize(np.cross(up, z))
    y = _normalize(np.cross(z, x))
    return np.stack([x, y, z, pos], 1)


def spiral_pose(theta: float, p: dict) -> np.ndarray:
    """LLFF's ``render_path_spiral`` around a camera at ``center`` looking
    down -z at a point ``focus`` away (``rads``, ``zrate``)."""
    center = np.asarray(p["center"], np.float64)
    rads = np.asarray(p["rads"], np.float64)
    c = center + np.array([np.cos(theta), -np.sin(theta),
                           -np.sin(theta * p["zrate"])]) * rads
    z = c - (center + np.array([0.0, 0.0, -p["focus"]]))
    return _viewmatrix(z, np.array([0.0, 1.0, 0.0]), c).astype(np.float32)


def spherical_pose(theta_deg: float, phi_deg: float, radius: float):
    """NeRF's ``pose_spherical`` (the Blender loader's render path)."""
    th, ph = np.deg2rad(theta_deg), np.deg2rad(phi_deg)
    t = np.eye(4)
    t[2, 3] = radius
    rphi = np.array([[1, 0, 0, 0], [0, np.cos(ph), -np.sin(ph), 0],
                     [0, np.sin(ph), np.cos(ph), 0], [0, 0, 0, 1]])
    rth = np.array([[np.cos(th), 0, -np.sin(th), 0], [0, 1, 0, 0],
                    [np.sin(th), 0, np.cos(th), 0], [0, 0, 0, 1]])
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    return (flip @ rth @ rphi @ t)[:3, :4].astype(np.float32)


def path(p: dict, seed: int) -> list:
    """The camera path of a render mix: ``n`` poses of the published path,
    starting at an index drawn from the seed (every seed sees the same
    poses, in another order)."""
    n = p["n"]
    if p["path"] == "llff_spiral":
        poses = [spiral_pose(t, p) for t in
                 np.linspace(0.0, 2.0 * np.pi * p["rots"], n + 1)[:-1]]
    elif p["path"] == "blender_orbit":
        poses = [spherical_pose(t, p["phi"], p["radius"]) for t in
                 np.linspace(-180.0, 180.0, n + 1)[:-1]]
    else:
        raise ValueError(f"unknown camera path {p['path']!r}")
    start = int(np.random.default_rng((int(seed), 3)).integers(n))
    return poses[start:] + poses[:start]


def views(p: dict, n: int, seed: int) -> list:
    """``n`` training cameras: evenly spaced on the spiral, or on the upper
    hemisphere of the Blender sphere (a Fibonacci lattice, even in area,
    above ``min_sin``). Every seed gets the same cameras, in an order
    drawn from the seed, so every seed's steps do the same work."""
    if p["path"] == "llff_spiral":
        poses = [spiral_pose(t, p) for t in
                 np.linspace(0, 2.0 * np.pi * p["rots"], n, endpoint=False)]
    elif p["path"] == "blender_hemisphere":
        k = np.arange(n) + 0.5
        z = p["min_sin"] + (1.0 - p["min_sin"]) * k / n
        th = np.rad2deg(np.pi * (3.0 - np.sqrt(5.0)) * k) % 360.0 - 180.0
        poses = [spherical_pose(a, -np.rad2deg(np.arcsin(b)), p["radius"])
                 for a, b in zip(th, z)]
    else:
        raise ValueError(f"unknown view set {p['path']!r}")
    order = np.random.default_rng((int(seed), 4)).permutation(n)
    return [poses[i] for i in order]


def images(n: int, cam: dict, seed: int) -> np.ndarray:
    """Training targets ``[n, H, W, 3]``: uniform noise from the seed, on
    the host, as a loader hands images to the program."""
    rng = np.random.default_rng((int(seed), 5))
    return rng.random((n, cam["H"], cam["W"], 3), dtype=np.float32)


def bkgd_noise(seed: int, step: int, n: int, device) -> torch.Tensor:
    """The random background of training step ``step``: ``[n, 3]``
    uniform noise on the device."""
    g = generator(seed, 1000 + step, device)
    return torch.rand((n, 3), generator=g, device=device)
