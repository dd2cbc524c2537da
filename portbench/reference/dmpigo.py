"""DirectMPIGO for the reference, as published (frozoul/4K-NeRF
``lib/dmpigo.py``), in plain float32 PyTorch: its grid size, samples,
density on the NDC planes, colour and TV weights. Found by the family
name of a configuration (``family: dmpigo``)."""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import common as C

CHUNK = 8192      # rays a chunk of a whole frame
CORNERS = 4       # grid corners one interpolation reads
RAY_FLOATS = 4    # per-ray floats of the frame's sweep besides the view embedding


def world_size(model: dict) -> tuple:
    """xy from the voxel budget, z = ``mpi_depth``."""
    lo = np.asarray(model["xyz_min"], np.float64)
    hi = np.asarray(model["xyz_max"], np.float64)
    xy = hi[:2] - lo[:2]
    r = math.sqrt(model["num_voxels"] / model["mpi_depth"]
                  / float(np.prod(xy)))
    return (int(xy[0] * r), int(xy[1] * r), int(model["mpi_depth"]))


def rgbnet_in(model: dict) -> int:
    return (3 + 6 * model["viewbase_pe"] + 3 + 6 * model["spatial_pe"]
            + model["rgbnet_dim"])


def n_samples(model: dict, ws) -> int:
    """One sample a plane."""
    return int(ws[2])


def act_shift(mpi_depth: int, voxel_size_ratio: float) -> np.ndarray:
    """Per-plane density bias: every plane starts with equal alpha."""
    g = np.full([mpi_depth], 1.0 / mpi_depth - 1e-6)
    p = [1 - g[0]]
    for i in range(1, len(g)):
        p.append((1 - g[: i + 1].sum()) / (1 - g[:i].sum()))
    return np.array([np.log(pi ** (-1.0 / voxel_size_ratio) - 1.0)
                     for pi in p], dtype=np.float32)


def buffers(model: dict, device) -> dict:
    d = model["mpi_depth"]
    return {"act_shift": torch.as_tensor(
        act_shift(d, 256.0 / d), device=device).reshape(1, 1, d, 1)}


def alpha(model: dict, params: dict, bufs: dict, ro, rd, *, near: float,
          K: int, lo, hi) -> tuple:
    """(normalised points ``[N,K,3]``, valid ``[N,K]``, alpha ``[N,K]``,
    the depth normaliser)."""
    N = ro.shape[0]
    pts = C.ndc_points(ro, rd, K)
    valid = ((pts >= lo) & (pts <= hi)).all(-1)
    valid &= C.nearest_mask(bufs["mask_cache"], pts, lo, hi)
    ind = (pts - lo) / (hi - lo)
    plane = torch.arange(K, device=ro.device)[None, :].expand(N, K)
    dens = C.bilinear_on_planes(params["density"], ind[..., :2].reshape(-1, 2),
                                plane.reshape(-1))[:, 0].reshape(N, K)
    shift = bufs["act_shift"].reshape(1, K)
    interval = model["stepsize"] * 256.0 / model["mpi_depth"]
    return ind, valid, C.raw2alpha(dens + shift, 0.0, interval), K


def colour(model: dict, params: dict, ind, sel, K: int, vd, *, rnd, mm):
    """The rgbnet's colours of the samples ``sel`` (flat indices)."""
    ray, k = sel // K, sel % K
    emb = C.bilinear_on_planes(params["k0"], ind.reshape(-1, 3)[sel, :2], k)
    pe = ind.reshape(-1, 3)[sel].flip(-1) * 2.0 - 1.0
    feat = torch.cat([
        emb, C.positional_encoding(pe, model["spatial_pe"]),
        C.positional_encoding(vd[ray], model["viewbase_pe"])], -1)
    return torch.sigmoid(C.mlp(params["rgbnet"], feat, rnd=rnd, mm=mm))


def tv_weights(model: dict, ws, weight: float, n: int) -> tuple:
    """(wx, wy, wz) of a grid's TV at ``weight`` over ``n`` rays."""
    w = weight / n
    wxy = w * max(ws[:2]) / 128.0
    return wxy, wxy, w * model["mpi_depth"] / 128.0

