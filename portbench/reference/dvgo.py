"""DirectVoxGO for the reference, as published (frozoul/4K-NeRF
``lib/dvgo.py``), in plain float32 PyTorch: its grid size, samples from
the box entry, density, colour, TV weights and the occupancy hit test of
the ``in_maskcache`` sampler. Found by the family name of a configuration
(``family: dvgo``)."""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import common as C

CHUNK = 4096      # rays a chunk of a whole frame
CORNERS = 8       # grid corners one interpolation reads
RAY_FLOATS = 8    # per-ray floats of the frame's sweep besides the view embedding
HIT_CHUNK = 32768  # rays a chunk of the hit test


def voxels(model: dict, num_voxels=None) -> tuple:
    """Cubic voxels: (world size, voxel size)."""
    lo = np.asarray(model["xyz_min"], np.float64)
    hi = np.asarray(model["xyz_max"], np.float64)
    n = model["num_voxels"] if num_voxels is None else num_voxels
    vs = (np.prod(hi - lo) / n) ** (1.0 / 3.0)
    return tuple(int(w) for w in ((hi - lo) / vs).astype(np.int64)), float(vs)


def world_size(model: dict) -> tuple:
    return voxels(model)[0]


def rgbnet_in(model: dict) -> int:
    k0 = model["rgbnet_dim"] - (0 if model["rgbnet_direct"] else 3)
    return 3 + 3 * model["viewbase_pe"] * 2 + k0


def n_samples(model: dict, ws) -> int:
    """The bound of the box diagonal."""
    return int(torch.linalg.norm(torch.tensor(ws, dtype=torch.float64) + 1)
               / model["stepsize"]) + 1


def act_shift(alpha_init: float) -> float:
    return float(np.log(1.0 / (1.0 - alpha_init) - 1.0))


def buffers(model: dict, device) -> dict:
    return {}


def alpha(model: dict, params: dict, bufs: dict, ro, rd, *, near: float,
          K: int, lo, hi) -> tuple:
    """(normalised points ``[N,K,3]``, valid ``[N,K]``, alpha ``[N,K]``,
    the depth normaliser)."""
    N = ro.shape[0]
    ws = params["density"].shape[:3]
    pts, valid = C.box_points(ro, rd, lo, hi, near,
                              model["stepsize"] * voxels(model)[1], K)
    valid &= C.nearest_mask(bufs["mask_cache"], pts, lo, hi)
    ind = (pts - lo) / (hi - lo)
    flat_valid = valid.reshape(-1).nonzero().squeeze(1)
    dens_v = C.trilinear(params["density"], ind.reshape(-1, 3)[flat_valid])[:, 0]
    dens = torch.zeros(N * K, device=ro.device, dtype=dens_v.dtype) \
        .index_put((flat_valid,), dens_v).reshape(N, K)
    interval = model["stepsize"]  # voxel_size / voxel_size_base = 1
    n_ref = int((max(ws) - 1) / model["stepsize"]) + 1
    return (ind, valid,
            C.raw2alpha(dens, act_shift(model["alpha_init"]), interval), n_ref)


def colour(model: dict, params: dict, ind, sel, K: int, vd, *, rnd, mm):
    """The rgbnet's colours of the samples ``sel`` (flat indices)."""
    ray = sel // K
    emb = C.trilinear(params["k0"], ind.reshape(-1, 3)[sel])
    vde = C.positional_encoding(vd[ray], model["viewbase_pe"])
    direct = model["rgbnet_direct"]
    feat = torch.cat([emb if direct else emb[:, 3:], vde], -1)
    logit = C.mlp(params["rgbnet"], feat, rnd=rnd, mm=mm)
    return torch.sigmoid(logit if direct else logit + emb[:, :3])


def tv_weights(model: dict, ws, weight: float, n: int) -> tuple:
    """(wx, wy, wz) of a grid's TV at ``weight`` over ``n`` rays."""
    w = weight / n * max(ws) / 128.0
    return w, w, w


def hit_rays(model: dict, bufs: dict, ro, rd, near: float):
    """The rays ``[N]`` of which some sample meets the occupancy mask (the
    ``in_maskcache`` sampler's filter)."""
    dev = ro.device
    lo = torch.tensor(model["xyz_min"], device=dev)
    hi = torch.tensor(model["xyz_max"], device=dev)
    ws, vs = voxels(model)
    n = n_samples(model, ws)
    out = []
    for s in range(0, ro.shape[0], HIT_CHUNK):
        p, v = C.box_points(ro[s:s + HIT_CHUNK], rd[s:s + HIT_CHUNK], lo, hi,
                            near, model["stepsize"] * vs, n)
        out.append((v & C.nearest_mask(bufs["mask_cache"], p, lo, hi)).any(-1))
    return torch.cat(out)
