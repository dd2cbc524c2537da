"""DirectMPIGO: the multiplane-image voxel radiance field of the 4K LLFF
pipeline (torch).

A model is (static :class:`Config`, params dict, buffers dict), as in the
JAX package: params hold ``density [X,Y,Z,1]``, ``k0 [X,Y,Z,C]`` and the
``rgbnet`` dict; buffers hold ``act_shift [1,1,Z,1]`` and the bool
``mask_cache``. Only dense grids are ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import grid_sample, rays as ray_ops, render


@dataclasses.dataclass(frozen=True)
class Config:
    """Static model description."""

    xyz_min: tuple
    xyz_max: tuple
    num_voxels: int
    mpi_depth: int
    world_size: tuple
    mask_cache_world_size: tuple
    voxel_size_ratio: float
    fast_color_thres: float = 0.0
    mask_cache_thres: float = 1e-3
    mask_cache_path: str | None = None
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    rgbnet_dim: int = 0
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 0
    spatial_pe: int = 0
    act_type: str = "relu"
    dim_rend: int = 3
    mode_type: str = "mlp"

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def dim0(self) -> int:
        # voxel features + spatial PE + view PE
        return ((3 + 3 * self.viewbase_pe * 2 + 3 + 3 * self.spatial_pe * 2)
                + self.k0_dim)

    def n_samples(self, stepsize: float) -> int:
        return int((self.mpi_depth - 1) / stepsize) + 1


def make_config(xyz_min, xyz_max, num_voxels, mpi_depth,
                mask_cache_world_size=None, **kwargs) -> Config:
    world_size = common.dmpigo_grid_resolution(xyz_min, xyz_max, num_voxels,
                                               mpi_depth)
    if mask_cache_world_size is None:
        mask_cache_world_size = world_size
    known = {f.name for f in dataclasses.fields(Config)}
    derived = {"xyz_min", "xyz_max", "num_voxels", "mpi_depth", "world_size",
               "mask_cache_world_size", "voxel_size_ratio"}
    extra = {k: v for k, v in kwargs.items() if k in known - derived}
    for gk in ("density_config", "k0_config"):
        if isinstance(extra.get(gk), dict):
            extra[gk] = tuple(sorted(extra[gk].items()))
    return Config(
        xyz_min=tuple(float(v) for v in np.asarray(xyz_min)),
        xyz_max=tuple(float(v) for v in np.asarray(xyz_max)),
        num_voxels=int(num_voxels),
        mpi_depth=int(mpi_depth),
        world_size=tuple(world_size),
        mask_cache_world_size=tuple(int(v) for v in mask_cache_world_size),
        voxel_size_ratio=256.0 / mpi_depth,
        **extra,
    )


def _dense_only(cfg: Config):
    if cfg.density_type != "DenseGrid" or cfg.k0_type != "DenseGrid":
        raise NotImplementedError("the port has dense grids only")
    if cfg.dim_rend > 3:
        raise NotImplementedError("dim_rend > 3 (rend_layer) is not ported")


def init(cfg: Config, *, generator: torch.Generator | None = None,
         device=None):
    """(params, buffers): zero grids, a random rgbnet drawn from
    ``generator`` (seed 0 when None), per-plane act_shift, a full mask."""
    _dense_only(cfg)
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    X, Y, Z = cfg.world_size
    params = {
        "density": torch.zeros((X, Y, Z, 1), device=dev),
        "k0": torch.zeros((X, Y, Z, cfg.k0_dim), device=dev),
    }
    if cfg.rgbnet_dim > 0:
        dims = ([cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1)
                + [cfg.dim_rend])
        params["rgbnet"] = common.mlp_init(dims, generator=generator,
                                           device=dev)
    act_shift = common.mpi_act_shift(cfg.mpi_depth, cfg.voxel_size_ratio)
    buffers = {
        "act_shift": torch.as_tensor(act_shift, device=dev).reshape(
            1, 1, cfg.mpi_depth, 1),
        "mask_cache": torch.ones(cfg.mask_cache_world_size, dtype=torch.bool,
                                 device=dev),
    }
    return params, buffers


def _xyz_minmax(cfg: Config, device):
    return (torch.tensor(cfg.xyz_min, dtype=torch.float32, device=device),
            torch.tensor(cfg.xyz_max, dtype=torch.float32, device=device))


def plane_aligned_ok(cfg: Config, stepsize: float, ndc: bool) -> bool:
    """True when sample k of every NDC ray lies exactly on grid plane k:
    NDC rays, a z-bbox of [-1, 1], stepsize 1 and mpi_depth samples."""
    return (
        ndc
        and stepsize == 1.0
        and cfg.n_samples(stepsize) == cfg.world_size[2]
        and abs(cfg.xyz_min[2] + 1.0) < 1e-6
        and abs(cfg.xyz_max[2] - 1.0) < 1e-6
    )


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, bg: float = 0.0,
            render_depth: bool = False, ndc_planes: bool = False) -> dict:
    """Volume-render N rays densely (eval: no random background).

    ``ndc_planes`` selects the exact plane-aligned bilinear path
    (:func:`plane_aligned_ok`)."""
    _dense_only(cfg)
    N = rays_o.shape[0]
    K = cfg.n_samples(stepsize)
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio
    aligned = ndc_planes and K == cfg.world_size[2]

    pts = render.sample_ndc_pts_on_rays(rays_o, rays_d, K)
    valid = ((pts >= xyz_min) & (pts <= xyz_max)).all(-1)
    valid &= grid_sample.nearest_mask_lookup(buffers["mask_cache"], pts,
                                             xyz_min, xyz_max)

    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
    if aligned:
        density = grid_sample.trilinear_sample_plane_aligned(
            params["density"], ind01[..., :2])[..., 0]
        act_shift = buffers["act_shift"][0, 0, :, 0][None, :]
    else:
        density = grid_sample.trilinear_sample(params["density"], ind01)[..., 0]
        act_shift = grid_sample.trilinear_sample(buffers["act_shift"],
                                                 ind01)[..., 0]
    alpha = render.raw2alpha(density + act_shift, 0.0, interval)
    if cfg.fast_color_thres > 0:
        valid &= alpha > cfg.fast_color_thres

    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))

    if aligned:
        vox_emb = grid_sample.trilinear_sample_plane_aligned(params["k0"],
                                                             ind01[..., :2])
    else:
        vox_emb = grid_sample.trilinear_sample(params["k0"], ind01)
    if cfg.rgbnet_dim <= 0:
        rgb_raw = torch.sigmoid(vox_emb)
    else:
        pe_spa = ind01.flip(-1) * 2.0 - 1.0  # zyx order
        pe_emb = ray_ops.positional_encoding(pe_spa, cfg.spatial_pe)
        vdir_emb = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        rgb_feat = torch.cat([vox_emb, pe_emb, vdir_emb], dim=-1)
        rgb_raw = torch.sigmoid(common.mlp_apply(
            params["rgbnet"], rgb_feat, common.activation(cfg.act_type)))

    rgb_feature = render.composite(weights, rgb_raw)
    rgb_marched = rgb_feature + alphainv_last[:, None] * bg
    s = (torch.arange(K, dtype=rgb_marched.dtype, device=rays_o.device)
         + 0.5) / K
    s = s[None, :].expand(N, K)
    out = {
        "alphainv_last": alphainv_last,
        "weights": weights,
        "rgb_marched": rgb_marched,
        "rgb_feature": rgb_feature,
        "raw_alpha": torch.where(valid, alpha, torch.zeros_like(alpha)),
        "raw_rgb": rgb_raw,
        "n_max": K,
        "s": s,
    }
    if render_depth:
        out["depth"] = render.composite(weights, s)
    return out


_OCC_X_CHUNK = 16  # x-slab of the occupancy query: 16x405x256 points at fern scale


def update_occupancy_cache(cfg: Config, params: dict, buffers: dict) -> dict:
    """AND the occupancy cache with the 3x3x3-dilated alpha of the current
    density (queried WITHOUT act_shift, as the reference does). The query
    runs in x-slabs so the 8-corner temporaries stay small."""
    mask = buffers["mask_cache"]
    dev = mask.device
    xyz_min, xyz_max = _xyz_minmax(cfg, dev)
    axes = [torch.linspace(cfg.xyz_min[d], cfg.xyz_max[d], int(mask.shape[d]),
                           dtype=torch.float32, device=dev) for d in range(3)]
    alpha = torch.empty(mask.shape, dtype=torch.float32, device=dev)
    for x0 in range(0, mask.shape[0], _OCC_X_CHUNK):
        gx, gy, gz = torch.meshgrid(axes[0][x0:x0 + _OCC_X_CHUNK], axes[1],
                                    axes[2], indexing="ij")
        xyz = torch.stack([gx, gy, gz], -1)
        ind01 = grid_sample.world_to_ind01(xyz, xyz_min, xyz_max)
        dens = grid_sample.trilinear_sample(params["density"], ind01)[..., 0]
        alpha[x0:x0 + _OCC_X_CHUNK] = render.raw2alpha(dens, 0.0,
                                                  cfg.voxel_size_ratio)
    alpha = grid_sample.max_pool3d_same(alpha)
    return {**buffers, "mask_cache": mask & (alpha > cfg.fast_color_thres)}
