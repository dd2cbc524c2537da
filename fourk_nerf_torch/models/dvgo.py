"""DirectVoxGO: the dense-grid radiance field of bounded inward-facing
scenes (torch), eval side.

A model is (static :class:`Config`, params dict, buffers dict), as in the
JAX package: params hold ``density [X,Y,Z,1]``, ``k0 [X,Y,Z,C]`` and, with
``rgbnet_dim > 0``, the ``rgbnet`` dict; buffers hold the bool
``mask_cache``. Every ray gets a static sample count K (the bbox-diagonal
bound); samples past a ray's own count or outside the box carry alpha 0.
Only dense grids are ported; grid scaling, the near-camera mask-out, the
view counts and the TV gradients belong to the trainer.
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
    num_voxels_base: int
    world_size: tuple
    mask_cache_world_size: tuple
    voxel_size: float
    voxel_size_base: float
    alpha_init: float
    fast_color_thres: float = 0.0
    mask_cache_thres: float = 1e-3
    mask_cache_path: str | None = None
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    rgbnet_dim: int = 0
    rgbnet_direct: bool = False
    rgbnet_full_implicit: bool = False
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4
    act_type: str = "relu"
    dim_rend: int = 3
    mode_type: str = "mlp"

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def k0_dim(self) -> int:
        if self.rgbnet_dim <= 0:
            return 3
        return 0 if self.rgbnet_full_implicit else self.rgbnet_dim

    @property
    def dim0(self) -> int:
        """Input width of the rgbnet: viewdir PE plus the k0 features it
        sees (all of them when ``rgbnet_direct``, else all but the first
        three, which are added to the logit)."""
        d = 3 + 3 * self.viewbase_pe * 2
        if self.rgbnet_full_implicit:
            return d
        return d + (self.k0_dim if self.rgbnet_direct else self.k0_dim - 3)

    @property
    def act_shift(self) -> float:
        """Density bias that makes the initial alpha ``alpha_init``."""
        return float(np.log(1.0 / (1.0 - self.alpha_init) - 1.0))

    def n_samples_ref(self, stepsize: float) -> int:
        """The nominal bound that normalises the sample coordinate ``s``."""
        return int((max(self.world_size) - 1) / stepsize) + 1

    def n_samples(self, stepsize: float) -> int:
        """Static per-ray sample count: the bbox-diagonal bound."""
        return int(np.linalg.norm(np.array(self.world_size) + 1)
                   / stepsize) + 1


def make_config(xyz_min, xyz_max, num_voxels, num_voxels_base, alpha_init,
                mask_cache_world_size=None, **kwargs) -> Config:
    world_size, voxel_size = common.dvgo_grid_resolution(
        xyz_min, xyz_max, num_voxels)
    _, voxel_size_base = common.dvgo_grid_resolution(
        xyz_min, xyz_max, num_voxels_base)
    if mask_cache_world_size is None:
        mask_cache_world_size = world_size
    known = {f.name for f in dataclasses.fields(Config)}
    derived = {"xyz_min", "xyz_max", "num_voxels", "num_voxels_base",
               "world_size", "mask_cache_world_size", "voxel_size",
               "voxel_size_base", "alpha_init", "voxel_size_ratio"}
    extra = {k: v for k, v in kwargs.items() if k in known - derived}
    for gk in ("density_config", "k0_config"):
        if isinstance(extra.get(gk), dict):
            extra[gk] = tuple(sorted(extra[gk].items()))
    return Config(
        xyz_min=tuple(float(v) for v in np.asarray(xyz_min)),
        xyz_max=tuple(float(v) for v in np.asarray(xyz_max)),
        num_voxels=int(num_voxels),
        num_voxels_base=int(num_voxels_base),
        world_size=tuple(world_size),
        mask_cache_world_size=tuple(int(v) for v in mask_cache_world_size),
        voxel_size=float(voxel_size),
        voxel_size_base=float(voxel_size_base),
        alpha_init=float(alpha_init),
        **extra,
    )


def get_kwargs(cfg: Config) -> dict:
    """The checkpoint's self-description of the model."""
    return {
        "xyz_min": list(cfg.xyz_min),
        "xyz_max": list(cfg.xyz_max),
        "num_voxels": cfg.num_voxels,
        "num_voxels_base": cfg.num_voxels_base,
        "alpha_init": cfg.alpha_init,
        "voxel_size_ratio": cfg.voxel_size_ratio,
        "mask_cache_path": cfg.mask_cache_path,
        "mask_cache_thres": cfg.mask_cache_thres,
        "mask_cache_world_size": list(cfg.mask_cache_world_size),
        "fast_color_thres": cfg.fast_color_thres,
        "density_type": cfg.density_type,
        "k0_type": cfg.k0_type,
        "density_config": dict(cfg.density_config),
        "k0_config": dict(cfg.k0_config),
        "mode_type": cfg.mode_type,
        "act_type": cfg.act_type,
        "dim_rend": cfg.dim_rend,
        "rgbnet_dim": cfg.rgbnet_dim,
        "rgbnet_direct": cfg.rgbnet_direct,
        "rgbnet_full_implicit": cfg.rgbnet_full_implicit,
        "rgbnet_depth": cfg.rgbnet_depth,
        "rgbnet_width": cfg.rgbnet_width,
        "viewbase_pe": cfg.viewbase_pe,
    }


def _dense_only(cfg: Config):
    if cfg.density_type != "DenseGrid" or cfg.k0_type != "DenseGrid":
        raise NotImplementedError("the port has dense grids only")


def init(cfg: Config, *, generator: torch.Generator | None = None,
         init_mask=None, device=None):
    """(params, buffers): zero grids, a random rgbnet drawn from
    ``generator`` (seed 0 when None), a full mask (or ``init_mask``)."""
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
        dims = [cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]
        params["rgbnet"] = common.mlp_init(dims, generator=generator,
                                           device=dev)
    if init_mask is not None:
        mask = torch.as_tensor(np.asarray(init_mask, dtype=bool), device=dev)
    else:
        mask = torch.ones(cfg.mask_cache_world_size, dtype=torch.bool,
                          device=dev)
    return params, {"mask_cache": mask}


def _xyz_minmax(cfg: Config, device):
    return (torch.tensor(cfg.xyz_min, dtype=torch.float32, device=device),
            torch.tensor(cfg.xyz_max, dtype=torch.float32, device=device))


def sample_ray(cfg: Config, rays_o, rays_d, *, near, far, stepsize: float):
    """Fixed-shape bounded-scene sampling: (pts ``[N,K,3]``, valid
    ``[N,K]``, t_min ``[N]``)."""
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    return render.sample_pts_on_rays_fixed(
        rays_o, rays_d, xyz_min, xyz_max, near, far,
        stepsize * cfg.voxel_size, cfg.n_samples(stepsize))


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, near, far, bg: float = 0.0,
            render_depth: bool = False, **unused) -> dict:
    """Volume-render N rays densely (eval: no random background)."""
    _dense_only(cfg)
    N = rays_o.shape[0]
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio

    pts, valid, _ = sample_ray(cfg, rays_o, rays_d, near=near, far=far,
                               stepsize=stepsize)
    K = pts.shape[1]
    valid = valid & grid_sample.nearest_mask_lookup(
        buffers["mask_cache"], pts, xyz_min, xyz_max)

    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
    density = grid_sample.trilinear_sample(params["density"], ind01)[..., 0]
    alpha = render.raw2alpha(density, cfg.act_shift, interval)
    if cfg.fast_color_thres > 0:
        valid = valid & (alpha > cfg.fast_color_thres)

    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))

    k0 = None if cfg.rgbnet_full_implicit else \
        grid_sample.trilinear_sample(params["k0"], ind01)
    if cfg.rgbnet_dim <= 0:
        rgb_raw = torch.sigmoid(k0)
    else:
        vdir_emb = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        if cfg.rgbnet_full_implicit:
            rgb_feat = vdir_emb
        elif cfg.rgbnet_direct:
            rgb_feat = torch.cat([k0, vdir_emb], dim=-1)
        else:
            rgb_feat = torch.cat([k0[..., 3:], vdir_emb], dim=-1)
        rgb_logit = common.mlp_apply(params["rgbnet"], rgb_feat,
                                     common.activation(cfg.act_type))
        if cfg.rgbnet_direct or cfg.rgbnet_full_implicit:
            rgb_raw = torch.sigmoid(rgb_logit)
        else:
            rgb_raw = torch.sigmoid(rgb_logit + k0[..., :3])

    rgb_feature = render.composite(weights, rgb_raw)
    rgb_marched = rgb_feature + alphainv_last[:, None] * bg
    n_ref = cfg.n_samples_ref(stepsize)
    s = (torch.arange(K, dtype=rgb_marched.dtype, device=rays_o.device)
         + 0.5) / n_ref
    s = s[None, :].expand(N, K)
    out = {
        "alphainv_last": alphainv_last,
        "weights": weights,
        "rgb_marched": rgb_marched,
        "rgb_feature": rgb_feature,
        "raw_alpha": torch.where(valid, alpha, torch.zeros_like(alpha)),
        "raw_rgb": rgb_raw,
        "n_max": n_ref,
        "s": s,
    }
    if render_depth:
        out["depth"] = render.composite(weights, s)
    return out


def hit_coarse_geo(cfg: Config, buffers: dict, rays_o, rays_d, *, near, far,
                   stepsize: float, **unused):
    """True for the rays one of whose samples hits the occupancy mask."""
    pts, valid, _ = sample_ray(cfg, rays_o, rays_d, near=near, far=far,
                               stepsize=stepsize)
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    hit = valid & grid_sample.nearest_mask_lookup(
        buffers["mask_cache"], pts, xyz_min, xyz_max)
    return hit.any(-1)


_OCC_X_CHUNK = 16  # x-slab of the occupancy query


def update_occupancy_cache(cfg: Config, params: dict, buffers: dict) -> dict:
    """AND the occupancy mask with the 3x3x3-dilated alpha of the current
    density, queried at the mask's own resolution, in x-slabs so the
    8-corner temporaries stay small."""
    mask = buffers["mask_cache"]
    dev = mask.device
    xyz_min, xyz_max = _xyz_minmax(cfg, dev)
    axes = [torch.linspace(cfg.xyz_min[d], cfg.xyz_max[d], int(mask.shape[d]),
                           dtype=torch.float32, device=dev) for d in range(3)]
    alpha = torch.empty(mask.shape, dtype=torch.float32, device=dev)
    for x0 in range(0, mask.shape[0], _OCC_X_CHUNK):
        gx, gy, gz = torch.meshgrid(axes[0][x0:x0 + _OCC_X_CHUNK], axes[1],
                                    axes[2], indexing="ij")
        ind01 = grid_sample.world_to_ind01(torch.stack([gx, gy, gz], -1),
                                           xyz_min, xyz_max)
        dens = grid_sample.trilinear_sample(params["density"], ind01)[..., 0]
        alpha[x0:x0 + _OCC_X_CHUNK] = render.raw2alpha(
            dens, cfg.act_shift, cfg.voxel_size_ratio)
    alpha = grid_sample.max_pool3d_same(alpha)
    return {**buffers, "mask_cache": mask & (alpha > cfg.fast_color_thres)}
