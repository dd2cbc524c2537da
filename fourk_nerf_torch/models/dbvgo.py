"""DirectBiVoxGO: a foreground and an inverted-sphere background field
(torch).

The port of the JAX package's ``models/dbvgo.py`` (after frozoul/4K-NeRF
lib/dbvgo.py, dormant in the reference: no driver imports it, and none
here). Two independent voxel fields share one ``[-1, 1]^3`` cube: the
foreground samples the normalised scene inside the cube; the background
samples the ray beyond the cube, warped into it by the inverted-sphere
map of ``sample_bg_pts_on_rays`` (render_utils_kernel.cu:300-360). The
colour is the foreground over the background over the constant ``bg``.
Params are ``fg`` and ``bg`` subtrees (``density``, ``k0`` and, with
``rgbnet_dim > 0``, an ``rgbnet``; the background's only with
``bg_use_mlp``); buffers are the two fields' masks.
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
    scene_center: tuple
    scene_radius: tuple
    num_voxels: int
    num_voxels_base: int
    world_size: tuple
    mask_cache_world_size: tuple
    voxel_size: float
    voxel_size_base: float
    alpha_init: float
    bg_preserve: float = 0.5
    fast_color_thres: float = 0.0
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    rgbnet_dim: int = 0
    bg_use_mlp: bool = True
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4

    @property
    def xyz_min(self) -> tuple:
        return (-1.0, -1.0, -1.0)

    @property
    def xyz_max(self) -> tuple:
        return (1.0, 1.0, 1.0)

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def act_shift(self) -> float:
        return float(np.log(1.0 / (1.0 - self.alpha_init) - 1.0))

    def n_samples_fg(self, stepsize: float) -> int:
        stepdist = stepsize * self.voxel_size
        return int(2.0 * np.sqrt(3.0) / stepdist) + 1

    def n_samples_bg(self, stepsize: float) -> int:
        stepdist = stepsize * self.voxel_size
        return int(np.sqrt(3.0) / stepdist * (1.0 - self.bg_preserve)) + 1


def make_config(xyz_min, xyz_max, num_voxels, num_voxels_base, alpha_init,
                mask_cache_world_size=None, **kwargs) -> Config:
    """The scene box becomes the centre and radius of the normalised cube;
    the voxel sizes are those of ``num_voxels`` (``num_voxels_base``) in
    the ``[-1, 1]^3`` cube, float64 on the host."""
    xyz_min = np.asarray(xyz_min, dtype=np.float64)
    xyz_max = np.asarray(xyz_max, dtype=np.float64)
    cube = np.array([2.0, 2.0, 2.0])
    voxel_size = float((np.prod(cube) / num_voxels) ** (1.0 / 3.0))
    voxel_size_base = float((np.prod(cube) / num_voxels_base) ** (1.0 / 3.0))
    world_size = tuple(int(v) for v in (cube / voxel_size).astype(np.int64))
    if mask_cache_world_size is None:
        mask_cache_world_size = world_size
    known = {f.name for f in dataclasses.fields(Config)}
    derived = {"scene_center", "scene_radius", "num_voxels", "num_voxels_base",
               "world_size", "mask_cache_world_size", "voxel_size",
               "voxel_size_base", "alpha_init", "voxel_size_ratio"}
    extra = {k: v for k, v in kwargs.items() if k in known - derived}
    for gk in ("density_config", "k0_config"):
        if isinstance(extra.get(gk), dict):
            extra[gk] = tuple(sorted(extra[gk].items()))
    return Config(
        scene_center=tuple(((xyz_min + xyz_max) * 0.5).tolist()),
        scene_radius=tuple(((xyz_max - xyz_min) * 0.5).tolist()),
        num_voxels=int(num_voxels), num_voxels_base=int(num_voxels_base),
        world_size=world_size,
        mask_cache_world_size=tuple(int(v) for v in mask_cache_world_size),
        voxel_size=voxel_size, voxel_size_base=voxel_size_base,
        alpha_init=float(alpha_init), **extra)


def get_kwargs(cfg: Config) -> dict:
    """The checkpoint's ``model_kwargs``, the JAX package's."""
    c, r = np.asarray(cfg.scene_center), np.asarray(cfg.scene_radius)
    return {
        "xyz_min": (c - r).tolist(), "xyz_max": (c + r).tolist(),
        "num_voxels": cfg.num_voxels, "num_voxels_base": cfg.num_voxels_base,
        "alpha_init": cfg.alpha_init, "voxel_size_ratio": cfg.voxel_size_ratio,
        "mask_cache_world_size": list(cfg.mask_cache_world_size),
        "fast_color_thres": cfg.fast_color_thres,
        "bg_preserve": cfg.bg_preserve,
        "density_type": cfg.density_type, "k0_type": cfg.k0_type,
        "density_config": dict(cfg.density_config),
        "k0_config": dict(cfg.k0_config),
        "rgbnet_dim": cfg.rgbnet_dim, "bg_use_mlp": cfg.bg_use_mlp,
        "rgbnet_depth": cfg.rgbnet_depth, "rgbnet_width": cfg.rgbnet_width,
        "viewbase_pe": cfg.viewbase_pe,
    }


def init(cfg: Config, *, generator: torch.Generator | None = None,
         device=None):
    """(params, buffers): the ``fg`` then the ``bg`` field, each its grids
    (zero dense grids or TensoRF factors) and rgbnet drawn from
    ``generator`` (seed 0 when None) in that order; two full masks. The
    background without its MLP keeps a 3-channel k0 (its colour)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    dim0 = 3 + 3 * cfg.viewbase_pe * 2 + cfg.k0_dim
    dims = [dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]

    def field(with_mlp: bool, k0_ch: int) -> dict:
        p = {"density": common.grid_init(
                 cfg.density_type, 1, cfg.world_size, cfg.density_config,
                 generator=generator, device=dev),
             "k0": common.grid_init(
                 cfg.k0_type, k0_ch, cfg.world_size, cfg.k0_config,
                 generator=generator, device=dev)}
        if cfg.rgbnet_dim > 0 and with_mlp:
            p["rgbnet"] = common.mlp_init(dims, generator=generator,
                                          device=dev)
        return p

    params = {"fg": field(True, cfg.k0_dim),
              "bg": field(cfg.bg_use_mlp,
                          cfg.k0_dim if cfg.bg_use_mlp else 3)}
    buffers = {k: torch.ones(cfg.mask_cache_world_size, dtype=torch.bool,
                             device=dev)
               for k in ("mask_cache_fg", "mask_cache_bg")}
    return params, buffers


def sample_bg_pts(rays_o, rays_d, t_max, bg_preserve: float, n_samples: int):
    """``[N, K, 3]`` background samples (render_utils_kernel.cu:300-360):
    ``t = t_max - 1 + 1 / (1 - k / K)`` along the unit direction, each
    point pulled into the cube by the inverted-sphere map
    ``r^2 / t^2 (1 - bg_preserve) + r / t bg_preserve`` (``t`` its
    distance, ``r`` that over its inf norm)."""
    k = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)
    # k / K as the CPU divides (render.true_div): near k = K - 1 an ulp of
    # it moves t by K ulps
    ori_t = t_max[:, None] - 1.0 + 1.0 / (
        1.0 - render.true_div(k, n_samples))[None, :]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * ori_t[..., None]
    t_outer = torch.linalg.norm(pts, dim=-1)
    r_outer = t_outer / pts.abs().amax(-1)
    o2i = ((r_outer ** 2) / (t_outer ** 2) * (1.0 - bg_preserve)
           + r_outer / t_outer * bg_preserve)
    return pts * o2i[..., None]


def _field_forward(cfg: Config, fparams, mask_cache, pts, valid, viewdirs,
                   interval, xyz_min, xyz_max) -> dict:
    """One field's masked render terms (lib/dbvgo.py:248-309)."""
    N, K = pts.shape[:2]
    valid = valid & grid_sample.nearest_mask_lookup(mask_cache, pts, xyz_min,
                                                    xyz_max)
    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
    density = common.grid_query(cfg.density_type, fparams["density"],
                                ind01)[..., 0]
    alpha = render.raw2alpha(density, cfg.act_shift, interval)
    if cfg.fast_color_thres > 0:
        valid = valid & (alpha > cfg.fast_color_thres)
    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))
    k0 = common.grid_query(cfg.k0_type, fparams["k0"], ind01)
    if "rgbnet" not in fparams:
        rgb = torch.sigmoid(k0)
    else:
        vdir = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir = vdir[:, None, :].expand(N, K, vdir.shape[-1])
        rgb = torch.sigmoid(common.mlp_apply(
            fparams["rgbnet"], torch.cat([k0, vdir], dim=-1), torch.relu))
    return {"rgb": rgb,
            "alpha": torch.where(valid, alpha, torch.zeros_like(alpha)),
            "weights": weights, "alphainv_last": alphainv_last,
            "marched": render.composite(weights, rgb)}


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, bg: float = 0.0,
            render_depth: bool = False, **unused) -> dict:
    """Volume-render N rays densely (lib/dbvgo.py:310-398): the foreground
    on a fixed lattice through the cube, the background on
    :func:`sample_bg_pts` behind it (with ``fast_color_thres``, only for
    rays the foreground leaves visible), composited fg over bg over
    ``bg``; ``alphainv_last`` is the product of the two fields' (each
    also returned, ``alphainv_last_fg`` / ``_bg``)."""
    params = common.gathered(params)
    dev, dt = rays_o.device, rays_o.dtype
    center = torch.tensor(cfg.scene_center, dtype=dt, device=dev)
    radius = torch.tensor(cfg.scene_radius, dtype=dt, device=dev)
    o = (rays_o - center) / radius
    d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    xyz_min = torch.tensor(cfg.xyz_min, dtype=dt, device=dev)
    xyz_max = torch.tensor(cfg.xyz_max, dtype=dt, device=dev)
    interval = stepsize * cfg.voxel_size_ratio
    stepdist = stepsize * cfg.voxel_size
    far = 2.0 * float(np.sqrt(3.0))

    k_fg = cfg.n_samples_fg(stepsize)
    pts_fg, valid_fg, _ = render.sample_pts_on_rays_fixed(
        o, d, xyz_min, xyz_max, 0.0, far, stepdist, k_fg)
    _, t_max = render.ray_aabb(o, d, xyz_min, xyz_max, 0.0, far)
    fg = _field_forward(cfg, params["fg"], buffers["mask_cache_fg"], pts_fg,
                        valid_fg, viewdirs, interval, xyz_min, xyz_max)

    # rays the foreground occludes still run through the background (the
    # reference skips them); their share reaches the colour through the
    # foreground's transmittance, ~0
    k_bg = cfg.n_samples_bg(stepsize)
    pts_bg = sample_bg_pts(o, d, t_max, cfg.bg_preserve, k_bg)
    valid_bg = torch.ones(pts_bg.shape[:2], dtype=torch.bool, device=dev)
    if cfg.fast_color_thres > 0:
        valid_bg = valid_bg & (fg["alphainv_last"]
                               > cfg.fast_color_thres)[:, None]
    bgf = _field_forward(cfg, params["bg"], buffers["mask_cache_bg"], pts_bg,
                         valid_bg, viewdirs, interval, xyz_min, xyz_max)

    rgb_marched = (fg["marched"]
                   + fg["alphainv_last"][:, None] * bgf["marched"]
                   + (fg["alphainv_last"] * bgf["alphainv_last"])[:, None]
                   * bg)
    shape = fg["weights"].shape
    out = {
        "rgb_marched": rgb_marched,
        "rgb_feature": rgb_marched,
        "alphainv_last": fg["alphainv_last"] * bgf["alphainv_last"],
        "alphainv_last_fg": fg["alphainv_last"],
        "alphainv_last_bg": bgf["alphainv_last"],
        "weights_fg": fg["weights"], "weights_bg": bgf["weights"],
        "raw_rgb": fg["rgb"],
        "weights": fg["weights"],
        "n_max": k_fg,
        "s": ((torch.arange(k_fg, dtype=dt, device=dev) + 0.5)
              / k_fg).expand(shape),
    }
    if render_depth:
        step = torch.arange(k_fg, dtype=dt, device=dev).expand(shape)
        out["depth"] = render.composite(fg["weights"], step).detach()
    return out
