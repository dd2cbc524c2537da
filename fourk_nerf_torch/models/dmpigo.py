"""DirectMPIGO: the multiplane-image voxel radiance field of the 4K LLFF
pipeline (torch).

A model is (static :class:`Config`, params dict, buffers dict), as in the
JAX package: params hold ``density [X,Y,Z,1]``, ``k0 [X,Y,Z,C]`` and the
``rgbnet`` dict; buffers hold ``act_shift [1,1,Z,1]`` and the bool
``mask_cache``. A grid is dense (``DenseGrid``) or TensoRF factors
(``TensoRFGrid``, through ``common.grid_*``); the plane-aligned fast path
is for dense grids. With ``dim_rend > 3`` the rgbnet has ``dim_rend``
outputs under leaky ReLU, the composite is a ``dim_rend``-channel
``rgb_feature``, and a ``[dim_rend, 3]`` ``rend_layer`` maps it (and each
sample's raw colour) to rgb; such a model renders through the chunked
forward, since the sweep kernel composites 3 channels. The
training forms (random
background, progressive grid scaling, the act_shift decay, the TV
gradients, the view-count mask) follow the forward pass; gradients come
from torch autograd of the same forward.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common
from fourk_nerf_torch.ops import grid_sample, rays as ray_ops, render
from fourk_nerf_torch.utils import trace


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


def get_kwargs(cfg: Config) -> dict:
    """The model's self-describing checkpoint metadata, the JAX package's
    ``model_kwargs`` (frozoul/4K-NeRF lib/dmpigo.py:168-187)."""
    return {
        "xyz_min": list(cfg.xyz_min),
        "xyz_max": list(cfg.xyz_max),
        "num_voxels": cfg.num_voxels,
        "mpi_depth": cfg.mpi_depth,
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
        "rgbnet_depth": cfg.rgbnet_depth,
        "rgbnet_width": cfg.rgbnet_width,
        "viewbase_pe": cfg.viewbase_pe,
        "spatial_pe": cfg.spatial_pe,
    }


def init(cfg: Config, *, generator: torch.Generator | None = None,
         device=None):
    """(params, buffers): zero dense grids or TensoRF factors, a random
    rgbnet and, with ``dim_rend > 3``, a random ``rend_layer``, drawn from
    ``generator`` (seed 0 when None) in that order, per-plane act_shift, a
    full mask."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = {
        "density": common.grid_init(cfg.density_type, 1, cfg.world_size,
                                    cfg.density_config, generator=generator,
                                    device=dev),
        "k0": common.grid_init(cfg.k0_type, cfg.k0_dim, cfg.world_size,
                               cfg.k0_config, generator=generator,
                               device=dev),
    }
    if cfg.rgbnet_dim > 0:
        dims = ([cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1)
                + [cfg.dim_rend])
        params["rgbnet"] = common.mlp_init(dims, generator=generator,
                                           device=dev)
        if cfg.dim_rend > 3:
            params["rend_layer"] = common.mlp_init(
                [cfg.dim_rend, 3], generator=generator, device=dev)
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
            rand_bkgd: bool = False, is_train: bool = False, bg_noise=None,
            render_depth: bool = False, ndc_planes: bool = False) -> dict:
    """Volume-render N rays densely.

    ``ndc_planes`` selects the exact plane-aligned bilinear path
    (:func:`plane_aligned_ok`) for the dense grids. With ``rand_bkgd`` and ``is_train`` the
    background is ``bg_noise [N, 3]``, uniform noise that the caller draws
    (the trainer, from a seeded ``torch.Generator`` per step), in place of
    ``bg``. With ``dim_rend > 3``, ``rgb_feature`` has ``dim_rend``
    channels and ``rgb_marched`` and ``raw_rgb`` are the rend layer's rgb
    (lib/dmpigo.py:405-411)."""
    params = common.gathered(params)
    N = rays_o.shape[0]
    K = cfg.n_samples(stepsize)
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio
    aligned = (ndc_planes and common.is_dense(cfg.density_type)
               and K == cfg.world_size[2])

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
        density = common.grid_query(cfg.density_type, params["density"],
                                    ind01)[..., 0]
        act_shift = grid_sample.trilinear_sample(buffers["act_shift"],
                                                 ind01)[..., 0]
    alpha = render.raw2alpha(density + act_shift, 0.0, interval)
    if cfg.fast_color_thres > 0:
        valid &= alpha > cfg.fast_color_thres

    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))
    if trace.on():  # the rows the dense k0 gather and rgbnet compute
        trace.count("samples.k0", N * K)
        trace.count("samples.weighted", (weights > 0).sum())

    if aligned and common.is_dense(cfg.k0_type):
        vox_emb = grid_sample.trilinear_sample_plane_aligned(params["k0"],
                                                             ind01[..., :2])
    else:
        vox_emb = common.grid_query(cfg.k0_type, params["k0"], ind01)
    if cfg.rgbnet_dim <= 0:
        rgb_raw = torch.sigmoid(vox_emb)
    else:
        pe_spa = ind01.flip(-1) * 2.0 - 1.0  # zyx order
        pe_emb = ray_ops.positional_encoding(pe_spa, cfg.spatial_pe)
        vdir_emb = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        rgb_feat = torch.cat([vox_emb, pe_emb, vdir_emb], dim=-1)
        act = cfg.act_type if cfg.dim_rend <= 3 else "lkrelu"
        rgb_raw = torch.sigmoid(common.mlp_apply(
            params["rgbnet"], rgb_feat, common.activation(act)))

    rgb_feature = render.composite(weights, rgb_raw)
    rgb_marched = rgb_feature
    if cfg.dim_rend > 3:
        lk = common.activation("lkrelu")
        rgb_marched = common.mlp_apply(params["rend_layer"], rgb_feature, lk)
        rgb_raw = torch.sigmoid(common.mlp_apply(params["rend_layer"],
                                                 rgb_raw, lk))
    if rand_bkgd and is_train:
        if bg_noise is None:
            raise ValueError("rand_bkgd training needs bg_noise")
        rgb_marched = rgb_marched + alphainv_last[:, None] * bg_noise
    else:
        rgb_marched = rgb_marched + alphainv_last[:, None] * bg
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
        out["depth"] = render.composite(weights, s).detach()
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
        dens = common.grid_query(cfg.density_type, params["density"],
                                 ind01)[..., 0]
        alpha[x0:x0 + _OCC_X_CHUNK] = render.raw2alpha(dens, 0.0,
                                                  cfg.voxel_size_ratio)
    alpha = grid_sample.max_pool3d_same(alpha)
    return {**buffers, "mask_cache": mask & (alpha > cfg.fast_color_thres)}


def _grid_xyz(cfg: Config, shape, device):
    """World coordinates of the voxels of a ``shape`` grid over the box."""
    axes = [torch.linspace(cfg.xyz_min[d], cfg.xyz_max[d], int(shape[d]),
                           dtype=torch.float32, device=device)
            for d in range(3)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), -1)


def update_occupancy_cache_lt_nviews(cfg: Config, buffers: dict,
                                     rays_o_views, rays_d_views,
                                     stepsize: float,
                                     maskout_lt_nviews: int) -> dict:
    """AND the cache with the voxels that at least ``maskout_lt_nviews``
    training views touch (frozoul/4K-NeRF lib/dmpigo.py:228-246). A view
    touches a voxel when the gradient of a ones-grid query summed over the
    view's sample points (its trilinear splat) exceeds 1 there."""
    mask = buffers["mask_cache"]
    dev = mask.device
    xyz_min, xyz_max = _xyz_minmax(cfg, dev)
    X, Y, Z = cfg.world_size
    K = cfg.n_samples(stepsize)
    ones = torch.ones((X, Y, Z, 1), device=dev, requires_grad=True)
    count = torch.zeros((X, Y, Z, 1), device=dev)
    for ro_v, rd_v in zip(rays_o_views, rays_d_views):
        ro, rd = ro_v.reshape(-1, 3), rd_v.reshape(-1, 3)
        g = torch.zeros_like(count)
        for s in range(0, ro.shape[0], 8192):
            pts = render.sample_ndc_pts_on_rays(ro[s:s + 8192],
                                                rd[s:s + 8192], K)
            total = grid_sample.grid_query(ones, pts, xyz_min, xyz_max).sum()
            g = g + torch.autograd.grad(total, ones)[0]
        count = count + (g > 1).float()
    if tuple(mask.shape) == (X, Y, Z):
        new_mask = mask & (count[..., 0] >= maskout_lt_nviews)
    else:  # the count resampled onto the cache's resolution
        cnt = grid_sample.grid_query(count, _grid_xyz(cfg, mask.shape, dev),
                                     xyz_min, xyz_max)[..., 0]
        new_mask = mask & (cnt >= maskout_lt_nviews)
    return {**buffers, "mask_cache": new_mask}


@torch.no_grad()
def scale_volume_grid(cfg: Config, params: dict, buffers: dict,
                      num_voxels: int, mpi_depth: int):
    """Progressive scaling (frozoul/4K-NeRF lib/dmpigo.py:189-211): the
    grids resampled trilinearly onto the world size of ``num_voxels``.
    Up to 256^3 voxels the mask is rebuilt at the new resolution from the
    old mask and the new density; above, it keeps its resolution. Returns
    (new_cfg, new_params, new_buffers); the grids are new tensors (TensoRF
    factors each resized, ``common.grid_resize``)."""
    new_cfg = dataclasses.replace(
        cfg, num_voxels=int(num_voxels), mpi_depth=int(mpi_depth),
        world_size=common.dmpigo_grid_resolution(
            cfg.xyz_min, cfg.xyz_max, num_voxels, mpi_depth),
        voxel_size_ratio=256.0 / mpi_depth)
    new_params = dict(params)
    new_params["density"] = common.grid_resize(
        cfg.density_type, params["density"], new_cfg.world_size)
    new_params["k0"] = common.grid_resize(cfg.k0_type, params["k0"],
                                          new_cfg.world_size)
    new_buffers = dict(buffers)
    if int(np.prod(new_cfg.world_size)) <= 256 ** 3:
        dev = buffers["mask_cache"].device
        xyz_min, xyz_max = _xyz_minmax(new_cfg, dev)
        old_mask_at_new = grid_sample.nearest_mask_lookup(
            buffers["mask_cache"], _grid_xyz(new_cfg, new_cfg.world_size, dev),
            xyz_min, xyz_max)
        dens = common.grid_dense(cfg.density_type, new_params["density"],
                                 1) + buffers["act_shift"]
        alpha = render.raw2alpha(dens[..., 0], 0.0, new_cfg.voxel_size_ratio)
        alpha = grid_sample.max_pool3d_same(alpha)
        new_buffers["mask_cache"] = old_mask_at_new & (
            alpha > new_cfg.fast_color_thres)
        new_cfg = dataclasses.replace(
            new_cfg, mask_cache_world_size=new_cfg.world_size)
    return new_cfg, new_params, new_buffers


def decay_act_shift(buffers: dict, amount: float) -> dict:
    """act_shift -= amount after each progressive scaling (run.py:475)."""
    return {**buffers, "act_shift": buffers["act_shift"] - amount}


def tv_weights(cfg: Config, weight: float, n_rays: int):
    """The TV gradient's ``(wx, wy, wz)`` (``common.grid_tv_grad``) for a
    loss weight and a batch of ``n_rays``."""
    # frozoul/4K-NeRF lib/dmpigo.py:248-251: wxy = w max(X, Y) / 128 and
    # wz = w D / 128, passed as (wx, wy, wz) = (wxy, wxy, wz) to the
    # kernel's innermost-first axis order
    w = weight / n_rays
    wxy = w * max(cfg.world_size[:2]) / 128.0
    return wxy, wxy, w * cfg.mpi_depth / 128.0

