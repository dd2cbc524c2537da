"""DirectContractedVoxGO: the voxel radiance field of unbounded
inward-facing (360-degree) scenes (torch).

The port of the JAX package's ``models/dcvgo.py`` (after frozoul/4K-NeRF
lib/dcvgo.py). A ray is taken into the scene's normalised frame (centre
``scene_center``, radius ``scene_radius``: the cube that separates the
foreground from the background) and sampled on one fixed lattice ``t``
shared by every ray: an inner part uniform in ``[0, 2]`` and an outer part
uniform in ``1/t``. The contraction maps a point outside the unit cube
(``inf`` norm) or ball (``l2``) into a shell of width ``bg_len``, so the
grid spans ``[-1-bg_len, 1+bg_len]^3``. Outer samples crowd together in
the shell; :func:`cumdist_keep_mask` keeps one each time the distance
walked since the last kept one passes the grid's step. The rest is
DirectVoxGO's dense compositing, with the rgbnet reading the k0 features
and the view direction directly.

A model is (static :class:`Config`, params dict, buffers dict) as in the
other families, its grids dense or TensoRF. The occupancy renewal, the
progressive scaling and the TV gradients are DirectVoxGO's functions.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common, dvgo
from fourk_nerf_torch.ops import grid_sample, rays as ray_ops, render


@dataclasses.dataclass(frozen=True)
class Config:
    """Static model description; ``xyz_min`` / ``xyz_max`` are the grid's
    span in the normalised frame."""

    scene_center: tuple
    scene_radius: tuple
    num_voxels: int
    num_voxels_base: int
    world_size: tuple
    mask_cache_world_size: tuple
    voxel_size: float
    voxel_size_base: float
    alpha_init: float
    bg_len: float = 0.2
    contracted_norm: str = "inf"
    fast_color_thres: float = 0.0
    density_type: str = "DenseGrid"
    k0_type: str = "DenseGrid"
    density_config: tuple = ()
    k0_config: tuple = ()
    rgbnet_dim: int = 0
    rgbnet_depth: int = 3
    rgbnet_width: int = 128
    viewbase_pe: int = 4

    @property
    def xyz_min(self) -> tuple:
        return (-1.0 - self.bg_len,) * 3

    @property
    def xyz_max(self) -> tuple:
        return (1.0 + self.bg_len,) * 3

    @property
    def voxel_size_ratio(self) -> float:
        return self.voxel_size / self.voxel_size_base

    @property
    def world_len(self) -> int:
        return self.world_size[0]

    @property
    def k0_dim(self) -> int:
        return 3 if self.rgbnet_dim <= 0 else self.rgbnet_dim

    @property
    def dim0(self) -> int:
        """Input width of the rgbnet: the k0 features and the viewdir
        PE."""
        return 3 + 3 * self.viewbase_pe * 2 + self.k0_dim

    @property
    def act_shift(self) -> float:
        """Density bias that makes the initial alpha ``alpha_init``."""
        return float(np.log(1.0 / (1.0 - self.alpha_init) - 1.0))

    def n_inner(self, stepsize: float) -> int:
        """Samples of the inner part of the lattice (as many again
        outside)."""
        return int(2.0 / (2.0 + 2.0 * self.bg_len) * self.world_len
                   / stepsize) + 1

    def n_samples(self, stepsize: float) -> int:
        """Static per-ray sample count K: inner plus outer."""
        return 2 * self.n_inner(stepsize)


def _cube_resolution(xyz_min, xyz_max, num_voxels):
    """(world size, voxel size) of cubic voxels over a box, in float64 on
    the host."""
    voxel_size = (np.prod(xyz_max - xyz_min) / num_voxels) ** (1.0 / 3.0)
    world_size = ((xyz_max - xyz_min) / voxel_size).astype(np.int64)
    return tuple(int(w) for w in world_size), float(voxel_size)


def make_config(xyz_min, xyz_max, num_voxels, num_voxels_base, alpha_init,
                mask_cache_world_size=None, bg_len=0.2, **kwargs) -> Config:
    """``xyz_min`` / ``xyz_max``: the foreground cube (world frame), which
    gives the centre and radius; the grid spans the contracted cube."""
    xyz_min = np.asarray(xyz_min, dtype=np.float64)
    xyz_max = np.asarray(xyz_max, dtype=np.float64)
    full_min = np.full(3, -1.0 - bg_len)
    full_max = np.full(3, 1.0 + bg_len)
    world_size, voxel_size = _cube_resolution(full_min, full_max, num_voxels)
    _, voxel_size_base = _cube_resolution(full_min, full_max,
                                          num_voxels_base)
    if mask_cache_world_size is None:
        mask_cache_world_size = world_size
    known = {f.name for f in dataclasses.fields(Config)}
    derived = {"scene_center", "scene_radius", "num_voxels",
               "num_voxels_base", "world_size", "mask_cache_world_size",
               "voxel_size", "voxel_size_base", "alpha_init", "bg_len",
               "voxel_size_ratio"}
    extra = {k: v for k, v in kwargs.items() if k in known - derived}
    for gk in ("density_config", "k0_config"):
        if isinstance(extra.get(gk), dict):
            extra[gk] = tuple(sorted(extra[gk].items()))
    return Config(
        scene_center=tuple(((xyz_min + xyz_max) * 0.5).tolist()),
        scene_radius=tuple(((xyz_max - xyz_min) * 0.5).tolist()),
        num_voxels=int(num_voxels), num_voxels_base=int(num_voxels_base),
        world_size=tuple(world_size),
        mask_cache_world_size=tuple(int(v) for v in mask_cache_world_size),
        voxel_size=float(voxel_size), voxel_size_base=float(voxel_size_base),
        alpha_init=float(alpha_init), bg_len=float(bg_len), **extra)


def get_kwargs(cfg: Config) -> dict:
    """The checkpoint's self-description of the model; ``xyz_min`` /
    ``xyz_max`` are the foreground cube from the centre and radius."""
    c = np.asarray(cfg.scene_center)
    r = np.asarray(cfg.scene_radius)
    return {
        "xyz_min": (c - r).tolist(),
        "xyz_max": (c + r).tolist(),
        "num_voxels": cfg.num_voxels,
        "num_voxels_base": cfg.num_voxels_base,
        "alpha_init": cfg.alpha_init,
        "voxel_size_ratio": cfg.voxel_size_ratio,
        "mask_cache_world_size": list(cfg.mask_cache_world_size),
        "fast_color_thres": cfg.fast_color_thres,
        "contracted_norm": cfg.contracted_norm,
        "bg_len": cfg.bg_len,
        "density_type": cfg.density_type,
        "k0_type": cfg.k0_type,
        "density_config": dict(cfg.density_config),
        "k0_config": dict(cfg.k0_config),
        "rgbnet_dim": cfg.rgbnet_dim,
        "rgbnet_depth": cfg.rgbnet_depth,
        "rgbnet_width": cfg.rgbnet_width,
        "viewbase_pe": cfg.viewbase_pe,
    }


def init(cfg: Config, *, generator: torch.Generator | None = None,
         init_mask=None, device=None):
    """(params, buffers): the grids (``dvgo.init_grids``) and a random
    rgbnet drawn from ``generator`` (seed 0 when None), a full mask (or
    ``init_mask``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = dvgo.init_grids(cfg, generator, dev)
    if cfg.rgbnet_dim > 0:
        dims = [cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]
        params["rgbnet"] = common.mlp_init(dims, generator=generator,
                                           device=dev)
    if isinstance(init_mask, torch.Tensor):
        mask = init_mask.to(device=dev, dtype=torch.bool)
    elif init_mask is not None:
        mask = torch.as_tensor(np.asarray(init_mask, dtype=bool), device=dev)
    else:
        mask = torch.ones(cfg.mask_cache_world_size, dtype=torch.bool,
                          device=dev)
    return params, {"mask_cache": mask}


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``num`` float32 points from ``start`` to ``stop``: with ``u = i *
    (1 / (num - 1))``, ``start * (1 - u) + stop * u`` in float32, and the
    last one ``stop`` (the JAX package's ``linspace`` as XLA computes it,
    so both packages sample the same lattice)."""
    f32 = np.float32
    step = np.arange(num - 1, dtype=f32) * (f32(1) / f32(num - 1))
    out = f32(start) * (f32(1) - step) + f32(stop) * step
    return np.concatenate([out, [f32(stop)]]).astype(f32)


def sample_lattice(cfg: Config, stepsize: float) -> np.ndarray:
    """The shared sample distances ``t [K]`` (float32, host): the mid
    points of ``n_inner`` equal bins over ``[0, 2]``, then of as many bins
    with edges ``2 / linspace(1, 1/128)``."""
    n = cfg.n_inner(stepsize)
    b_inner = _linspace_f32(0.0, 2.0, n + 1)
    b_outer = np.float32(2.0) / _linspace_f32(1.0, 1.0 / 128.0, n + 1)
    half = np.float32(0.5)
    return np.concatenate([(b_inner[1:] + b_inner[:-1]) * half,
                           (b_outer[1:] + b_outer[:-1]) * half])


def _row_norm(x):
    """``[..., 1]`` Euclidean norm of the last axis (3), summed left to
    right elementwise: the same float32 rounding on every device, so the
    spacing filter keeps the same samples on the card as on the CPU."""
    sq = x * x
    return torch.sqrt(sq[..., 0:1] + sq[..., 1:2] + sq[..., 2:3])


def sample_ray(cfg: Config, rays_o, rays_d, *, stepsize: float):
    """Contracted-space samples on the shared lattice: (pts ``[N,K,3]`` in
    the normalised frame, inner ``[N,K]`` bool: inside the unit cube or
    ball, t ``[K]``)."""
    dev, dt = rays_o.device, rays_o.dtype
    center = torch.tensor(cfg.scene_center, dtype=dt, device=dev)
    radius = torch.tensor(cfg.scene_radius, dtype=dt, device=dev)
    o = (rays_o - center) / radius
    d = rays_d / _row_norm(rays_d)
    t = torch.as_tensor(sample_lattice(cfg, stepsize), device=dev)
    pts = o[:, None, :] + d[:, None, :] * t[None, :, None]
    if cfg.contracted_norm == "inf":
        norm = pts.abs().amax(-1, keepdim=True)
    elif cfg.contracted_norm == "l2":
        norm = _row_norm(pts)
    else:
        raise NotImplementedError(cfg.contracted_norm)
    inner = norm <= 1
    pts = torch.where(inner, pts,
                      pts / norm * ((1 + cfg.bg_len) - cfg.bg_len / norm))
    return pts, inner[..., 0], t


@torch.no_grad()
def cumdist_keep_mask(dist, thres: float):
    """The spacing filter: walking each ray near to far, add the distance
    ``dist [N, K-1]`` between consecutive samples to an accumulator; a
    sample is kept when the accumulator passes ``thres`` (which resets
    it). Returns ``[N, K-1]`` bool, the mask of samples 1..K-1. One pass
    over the gaps, in the order of float32 additions of the JAX package's
    scan (geometry only: no gradient)."""
    thres = float(np.float32(thres))
    cum = torch.zeros(dist.shape[0], dtype=dist.dtype, device=dist.device)
    keep = []
    for k in range(dist.shape[1]):
        cum = cum + dist[:, k]
        keep.append(cum > thres)
        cum = cum.masked_fill(keep[-1], 0.0)
    return torch.stack(keep, dim=1)


def keep_mask(cfg: Config, pts, inner, stepsize: float):
    """``[N, K]``: the inner samples and the outer ones the spacing filter
    keeps (the first sample of a ray only if inner)."""
    dist_thres = (2.0 + 2.0 * cfg.bg_len) / cfg.world_len * stepsize * 0.95
    with torch.no_grad():
        dist = _row_norm(pts[:, 1:] - pts[:, :-1])[..., 0]
    tail = cumdist_keep_mask(dist, dist_thres)
    return inner | torch.cat([torch.zeros_like(inner[:, :1]), tail], dim=1)


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, bg: float = 0.0,
            rand_bkgd: bool = False, is_train: bool = False, bg_noise=None,
            render_depth: bool = False, **unused) -> dict:
    """Volume-render N rays densely on the shared lattice. With
    ``rand_bkgd`` and ``is_train`` the background is ``bg_noise [N, 3]``,
    uniform noise that the caller draws; otherwise ``bg``. Outputs: the
    composited colour (``rgb_marched``, also as ``rgb_feature``), the
    weights and ``alphainv_last``, ``wsum_mid`` (the weight of the inner
    samples), ``t [N,K]``, ``s = t / (1 + t)``, ``n_max`` (K), the masked
    ``raw_density`` / ``raw_alpha``, ``raw_rgb`` and, with
    ``render_depth``, ``depth`` (the composited ``s``, detached)."""
    params = common.gathered(params)
    N = rays_o.shape[0]
    xyz_min, xyz_max = dvgo._xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio

    pts, inner, t = sample_ray(cfg, rays_o, rays_d, stepsize=stepsize)
    K = pts.shape[1]
    valid = keep_mask(cfg, pts, inner, stepsize)
    valid = valid & grid_sample.nearest_mask_lookup(
        buffers["mask_cache"], pts, xyz_min, xyz_max)

    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
    density = common.grid_query(cfg.density_type, params["density"],
                                ind01)[..., 0]
    alpha = render.raw2alpha(density, cfg.act_shift, interval)
    if cfg.fast_color_thres > 0:
        valid = valid & (alpha > cfg.fast_color_thres)

    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))

    k0 = common.grid_query(cfg.k0_type, params["k0"], ind01)
    if cfg.rgbnet_dim <= 0:
        rgb_raw = torch.sigmoid(k0)
    else:
        vdir_emb = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        rgb_logit = common.mlp_apply(params["rgbnet"],
                                     torch.cat([k0, vdir_emb], dim=-1),
                                     torch.relu)
        rgb_raw = torch.sigmoid(rgb_logit)

    rgb_marched = render.composite(weights, rgb_raw)
    if rand_bkgd and is_train:
        if bg_noise is None:
            raise ValueError("rand_bkgd training needs bg_noise")
        rgb_marched = rgb_marched + alphainv_last[:, None] * bg_noise
    else:
        rgb_marched = rgb_marched + alphainv_last[:, None] * bg

    zero = torch.zeros_like(weights)
    wsum_mid = torch.where(inner, weights, zero).sum(-1)
    t_b = t[None, :].expand(N, K)
    s = 1.0 - 1.0 / (1.0 + t_b)  # [0, inf) -> [0, 1)
    out = {
        "alphainv_last": alphainv_last,
        "weights": weights,
        "wsum_mid": wsum_mid,
        "rgb_marched": rgb_marched,
        "rgb_feature": rgb_marched,
        "raw_density": torch.where(valid, density, zero),
        "raw_alpha": torch.where(valid, alpha, zero),
        "raw_rgb": rgb_raw,
        "t": t_b,
        "s": s,
        "n_max": K,
    }
    if render_depth:
        out["depth"] = render.composite(weights, s).detach()
    return out


# The occupancy renewal, progressive scaling (the mask rebuilt up to 256^3
# voxels) and the TV gradients are DirectVoxGO's rules: the grids span
# xyz_min..xyz_max (the contracted cube) as a DirectVoxGO's span its box.
update_occupancy_cache = dvgo.update_occupancy_cache
scale_volume_grid = dvgo.scale_volume_grid
tv_weights = dvgo.tv_weights
