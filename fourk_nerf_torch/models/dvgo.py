"""DirectVoxGO: the voxel radiance field of bounded inward-facing
scenes (torch).

A model is (static :class:`Config`, params dict, buffers dict), as in the
JAX package: params hold ``density [X,Y,Z,1]``, ``k0 [X,Y,Z,C]`` and, with
``rgbnet_dim > 0``, the ``rgbnet`` dict; buffers hold the bool
``mask_cache``. Every ray gets a static sample count K (the bbox-diagonal
bound); samples past a ray's own count or outside the box carry alpha 0.
A grid is dense (``DenseGrid``) or TensoRF factors (``TensoRFGrid``, through
``common.grid_*``). The training forms follow the forward pass:
progressive grid scaling, the near-camera mask-out, the per-voxel view
counts of the per-voxel lr, the occupancy renewal and the TV gradients;
gradients come from torch autograd of the same forward (the training
background is ``bg``: the JAX forward takes no random one).
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


def init_grids(cfg, generator: torch.Generator, dev) -> dict:
    """``density`` and ``k0`` of ``cfg``'s grid types: zero dense grids, or
    TensoRF factors drawn from ``generator`` (density first)."""
    return {
        "density": common.grid_init(cfg.density_type, 1, cfg.world_size,
                                    cfg.density_config, generator=generator,
                                    device=dev),
        "k0": common.grid_init(cfg.k0_type, cfg.k0_dim, cfg.world_size,
                               cfg.k0_config, generator=generator,
                               device=dev),
    }


def init(cfg: Config, *, generator: torch.Generator | None = None,
         init_mask=None, device=None):
    """(params, buffers): the grids (:func:`init_grids`) and a random
    rgbnet drawn from ``generator`` (seed 0 when None), a full mask (or
    ``init_mask``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params = init_grids(cfg, generator, dev)
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


def _colour(cfg: Config, params: dict, ind01, vdir_emb):
    """Raw colour ``[..., 3]`` at normalised ``[..., 3]`` coordinates:
    k0 through a sigmoid, or the rgbnet on k0 and the viewdir embedding
    ``vdir_emb [..., E]``."""
    k0 = None if cfg.rgbnet_full_implicit else \
        common.grid_query(cfg.k0_type, params["k0"], ind01)
    if cfg.rgbnet_dim <= 0:
        return torch.sigmoid(k0)
    if cfg.rgbnet_full_implicit:
        rgb_feat = vdir_emb
    elif cfg.rgbnet_direct:
        rgb_feat = torch.cat([k0, vdir_emb], dim=-1)
    else:
        rgb_feat = torch.cat([k0[..., 3:], vdir_emb], dim=-1)
    rgb_logit = common.mlp_apply(params["rgbnet"], rgb_feat,
                                 common.activation(cfg.act_type))
    if cfg.rgbnet_direct or cfg.rgbnet_full_implicit:
        return torch.sigmoid(rgb_logit)
    return torch.sigmoid(rgb_logit + k0[..., :3])


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, near, far, bg: float = 0.0,
            render_depth: bool = False, **unused) -> dict:
    """Volume-render N rays over their K static samples (eval: no random
    background). With ``fast_color_thres > 0`` k0 and the rgbnet run only
    on the samples whose weight survives the threshold, found by one
    read-back, and ``raw_rgb`` is 0 at the others."""
    params = common.gathered(params)
    N = rays_o.shape[0]
    xyz_min, xyz_max = _xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio

    pts, valid, _ = sample_ray(cfg, rays_o, rays_d, near=near, far=far,
                               stepsize=stepsize)
    K = pts.shape[1]
    valid = valid & grid_sample.nearest_mask_lookup(
        buffers["mask_cache"], pts, xyz_min, xyz_max)

    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
    density = common.grid_query(cfg.density_type, params["density"],
                                ind01)[..., 0]
    alpha = render.raw2alpha(density, cfg.act_shift, interval)
    if cfg.fast_color_thres > 0:
        valid = valid & (alpha > cfg.fast_color_thres)

    weights, alphainv_last, _ = render.alpha2weight(alpha, valid)
    vdir_emb = None if cfg.rgbnet_dim <= 0 else \
        ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
    if cfg.fast_color_thres > 0:
        weights = torch.where(weights > cfg.fast_color_thres, weights,
                              torch.zeros_like(weights))
        # colour only the samples that carry weight (the reference's
        # ``weights > fast_color_thres``): a weight-0 sample adds 0 to every
        # output and, past the two thresholds, passes no gradient back
        rows = torch.nonzero(weights.reshape(-1) > 0).squeeze(1)
        if vdir_emb is not None:
            vdir_emb = vdir_emb[rows // K]
        rgb_rows = _colour(cfg, params, ind01.reshape(-1, 3)[rows], vdir_emb)
        rgb_raw = torch.zeros((N * K, 3), dtype=rgb_rows.dtype,
                              device=rgb_rows.device).index_put(
            (rows,), rgb_rows).reshape(N, K, 3)
        n_rows = rows.numel()
    else:  # a valid sample of alpha 0 still has a gradient through colour
        if vdir_emb is not None:
            vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        rgb_raw = _colour(cfg, params, ind01, vdir_emb)
        n_rows = N * K
    if trace.on():  # the rows the k0 gather and rgbnet compute
        trace.count("samples.k0", n_rows)
        trace.count("samples.weighted", (weights > 0).sum())

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
        out["depth"] = render.composite(weights, s).detach()
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
        dens = common.grid_query(cfg.density_type, params["density"],
                                 ind01)[..., 0]
        alpha[x0:x0 + _OCC_X_CHUNK] = render.raw2alpha(
            dens, cfg.act_shift, cfg.voxel_size_ratio)
    alpha = grid_sample.max_pool3d_same(alpha)
    return {**buffers, "mask_cache": mask & (alpha > cfg.fast_color_thres)}


def _grid_xyz(cfg: Config, shape, device, x_slice=slice(None)):
    """World coordinates ``[x, Y, Z, 3]`` of the voxels of a ``shape`` grid
    over the box (the rows ``x_slice`` of the first axis)."""
    axes = [torch.linspace(cfg.xyz_min[d], cfg.xyz_max[d], int(shape[d]),
                           dtype=torch.float32, device=device)
            for d in range(3)]
    return torch.stack(torch.meshgrid(axes[0][x_slice], axes[1], axes[2],
                                      indexing="ij"), -1)


_CAM_CHUNK = 64  # cameras a pass of the near-camera distance


@torch.no_grad()
def maskout_near_cam_vox(cfg: Config, params: dict, cam_o, near: float
                         ) -> dict:
    """Density -100 at the voxels within ``near`` of a camera centre
    ``cam_o [n, 3]`` (frozoul/4K-NeRF lib/dvgo.py:186-198). The nearest
    squared distance is kept as a running minimum over x-slabs and chunks
    of cameras, so no ``[X, Y, Z, n]`` tensor forms. A dense density only:
    the JAX package's ``jnp.where`` over TensoRF factors fails too."""
    if not common.is_dense(cfg.density_type):
        raise ValueError("maskout_near_cam_vox writes voxels of a dense "
                         "density grid; a TensoRFGrid has none")
    dens = params["density"]
    dev = dens.device
    cam = torch.as_tensor(np.asarray(cam_o, dtype=np.float32), device=dev)
    X = cfg.world_size[0]
    out = dens.clone()
    for x0 in range(0, X, _OCC_X_CHUNK):
        xyz = _grid_xyz(cfg, cfg.world_size, dev,
                        slice(x0, x0 + _OCC_X_CHUNK))
        d2 = None
        for c0 in range(0, cam.shape[0], _CAM_CHUNK):
            c = cam[c0:c0 + _CAM_CHUNK]
            m = ((xyz[..., None, :] - c) ** 2).sum(-1).amin(-1)
            d2 = m if d2 is None else torch.minimum(d2, m)
        near_mask = (torch.sqrt(d2) <= near)[..., None]
        out[x0:x0 + _OCC_X_CHUNK].masked_fill_(near_mask, -100.0)
    return {**params, "density": out}


@torch.no_grad()
def scale_volume_grid(cfg: Config, params: dict, buffers: dict,
                      num_voxels: int):
    """Progressive scaling (frozoul/4K-NeRF lib/dvgo.py:200-221): the grids
    resampled trilinearly onto the world size of ``num_voxels``. Up to
    256^3 voxels the mask is rebuilt at the new resolution (the old mask
    at the new voxels, AND the dilated alpha of the new density); above,
    it keeps its resolution. Returns (new_cfg, new_params, new_buffers);
    the grids are new tensors (TensoRF factors each resized,
    ``common.grid_resize``)."""
    world_size, voxel_size = common.dvgo_grid_resolution(
        cfg.xyz_min, cfg.xyz_max, num_voxels)
    new_cfg = dataclasses.replace(cfg, num_voxels=int(num_voxels),
                                  world_size=tuple(world_size),
                                  voxel_size=voxel_size)
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
        dens = common.grid_dense(cfg.density_type, new_params["density"], 1)
        alpha = render.raw2alpha(dens[..., 0], new_cfg.act_shift,
                                 new_cfg.voxel_size_ratio)
        alpha = grid_sample.max_pool3d_same(alpha)
        new_buffers["mask_cache"] = old_mask_at_new & (
            alpha > new_cfg.fast_color_thres)
        new_cfg = dataclasses.replace(
            new_cfg, mask_cache_world_size=new_cfg.world_size)
    return new_cfg, new_params, new_buffers


def _corner_splat(grid_flat, sizes, pos):
    """Add the trilinear weights of the points ``pos [n, 3]`` (voxel
    units) to ``grid_flat [X*Y*Z]``: what the gradient of a ones-grid
    query summed over the points is. Corners outside the grid add
    nothing (zeros padding), so only the corners inside are added."""
    X, Y, Z = sizes
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    lim = torch.tensor(sizes, dtype=torch.long, device=pos.device)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = torch.tensor([cx, cy, cz], device=pos.device)
                idx = i0 + corner
                valid = ((idx >= 0) & (idx < lim)).all(-1)
                w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
                idx, w = idx[valid], w[valid]
                grid_flat.index_add_(0, (idx[:, 0] * Y + idx[:, 1]) * Z
                                     + idx[:, 2], w)


@torch.no_grad()
def voxel_count_views(cfg: Config, rays_o_views, rays_d_views, near,
                      stepsize: float, downrate: int = 1,
                      chunk: int = 10000) -> torch.Tensor:
    """``[X, Y, Z, 1]`` per-voxel count of the training views that touch a
    voxel, the per-voxel lr's scale (frozoul/4K-NeRF lib/dvgo.py:235-266):
    every ray (every ``downrate``-th pixel of a view ``[H, W, 3]``) takes
    the diagonal bound of samples from its box entry, clamped at
    ``near``, with no far limit; a view touches a voxel where the
    trilinear weights of its samples sum above 1. The weights are
    splatted by ``index_add_`` in chunks of ``chunk`` rays. ``cfg`` may be
    any family's with a box and cubic voxels (a DirectContractedVoxGO's:
    its contracted cube, as the JAX package counts it); the sample count
    is the diagonal bound of that grid."""
    dev = rays_o_views[0].device
    X, Y, Z = cfg.world_size
    K = int(np.linalg.norm(np.array(cfg.world_size) + 1) / stepsize) + 1
    xyz_min, xyz_max = _xyz_minmax(cfg, dev)
    span = torch.tensor([X - 1, Y - 1, Z - 1], dtype=torch.float32,
                        device=dev)
    steps = stepsize * cfg.voxel_size * torch.arange(K, dtype=torch.float32,
                                                     device=dev)
    count = torch.zeros((X, Y, Z, 1), device=dev)
    for ro_v, rd_v in zip(rays_o_views, rays_d_views):
        ro = ro_v[::downrate, ::downrate].reshape(-1, 3)
        rd = rd_v[::downrate, ::downrate].reshape(-1, 3)
        g = torch.zeros(X * Y * Z, device=dev)
        for s in range(0, ro.shape[0], chunk):
            o, d = ro[s:s + chunk], rd[s:s + chunk]
            t_min, _ = render.ray_aabb(o, d, xyz_min, xyz_max, near, 1e9)
            t = t_min[:, None] + steps[None, :] / torch.linalg.norm(
                d, dim=-1, keepdim=True)
            pts = o[:, None, :] + d[:, None, :] * t[..., None]
            gc = torch.zeros_like(g)
            ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
            _corner_splat(gc, (X, Y, Z), (ind01 * span).reshape(-1, 3))
            g += gc
        count += (g > 1).float().reshape(X, Y, Z, 1)
    return count


def tv_weights(cfg: Config, weight: float, n_rays: int):
    """The TV gradient's ``(wx, wy, wz)`` (``common.grid_tv_grad``) for a
    loss weight and a batch of ``n_rays``."""
    # frozoul/4K-NeRF lib/dvgo.py:268-270: the same weight on every axis
    w = weight / n_rays * max(cfg.world_size) / 128.0
    return w, w, w

