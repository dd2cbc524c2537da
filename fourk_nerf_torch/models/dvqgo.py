"""DirectQVGO: the vector-quantised DirectMPIGO (torch).

The port of the JAX package's ``models/dvqgo.py`` (after frozoul/4K-NeRF
lib/dvqgo.py, chosen by ``mode_type == 'adain_vq'``, run.py:287-293). The
k0 feature grid gives way to an EMA codebook (``ops/vq.py``) queried with
the spatial positional encoding of each sample (lib/dvqgo.py:322-327):
params hold ``density``, ``k0_vq`` (the projection MLP, trained under
``lrate_k0``) and the ``rgbnet``; buffers hold DirectMPIGO's ``act_shift``
and ``mask_cache`` and the codebook's ``vq_state``. The training forward
returns the updated ``vq_state``; the trainer puts it in the buffers after
the step. Like the JAX package it returns the commitment term ``vq_diff``
and leaves it out of the loss. The MPI geometry (sampling, occupancy,
act_shift decay, the density's TV) is DirectMPIGO's. There is no
progressive scaling: the JAX package has no ``scale_volume_grid`` here
(its loop fails at the first ``pg_scale`` step), and the port's trainer
refuses a ``pg_scale`` for this family up front.
"""

from __future__ import annotations

import dataclasses

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common, dmpigo
from fourk_nerf_torch.ops import grid_sample, rays as ray_ops, render, vq


@dataclasses.dataclass(frozen=True)
class Config(dmpigo.Config):
    n_cluster: int = 4096  # the codebook's size (the reference's k0 kwarg)

    @property
    def pe_dim(self) -> int:
        return 3 + 3 * self.spatial_pe * 2


def make_config(*args, n_cluster: int = 4096, **kwargs) -> Config:
    base = dmpigo.make_config(*args, **kwargs)
    return Config(**{f.name: getattr(base, f.name)
                     for f in dataclasses.fields(dmpigo.Config)},
                  n_cluster=int(n_cluster))


def get_kwargs(cfg: Config) -> dict:
    kw = dmpigo.get_kwargs(cfg)
    kw["n_cluster"] = cfg.n_cluster
    return kw


def init(cfg: Config, *, generator: torch.Generator | None = None,
         device=None):
    """(params, buffers): DirectMPIGO's without ``k0``, the projection and
    the codebook (``vq.init_vq``) and an rgbnet ending in 3 channels,
    drawn from ``generator`` (seed 0 when None)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    params, buffers = dmpigo.init(cfg, generator=generator, device=dev)
    params.pop("k0")  # the codebook takes its place
    params["k0_vq"], buffers["vq_state"] = vq.init_vq(
        cfg.pe_dim, cfg.k0_dim, cfg.n_cluster, generator=generator,
        device=dev)
    if cfg.rgbnet_dim > 0:
        dims = [cfg.dim0] + [cfg.rgbnet_width] * (cfg.rgbnet_depth - 1) + [3]
        params["rgbnet"] = common.mlp_init(dims, generator=generator,
                                           device=dev)
    return params, buffers


def forward(cfg: Config, params: dict, buffers: dict, rays_o, rays_d,
            viewdirs, *, stepsize: float, bg: float = 0.0,
            rand_bkgd: bool = False, is_train: bool = False, bg_noise=None,
            render_depth: bool = False, **unused) -> dict:
    """Volume-render N rays densely (lib/dvqgo.py:279-408). With
    ``rand_bkgd`` and ``is_train`` the background is ``bg_noise [N, 3]``.
    The outputs are DirectMPIGO's (``rgb_feature`` is the marched colour:
    the reference's model has no rend layer) and ``vq_diff``; with
    ``is_train`` also ``vq_state``, the codebook after this batch."""
    params = common.gathered(params)
    N = rays_o.shape[0]
    K = cfg.n_samples(stepsize)
    xyz_min, xyz_max = dmpigo._xyz_minmax(cfg, rays_o.device)
    interval = stepsize * cfg.voxel_size_ratio

    pts = render.sample_ndc_pts_on_rays(rays_o, rays_d, K)
    valid = ((pts >= xyz_min) & (pts <= xyz_max)).all(-1)
    valid &= grid_sample.nearest_mask_lookup(buffers["mask_cache"], pts,
                                             xyz_min, xyz_max)

    ind01 = grid_sample.world_to_ind01(pts, xyz_min, xyz_max)
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

    pe_spa = ind01.flip(-1) * 2.0 - 1.0  # zyx order
    pe_emb = ray_ops.positional_encoding(pe_spa, cfg.spatial_pe)
    vq_emb, vq_diff, _, vq_state = vq.vq_forward(
        params["k0_vq"], buffers["vq_state"], pe_emb, training=is_train)
    if cfg.rgbnet_dim <= 0:
        rgb_raw = torch.sigmoid(vq_emb)
    else:
        vdir_emb = ray_ops.positional_encoding(viewdirs, cfg.viewbase_pe)
        vdir_emb = vdir_emb[:, None, :].expand(N, K, vdir_emb.shape[-1])
        rgb_feat = torch.cat([vq_emb, pe_emb, vdir_emb], dim=-1)
        rgb_raw = torch.sigmoid(common.mlp_apply(
            params["rgbnet"], rgb_feat, common.activation(cfg.act_type)))

    rgb_marched = render.composite(weights, rgb_raw)
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
        "rgb_feature": rgb_marched,
        "raw_alpha": torch.where(valid, alpha, torch.zeros_like(alpha)),
        "raw_rgb": rgb_raw,
        "n_max": K,
        "s": s,
        "vq_diff": vq_diff,
    }
    if is_train:
        out["vq_state"] = vq_state
    if render_depth:
        out["depth"] = render.composite(weights, s).detach()
    return out


# the MPI geometry's maintenance is DirectMPIGO's
update_occupancy_cache = dmpigo.update_occupancy_cache
decay_act_shift = dmpigo.decay_act_shift
tv_weights = dmpigo.tv_weights
