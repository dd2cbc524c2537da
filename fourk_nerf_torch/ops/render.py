"""Volume-rendering math on dense ``[rays, samples]`` tensors (torch).

As in the JAX package, the reference's ragged sample compactions are
folded into the alphas: a dropped sample behaves exactly as alpha = 0.
Early ray termination (transmittance < 1e-3) zeroes the weights after the
break and fixes ``alphainv_last`` at the break point. The training terms
(the distortion loss and the total-variation gradient) sit at the end.
"""

from __future__ import annotations

import torch

EARLY_TERM_THRES = 1e-3


class _Softplus(torch.autograd.Function):
    """The formula's own autograd would differentiate ``max(x, 0)`` and
    ``|x|`` separately and give 1 at ``x = 0``; the derivative of softplus
    is ``sigmoid(x)`` everywhere (0.5 at 0, as ``jax.nn.softplus``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.sigmoid(x)


def softplus(x):
    """``log(1 + exp(x))`` in the overflow-free ``max(x,0) + log1p(exp(-|x|))``
    form (the same formula the sweep kernel evaluates), differentiated as
    ``sigmoid(x)``."""
    return _Softplus.apply(x)


def raw2alpha(density, shift, interval):
    """alpha = 1 - exp(-softplus(density + shift) * interval)."""
    return 1.0 - torch.exp(-softplus(density + shift) * interval)


def alpha2weight(alpha, valid=None):
    """Transmittance-weighted compositing weights along the last axis.

    Returns (weights ``[N,K]``, alphainv_last ``[N]``, T ``[N,K]``)."""
    if valid is not None:
        alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_post = torch.cumprod(1.0 - alpha, dim=-1)
    T = torch.cat([torch.ones_like(t_post[:, :1]), t_post[:, :-1]], dim=-1)
    alive = T >= EARLY_TERM_THRES  # prefix-true since T is non-increasing
    weights = torch.where(alive, T * alpha, torch.zeros_like(alpha))
    last_alive = torch.clamp_min(alive.sum(-1) - 1, 0)
    alphainv_last = torch.gather(t_post, -1, last_alive[:, None])[:, 0]
    alphainv_last = torch.where(alive[:, 0], alphainv_last,
                                torch.ones_like(alphainv_last))
    return weights, alphainv_last, T


def composite(weights, values):
    """``sum_k w_k * v_k``; values ``[N,K,C]`` or ``[N,K]``."""
    if values.dim() == weights.dim():
        return (weights * values).sum(-1)
    return (weights[..., None] * values).sum(-2)


def true_div(t, d: float):
    """``t / d`` for a Python number ``d``, the same bits on every device:
    a CUDA tensor divided by a Python number is multiplied by its
    reciprocal, an ulp off the CPU's true division, so ``d`` goes in as a
    device tensor."""
    return t / torch.full((1,), float(d), dtype=t.dtype, device=t.device)


def sample_ndc_pts_on_rays(rays_o, rays_d, n_samples: int):
    """Fixed-count equidistant NDC sampling ``p_k = o + d * k/(K-1)``:
    ``[N, K, 3]``. ``k/(K-1)`` is a :func:`true_div`: an ulp off moves a
    sample that lies on a grid plane to the other side of it on the card
    (its 8-corner gradient goes to other voxels)."""
    dist = true_div(torch.arange(n_samples, dtype=rays_o.dtype,
                                 device=rays_o.device), n_samples - 1)
    return rays_o[:, None, :] + rays_d[:, None, :] * dist[None, :, None]


def ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far):
    """Ray / axis-aligned-box entry and exit distances, clamped to
    ``[near, far]``; an axis-parallel direction component is replaced by
    1e-6."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (xyz_max - rays_o) / vec
    rate_b = (xyz_min - rays_o) / vec
    t_min = torch.minimum(rate_a, rate_b).amax(-1).clamp(near, far)
    t_max = torch.maximum(rate_a, rate_b).amin(-1).clamp(near, far)
    return t_min, t_max


def sample_pts_on_rays_fixed(rays_o, rays_d, xyz_min, xyz_max, near, far,
                             stepdist, n_samples: int):
    """Bounded-scene sampling as a fixed ``[N, K]`` lattice: ray r gets
    ``ceil((t_max - t_min) * |d| / stepdist)`` samples from its own entry
    point, ``stepdist`` apart along the unit direction; the rest, and the
    points outside the box, are marked invalid (``far`` is overridden by
    1e9, as the reference does). Returns (pts ``[N,K,3]``, valid ``[N,K]``,
    t_min ``[N]``)."""
    t_min, t_max = ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, 1e9)
    rnorm = torch.linalg.norm(rays_d, dim=-1)
    n_per_ray = torch.clamp_min(
        torch.ceil((t_max - t_min) * rnorm / stepdist), 1.0)
    rays_start = rays_o + rays_d * t_min[:, None]
    rays_unit = rays_d / rnorm[:, None]
    k = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)
    pts = rays_start[:, None, :] \
        + rays_unit[:, None, :] * (stepdist * k)[None, :, None]
    in_count = k[None, :] < n_per_ray[:, None]
    in_bbox = ((pts >= xyz_min) & (pts <= xyz_max)).all(-1)
    return pts, in_count & in_bbox, t_min


def distortion_loss(weights, s, interval, n_rays=None):
    """The O(K) distortion loss on dense ``[N, K]`` weights:
    ``(sum 2 w_k (s_k Wex_k - WSex_k) + interval/3 sum w_k^2) / N`` with the
    exclusive prefix sums ``Wex`` / ``WSex`` of each ray. Masked samples
    carry weight 0 and add nothing."""
    n = weights.shape[0] if n_rays is None else n_rays
    ws = weights * s
    w_prefix = torch.cumsum(weights, dim=-1) - weights
    ws_prefix = torch.cumsum(ws, dim=-1) - ws
    loss_bi = 2.0 * weights * (s * w_prefix - ws_prefix)
    loss_uni = (1.0 / 3.0) * interval * weights ** 2
    return (loss_bi.sum() + loss_uni.sum()) / n


def total_variation_grad(grid, wx, wy, wz, sparse_grad=None):
    """Gradient of the clamped total variation of a ``[X,Y,Z,C]`` grid: per
    axis ``w/6 * (clip(g_i - g_{i+1}) + clip(g_i - g_{i-1}))``, a missing
    neighbour adding nothing. ``wx`` weighs the innermost (Z) axis and ``wz``
    the outermost (X), the reference kernel's convention. With
    ``sparse_grad``, voxels whose gradient there is zero get none.

    Built from slices: one clamped difference per axis feeds both of its
    voxels (``clip(-d) = -clip(d)``), so there is no wrapped copy of the
    grid and no boundary mask."""
    tv = torch.zeros_like(grid)
    for axis, w in ((2, wx / 6.0), (1, wy / 6.0), (0, wz / 6.0)):
        n = grid.shape[axis]
        if n < 2:
            continue
        d = (grid.narrow(axis, 0, n - 1) - grid.narrow(axis, 1, n - 1))
        d = d.clamp_(-1.0, 1.0).mul_(w)
        tv.narrow(axis, 0, n - 1).add_(d)
        tv.narrow(axis, 1, n - 1).sub_(d)
        del d
    if sparse_grad is not None:
        tv.masked_fill_(sparse_grad == 0, 0.0)
    return tv
