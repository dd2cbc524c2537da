"""Volume-rendering math on dense ``[rays, samples]`` tensors (torch).

As in the JAX package, the reference's ragged sample compactions are
folded into the alphas: a dropped sample behaves exactly as alpha = 0.
Early ray termination (transmittance < 1e-3) zeroes the weights after the
break and fixes ``alphainv_last`` at the break point.
"""

from __future__ import annotations

import torch

EARLY_TERM_THRES = 1e-3


def softplus(x):
    """``log(1 + exp(x))`` in the overflow-free ``max(x,0) + log1p(exp(-|x|))``
    form (the same formula the sweep kernel evaluates)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


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


def sample_ndc_pts_on_rays(rays_o, rays_d, n_samples: int):
    """Fixed-count equidistant NDC sampling ``p_k = o + d * k/(K-1)``:
    ``[N, K, 3]``."""
    dist = torch.arange(n_samples, dtype=rays_o.dtype,
                        device=rays_o.device) / (n_samples - 1)
    return rays_o[:, None, :] + rays_d[:, None, :] * dist[None, :, None]
