"""The reference's StyleGAN3-heritage ops (torch).

The port of the JAX package's ``ops/stylegan.py``: the reference ships
them as CUDA plugins under torch_utils/ops; the JAX package writes them as
XLA functions (no Pallas kernel), and so does the port, as plain torch ops:

- :func:`bias_act` -- torch_utils/ops/bias_act.py (9 activations with
  gain and clamp);
- :func:`upfirdn2d` -- torch_utils/ops/upfirdn2d.py (upsample, FIR filter,
  downsample), with :func:`upsample2d` / :func:`downsample2d`;
- :func:`filtered_lrelu` -- torch_utils/ops/filtered_lrelu.py (upsample,
  bias, leaky ReLU, clamp, downsample);
- :func:`hash_encode` -- torch_utils/ops/hash_sample.py (the
  multiresolution hash grid; dormant in the reference);
- :func:`topp_masking` -- torch_utils/ops/nerf_utils.py (the top-p weight
  mask).

Tensors are NCHW, as the reference's. Gradients come from autograd.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from fourk_nerf_torch.device import resolve_device


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


_ACTS = {  # torch_utils/ops/bias_act.py:21-31: (function, default gain)
    "linear": (lambda x: x, 1.0),
    "relu": (torch.relu, math.sqrt(2.0)),
    "lrelu": (lambda x: F.leaky_relu(x, 0.2), math.sqrt(2.0)),
    "tanh": (torch.tanh, 1.0),
    "sigmoid": (torch.sigmoid, 1.0),
    "elu": (F.elu, 1.0),
    "selu": (F.selu, 1.0),
    "softplus": (_softplus, 1.0),
    "swish": (lambda x: x * torch.sigmoid(x), math.sqrt(2.0)),
}


def bias_act(x, b=None, *, dim: int = 1, act: str = "linear", alpha=None,
             gain=None, clamp=None):
    """Bias along ``dim``, the activation (``alpha``: the leaky slope of
    ``lrelu``), the gain (the activation's default when None), then a
    clamp to ``[-clamp, clamp]`` when ``clamp`` is not negative."""
    fn, def_gain = _ACTS[act]
    gain = def_gain if gain is None else gain
    if b is not None:
        shape = [1] * x.ndim
        shape[dim] = -1
        x = x + b.reshape(shape)
    x = F.leaky_relu(x, alpha) if act == "lrelu" and alpha is not None \
        else fn(x)
    if gain != 1.0:
        x = x * gain
    if clamp is not None and clamp >= 0:
        x = x.clamp(-clamp, clamp)
    return x


def setup_filter(f, normalize: bool = True, gain: float = 1.0,
                 device=None):
    """A 2D FIR filter from a 1D or 2D tap list (a 1D list ``f`` becomes
    ``outer(f, f)``), normalised to sum 1 and scaled by ``gain``, float32 on
    ``device`` (default ``cuda``)."""
    f = torch.as_tensor(np.asarray(f, dtype=np.float32),
                        device=resolve_device(device))
    if f.ndim == 0:
        f = f[None]
    if f.ndim == 1:
        f = torch.outer(f, f)
    if normalize:
        f = f / f.sum()
    return f * gain


def upfirdn2d(x, f, up: int = 1, down: int = 1, padding=0,
              gain: float = 1.0):
    """``x [N, C, H, W]`` zero-stuffed by ``up`` (``up - 1`` zeros after
    each sample, the last included), padded by ``padding`` (``px0, px1,
    py0, py1``, or one int; a negative pad crops), convolved with the FIR
    ``f`` (a true convolution: the flipped filter correlated, one channel
    at a time) and subsampled by ``down``: the JAX package's one
    ``conv_general_dilated`` with lhs dilation, as zero-stuffing,
    ``F.pad`` and a grouped strided ``F.conv2d``."""
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    px0, px1, py0, py1 = padding
    n, c, h, w = x.shape
    if up > 1:
        z = x.new_zeros((n, c, h * up, w * up))
        z[:, :, ::up, ::up] = x
        x = z
    x = F.pad(x, (px0, px1, py0, py1))
    f = torch.as_tensor(f, dtype=x.dtype, device=x.device)
    kern = f.flip(0, 1)[None, None].expand(c, 1, *f.shape)
    y = F.conv2d(x, kern, stride=down, groups=c)
    return y * gain if gain != 1.0 else y


def upsample2d(x, f, up: int = 2, gain: float = 1.0):
    fh = f.shape[-1]
    p0, p1 = (fh + up - 1) // 2, (fh - up) // 2
    return upfirdn2d(x, f, up=up, padding=(p0, p1, p0, p1),
                     gain=gain * up * up)


def downsample2d(x, f, down: int = 2, gain: float = 1.0):
    fh = f.shape[-1]
    p0, p1 = (fh - down + 1) // 2, (fh - down) // 2
    return upfirdn2d(x, f, down=down, padding=(p0, p1, p0, p1), gain=gain)


def filtered_lrelu(x, fu=None, fd=None, b=None, *, up: int = 2,
                   down: int = 2, padding=0, gain: float = math.sqrt(2.0),
                   slope: float = 0.2, clamp=None):
    """StyleGAN3's filtered leaky ReLU (torch_utils/ops/filtered_lrelu.py):
    upsample by ``up`` through ``fu`` (gain ``up^2``), bias, leaky ReLU of
    ``slope`` times ``gain``, clamp, downsample by ``down`` through ``fd``;
    a filter that is None is the 1-tap identity."""
    one = torch.ones((1, 1), dtype=x.dtype, device=x.device)
    fu = one if fu is None else fu
    fd = one if fd is None else fd
    if isinstance(padding, int):
        padding = (padding, padding, padding, padding)
    x = upfirdn2d(x, fu, up=up, padding=padding, gain=float(up * up))
    x = bias_act(x, b, dim=1, act="lrelu", alpha=slope, gain=gain,
                 clamp=clamp)
    return upfirdn2d(x, fd, down=down)


_PRIMES = (1, 2654435761, 805459861)  # uint32; products wrap mod 2^32
_U32 = 0xFFFFFFFF


def hash_index(corner, table_size: int):
    """``[M]`` int64 table rows of the integer corners ``[M, 3]``:
    ``(x p0 ^ y p1 ^ z p2) mod table_size`` in uint32 arithmetic, as the
    JAX package computes it. Each product is taken in int64 and masked to
    its low 32 bits (a corner times a prime stays below 2^63 for any
    corner under 2^31)."""
    h = (corner[:, 0] * _PRIMES[0]) & _U32
    for axis in (1, 2):
        h = h ^ ((corner[:, axis] * _PRIMES[axis]) & _U32)
    return h % table_size


def hash_encode(xyz01, table, *, n_levels: int = 16, base_res: int = 16,
                per_level_scale: float = 1.3819129,
                features_per_level: int = 2):
    """The multiresolution hash grid: ``xyz01 [M, 3]`` in ``[0, 1]``,
    ``table [n_levels, T, F]``; returns ``[M, n_levels * F]``, each level
    the trilinear blend of its 8 corners' entries. A corner's entry is
    ``(x * p0 ^ y * p1 ^ z * p2) mod T`` with the uint32 primes and the
    JAX package's uint32 wraparound (:func:`hash_index`)."""
    L, T, Fd = table.shape
    if L != n_levels or Fd != features_per_level:
        raise ValueError(f"table {tuple(table.shape)} for {n_levels} levels "
                         f"of {features_per_level} features")
    dev = xyz01.device
    outs = []
    for lvl in range(n_levels):
        res = int(np.floor(base_res * per_level_scale ** lvl))
        pos = xyz01 * res
        fl = torch.floor(pos)
        i0 = fl.long()
        frac = pos - fl
        feat = torch.zeros((xyz01.shape[0], Fd), dtype=table.dtype,
                           device=table.device)
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    corner = torch.tensor([cx, cy, cz], device=dev)
                    idx = hash_index(i0 + corner, T)
                    w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
                    feat = feat + w[:, None] * table[lvl][idx]
        outs.append(feat)
    return torch.cat(outs, dim=-1)


def init_hash_table(n_levels: int = 16, log2_table_size: int = 19,
                    features_per_level: int = 2, scale: float = 1e-4, *,
                    generator: torch.Generator, device=None):
    """``[n_levels, 2^log2_table_size, features_per_level]`` uniform in
    ``[-scale, scale]``, drawn from ``generator`` on the host."""
    t = torch.rand((n_levels, 2 ** log2_table_size, features_per_level),
                   generator=generator) * (2 * scale) - scale
    return t.to(resolve_device(device))


def topp_masking(weights, p: float = 0.99):
    """Per ray of ``weights [N, K]``, keep the smallest set of samples,
    largest first, whose weights reach ``p`` of the total
    (torch_utils/ops/nerf_utils.py:24-38); a stable sort, as JAX's, so
    equal weights keep their order. Returns bool ``[N, K]``."""
    order = torch.argsort(-weights, dim=-1, stable=True)
    sorted_w = torch.gather(weights, -1, order)
    total = sorted_w.sum(-1, keepdim=True)
    cum = torch.cumsum(sorted_w, dim=-1)
    keep_sorted = (cum - sorted_w) < p * total
    return torch.empty_like(keep_sorted).scatter_(-1, order, keep_sorted)
