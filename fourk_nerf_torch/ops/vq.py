"""The EMA vector-quantisation codebook of DirectQVGO (torch).

The port of the JAX package's ``ops/vq.py`` (after frozoul/4K-NeRF
lib/grid.py:38-103, ``VQGrid``): a projection MLP maps the input features
to the code dimension, each row takes its nearest codebook entry, the
codebook follows exponential moving averages of its clusters (Laplace
smoothed), and the gradient passes straight through to the projection.
The EMA buffers are explicit state, returned by :func:`vq_forward`.

At full width a training batch quantises 4096 rays x 256 planes = 1.05M
rows against 4096 codes: the ``[rows, codes]`` float32 distances take
4.3 GB, and the JAX package's one-hot EMA product as much again. Here the
distances and their argmin are computed under ``no_grad`` (``argmin`` has
no gradient) in chunks of ``ROW_CHUNK`` rows, and the EMA sums are a
``bincount`` and an ``index_add_`` of the rows into their codes: no
one-hot matrix forms. The distance is the JAX formula ``|v|^2 - 2 v.E +
|E|^2`` (not ``torch.cdist``, which may change formula and move ties);
ties take the first index, as ``jnp.argmin``. The EMA sums are added in
another order than the one-hot product (on the card, by atomics): they
agree with it to float32 rounding of a sum.
"""

from __future__ import annotations

import torch

from fourk_nerf_torch.device import resolve_device
from fourk_nerf_torch.models import common

DECAY, EPS = 0.99, 1e-5  # lib/grid.py:39
ROW_CHUNK = 1 << 16      # rows of a distance chunk: 1 GB at 4096 codes


def init_vq(input_dim: int, dim: int, n_embed: int, *,
            generator: torch.Generator, device=None):
    """(params, state): the projection MLP ``[input_dim, dim, dim]`` (its
    final bias drawn too) and the codebook state ``embed [dim, n_embed]``
    (standard normal), ``cluster_size`` zeros and ``embed_avg`` (a copy of
    ``embed``), drawn from ``generator`` on the host."""
    dev = resolve_device(device)
    params = {"project": common.mlp_init([input_dim, dim, dim],
                                         generator=generator, device=dev,
                                         zero_final_bias=False)}
    embed = torch.randn((dim, n_embed), generator=generator).to(dev)
    state = {"embed": embed,
             "cluster_size": torch.zeros(n_embed, device=dev),
             "embed_avg": embed.clone()}
    return params, state


@torch.no_grad()
def nearest_code(flat, embed):
    """``[P]`` int64: the index of the nearest column of ``embed [dim,
    n]`` to each row of ``flat [P, dim]`` by ``|v|^2 - 2 v.E + |E|^2``,
    the first on ties, in chunks of ``ROW_CHUNK`` rows."""
    e2 = (embed ** 2).sum(0, keepdim=True)
    out = torch.empty(flat.shape[0], dtype=torch.long, device=flat.device)
    for s in range(0, flat.shape[0], ROW_CHUNK):
        f = flat[s:s + ROW_CHUNK]
        # |v|^2 - 2 v.E in the product's epilogue: -2 (v.E) is exact, so
        # this rounds as the JAX package's |v|^2 - (2v).E, one pass fewer
        dist = torch.addmm((f ** 2).sum(1, keepdim=True), f, embed,
                           alpha=-2.0)
        dist += e2
        out[s:s + ROW_CHUNK] = torch.argmin(dist, dim=1)
    return out


@torch.no_grad()
def ema_update(state: dict, flat, idx) -> dict:
    """The codebook state after one batch (lib/grid.py:78-96): cluster
    sizes and code sums decayed by ``DECAY``, the batch's counts
    (``bincount``) and row sums (``index_add_``) added, the codes the sums
    over the Laplace-smoothed sizes."""
    n_embed = state["embed"].shape[1]
    counts = torch.bincount(idx, minlength=n_embed).to(flat.dtype)
    sums = torch.zeros((n_embed, flat.shape[1]), dtype=flat.dtype,
                       device=flat.device).index_add_(0, idx, flat)
    cluster_size = state["cluster_size"] * DECAY + (1 - DECAY) * counts
    embed_avg = state["embed_avg"] * DECAY + (1 - DECAY) * sums.T
    n = cluster_size.sum()
    smoothed = (cluster_size + EPS) / (n + n_embed * EPS) * n
    return {"embed": embed_avg / smoothed[None, :],
            "cluster_size": cluster_size, "embed_avg": embed_avg}


def vq_forward(params: dict, state: dict, x, *, training: bool = False):
    """Quantise ``x [..., input_dim]``: (quantised ``[..., dim]`` with the
    straight-through gradient, the commitment ``diff`` (a scalar),
    indices ``[...]``, the new state; ``state`` itself when not
    training)."""
    v = common.mlp_apply(params["project"], x, torch.relu)
    dim = v.shape[-1]
    flat = v.reshape(-1, dim)
    embed = state["embed"]
    idx = nearest_code(flat, embed)
    quantize = embed.T[idx].reshape(v.shape)
    new_state = ema_update(state, flat.detach(), idx) if training else state
    diff = ((quantize.detach() - v) ** 2).mean()
    quantize = v + (quantize - v).detach()  # straight-through
    return quantize, diff, idx.reshape(x.shape[:-1]), new_state
