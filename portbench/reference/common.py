"""Plain float32 building blocks of the benchmark's reference.

A frozen copy, in plain PyTorch, of the published 4K-NeRF math (frozoul/
4K-NeRF ``lib/dmpigo.py``, ``lib/dvgo.py``, ``lib/utils.py``,
``lib/masked_adam.py``): camera rays and the NDC warp, the dispatch to a
model family's module (``reference/<family>.py``), trilinear and plane-aligned bilinear grid sampling, the nearest occupancy
lookup, softplus raw2alpha, transmittance weights with early termination,
the MLP, the positional encoding. Nothing here imports the program.

The rounding hooks serve the controls: ``rnd`` rounds a value to a
storage type (identity for float32, :func:`round_fp8` for the render
cells' control) and ``mm`` multiplies two matrices (``torch.matmul``, or
:func:`mm_tf32` for the training cells' control).
"""

from __future__ import annotations

import contextlib
import importlib

import numpy as np
import torch

EARLY_TERM_THRES = 1e-3


@contextlib.contextmanager
def full_fp32():
    """Matmuls and cuDNN convolutions in full float32 (TF32 off) inside the
    block; the previous settings restored after."""
    matmul = torch.backends.cuda.matmul.allow_tf32
    conv = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = conv


def identity(x):
    return x


def round_fp8(x):
    """float32 values rounded to float8 e4m3 (saturated at +-448), kept as
    float32: the storage of an fp8 path."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)


def round_tf32(x):
    """float32 values rounded to TF32 (10 mantissa bits, to nearest even),
    kept as float32: what a tensor core reads of a TF32 operand."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0xFFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


class _MatmulTF32(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32, forward and backward
    (each product of the backward rounds its operands too), accumulated in
    float32."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = g @ round_tf32(b).transpose(-1, -2)
        gb = round_tf32(a).reshape(-1, a.shape[-1]).t() \
            @ g.reshape(-1, g.shape[-1])
        return ga, gb


def mm_tf32(a, b):
    return _MatmulTF32.apply(a, b)


def matmul(a, b):
    return a @ b


# --- cameras -----------------------------------------------------------------

def get_rays(H: int, W: int, K, c2w, device):
    """Pixel-centre rays of an OpenGL camera (-z forward): (rays_o,
    rays_d, viewdirs), each ``[H, W, 3]``."""
    K = torch.as_tensor(np.asarray(K, np.float32), device=device)
    c2w = torch.as_tensor(np.asarray(c2w, np.float32), device=device)
    j, i = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=device),
                          torch.arange(W, dtype=torch.float32, device=device),
                          indexing="ij")
    i, j = i + 0.5, j + 0.5
    dirs = torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], -1)
    rot = c2w[:3, :3]
    rays_d = (dirs[..., 0:1] * rot[:, 0] + dirs[..., 1:2] * rot[:, 1]
              + dirs[..., 2:3] * rot[:, 2])
    rays_o = c2w[:3, 3].expand(rays_d.shape)
    viewdirs = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    return rays_o, rays_d, viewdirs


def ndc_rays(H: int, W: int, focal: float, near: float, rays_o, rays_d):
    """The forward-facing NDC warp (LLFF)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d
    o0 = -1.0 / (W / (2.0 * focal)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (H / (2.0 * focal)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]
    d0 = -1.0 / (W / (2.0 * focal)) * (
        rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    d1 = -1.0 / (H / (2.0 * focal)) * (
        rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    d2 = -2.0 * near / rays_o[..., 2]
    return torch.stack([o0, o1, o2], -1), torch.stack([d0, d1, d2], -1)


def view_rays(cam: dict, K, c2w, device):
    """(rays_o, rays_d, viewdirs) ``[H*W, 3]`` of one view of a
    configuration's camera (``ndc`` for a forward-facing scene)."""
    H, W = cam["H"], cam["W"]
    ro, rd, vd = get_rays(H, W, K, c2w, device)
    if cam.get("ndc"):
        ro, rd = ndc_rays(H, W, float(K[0][0]), 1.0, ro, rd)
    return ro.reshape(-1, 3), rd.reshape(-1, 3), vd.reshape(-1, 3)


def positional_encoding(x, n_freqs: int):
    if n_freqs == 0:
        return x
    freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = (x[..., None] * freqs).reshape(*x.shape[:-1], x.shape[-1] * n_freqs)
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)


# --- model families ----------------------------------------------------------

def family(name: str):
    """The reference's module of a model family (``reference/<name>.py``):
    its grid size, samples, density, colour and TV weights."""
    return importlib.import_module(f"portbench.reference.{name}")


def world_size(name: str, model: dict) -> tuple:
    return family(name).world_size(model)


def rgbnet_dims(name: str, model: dict) -> list:
    w = model["rgbnet_width"]
    return ([family(name).rgbnet_in(model)] + [w] * (model["rgbnet_depth"] - 1)
            + [3])


# --- sampling and compositing ------------------------------------------------

class _Softplus(torch.autograd.Function):
    """``max(x,0) + log1p(exp(-|x|))`` with the derivative ``sigmoid(x)``."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        return grad * torch.sigmoid(x)


def raw2alpha(density, shift, interval):
    return 1.0 - torch.exp(-_Softplus.apply(density + shift) * interval)


def alpha2weight(alpha, valid):
    """(weights ``[N,K]``, alphainv_last ``[N]``): transmittance weights,
    cut where the transmittance falls under 1e-3."""
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    t_post = torch.cumprod(1.0 - alpha, dim=-1)
    T = torch.cat([torch.ones_like(t_post[:, :1]), t_post[:, :-1]], dim=-1)
    alive = T >= EARLY_TERM_THRES
    weights = torch.where(alive, T * alpha, torch.zeros_like(alpha))
    last = torch.clamp_min(alive.sum(-1) - 1, 0)
    ail = torch.gather(t_post, -1, last[:, None])[:, 0]
    ail = torch.where(alive[:, 0], ail, torch.ones_like(ail))
    return weights, ail


def bilinear_on_planes(grid, xy, plane):
    """Bilinear sample of ``grid [X,Y,Z,C]`` on plane ``plane [M]`` at
    normalised ``xy [M, 2]`` (align_corners), zeros outside: ``[M, C]``."""
    X, Y, Z, C = grid.shape
    dev = grid.device
    pos = xy * torch.tensor([X - 1.0, Y - 1.0], device=dev)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    flat = grid.reshape(-1, C)
    sizes = torch.tensor([X, Y], device=dev)
    out = torch.zeros((xy.shape[0], C), dtype=grid.dtype, device=dev)
    for cx in (0, 1):
        for cy in (0, 1):
            corner = torch.tensor([cx, cy], device=dev)
            idx = i0 + corner
            ok = ((idx >= 0) & (idx < sizes)).all(-1)
            w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
            c = torch.minimum(torch.clamp_min(idx, 0), sizes - 1)
            fidx = (c[:, 0] * Y + c[:, 1]) * Z + plane
            out = out + torch.where(ok, w, torch.zeros_like(w))[:, None] \
                * flat[fidx]
    return out


def trilinear(grid, ind01):
    """Trilinear sample of ``grid [X,Y,Z,C]`` at ``[M, 3]`` normalised
    coordinates (align_corners), zeros outside."""
    X, Y, Z, C = grid.shape
    dev = grid.device
    sizes = torch.tensor([X, Y, Z], device=dev)
    pos = ind01 * (sizes.to(ind01.dtype) - 1)
    i0f = torch.floor(pos)
    frac = pos - i0f
    i0 = i0f.long()
    flat = grid.reshape(-1, C)
    out = torch.zeros((pos.shape[0], C), dtype=grid.dtype, device=dev)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = torch.tensor([cx, cy, cz], device=dev)
                idx = i0 + corner
                ok = ((idx >= 0) & (idx < sizes)).all(-1)
                w = torch.where(corner == 1, frac, 1.0 - frac).prod(-1)
                c = torch.minimum(torch.clamp_min(idx, 0), sizes - 1)
                fidx = (c[:, 0] * Y + c[:, 1]) * Z + c[:, 2]
                out = out + torch.where(ok, w, torch.zeros_like(w))[:, None] \
                    * flat[fidx]
    return out


def nearest_mask(mask, xyz, lo, hi):
    """Nearest occupancy lookup (round half to even), False outside."""
    X, Y, Z = mask.shape
    sizes = torch.tensor([X, Y, Z], dtype=xyz.dtype, device=xyz.device)
    scale = (sizes - 1) / (hi - lo)
    ijk = torch.round(xyz * scale + (-lo * scale)).long()
    isz = sizes.long()
    ok = ((ijk >= 0) & (ijk < isz)).all(-1)
    c = torch.minimum(torch.clamp_min(ijk, 0), isz - 1)
    fidx = (c[..., 0] * Y + c[..., 1]) * Z + c[..., 2]
    return mask.reshape(-1)[fidx.reshape(-1)].reshape(fidx.shape) & ok


def ndc_points(rays_o, rays_d, n: int):
    """``o + d * k/(n-1)``, ``k/(n-1)`` divided by a device tensor (true
    division on every device)."""
    k = torch.arange(n, dtype=rays_o.dtype, device=rays_o.device)
    dist = k / torch.full((1,), float(n - 1), device=rays_o.device)
    return rays_o[:, None, :] + rays_d[:, None, :] * dist[None, :, None]


def box_points(rays_o, rays_d, lo, hi, near, stepdist, n: int):
    """Bounded sampling from the box entry, ``stepdist`` apart along the
    unit direction: (pts ``[N,n,3]``, valid ``[N,n]``)."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    ra, rb = (hi - rays_o) / vec, (lo - rays_o) / vec
    t_min = torch.minimum(ra, rb).amax(-1).clamp(near, 1e9)
    t_max = torch.maximum(ra, rb).amin(-1).clamp(near, 1e9)
    rnorm = torch.linalg.norm(rays_d, dim=-1)
    n_per = torch.clamp_min(torch.ceil((t_max - t_min) * rnorm / stepdist),
                            1.0)
    start = rays_o + rays_d * t_min[:, None]
    unit = rays_d / rnorm[:, None]
    k = torch.arange(n, dtype=rays_o.dtype, device=rays_o.device)
    pts = start[:, None, :] + unit[:, None, :] * (stepdist * k)[None, :, None]
    valid = (k[None, :] < n_per[:, None]) & ((pts >= lo) & (pts <= hi)).all(-1)
    return pts, valid


def mlp(params: dict, x, *, rnd=identity, mm=matmul):
    """ReLU MLP ``{w0 [Cin,W], b0, ...}``; ``rnd`` rounds the inputs,
    weights and hidden activations to the compute type."""
    n = len(params) // 2
    x = rnd(x)
    for i in range(n):
        x = mm(x, rnd(params[f"w{i}"])) + params[f"b{i}"]
        if i < n - 1:
            x = rnd(torch.relu(x))
    return x
