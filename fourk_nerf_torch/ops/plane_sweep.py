"""NDC plane sweep, eval form: the plain PyTorch version of the sweep kernel.

In NDC every ray of the MPI model meets grid plane k at sample k, and its
grid-space xy position there is affine in k: ``pos(k) = a + b*k``. The
sweep marches the planes in order and, per plane, takes a bilinear sample
of the packed ``[density | k0 | mask]`` grid (four taps), an exact
nearest-neighbour free-space mask from the mask channel, softplus raw2alpha
with the per-plane ``act_shift``, the rgbnet MLP on the surviving samples,
and the front-to-back composite. Same semantics as the JAX package's
``plane_sweep.sweep_all_tiles`` / ``pallas_sweep._sweep_kernel``; the
TPU's patch and hat-weight machinery (which exists to avoid gathers) is
replaced by plain gathers, and a mask whose resolution differs from the
grid's is nearest-resampled onto the grid first, as the Pallas kernel does.
With a bfloat16 grid the sweep rounds where the Pallas kernel does under
``use_bf16``: the bilinear x weights (it interpolates along x with a bf16
matmul) and the MLP's inputs, weights and hidden activations.

:func:`sweep_plain` is what ``ops.cuda_sweep.sweep`` runs for CPU tensors,
and what the kernel is held against on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from fourk_nerf_torch.device import as_tensor, resolve_device
from fourk_nerf_torch.models import common, dmpigo
from fourk_nerf_torch.ops import rays as ray_ops, render


@dataclasses.dataclass(frozen=True)
class PackedGrid:
    """``packed [Z, X, Y, Cp]`` (density, k0, mask, zero padding),
    ``act_shift [Z]`` float32, and the mask channel's index."""

    packed: torch.Tensor
    act_shift: torch.Tensor
    mask_ch: int


def nearest_resample_mask(mask, shape):
    """Nearest resample of a bool ``[mX, mY, mZ]`` mask onto ``shape``
    (align_corners mapping, round half to even)."""
    idx = []
    for d in range(3):
        m, n = mask.shape[d], shape[d]
        if n == 1 or m == 1:
            idx.append(torch.zeros(n, dtype=torch.long, device=mask.device))
        else:
            idx.append(torch.round(
                torch.arange(n, dtype=torch.float32, device=mask.device)
                * (m - 1) / (n - 1)).long())
    return mask[idx[0]][:, idx[1]][:, :, idx[2]]


def pack_grids(params: dict, buffers: dict, *,
               dtype=torch.float32) -> PackedGrid:
    """Plane-major packed grid: channel 0 density, 1..C k0, C+1 the 0/1
    mask, zero-padded to a multiple of 8 channels."""
    density, k0 = params["density"], params["k0"]
    X, Y, Z, C = k0.shape
    mask = buffers["mask_cache"]
    if tuple(mask.shape) != (X, Y, Z):
        mask = nearest_resample_mask(mask, (X, Y, Z))
    cp = C + 2
    Cp = cp + (-cp) % 8
    packed = torch.zeros((Z, X, Y, Cp), dtype=dtype, device=density.device)
    packed[..., 0:1] = density.permute(2, 0, 1, 3)
    packed[..., 1:1 + C] = k0.permute(2, 0, 1, 3)
    packed[..., 1 + C] = mask.permute(2, 0, 1)
    act_shift = buffers["act_shift"].reshape(-1).to(torch.float32).contiguous()
    return PackedGrid(packed, act_shift, 1 + C)


def affine_coeffs(rays_o, rays_d, xyz_min, xyz_max, sizes, n_samples: int):
    """Grid-space xy position of sample k: ``pos(k) = a + b * k``."""
    a = (rays_o[..., :2] - xyz_min[:2]) / (xyz_max[:2] - xyz_min[:2]) \
        * (sizes - 1)
    b = (rays_d[..., :2] / (xyz_max[:2] - xyz_min[:2])) * (sizes - 1) \
        / (n_samples - 1)
    return a, b


def prepare_frame(cfg, H: int, W: int, K, c2w, *, device,
                  inverse_y: bool = False, flip_x: bool = False,
                  flip_y: bool = False):
    """Per-ray sweep inputs for one camera, row-major over pixels:
    ``a, b [H*W, 2]`` and the viewdir embedding ``vde [H*W, E]``."""
    ro, rd, vd = ray_ops.get_rays_of_a_view(
        H, W, K, c2w, ndc=True, inverse_y=inverse_y, flip_x=flip_x,
        flip_y=flip_y, device=device)
    X, Y, Z = cfg.world_size
    sizes = torch.tensor([X, Y], dtype=torch.float32, device=device)
    a, b = affine_coeffs(ro, rd, as_tensor(cfg.xyz_min, device),
                         as_tensor(cfg.xyz_max, device), sizes, Z)
    vde = ray_ops.positional_encoding(vd, cfg.viewbase_pe)
    return (a.reshape(-1, 2).contiguous(), b.reshape(-1, 2).contiguous(),
            vde.reshape(H * W, -1).contiguous())


def assemble(rgb, depth, ail, H: int, W: int, bg: float) -> dict:
    """Per-ray sweep outputs -> ``[H, W, ...]`` maps."""
    feat = rgb.reshape(H, W, 3)
    a = ail.reshape(H, W)
    return {"rgb_feature": feat, "rgb_marched": feat + a[..., None] * bg,
            "depth": depth.reshape(H, W), "alphainv_last": a}


def mlp_layers(rgbnet: dict):
    """``{w0, b0, ...}`` -> [(w [Cin, W], b [W]), ...] as float32."""
    return [(rgbnet[f"w{i}"].float(), rgbnet[f"b{i}"].float())
            for i in range(len(rgbnet) // 2)]


_RAY_CHUNK = 1 << 18


def sweep_plain(packed, act_shift, a, b, vde, mlp, *, Xl: int, Yl: int,
                mask_ch: int, k0_dim: int, interval: float,
                fast_thres: float, spatial_pe: int, act_type: str,
                stats: dict | None = None):
    """Plain sweep over rays ``a, b [R, 2]``, ``vde [R, E]``.

    ``packed [Z, X, Y, Cp]`` float32 or bfloat16 (read as float32),
    ``act_shift [Z]``, ``mlp`` a list of (w, b). A bfloat16 grid also sets
    the compute type, as ``use_bf16`` does in the JAX kernel: the bilinear
    x weights and the MLP's inputs, weights and hidden activations are
    rounded to bfloat16; products accumulate in float32 and the y weights,
    biases and composite stay float32. Returns
    (rgb_feature [R,3], depth [R], alphainv_last [R]). When ``stats`` is a
    dict, it receives ``samples`` (in-bounds live (ray, plane) pairs) and
    ``mlp_samples`` (pairs with a non-zero composite weight, the only ones
    whose MLP output is used). Rays go in chunks of ``_RAY_CHUNK`` to bound
    the per-plane temporaries."""
    R = a.shape[0]
    rgb = torch.zeros((R, 3), dtype=torch.float32, device=a.device)
    depth = torch.zeros(R, dtype=torch.float32, device=a.device)
    ail = torch.ones(R, dtype=torch.float32, device=a.device)
    n_samp = torch.zeros((), dtype=torch.long, device=a.device)
    n_mlp = torch.zeros((), dtype=torch.long, device=a.device)
    rnd = round_bf16 if packed.dtype == torch.bfloat16 else (lambda t: t)
    mlp = [(rnd(w), bias) for w, bias in mlp]
    for s in range(0, R, _RAY_CHUNK):
        sl = slice(s, min(s + _RAY_CHUNK, R))
        ns, nm = _sweep_chunk(
            packed, act_shift, a[sl], b[sl], vde[sl], mlp, rgb[sl],
            depth[sl], ail[sl], Xl=Xl, Yl=Yl, mask_ch=mask_ch, k0_dim=k0_dim,
            interval=interval, fast_thres=fast_thres, spatial_pe=spatial_pe,
            act=common.activation(act_type), rnd=rnd)
        n_samp += ns
        n_mlp += nm
    if stats is not None:
        stats["samples"] = int(n_samp)
        stats["mlp_samples"] = int(n_mlp)
    return rgb, depth, ail


def round_bf16(t):
    """Round float32 values to the nearest bfloat16, kept as float32."""
    return t.to(torch.bfloat16).float()


def _sweep_chunk(packed, act_shift, a, b, vde, mlp, rgb, depth, t, *, Xl,
                 Yl, mask_ch, k0_dim, interval, fast_thres, spatial_pe, act,
                 rnd):
    """Sweep one ray chunk; accumulates into the ``rgb, depth, t`` views.
    ``rnd`` rounds the x weights and the MLP's inputs and hidden
    activations to the compute type."""
    Z, X, Y, Cp = packed.shape
    flat = packed.reshape(Z, X * Y, Cp)
    n_samp = torch.zeros((), dtype=torch.long, device=a.device)
    n_mlp = torch.zeros((), dtype=torch.long, device=a.device)
    for k in range(Z):
        kf = float(k)
        px = a[:, 0] + b[:, 0] * kf
        py = a[:, 1] + b[:, 1] * kf
        live = ((px >= 0) & (px <= Xl - 1) & (py >= 0) & (py <= Yl - 1)
                & (t >= render.EARLY_TERM_THRES))
        idx = live.nonzero().squeeze(1)
        n_samp += idx.numel()
        px, py = px[idx], py[idx]
        x0f, y0f = torch.floor(px), torch.floor(py)
        fx, fy = px - x0f, py - y0f
        x0, y0 = x0f.long(), y0f.long()
        x1 = torch.clamp_max(x0 + 1, X - 1)
        y1 = torch.clamp_max(y0 + 1, Y - 1)
        plane = flat[k]
        wx0, wx1 = rnd(1.0 - fx)[:, None], rnd(fx)[:, None]
        # x-interpolated rows at the two y taps, then the y blend
        r0 = wx0 * plane[x0 * Y + y0].float() + wx1 * plane[x1 * Y + y0].float()
        r1 = wx0 * plane[x0 * Y + y1].float() + wx1 * plane[x1 * Y + y1].float()
        wy0, wy1 = 1.0 - fy, fy
        samp = wy0[:, None] * r0 + wy1[:, None] * r1
        # exact nearest mask: the y taps within 1/2 voxel select x-bilerps
        # of the 0/1 mask; floor(. + 0.5) of that is the nearest x tap
        mval = torch.floor(torch.floor(wy0 + 0.5) * r0[:, mask_ch]
                           + torch.floor(wy1 + 0.5) * r1[:, mask_ch] + 0.5)
        alpha = render.raw2alpha(samp[:, 0], act_shift[k], interval)
        zero = torch.zeros_like(alpha)
        alpha = torch.where(mval > 0.5, alpha, zero)
        if fast_thres > 0:
            alpha = torch.where(alpha > fast_thres, alpha, zero)
        tc = t[idx]
        w = tc * alpha
        if fast_thres > 0:
            w = torch.where(w > fast_thres, w, zero)
        t[idx] = tc * (1.0 - alpha)
        sel = (w > 0).nonzero().squeeze(1)
        n_mlp += sel.numel()
        ridx = idx[sel]
        pe_spa = torch.stack([
            torch.full((sel.numel(),), 2.0 * kf / max(Z - 1, 1) - 1.0,
                       device=a.device),
            py[sel] / (Yl - 1) * 2.0 - 1.0,
            px[sel] / (Xl - 1) * 2.0 - 1.0,
        ], dim=-1)
        h = rnd(torch.cat([samp[sel, 1:1 + k0_dim],
                           ray_ops.positional_encoding(pe_spa, spatial_pe),
                           vde[ridx]], dim=-1))
        for li, (wl, bl) in enumerate(mlp):
            h = h @ wl + bl
            if li < len(mlp) - 1:
                h = rnd(act(h))
        ws = w[sel]
        rgb.index_add_(0, ridx, ws[:, None] * torch.sigmoid(h))
        depth.index_add_(0, ridx, ws * ((kf + 0.5) / Z))
    return n_samp, n_mlp


def render_frame(cfg, params, buffers, H: int, W: int, K, c2w, *,
                 stepsize: float, bg: float, use_bf16: bool = False,
                 device=None, packed: PackedGrid | None = None,
                 inverse_y: bool = False, flip_x: bool = False,
                 flip_y: bool = False) -> dict:
    """Full-frame render through :func:`sweep_plain` (any device)."""
    if not dmpigo.plane_aligned_ok(cfg, stepsize, ndc=True):
        raise ValueError("the plane sweep needs the plane-aligned NDC setup")
    dev = resolve_device(device)
    if packed is None:
        packed = pack_grids(params, buffers,
                            dtype=torch.bfloat16 if use_bf16 else torch.float32)
    a, b, vde = prepare_frame(cfg, H, W, K, c2w, device=dev,
                              inverse_y=inverse_y, flip_x=flip_x,
                              flip_y=flip_y)
    X, Y, _ = cfg.world_size
    rgb, depth, ail = sweep_plain(
        packed.packed, packed.act_shift, a, b, vde,
        mlp_layers(params["rgbnet"]), Xl=X, Yl=Y, mask_ch=packed.mask_ch,
        k0_dim=cfg.k0_dim, interval=float(stepsize * cfg.voxel_size_ratio),
        fast_thres=float(cfg.fast_color_thres), spatial_pe=cfg.spatial_pe,
        act_type=cfg.act_type)
    return assemble(rgb, depth, ail, H, W, bg)
