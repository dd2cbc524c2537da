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
import math

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


# ---------------------------------------------------------------------------
# training forms: the patch sweep under autograd (the JAX package's
# ``sweep_patch_train`` / ``sweep_patch_train_win``), and the native-mask
# float32 frame render of its scored path
# ---------------------------------------------------------------------------

def mask_scale_and_patch(cfg, mask_shape, patch: int):
    """Per-axis index scale from grid units to mask units, and the mask
    window size that covers a ``patch``-wide grid footprint (the JAX
    package's ``plane_sweep.mask_scale_and_patch``)."""
    X, Y, _ = cfg.world_size
    mX, mY = int(mask_shape[0]), int(mask_shape[1])
    sx = (mX - 1) / max(X - 1, 1)
    sy = (mY - 1) / max(Y - 1, 1)
    pm = int(math.ceil(patch * max(sx, sy))) + 4
    pm = max(int(math.ceil(pm / 8.0) * 8), 8)
    return float(sx), float(sy), min(pm, mX, mY)


class _RoundBF16(torch.autograd.Function):
    """Round to bfloat16 going forward, pass the gradient through in
    float32."""

    @staticmethod
    def forward(ctx, x):
        return x.to(torch.bfloat16).to(x.dtype)

    @staticmethod
    def backward(ctx, grad):
        return grad


class _Cumprod(torch.autograd.Function):
    """``torch.cumprod`` along the last axis, with the gradient torch's own
    backward gives, computed by the same ops for inputs with and without
    zero factors alike. Torch's backward reads back whether the input holds
    a zero to choose between the two, which holds the host until the device
    has drained, once in every training step."""

    @staticmethod
    def forward(ctx, x):
        out = torch.cumprod(x, dim=-1)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        if x.shape[-1] <= 1:
            return grad
        cumsum = (x == 0).cumsum(-1)
        # before a row's first zero: the reversed cumsum of out * grad over x
        before = cumsum == 0
        g = ((out * grad).masked_fill(~before, 0.0).flip(-1).cumsum(-1)
             .flip(-1).div_(x.masked_fill(~before, 1.0)))
        # at the first zero: the gradient through the factors up to the next
        mask = cumsum == 1
        idx = mask.max(-1, keepdim=True).indices
        first = torch.zeros_like(mask).scatter_(-1, idx, True) & mask
        mask &= ~first
        g0 = (x.masked_fill(~mask, 1.0).cumprod(-1)
              .mul_(grad.masked_fill(cumsum != 1, 0.0))
              .sum(-1, keepdim=True)
              .mul_(torch.gather(out, -1, (idx - 1).relu_())
                    .masked_fill_(idx == 0, 1.0)))
        return torch.where(before, g, torch.where(first, g0, 0.0))


def _origin(pos, n: int, window: int | None):
    """Start of each (tile, plane)'s ``window``-wide slice of an axis of
    ``n`` cells: ``floor(min over the tile's rays) - 1``, clipped to the
    axis. ``pos [T, R, Z]``; returns ``[T, 1, Z]`` (0 without a window)."""
    if window is None:
        return torch.zeros_like(pos[:, :1, :], dtype=torch.long)
    o = torch.floor(pos.amin(1, keepdim=True)).long() - 1
    return o.clamp(0, max(n - window, 0))


def _hat_taps(p, lo, n: int, window: int | None):
    """The two bilinear taps of positions ``p`` along one axis: indices
    ``i0, i0 + 1`` and weights ``1 - |p - i|`` (the hat weights of the JAX
    sweep), a weight set to 0 where its tap lies outside the slice
    ``[lo, lo + window)`` (outside ``[0, n)`` without a window). Returns
    (i0, i1 clamped into the axis, w0, w1)."""
    f = torch.floor(p)
    fr = p - f
    w0 = 1.0 - fr
    w1 = 1.0 - (fr - 1.0).abs()
    i0 = f.long()
    i1 = i0 + 1
    hi = n if window is None else lo + window
    lo = 0 if window is None else lo
    w0 = torch.where((i0 >= lo) & (i0 < hi), w0, torch.zeros_like(w0))
    w1 = torch.where((i1 >= lo) & (i1 < hi), w1, torch.zeros_like(w1))
    return i0.clamp(0, n - 1), i1.clamp(0, n - 1), w0, w1


def _nearest_tap(p, lo, n: int, window: int | None):
    """The nearest cell of positions ``p`` (ties up, as the JAX sweep's
    one-hot weights select) and whether it lies in ``[lo, lo + window)``
    (``[0, n)`` without a window)."""
    f = torch.floor(p)
    i = f.long() + (p - f >= 0.5).long()
    lo = 0 if window is None else lo
    hi = n if window is None else lo + window
    return i.clamp(0, n - 1), (i >= lo) & (i < hi)


def sweep_all_tiles_train(density, k0, act_shift, mask, a_tiles, b_tiles,
                          vd_tiles, rgbnet: dict, *, cfg, interval: float,
                          patch: int | None, msx: float = 1.0,
                          msy: float = 1.0, mpatch: int | None = None,
                          use_bf16: bool = True, origin=None, bounds=None):
    """Plane sweep of ``T`` ray tiles with per-sample outputs, under
    autograd (the JAX package's ``sweep_all_tiles_train``).

    ``density [X,Y,Z,1]`` and ``k0 [X,Y,Z,C]`` are the grids, or, with
    ``origin = (ox, oy)`` (host ints) and ``bounds = (Xg, Yg)``, their
    window at that origin in a grid of that extent; ``act_shift [Z]``.
    The mask is read in one of the JAX sweep's two modes: CHANNEL when
    ``mask`` has the (window's) grid shape (the nearest mask value from
    the bilinear taps), NATIVE otherwise (the nearest cell at the mask's
    own resolution, grid positions scaled by ``msx``/``msy``, z by the
    nearest plane). ``a_tiles``/``b_tiles [T,R,2]`` give sample k at grid
    position ``a + b*k`` (global units); ``vd_tiles [T,R,3]``.

    As in the JAX sweep, each (tile, plane) reads a ``patch``-wide slice
    of the grid (``mpatch`` of the mask) starting one cell before the
    tile's smallest position, and a tap outside it counts zero; with
    ``patch`` None the whole grid is the slice (zero padding outside).
    With ``use_bf16`` the grid values, the x weights and the MLP run in
    bfloat16 where the JAX sweep casts (``astype(bfloat16)``): grid values
    and x weights rounded, products summed in float32, the MLP's matmuls,
    biases and activations in bfloat16; the gradient of a rounded grid
    value passes through in float32.

    Returns (weights [T,R,Z], alphainv_last [T,R], rgb_feature [T,R,3],
    raw_rgb [T,R,Z,3])."""
    X, Y, Z, C = k0.shape
    Xg, Yg = bounds if bounds is not None else (X, Y)
    dev = a_tiles.device
    channel = tuple(mask.shape) == (X, Y, Z)
    ks = torch.arange(Z, dtype=torch.float32, device=dev)
    pos = a_tiles[:, :, None, :] + b_tiles[:, :, None, :] * ks[:, None]
    px, py = pos[..., 0], pos[..., 1]                        # [T,R,Z] global
    if origin is None:
        lx, ly = px, py
    else:
        lx, ly = px - float(origin[0]), py - float(origin[1])
    ox, oy = _origin(lx, X, patch), _origin(ly, Y, patch)
    x0, x1, wx0, wx1 = _hat_taps(lx, ox, X, patch)
    y0, y1, wy0, wy1 = _hat_taps(ly, oy, Y, patch)
    kz = torch.arange(Z, device=dev)
    taps = torch.stack([(x0 * Y + y0) * Z + kz, (x1 * Y + y0) * Z + kz,
                        (x0 * Y + y1) * Z + kz, (x1 * Y + y1) * Z + kz])
    rnd = _RoundBF16.apply if use_bf16 else (lambda t: t)
    if use_bf16:
        wx0, wx1 = round_bf16(wx0), round_bf16(wx1)
    d = rnd(density.reshape(-1)[taps])                       # [4,T,R,Z]
    f = rnd(k0.reshape(-1, C)[taps])                         # [4,T,R,Z,C]
    dens = wy0 * (wx0 * d[0] + wx1 * d[1]) + wy1 * (wx0 * d[2] + wx1 * d[3])
    feat = (wy0[..., None] * (wx0[..., None] * f[0] + wx1[..., None] * f[1])
            + wy1[..., None] * (wx0[..., None] * f[2]
                                + wx1[..., None] * f[3]))
    with torch.no_grad():
        if channel:
            m = mask.reshape(-1)[taps].float()
            r0 = wx0 * m[0] + wx1 * m[1]
            r1 = wx0 * m[2] + wx1 * m[3]
            mval = torch.floor(torch.floor(wy0 + 0.5) * r0
                               + torch.floor(wy1 + 0.5) * r1 + 0.5)
        else:
            mX, mY, mZ = mask.shape
            pmx, pmy = px * msx, py * msy
            oxm, oym = _origin(pmx, mX, mpatch), _origin(pmy, mY, mpatch)
            ix, okx = _nearest_tap(pmx, oxm, mX, mpatch)
            iy, oky = _nearest_tap(pmy, oym, mY, mpatch)
            zidx = torch.round(ks * (mZ - 1) / max(Z - 1, 1)).long()
            mval = (mask[ix, iy, zidx] & okx & oky).float()
    alpha = render.raw2alpha(dens, act_shift.to(dens.dtype), interval)
    inb = (px >= 0) & (px <= Xg - 1) & (py >= 0) & (py <= Yg - 1)
    zero = torch.zeros_like(alpha)
    alpha = torch.where(inb & (mval > 0.5), alpha, zero)
    if cfg.fast_color_thres > 0:
        alpha = torch.where(alpha > cfg.fast_color_thres, alpha, zero)
    # early termination: a ray stops after the first plane that leaves its
    # transmittance under the threshold (the product before the stop is
    # the same with or without the stop, since it never increases)
    with torch.no_grad():
        t_all = torch.cumprod(1.0 - alpha, dim=-1)
        alive = torch.cat([torch.ones_like(t_all[..., :1], dtype=torch.bool),
                           t_all[..., :-1] >= render.EARLY_TERM_THRES], -1)
    alpha = torch.where(alive, alpha, zero)
    t_post = _Cumprod.apply(1.0 - alpha)
    t_pre = torch.cat([torch.ones_like(t_post[..., :1]), t_post[..., :-1]],
                      dim=-1)
    w = t_pre * alpha
    if cfg.fast_color_thres > 0:
        w = torch.where(w > cfg.fast_color_thres, w, zero)

    T_, R = px.shape[:2]
    kk = torch.full_like(px, 0.0) + (2.0 * ks / max(Z - 1, 1) - 1.0)
    pe_spa = torch.stack([kk, py / (Yg - 1) * 2.0 - 1.0,
                          px / (Xg - 1) * 2.0 - 1.0], dim=-1)
    vde = ray_ops.positional_encoding(vd_tiles, cfg.viewbase_pe)
    h = torch.cat([feat, ray_ops.positional_encoding(pe_spa, cfg.spatial_pe),
                   vde[:, :, None, :].expand(T_, R, Z, vde.shape[-1])], -1)
    act = common.activation(cfg.act_type)
    if use_bf16:
        h = _mlp_bf16(rgbnet, h, act)
    else:
        h = common.mlp_apply(rgbnet, h, act)
    raw_rgb = torch.sigmoid(h)
    rgb_feature = (w[..., None] * raw_rgb).sum(-2)
    return w, t_post[..., -1], rgb_feature, raw_rgb


def _mlp_bf16(rgbnet: dict, h, act):
    """The rgbnet with its input, weights and biases in bfloat16, rounded
    where the JAX sweep's compiled MLP rounds: each layer's product to
    bfloat16, the bias added in float32, a hidden layer's sum rounded to
    bfloat16 again before its activation; the last layer's sum stays
    float32 (XLA drops that rounding before the cast back)."""
    n = len(rgbnet) // 2
    h = h.to(torch.bfloat16)
    for i in range(n):
        w = rgbnet[f"w{i}"].to(torch.bfloat16)
        b = rgbnet[f"b{i}"].to(torch.bfloat16).float()
        h = (h @ w).float() + b
        if i < n - 1:
            h = act(h.to(torch.bfloat16).float()).to(torch.bfloat16)
    return h


def _patch_outputs(w, t_cum, rgb_feature, raw_rgb, Z: int, *, bg: float,
                   bg_noise=None) -> dict:
    """The dense output dict of ``dmpigo.forward`` from one tile's sweep
    outputs (``bg_noise [R,3]`` replaces ``bg`` when given)."""
    w, t_cum, rgb_feature, raw_rgb = w[0], t_cum[0], rgb_feature[0], \
        raw_rgb[0]
    R = w.shape[0]
    back = bg if bg_noise is None else bg_noise
    s = ((torch.arange(Z, dtype=torch.float32, device=w.device) + 0.5)
         / Z)[None, :].expand(R, Z)
    return {"alphainv_last": t_cum, "weights": w,
            "rgb_marched": rgb_feature + t_cum[:, None] * back,
            "rgb_feature": rgb_feature, "raw_rgb": raw_rgb, "n_max": Z,
            "s": s, "depth": (w * s).sum(-1).detach()}


def sweep_patch_train(cfg, params, buffers, rays_o, rays_d, viewdirs, *,
                      stepsize: float, bg: float, bg_noise=None,
                      patch: int = 48, check: bool = True) -> dict:
    """Differentiable render of one pixel patch (rays ``[R, 3]``) by the
    plane sweep, returning the dense dict of ``dmpigo.forward`` (the JAX
    package's ``plane_sweep.sweep_patch_train``, bf16 as the JAX step
    calls it). ``patch`` is the grid slice each plane reads; with
    ``check`` the patch's footprint is held to it and a ``ValueError``
    raised when it does not fit."""
    if not dmpigo.plane_aligned_ok(cfg, stepsize, ndc=True):
        raise ValueError("the plane sweep needs the plane-aligned NDC setup")
    X, Y, Z = cfg.world_size
    dev = rays_o.device
    sizes = torch.tensor([X, Y], dtype=torch.float32, device=dev)
    a, b = affine_coeffs(rays_o, rays_d, as_tensor(cfg.xyz_min, dev),
                         as_tensor(cfg.xyz_max, dev), sizes, Z)
    if check:
        for k in (0.0, float(Z - 1)):
            p = a + b * k
            spread = (p.amax(0) - p.amin(0)).cpu()
            if bool((spread > patch - 3).any()):
                raise ValueError(f"patch footprint {spread.tolist()} exceeds "
                                 f"{patch}")
    mask = buffers["mask_cache"]
    msx, msy, mpatch = mask_scale_and_patch(cfg, mask.shape, patch)
    out = sweep_all_tiles_train(
        params["density"], params["k0"], buffers["act_shift"].reshape(-1),
        mask, a[None], b[None], viewdirs[None], params["rgbnet"], cfg=cfg,
        interval=float(stepsize * cfg.voxel_size_ratio), patch=patch,
        msx=msx, msy=msy, mpatch=mpatch)
    return _patch_outputs(*out, Z, bg=bg, bg_noise=bg_noise)


def sweep_window_origin(a, b, Z: int, X: int, Y: int, window: int):
    """Origin ``(ox, oy)`` (host ints) of the ``window``-wide grid window
    that holds a ray patch's footprint on every plane: ``pos(k) = a + b*k``
    is affine in k, so the extremes lie on planes 0 and Z - 1."""
    p1 = a + b * float(Z - 1)
    mn = torch.minimum(a.reshape(-1, 2).amin(0), p1.reshape(-1, 2).amin(0))
    o = torch.floor(mn).long() - 1
    return (int(o[0].clamp(0, X - window)), int(o[1].clamp(0, Y - window)))


def sweep_patch_train_win(cfg, win_params, win_buffers, a, b, viewdirs, *,
                          origin, interval: float, patch: int, bg: float,
                          bg_noise=None) -> dict:
    """:func:`sweep_patch_train` on a grid window (the JAX package's
    ``sweep_patch_train_win``): ``win_params`` holds the density and k0
    windows at ``origin`` and the rgbnet, ``win_buffers`` the act_shift and
    the mask window (the mask must have the grid's resolution); ``a, b``
    are the global affine coefficients. The slices shift by the integer
    origin, so the taps, their order and the result are those of the full
    grid's sweep."""
    X, Y, Z = cfg.world_size
    mask = win_buffers["mask_cache"]
    if tuple(mask.shape) != tuple(win_params["density"].shape[:3]):
        raise NotImplementedError(
            "the windowed step needs a mask at the grid's resolution (the "
            "caller takes sweep_patch_train)")
    out = sweep_all_tiles_train(
        win_params["density"], win_params["k0"],
        win_buffers["act_shift"].reshape(-1), mask, a[None], b[None],
        viewdirs[None], win_params["rgbnet"], cfg=cfg, interval=interval,
        patch=patch, origin=origin, bounds=(X, Y))
    return _patch_outputs(*out, Z, bg=bg, bg_noise=bg_noise)


_NATIVE_SAMPLES = 1 << 21  # (ray, plane) pairs a chunk of the native render


@torch.no_grad()
def render_frame_native(cfg, params, buffers, H: int, W: int, K, c2w, *,
                        stepsize: float, bg: float, device=None) -> dict:
    """Full-frame float32 render that reads the mask at its own resolution
    (the JAX package's XLA ``plane_sweep.render_frame`` with
    ``use_bf16=False``, the render its scored views take) of an LLFF
    camera (no y inversion, no flips): rays in chunks through
    :func:`sweep_all_tiles_train` without grid slices."""
    if not dmpigo.plane_aligned_ok(cfg, stepsize, ndc=True):
        raise ValueError("the plane sweep needs the plane-aligned NDC setup")
    dev = resolve_device(device)
    X, Y, Z = cfg.world_size
    ro, rd, vd = (t.reshape(-1, 3) for t in ray_ops.get_rays_of_a_view(
        H, W, K, c2w, ndc=True, inverse_y=False, flip_x=False,
        flip_y=False, device=dev))
    sizes = torch.tensor([X, Y], dtype=torch.float32, device=dev)
    a, b = affine_coeffs(ro, rd, as_tensor(cfg.xyz_min, dev),
                         as_tensor(cfg.xyz_max, dev), sizes, Z)
    mask = buffers["mask_cache"]
    msx, msy, _ = mask_scale_and_patch(cfg, mask.shape, 8)
    params32 = {k: v.float() if k != "rgbnet" else
                {n: t.float() for n, t in v.items()}
                for k, v in params.items()}
    chunk = max(_NATIVE_SAMPLES // Z, 1)
    rgb, depth, ail = [], [], []
    s = (torch.arange(Z, dtype=torch.float32, device=dev) + 0.5) / Z
    for i in range(0, a.shape[0], chunk):
        w, t, f, _ = sweep_all_tiles_train(
            params32["density"], params32["k0"],
            buffers["act_shift"].reshape(-1).float(), mask,
            a[None, i:i + chunk], b[None, i:i + chunk], vd[None, i:i + chunk],
            params32["rgbnet"], cfg=cfg,
            interval=float(stepsize * cfg.voxel_size_ratio), patch=None,
            msx=msx, msy=msy, use_bf16=False)
        rgb.append(f[0])
        depth.append((w[0] * s).sum(-1))
        ail.append(t[0])
    return assemble(torch.cat(rgb), torch.cat(depth), torch.cat(ail), H, W,
                    bg)
