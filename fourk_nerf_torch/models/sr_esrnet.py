"""VC-Decoder: the SFT-conditioned RRDB super-resolution network (torch).

``conv_first`` -> ``num_block`` x RRDB_SFT (three ResidualDenseBlock_SFT and
a trailing SFT each) -> ``sftbody`` + ``conv_body`` residual -> two
nearest-up x2 convs -> ``conv_hr`` / ``conv_last``, with a CondNet
(``cond0..3``) mapping the conditioning signal (depth) to the 32-channel
SFT condition. Module and parameter names mirror the JAX package's flax
tree (``body{i}/rdb{j}/conv{k}``, ``sft0/scale0``, ...), so
:func:`fourk_nerf_torch.weights.sftnet_from_flax` carries weights over by
name. Inputs and outputs are NHWC, as in the JAX package; convolutions
run in NCHW inside.

The plain ESRGAN generator :class:`RRDBNetBPS` (dense blocks without SFT,
pixel-shuffle upsampling), the memory-bounded tiled inference
:func:`tile_process` (over the ranks of a mesh axis:
:func:`tile_process_sharded`) and the standalone :func:`enhance` follow.

Evaluation in float32 or, through :func:`apply_bf16`, in bfloat16 with the
rounding points of the JAX module: a plain conv rounds its output to the
working dtype before its bias is added; a dense-block conv accumulates in
float32 with its bias and rounds after the activation.
"""

from __future__ import annotations

import copy
import math

import torch
import torch.nn as nn
import torch.nn.functional as F


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def conv_nchw(x, weight, bias=None, *, f32_out: bool = False):
    """SAME-padded stride-1 conv of NCHW ``x``, accumulated in float32.

    The output is rounded to ``x.dtype`` (unless ``f32_out``) and the bias
    then added in that dtype, the order of a bf16 XLA conv + bias. On the
    card a bf16 conv goes to cuDNN directly (it accumulates in float32);
    on the CPU it is evaluated in float32 and rounded."""
    pad = weight.shape[-1] // 2
    if x.dtype == torch.float32 or (x.is_cuda and not f32_out):
        y = F.conv2d(x, weight.to(x.dtype), padding=pad)
    else:
        y = F.conv2d(x.float(), weight.float(), padding=pad)
    y = y if f32_out else y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)[None, :, None, None]
    return y


class Conv(nn.Module):
    """A conv with OIHW weight and bias, applied by :func:`conv_nchw`."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return conv_nchw(x, self.weight, self.bias)


class SFTLayer(nn.Module):
    """``x * (scale + 1) + shift`` with scale/shift from two 1x1 branches."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.scale0 = Conv(32, num_grow_ch, 1)
        self.scale1 = Conv(num_grow_ch, num_feat, 1)
        self.shift0 = Conv(32, num_grow_ch, 1)
        self.shift1 = Conv(num_grow_ch, num_feat, 1)

    def forward(self, x, cond):
        scale = self.scale1(lrelu(self.scale0(cond)))
        shift = self.shift1(lrelu(self.shift0(cond)))
        return x * (scale + 1.0) + shift


def _dense_convs(block, src, dtype, modulate4=None):
    """The five dense 3x3 convs ``conv1..conv5`` of ``block`` on NCHW
    ``src``: each reads the concat of ``src`` and the earlier outputs, sums
    in float32 with its bias, and (but for the last) is rounded to ``dtype``
    after its lrelu; ``modulate4`` acts on the fourth output before conv5
    reads it. Returns conv5's float32 output."""
    srcs = [src]
    for i in range(5):
        conv = getattr(block, f"conv{i + 1}")
        acc = F.conv2d(torch.cat(srcs, 1).float(), conv.weight.float(),
                       padding=1) + conv.bias.float()[None, :, None, None]
        if i < 4:
            y = lrelu(acc).to(dtype)
            srcs.append(modulate4(y) if i == 3 and modulate4 else y)
    return acc


class ResidualDenseBlockSFT(nn.Module):
    """Dense block: SFT at entry, five 3x3 dense convs (the fourth output
    SFT-modulated before conv5 sees it), residual ``x5 * 0.2 + x``."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        F_, G = num_feat, num_grow_ch
        self.sft0 = SFTLayer(F_, G)
        self.sft1 = SFTLayer(G, G)
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    Conv(F_ + i * G, G if i < 4 else F_))

    def forward(self, x, cond):
        acc = _dense_convs(self, self.sft0(x, cond), x.dtype,
                           lambda y: self.sft1(y, cond))
        return acc.to(x.dtype) * 0.2 + x


class RRDBSFT(nn.Module):
    """Three dense blocks and a trailing SFT, residual ``out * 0.2 + x``."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlockSFT(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlockSFT(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlockSFT(num_feat, num_grow_ch)
        self.sft0 = SFTLayer(num_feat, num_grow_ch)

    def forward(self, x, cond):
        out = self.rdb3(self.rdb2(self.rdb1(x, cond), cond), cond)
        return self.sft0(out, cond) * 0.2 + x


def nearest_up2(x):
    """NCHW nearest x2 upsample."""
    return x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)


class SFTNet(nn.Module):
    """The VC-Decoder; ``forward(x [N,H,W,Cin], cond [N,H,W,num_cond])``
    returns ``[N, H*scale, W*scale, 3]``."""

    def __init__(self, n_in_colors: int = 3, scale: int = 4,
                 num_feat: int = 64, num_block: int = 5,
                 num_grow_ch: int = 32, num_cond: int = 1):
        super().__init__()
        if scale not in (1, 2, 4):
            raise ValueError(f"scale must be 1, 2 or 4, got {scale}")
        self.scale, self.num_block = scale, num_block
        self.conv_first = Conv(n_in_colors, num_feat)
        self.cond0 = Conv(num_cond, 64)
        self.cond1 = Conv(64, 64, 1)
        self.cond2 = Conv(64, 64, 1)
        self.cond3 = Conv(64, 32, 1)
        for i in range(num_block):
            setattr(self, f"body{i}", RRDBSFT(num_feat, num_grow_ch))
        self.sftbody = SFTLayer(num_feat, num_grow_ch)
        self.conv_body = Conv(num_feat, num_feat)
        if scale > 1:
            self.conv_up1 = Conv(num_feat, num_feat)
        if scale == 4:
            self.conv_up2 = Conv(num_feat, num_feat)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, 3)

    def condition(self, cond):
        """CondNet on NCHW ``cond`` -> the 32-channel SFT condition."""
        c = self.cond0(cond)
        for m in (self.cond1, self.cond2, self.cond3):
            c = m(lrelu(c))
        return c

    def forward(self, x, cond):
        x = x.permute(0, 3, 1, 2)
        c = self.condition(cond.permute(0, 3, 1, 2))
        feat = self.conv_first(x)
        body = feat
        for i in range(self.num_block):
            body = getattr(self, f"body{i}")(body, c)
        body = self.conv_body(self.sftbody(body, c)) + feat
        if self.scale > 1:
            body = lrelu(self.conv_up1(nearest_up2(body)))
        if self.scale == 4:
            body = lrelu(self.conv_up2(nearest_up2(body)))
        out = self.conv_last(lrelu(self.conv_hr(body)))
        return out.permute(0, 2, 3, 1)


def _dense_conv(path: str) -> bool:
    """True for the module path of a dense-block conv (``bodyI.rdbJ.convK``)."""
    parts = path.split(".")
    return len(parts) == 3 and parts[1].startswith("rdb") \
        and parts[2].startswith("conv")


def _trunc_normal(shape, generator):
    """Standard normal draws truncated to [-2, 2] (inverse CDF)."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))
    u = lo + (hi - lo) * torch.rand(shape, generator=generator,
                                    dtype=torch.float64)
    return (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).float()


@torch.no_grad()
def init_like_jax(model: nn.Module, generator: torch.Generator):
    """Draw ``model``'s convs from the JAX module's initialisers, in place:
    flax's default conv init (``lecun_normal``: a normal truncated to two
    standard deviations, scaled to a variance of 1/fan_in) and, for the
    dense-block convs, ``_rdb_kernel_init`` (kaiming normal over fan_in
    with the relu gain, times 0.1); every bias zero. Returns ``model``."""
    for path, mod in model.named_modules():
        if not isinstance(mod, Conv):
            continue
        w = mod.weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        if _dense_conv(path):
            draw = torch.randn(w.shape, generator=generator) \
                * (0.1 * math.sqrt(2.0 / fan_in))
        else:
            draw = _trunc_normal(w.shape, generator) \
                * (math.sqrt(1.0 / fan_in) / 0.87962566103423978)
        w.copy_(draw.to(w.device))
        mod.bias.zero_()
    return model


_SFT_MAP = {"SFT_scale_conv0": "scale0", "SFT_scale_conv1": "scale1",
            "SFT_shift_conv0": "shift0", "SFT_shift_conv1": "shift1"}
_CONDNET = {0: "cond0", 2: "cond1", 4: "cond2", 6: "cond3"}
_TOP_CONVS = ("conv_first", "conv_body", "conv_up1", "conv_up2", "conv_hr",
              "conv_last")


def _reference_path(key: str) -> str | None:
    """The module path of a reference SFTNet / RRDBNet state-dict conv
    (``body.0.rdb1.sft0.SFT_scale_conv0`` -> ``body0.rdb1.sft0.scale0``,
    ``CondNet.2`` -> ``cond1``), None for a key it does not map."""
    parts = key.split(".")
    if parts[0] in _TOP_CONVS and len(parts) == 1:
        return parts[0]
    if parts[0] == "CondNet" and len(parts) == 2:
        return _CONDNET.get(int(parts[1]))
    if parts[0] == "sftbody" and len(parts) == 2 and parts[1] in _SFT_MAP:
        return f"sftbody.{_SFT_MAP[parts[1]]}"
    if parts[0] == "body" and len(parts) >= 3:
        blk = f"body{parts[1]}"
        if parts[2].startswith("rdb") and len(parts) == 4 \
                and parts[3].startswith("conv"):
            return f"{blk}.{parts[2]}.{parts[3]}"
        if parts[2].startswith("rdb") and len(parts) == 5 \
                and parts[4] in _SFT_MAP:
            return f"{blk}.{parts[2]}.{parts[3]}.{_SFT_MAP[parts[4]]}"
        if parts[2] == "sft0" and len(parts) == 4 and parts[3] in _SFT_MAP:
            return f"{blk}.sft0.{_SFT_MAP[parts[3]]}"
    return None


@torch.no_grad()
def load_reference_state_dict(model: nn.Module, state_dict) -> list:
    """Copy a reference SFTNet save, or the plain RealESRNet RRDBNet init,
    into ``model`` by name (the JAX package's ``import_sftnet_torch`` then
    ``merge_params``; ``--ftsr_path`` / ``--sr_path``). A conv whose key is
    absent, or whose weight or bias has another shape, keeps its current
    values (the reference's ``strict=False`` load); a missing bias loads
    as zeros. Returns the module paths that were loaded."""
    mods = dict(model.named_modules())
    loaded = []
    for k, v in state_dict.items():
        if not k.endswith(".weight"):
            continue
        base = k[:-len(".weight")]
        path = _reference_path(base)
        mod = mods.get(path) if path else None
        if not isinstance(mod, Conv):
            continue
        w = torch.as_tensor(v).float()
        b = state_dict.get(base + ".bias")
        b = torch.zeros(w.shape[0]) if b is None else torch.as_tensor(b).float()
        if w.shape != mod.weight.shape or b.shape != mod.bias.shape:
            continue
        mod.weight.copy_(w)
        mod.bias.copy_(b)
        loaded.append(path)
    return loaded


def apply_bf16(model: SFTNet, x, cond):
    """bfloat16 inference (weights and activations), float32 result."""
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        y = m16(x.to(torch.bfloat16), cond.to(torch.bfloat16))
    return y.float()


class ResidualDenseBlock(nn.Module):
    """The plain ESRGAN dense block: five 3x3 dense convs, residual
    ``x5 * 0.2 + x``; float32 conv sums, one rounding per conv output."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        for i in range(5):
            setattr(self, f"conv{i + 1}",
                    Conv(num_feat + i * num_grow_ch,
                         num_grow_ch if i < 4 else num_feat))

    def forward(self, x):
        return _dense_convs(self, x, x.dtype).to(x.dtype) * 0.2 + x


class RRDB(nn.Module):
    """Three plain dense blocks, residual ``out * 0.2 + x``."""

    def __init__(self, num_feat: int = 64, num_grow_ch: int = 32):
        super().__init__()
        self.rdb1 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb2 = ResidualDenseBlock(num_feat, num_grow_ch)
        self.rdb3 = ResidualDenseBlock(num_feat, num_grow_ch)

    def forward(self, x):
        return self.rdb3(self.rdb2(self.rdb1(x))) * 0.2 + x


class RRDBNetBPS(nn.Module):
    """The plain RRDB super-resolver with pixel-shuffle upsampling
    (``F.pixel_shuffle`` on NCHW is the JAX package's NHWC
    ``_pixel_shuffle2``: torch's channel order); ``forward(x
    [N,H,W,n_colors])`` returns ``[N, H*scale, W*scale, n_colors]``."""

    def __init__(self, n_colors: int = 3, scale: int = 4, num_feat: int = 64,
                 num_block: int = 5, num_grow_ch: int = 32):
        super().__init__()
        if scale not in (2, 4):
            raise ValueError(f"scale must be 2 or 4, got {scale}")
        self.scale, self.num_block = scale, num_block
        self.conv_first = Conv(n_colors, num_feat)
        for i in range(num_block):
            setattr(self, f"body{i}", RRDB(num_feat, num_grow_ch))
        self.conv_body = Conv(num_feat, num_feat)
        self.ps_preconv1 = Conv(num_feat, 4 * num_feat)
        self.conv_up1 = Conv(num_feat, num_feat)
        if scale == 4:
            self.ps_preconv2 = Conv(num_feat, 4 * num_feat)
            self.conv_up2 = Conv(num_feat, num_feat)
        self.conv_hr = Conv(num_feat, num_feat)
        self.conv_last = Conv(num_feat, n_colors)

    def forward(self, x):
        feat = self.conv_first(x.permute(0, 3, 1, 2))
        body = feat
        for i in range(self.num_block):
            body = getattr(self, f"body{i}")(body)
        feat = feat + self.conv_body(body)
        feat = lrelu(self.conv_up1(F.pixel_shuffle(self.ps_preconv1(feat), 2)))
        if self.scale == 4:
            feat = lrelu(self.conv_up2(
                F.pixel_shuffle(self.ps_preconv2(feat), 2)))
        out = self.conv_last(lrelu(self.conv_hr(feat)))
        return out.permute(0, 2, 3, 1)


def _pad_nhwc(x, pad, mode):
    """Pad H by ``pad[0:2]`` and W by ``pad[2:4]`` (before, after)."""
    t, b, l, r = pad
    return F.pad(x.permute(0, 3, 1, 2), (l, r, t, b), mode=mode) \
        .permute(0, 2, 3, 1)


def _tile_plan(img, cond, tile_size: int, tile_pad: int):
    """The edge-padded frame and condition and the row-major tile origins
    of :func:`tile_process`."""
    _, H, W, _ = img.shape
    ts, tp = tile_size, tile_pad
    ny, nx = math.ceil(H / ts), math.ceil(W / ts)
    pad = (tp, ny * ts + tp - H, tp, nx * ts + tp - W)
    starts = [(y * ts, x * ts) for y in range(ny) for x in range(nx)]
    return (_pad_nhwc(img, pad, "replicate"),
            _pad_nhwc(cond, pad, "replicate"), starts, ny, nx)


def _tile_core(apply_fn, img_p, cond_p, start, tile_size: int,
               tile_pad: int, scale: int):
    """The unpadded SR core of the tile at ``start``."""
    sy, sx = start
    full = tile_size + 2 * tile_pad
    sr = apply_fn(img_p[:, sy:sy + full, sx:sx + full],
                  cond_p[:, sy:sy + full, sx:sx + full])[0]
    lo, hi = tile_pad * scale, (tile_pad + tile_size) * scale
    return sr[lo:hi, lo:hi]


def _paste(cores, ny: int, nx: int, H: int, W: int, tile_size: int,
           scale: int):
    """The frame ``[1, H*scale, W*scale, C]`` of the row-major ``cores``
    (an iterable: each is written as it comes)."""
    hs = tile_size * scale
    out = None
    for i, core in enumerate(cores):
        if out is None:
            out = core.new_empty((ny * hs, nx * hs, core.shape[-1]))
        y, x = divmod(i, nx)
        out[y * hs:(y + 1) * hs, x * hs:(x + 1) * hs] = core
    return out[None, :H * scale, :W * scale]


def tile_process(apply_fn, img, cond, tile_size: int, tile_pad: int = 10,
                 scale: int = 4):
    """Memory-bounded full-frame SR: edge-pad the frame, cut overlapping
    tiles that all have the shape ``tile_size + 2 * tile_pad`` square (edge
    tiles too), run each through ``apply_fn(x_tile, cond_tile) -> sr_tile``
    (NHWC) and paste the unpadded cores into the frame on the device, each
    as it is decoded.

    ``img [1,H,W,C]``, ``cond [1,H,W,Cc]`` -> ``[1, H*scale, W*scale, 3]``."""
    _, H, W, _ = img.shape
    img_p, cond_p, starts, ny, nx = _tile_plan(img, cond, tile_size,
                                               tile_pad)
    cores = (_tile_core(apply_fn, img_p, cond_p, st, tile_size, tile_pad,
                        scale) for st in starts)
    return _paste(cores, ny, nx, H, W, tile_size, scale)


def tile_process_sharded(apply_fn, img, cond, tile_size: int, mesh,
                         tile_pad: int = 10, scale: int = 4,
                         axis: str = "data"):
    """:func:`tile_process` with the tiles split over ``mesh``'s ``axis``
    (a ``parallel.mesh.make_mesh`` mesh): the row-major tile list, padded
    by its first tiles to a multiple of the axis size (the extras are
    decoded and dropped, as in the JAX package), is cut into equal
    contiguous shares; each rank decodes its share, the cores are
    all-gathered in the axis's process group and pasted. Tiles are
    independent (each carries its halo), so the frame equals
    :func:`tile_process`'s exactly."""
    import torch.distributed as dist

    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    _, H, W, _ = img.shape
    img_p, cond_p, starts, ny, nx = _tile_plan(img, cond, tile_size,
                                               tile_pad)
    nt = len(starts)
    padded = starts + starts[:(-nt) % n]
    per = len(padded) // n
    local = torch.stack([
        _tile_core(apply_fn, img_p, cond_p, st, tile_size, tile_pad, scale)
        for st in padded[rank * per:(rank + 1) * per]]).contiguous()
    got = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(got, local, group=group)
    cores = torch.cat(got)[:nt]
    return _paste(cores, ny, nx, H, W, tile_size, scale)


def enhance(apply_fn, img, cond=None, *, scale: int = 4, pre_pad: int = 10,
            mod: int = 8, tile_size: int = 0, tile_pad: int = 10):
    """Standalone SR inference with pre-padding and modulus padding:
    reflect-pad by ``pre_pad``, pad to a multiple of ``mod``, run the
    network (tiled when ``tile_size`` > 0), crop both pads from the
    upscaled output.

    ``apply_fn(x, cond) -> y`` NHWC, or ``apply_fn(x)`` when ``cond`` is
    None; ``img [1,H,W,C]`` in [0, 1]."""
    _, H, W, _ = img.shape
    fn = apply_fn if cond is not None else (lambda x, c: apply_fn(x))
    pp = (pre_pad,) * 4
    x = _pad_nhwc(img, pp, "reflect")
    c = _pad_nhwc(cond, pp, "reflect") if cond is not None else None
    h, w = x.shape[1:3]
    mp = (0, (-h) % mod, 0, (-w) % mod)
    x = _pad_nhwc(x, mp, "reflect")
    c = _pad_nhwc(c, mp, "reflect") if c is not None \
        else torch.zeros_like(x[..., :1])
    if tile_size > 0:
        y = tile_process(fn, x, c, tile_size=tile_size, tile_pad=tile_pad,
                         scale=scale)
    else:
        y = fn(x, c)
    p = pre_pad * scale
    return y[:, :h * scale, :w * scale][:, p:p + H * scale, p:p + W * scale]
