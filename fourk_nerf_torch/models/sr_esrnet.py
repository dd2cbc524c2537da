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

Evaluation in float32 or, through :func:`apply_bf16`, in bfloat16 with the
rounding points of the JAX module: a plain conv rounds its output to the
working dtype before its bias is added; a dense-block conv accumulates in
float32 with its bias and rounds after the activation.
"""

from __future__ import annotations

import copy

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
        srcs = [self.sft0(x, cond)]
        for i in range(5):
            conv = getattr(self, f"conv{i + 1}")
            acc = F.conv2d(torch.cat(srcs, 1).float(), conv.weight.float(),
                           padding=1) + conv.bias.float()[None, :, None, None]
            if i < 4:
                y = lrelu(acc).to(x.dtype)
                srcs.append(self.sft1(y, cond) if i == 3 else y)
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


def apply_bf16(model: SFTNet, x, cond):
    """bfloat16 inference (weights and activations), float32 result."""
    m16 = copy.deepcopy(model).to(torch.bfloat16)
    with torch.no_grad():
        y = m16(x.to(torch.bfloat16), cond.to(torch.bfloat16))
    return y.float()
