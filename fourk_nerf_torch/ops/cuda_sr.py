"""The decoder of the 4K frame on the card: the fused SFT dense-block kernel
(``csrc/rdb.cu``) and the SFTNet driver around it.

:func:`rdb_apply` is the kernel's wrapper: one ResidualDenseBlock_SFT on
NHWC bf16 ``x [H,W,64]`` and ``cond [H,W,32]``, in tail mode (``xin``
given) with the RRDB's trailing SFT and residual fused in. For CUDA tensors
it launches the kernel (and raises if the launch fails); for CPU tensors,
and only for them, it runs the plain version :func:`rdb_plain`. It counts
its launches in ``rdb_apply.launches``.

:func:`sftnet_apply_cuda` is the decode of the JAX package's
``pallas_sr.sftnet_apply_pallas`` with ``upchain="dilated"``: bf16 head
convs (cuDNN), the 15 dense blocks through :func:`rdb_apply`, bf16 tail
convs, a float32 ``conv_last``. :func:`sftnet_apply_plain` is the same
chain with :func:`rdb_plain` in place of the kernel.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from fourk_nerf_torch.models.sr_esrnet import SFTNet, conv_nchw, lrelu
from fourk_nerf_torch.ops import _build, s2d

_F, _G = 64, 32
_CIN = tuple(_F + _G * s for s in range(5))
_COUT = (_G, _G, _G, _G, _F)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


@dataclasses.dataclass(frozen=True)
class RdbWeights:
    """One dense block's weights in the kernel's layout.

    ``conv``: the five 3x3 kernels back to back, each ``[9, Cin, Cout]``
    (tap-major HWIO), bf16. ``bias [5, 64]`` float32. ``sftm [12, 32, 64]``
    float32 holding bf16-rounded 1x1 weights ``[in, out]``, zero-padded:
    rows 0..3 sft0, 4..7 sft1, 8..11 the RRDB's trailing SFT (tail mode),
    each as (scale0, scale1, shift0, shift1). ``sftb [12, 64]`` float32."""

    conv: torch.Tensor
    bias: torch.Tensor
    sftm: torch.Tensor
    sftb: torch.Tensor
    tail: bool


def pack_rdb_weights(rdb, rrdb_sft=None) -> RdbWeights:
    """Pack a ``ResidualDenseBlockSFT`` module (and, for an RRDB's third
    block, the RRDB's ``sft0``) for :func:`rdb_apply`."""
    dev = rdb.conv1.weight.device
    convs = []
    bias = torch.zeros((5, 64), dtype=torch.float32, device=dev)
    for s in range(5):
        conv = getattr(rdb, f"conv{s + 1}")
        w = conv.weight.detach()  # OIHW
        if tuple(w.shape) != (_COUT[s], _CIN[s], 3, 3):
            raise ValueError(f"conv{s + 1}: expected {(_COUT[s], _CIN[s], 3, 3)}"
                             f", got {tuple(w.shape)} (num_feat 64, grow 32)")
        convs.append(w.permute(2, 3, 1, 0).reshape(-1))
        bias[s, :_COUT[s]] = conv.bias.detach().float()
    sftm = torch.zeros((12, 32, 64), dtype=torch.float32, device=dev)
    sftb = torch.zeros((12, 64), dtype=torch.float32, device=dev)
    layers = [rdb.sft0, rdb.sft1] + ([rrdb_sft] if rrdb_sft is not None else [])
    for si, sft in enumerate(layers):
        for wi, name in enumerate(("scale0", "scale1", "shift0", "shift1")):
            m = getattr(sft, name)
            k = m.weight.detach()[:, :, 0, 0].t()  # [in, out]
            sftm[4 * si + wi, :k.shape[0], :k.shape[1]] = \
                k.to(torch.bfloat16).float()
            sftb[4 * si + wi, :k.shape[1]] = m.bias.detach().float()
    return RdbWeights(torch.cat(convs).to(torch.bfloat16).contiguous(), bias,
                      sftm, sftb, rrdb_sft is not None)


def _unpack_conv(w: RdbWeights, s: int):
    """Conv s as an OIHW float32 tensor (bf16 values)."""
    off = sum(9 * _CIN[t] * _COUT[t] for t in range(s))
    k = w.conv[off:off + 9 * _CIN[s] * _COUT[s]].float()
    return k.reshape(3, 3, _CIN[s], _COUT[s]).permute(3, 2, 0, 1)


def rdb_plain(x, cond, w: RdbWeights, xin=None):
    """Plain PyTorch dense block with the kernel's rounding points:
    bf16 storage, float32 sums, full-frame SAME zero padding."""
    bf = torch.bfloat16
    xf, cf = x.float(), cond.float()

    def sft(base, n):
        h = lrelu(cf @ w.sftm[base, :, :_G] + w.sftb[base, :_G]).to(bf).float()
        scale = h @ w.sftm[base + 1, :, :n] + w.sftb[base + 1, :n]
        h2 = lrelu(cf @ w.sftm[base + 2, :, :_G]
                   + w.sftb[base + 2, :_G]).to(bf).float()
        shift = h2 @ w.sftm[base + 3, :, :n] + w.sftb[base + 3, :n]
        return scale, shift

    sc, sh = sft(0, _F)
    srcs = [(xf * (sc + 1.0) + sh).to(bf)]
    for s in range(5):
        inp = torch.cat(srcs, -1).float().permute(2, 0, 1)[None]
        acc = F.conv2d(inp, _unpack_conv(w, s), padding=1)[0].permute(1, 2, 0) \
            + w.bias[s, :_COUT[s]]
        if s < 4:
            y = lrelu(acc).to(bf)
            if s == 3:
                sc1, sh1 = sft(4, _G)
                y = (y.float() * (sc1 + 1.0) + sh1).to(bf)
            srcs.append(y)
    out = acc * 0.2 + xf
    if xin is None:
        return out.to(bf)
    sc2, sh2 = sft(8, _F)
    out = ((out * (sc2 + 1.0) + sh2) * 0.2).to(bf)
    return (out.float() + xin.float()).to(bf)


def rdb_apply(x, cond, w: RdbWeights, xin=None):
    """One fused dense block; tail mode when ``xin`` is given (then ``w``
    must carry the RRDB's trailing SFT). Returns ``[H, W, 64]`` bf16."""
    if (xin is not None) != w.tail:
        raise ValueError("rdb_apply: xin must be given exactly for weights "
                         "packed with the RRDB's trailing SFT")
    tensors = [x, cond, w.conv, w.bias, w.sftm, w.sftb] + (
        [xin] if xin is not None else [])
    if all(t.device.type == "cpu" for t in tensors):
        return rdb_plain(x, cond, w, xin)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("rdb_apply: all tensors must be on one CUDA device "
                         "(or all on the CPU for the plain version)")
    if x.dim() != 3 or x.shape[2] != _F:
        raise ValueError(f"rdb_apply: x must be [H,W,64], got {tuple(x.shape)}")
    H, W = x.shape[:2]
    for name, t, shape in (("x", x, (H, W, _F)), ("cond", cond, (H, W, _G)),
                           ("xin", xin, (H, W, _F))):
        if t is not None and (t.dtype != torch.bfloat16
                              or tuple(t.shape) != shape
                              or not t.is_contiguous()):
            raise ValueError(f"rdb_apply: {name} must be contiguous bf16 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if w.conv.dtype != torch.bfloat16 or w.conv.numel() != sum(
            9 * ci * co for ci, co in zip(_CIN, _COUT)):
        raise ValueError("rdb_apply: bad packed conv weights")
    out = torch.empty_like(x)
    lib = _build.load("rdb")
    fn = lib.rdb_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), cond.data_ptr(),
             xin.data_ptr() if xin is not None else None, out.data_ptr(),
             w.conv.data_ptr(), w.bias.data_ptr(), w.sftm.data_ptr(),
             w.sftb.data_ptr(), H, W, int(xin is not None),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "rdb_error_string", err, "rdb kernel")
    rdb_apply.launches += 1
    return out


rdb_apply.launches = 0


@dataclasses.dataclass(frozen=True)
class PreparedSFTNet:
    """An SFTNet ready for the fused decode: a bf16 copy of the module,
    the packed weights of its ``3 * num_block`` dense blocks, and
    ``conv_last``'s float32 bias (the last conv adds it in float32)."""

    m16: SFTNet
    packs: tuple
    last_bias: torch.Tensor


def prepare_sftnet(model: SFTNet) -> PreparedSFTNet:
    packs = []
    for i in range(model.num_block):
        body = getattr(model, f"body{i}")
        packs += [pack_rdb_weights(body.rdb1), pack_rdb_weights(body.rdb2),
                  pack_rdb_weights(body.rdb3, rrdb_sft=body.sft0)]
    m16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    return PreparedSFTNet(m16, tuple(packs),
                          model.conv_last.bias.detach().float().clone())


def sftnet_head(prep: PreparedSFTNet, x, cond):
    """The bf16 head: ``x [1,H,W,Cin]``, ``cond [1,H,W,num_cond]`` ->
    (feat, c) as NCHW bf16 and the dense blocks' inputs, the body
    ``[H,W,64]`` and condition ``[H,W,32]`` as contiguous NHWC bf16."""
    m, bf = prep.m16, torch.bfloat16
    with torch.no_grad():
        feat = m.conv_first(x.to(bf).permute(0, 3, 1, 2))
        c = m.condition(cond.to(bf).permute(0, 3, 1, 2))
    return (feat, c, feat[0].permute(1, 2, 0).contiguous(),
            c[0].permute(1, 2, 0).contiguous())


def _sftnet_fused(prep: PreparedSFTNet, x, cond, rdb):
    """The dilated-upchain fused decode with dense-block function ``rdb``;
    ``x [1,H,W,Cin]``, ``cond [1,H,W,num_cond]`` -> float32
    ``[1, 4H, 4W, 3]`` (or the model's scale)."""
    m = prep.m16
    feat, c, body, ch = sftnet_head(prep, x, cond)
    with torch.no_grad():
        for i in range(m.num_block):
            xin = body
            cur = rdb(body, ch, prep.packs[3 * i])
            cur = rdb(cur, ch, prep.packs[3 * i + 1])
            body = rdb(cur, ch, prep.packs[3 * i + 2], xin=xin)
        body = body.permute(2, 0, 1)[None]
        body = m.conv_body(m.sftbody(body, c)) + feat
        body = body.permute(0, 2, 3, 1)
        for conv in (getattr(m, n) for n in ("conv_up1", "conv_up2")
                     if hasattr(m, n)):
            body = lrelu(s2d.conv_up_dilated(
                body, conv.weight.permute(2, 3, 1, 0), conv.bias))
        out = lrelu(m.conv_hr(body.permute(0, 3, 1, 2)))
        out = conv_nchw(out, m.conv_last.weight, None, f32_out=True) \
            + prep.last_bias[None, :, None, None]
    return out.permute(0, 2, 3, 1)


def sftnet_apply_cuda(model, x, cond):
    """SFTNet decode with the 15 (``3 * num_block``) dense blocks on the
    kernel. ``model``: an :class:`SFTNet` or a :class:`PreparedSFTNet`."""
    prep = model if isinstance(model, PreparedSFTNet) else prepare_sftnet(model)
    return _sftnet_fused(prep, x, cond, rdb_apply)


def sftnet_apply_plain(model, x, cond):
    """:func:`sftnet_apply_cuda` with :func:`rdb_plain` for every block."""
    prep = model if isinstance(model, PreparedSFTNet) else prepare_sftnet(model)
    return _sftnet_fused(prep, x, cond, rdb_plain)
