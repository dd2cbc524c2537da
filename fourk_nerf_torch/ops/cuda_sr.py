"""The SFTNet decoder on the card: the fused SFT dense-block kernel
(``csrc/rdb.cu``), the whole-RRDB kernel (``csrc/rrdb.cu``), the fused
upsample tail (``csrc/uptail.cu``) and the SFTNet decode around them.

:func:`rdb_apply` is the kernel's wrapper: one ResidualDenseBlock_SFT on
NHWC bf16 ``x [H,W,64]`` and ``cond [H,W,32]``, in tail mode (``xin``
given) with the RRDB's trailing SFT and residual fused in. For CUDA tensors
it launches the kernel (and raises if the launch fails); for CPU tensors,
and only for them, it runs the plain version :func:`rdb_plain`. It counts
its launches in ``rdb_apply.launches``.

:func:`rrdb_apply` wraps the whole-RRDB kernel the same way: three dense
blocks, the RRDB's trailing SFT and both residuals in one launch, with the
features carried in float32 between the blocks. Its plain version is
:func:`rrdb_plain`, its count ``rrdb_apply.launches``.

:func:`sftnet_apply_cuda` is the decode of the JAX package's
``pallas_sr.sftnet_apply_pallas``: bf16 head convs (cuDNN), the 15 dense
blocks through :func:`rdb_apply` (or, with ``fuse_rrdb=True``, the 5 RRDBs
through :func:`rrdb_apply`), the two upsample convs in the form ``upchain``
names, bf16 tail convs, a float32 ``conv_last``. :func:`sftnet_apply_plain`
is the same chain with the plain versions in place of the kernels.
:func:`sftnet_trunk_cuda` stops after ``conv_up1`` and :func:`sftnet_tail`
is the rest.

:func:`uptail_apply` wraps the fused x4 upsample tail (``csrc/uptail.cu``):
``conv_up2`` on the nearest-upsampled trunk output, ``conv_hr`` and
``conv_last`` in one launch, as the JAX package's ``uptail_apply_pallas``.
Its plain version is :func:`uptail_plain`, its packer
:func:`pack_uptail_weights` (the HWIO weights for the plain version and
the same values in ``mma.sync`` fragment order for the kernel), its count
``uptail_apply.launches``. As in the
JAX package no decode entry point chains it; a caller composes
:func:`sftnet_trunk_cuda` and :func:`uptail_apply`.
"""

from __future__ import annotations

import copy
import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from fourk_nerf_torch.models.sr_esrnet import SFTNet, conv_nchw, lrelu, \
    nearest_up2
from fourk_nerf_torch.ops import _build, s2d
from fourk_nerf_torch.utils import trace

_F, _G = 64, 32
_CIN = tuple(_F + _G * s for s in range(5))
_COUT = (_G, _G, _G, _G, _F)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
UPCHAINS = ("materialized", "dilated")


@dataclasses.dataclass(frozen=True)
class RdbWeights:
    """One dense block's weights in the kernel's layout.

    ``conv``: the five 3x3 kernels back to back, bf16, each in
    ``mma.sync`` fragment order (:func:`_to_fragments`: per tap and
    16-channel input chunk, per 16 output channels, 32 lanes x 8 values that
    are one lane's B operands of ``mma.sync`` m16n8k16 for two 8-channel
    tiles), as the whole-RRDB kernel reads them. ``conva``: the same values
    as the dense-block kernel streams them, ``wgmma`` A tiles of output
    channels by 16 inputs (:func:`_conv_a_tiles`, :func:`_to_afrag`; convs
    1-4 pair two taps in a tile and carry zeros beside their third).
    ``bias [5, 64]`` float32. ``sftm [12, 32, 64]``
    float32 holding bf16-rounded 1x1 weights ``[in, out]``, zero-padded:
    rows 0..3 sft0, 4..7 sft1, 8..11 the RRDB's trailing SFT (tail mode),
    each as (scale0, scale1, shift0, shift1). ``sftb [12, 64]`` float32.
    ``sftk [12 * 2048]`` bf16: the same twelve ``[32, 64]`` matrices in
    fragment order, as the kernel reads them (``sftm`` serves the plain
    version)."""

    conv: torch.Tensor
    bias: torch.Tensor
    sftm: torch.Tensor
    sftb: torch.Tensor
    sftk: torch.Tensor
    tail: bool
    conva: torch.Tensor


# a B operand [K, N] as K / 16 steps of 16 rows k = 8 khi + 2 t + klo, with
# column n = 16 p + 8 half + g, in the order (step, p, g, t, half, khi, klo):
# lane 4 g + t holds B[k][n] for k in (2t, 2t+1, 2t+8, 2t+9) and n = 16 p + g,
# then the same for n = 16 p + 8 + g
_FRAG = (0, 4, 6, 2, 5, 1, 3)
_UNFRAG = tuple(_FRAG.index(d) for d in range(7))


def _to_fragments(k):
    """A B operand ``[..., K, N]`` (a conv as tap-major HWIO ``[3, 3, Cin,
    Cout]``: K runs over taps and input channels) -> the kernel's flat
    fragment order."""
    n = k.shape[-1]
    return k.reshape(-1, 2, 4, 2, n // 16, 2, 8).permute(_FRAG).reshape(-1)


def _from_fragments(flat, cin: int, cout: int):
    """The inverse of :func:`_to_fragments` for a 3x3 conv, as HWIO."""
    return _matrix_from_fragments(flat, 9 * cin, cout).reshape(3, 3, cin, cout)


# one n8 B tile [K, 8] in the order (step, g, t, khi, klo): lane 4 g + t
# holds B[k][g] for k in (2t, 2t+1, 2t+8, 2t+9), its two B registers
_FRAG8 = (0, 4, 2, 1, 3)
_UNFRAG8 = tuple(_FRAG8.index(d) for d in range(5))


# The dense-block kernel's conv weights: wgmma A tiles of 64 rows x 16
# inputs, one a step. Conv5 (64 outputs): a step per tap and 16-channel
# input chunk, tap-major, rows = output channels. Convs 1-4 (32 outputs): a
# step per kernel row dy and chunk, first the pairs (rows 16 w + r: channel
# 8 w + r of tap (dy, -1); rows 16 w + 8 + r: the same of tap (dy, 0)) of
# dy = -1, 0, 1, then the taps (dy, +1) alone (zero rows below). In a tile
# the rows 16 w .. 16 w + 15 of warp w come as the four 8 x 8 pieces one
# ldmatrix.x4 reads, 128 bytes each: (rows 0-7, inputs 0-7), (8-15, 0-7),
# (0-7, 8-15), (8-15, 8-15).


def _conv_a_tiles(hwio):
    """A conv ``[3, 3, Cin, Cout]`` (Cout 32 or 64) -> its A tiles
    ``[steps, 64, 16]`` in the dense-block kernel's step order."""
    cin, cout = hwio.shape[2], hwio.shape[3]
    nch = cin // 16
    if cout == 64:
        return hwio.reshape(9, nch, 16, 64).permute(0, 1, 3, 2) \
            .reshape(-1, 64, 16)
    k = hwio.reshape(3, 3, nch, 16, cout)
    tiles = []
    for j in range(6):
        dy = j % 3
        up = k[dy, 0] if j < 3 else k[dy, 2]
        low = k[dy, 1] if j < 3 else torch.zeros_like(up)
        t = torch.stack([up, low], 1).reshape(nch, 2, 16, 4, 8)
        tiles.append(t.permute(0, 3, 1, 4, 2).reshape(nch, 64, 16))
    return torch.cat(tiles)


def _conv_from_a_tiles(tiles, cin: int, cout: int):
    """The inverse of :func:`_conv_a_tiles`: HWIO ``[3, 3, Cin, Cout]``
    and, for Cout 32, the rows the single taps leave zero."""
    nch = cin // 16
    if cout == 64:
        k = tiles.reshape(9, nch, 64, 16).permute(0, 1, 3, 2)
        return k.reshape(3, 3, cin, 64), tiles.new_zeros(0)
    t = tiles.reshape(6, nch, 4, 2, 8, 16).permute(0, 3, 1, 5, 2, 4) \
        .reshape(6, 2, nch, 16, cout)
    k = torch.stack([torch.stack([t[dy, 0], t[dy, 1], t[3 + dy, 0]])
                     for dy in range(3)])
    return k.reshape(3, 3, cin, cout), t[3:, 1]


def _to_afrag(tiles):
    """A tiles ``[steps, 64, 16]`` -> the flat order the kernel reads with
    ``ldmatrix``."""
    return tiles.reshape(-1, 4, 2, 8, 2, 8).permute(0, 1, 4, 2, 3, 5) \
        .reshape(-1)


def _tiles_from_afrag(flat):
    """The inverse of :func:`_to_afrag`."""
    return flat.reshape(-1, 4, 2, 2, 8, 8).permute(0, 1, 3, 4, 2, 5) \
        .reshape(-1, 64, 16)


# conva's elements: 6 (convs 1-4) or 9 (conv5) steps a chunk, 1024 a step
_CONVA = tuple((6 if co == _G else 9) * (ci // 16) * 1024
               for ci, co in zip(_CIN, _COUT))


def _to_fragments8(k):
    """A B operand ``[K, 8]`` -> the kernel's flat n8 fragment order."""
    return k.reshape(-1, 2, 4, 2, 8).permute(_FRAG8).reshape(-1)


def _matrix_from_fragments(flat, k: int, n: int):
    """The ``[K, N]`` matrix of a flat fragment order: the inverse of
    :func:`_to_fragments` (N a multiple of 16) or of
    :func:`_to_fragments8` (N = 8)."""
    if n == 8:
        return flat.reshape(k // 16, 8, 4, 2, 2).permute(_UNFRAG8) \
            .reshape(k, 8)
    return flat.reshape(k // 16, n // 16, 8, 4, 2, 2, 2).permute(_UNFRAG) \
        .reshape(k, n)


def pack_rdb_weights(rdb, rrdb_sft=None) -> RdbWeights:
    """Pack a ``ResidualDenseBlockSFT`` module (and, for an RRDB's third
    block, the RRDB's ``sft0``) for :func:`rdb_apply`."""
    dev = rdb.conv1.weight.device
    convs, conva = [], []
    bias = torch.zeros((5, 64), dtype=torch.float32, device=dev)
    for s in range(5):
        conv = getattr(rdb, f"conv{s + 1}")
        w = conv.weight.detach()  # OIHW
        if tuple(w.shape) != (_COUT[s], _CIN[s], 3, 3):
            raise ValueError(f"conv{s + 1}: expected {(_COUT[s], _CIN[s], 3, 3)}"
                             f", got {tuple(w.shape)} (num_feat 64, grow 32)")
        hwio = w.permute(2, 3, 1, 0)
        convs.append(_to_fragments(hwio))
        conva.append(_to_afrag(_conv_a_tiles(hwio)))
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
    bf = torch.bfloat16
    return RdbWeights(torch.cat(convs).to(bf).contiguous(), bias, sftm, sftb,
                      _to_fragments(sftm).to(bf).contiguous(),
                      rrdb_sft is not None,
                      torch.cat(conva).to(bf).contiguous())


def _unpack_conv(w: RdbWeights, s: int):
    """Conv s as an OIHW float32 tensor (bf16 values)."""
    off = sum(9 * _CIN[t] * _COUT[t] for t in range(s))
    k = w.conv[off:off + 9 * _CIN[s] * _COUT[s]].float()
    return _from_fragments(k, _CIN[s], _COUT[s]).permute(3, 2, 0, 1)


def _sft_plain(cf, w: RdbWeights, base: int, n: int):
    """(scale, shift) ``[H,W,n]`` of SFT rows ``base..base+3`` on the float32
    condition ``cf``; the hidden layer is rounded to bf16."""
    bf = torch.bfloat16
    h = lrelu(cf @ w.sftm[base, :, :_G] + w.sftb[base, :_G]).to(bf).float()
    scale = h @ w.sftm[base + 1, :, :n] + w.sftb[base + 1, :n]
    h2 = lrelu(cf @ w.sftm[base + 2, :, :_G]
               + w.sftb[base + 2, :_G]).to(bf).float()
    shift = h2 @ w.sftm[base + 3, :, :n] + w.sftb[base + 3, :n]
    return scale, shift


def _block_plain(xf, cf, w: RdbWeights):
    """One dense block on float32 ``xf [H,W,64]``: the float32 output
    ``conv5 * 0.2 + xf`` (not rounded), with the kernel's rounding points
    inside: bf16 conv operands, float32 sums, full-frame SAME padding."""
    bf = torch.bfloat16
    sc, sh = _sft_plain(cf, w, 0, _F)
    srcs = [(xf * (sc + 1.0) + sh).to(bf)]
    for s in range(5):
        inp = torch.cat(srcs, -1).float().permute(2, 0, 1)[None]
        acc = F.conv2d(inp, _unpack_conv(w, s), padding=1)[0].permute(1, 2, 0) \
            + w.bias[s, :_COUT[s]]
        if s < 4:
            y = lrelu(acc).to(bf)
            if s == 3:
                sc1, sh1 = _sft_plain(cf, w, 4, _G)
                y = (y.float() * (sc1 + 1.0) + sh1).to(bf)
            srcs.append(y)
    return acc * 0.2 + xf


def rdb_plain(x, cond, w: RdbWeights, xin=None):
    """Plain PyTorch dense block with the kernel's rounding points:
    bf16 storage, float32 sums, full-frame SAME zero padding."""
    bf = torch.bfloat16
    cf = cond.float()
    out = _block_plain(x.float(), cf, w)
    if xin is None:
        return out.to(bf)
    sc2, sh2 = _sft_plain(cf, w, 8, _F)
    out = ((out * (sc2 + 1.0) + sh2) * 0.2).to(bf)
    return (out.float() + xin.float()).to(bf)


def rdb_apply(x, cond, w: RdbWeights, xin=None):
    """One fused dense block; tail mode when ``xin`` is given (then ``w``
    must carry the RRDB's trailing SFT). Returns ``[H, W, 64]`` bf16."""
    if (xin is not None) != w.tail:
        raise ValueError("rdb_apply: xin must be given exactly for weights "
                         "packed with the RRDB's trailing SFT")
    tensors = [x, cond, w.conva, w.bias, w.sftm, w.sftb, w.sftk] + (
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
    if w.conva.dtype != torch.bfloat16 or w.conva.numel() != sum(_CONVA) \
            or not w.conva.is_contiguous():
        raise ValueError("rdb_apply: bad packed conv weights")
    out = torch.empty_like(x)
    lib = _build.load("rdb")
    fn = lib.rdb_launch
    fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), cond.data_ptr(),
             xin.data_ptr() if xin is not None else None, out.data_ptr(),
             w.conva.data_ptr(), w.bias.data_ptr(), w.sftk.data_ptr(),
             w.sftb.data_ptr(), H, W, int(xin is not None),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "rdb_error_string", err, "rdb kernel")
    rdb_apply.launches += 1
    return out


rdb_apply.launches = 0


@dataclasses.dataclass(frozen=True)
class RrdbWeights:
    """One RRDB's three dense-block packs stacked on a leading axis:
    ``conv [3, n]`` bf16, ``bias [3, 5, 64]``, ``sftm [3, 12, 32, 64]``,
    ``sftb [3, 12, 64]``, ``sftk [3, 12 * 2048]``, ``conva [3, n]``. The
    third block's SFT rows 8..11 hold the RRDB's trailing SFT."""

    conv: torch.Tensor
    bias: torch.Tensor
    sftm: torch.Tensor
    sftb: torch.Tensor
    sftk: torch.Tensor
    conva: torch.Tensor

    def block(self, r: int) -> RdbWeights:
        return RdbWeights(self.conv[r], self.bias[r], self.sftm[r],
                          self.sftb[r], self.sftk[r], r == 2, self.conva[r])


def _stack_packs(packs) -> RrdbWeights:
    """Three dense-block packs (the third with the RRDB's SFT) stacked."""
    return RrdbWeights(*(torch.stack([getattr(p, f) for p in packs])
                         .contiguous()
                         for f in ("conv", "bias", "sftm", "sftb", "sftk",
                                   "conva")))


def pack_rrdb_weights(body) -> RrdbWeights:
    """Pack an ``RRDBSFT`` module for :func:`rrdb_apply`."""
    return _stack_packs([pack_rdb_weights(body.rdb1),
                         pack_rdb_weights(body.rdb2),
                         pack_rdb_weights(body.rdb3, rrdb_sft=body.sft0)])


def rrdb_plain(x, cond, w: RrdbWeights):
    """Plain PyTorch RRDB with the kernel's rounding points: the features
    stay float32 between the three blocks, the tail
    ``SFT(x3) * 0.2 + x`` is rounded to bf16 once."""
    cf = cond.float()
    x0 = x.float()
    xf = x0
    for r in range(3):
        xf = _block_plain(xf, cf, w.block(r))
    sc, sh = _sft_plain(cf, w.block(2), 8, _F)
    return ((xf * (sc + 1.0) + sh) * 0.2 + x0).to(torch.bfloat16)


_RRDB_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rrdb_apply(x, cond, w: RrdbWeights):
    """One whole RRDB in one launch. Returns ``[H, W, 64]`` bf16."""
    tensors = [x, cond, w.conv, w.bias, w.sftm, w.sftb, w.sftk]
    if all(t.device.type == "cpu" for t in tensors):
        return rrdb_plain(x, cond, w)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("rrdb_apply: all tensors must be on one CUDA device "
                         "(or all on the CPU for the plain version)")
    if x.dim() != 3 or x.shape[2] != _F:
        raise ValueError(f"rrdb_apply: x must be [H,W,64], got {tuple(x.shape)}")
    H, W = x.shape[:2]
    for name, t, shape in (("x", x, (H, W, _F)), ("cond", cond, (H, W, _G))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"rrdb_apply: {name} must be contiguous bf16 "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    n_conv = sum(9 * ci * co for ci, co in zip(_CIN, _COUT))
    if w.conv.dtype != torch.bfloat16 or tuple(w.conv.shape) != (3, n_conv) \
            or not all(t.is_contiguous() for t in tensors[2:]):
        raise ValueError("rrdb_apply: bad packed weights")
    lib = _build.load("rrdb")
    lib.rrdb_scratch_floats.restype = ctypes.c_longlong
    lib.rrdb_regions.argtypes = [ctypes.c_int, ctypes.c_int]
    # one persistent thread block per SM, each with its own scratch for
    # the float32 features between the dense blocks
    blocks = min(lib.rrdb_regions(H, W),
                 torch.cuda.get_device_properties(dev).multi_processor_count)
    scratch = torch.empty(blocks * lib.rrdb_scratch_floats(),
                          dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    fn = lib.rrdb_launch
    fn.argtypes, fn.restype = _RRDB_ARGTYPES, ctypes.c_int
    err = fn(x.data_ptr(), cond.data_ptr(), out.data_ptr(),
             w.conv.data_ptr(), w.bias.data_ptr(), w.sftk.data_ptr(),
             w.sftb.data_ptr(), scratch.data_ptr(), H, W, n_conv, blocks,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "rrdb_error_string", err, "rrdb kernel")
    rrdb_apply.launches += 1
    return out


rrdb_apply.launches = 0


@dataclasses.dataclass(frozen=True)
class PreparedSFTNet:
    """An SFTNet ready for the fused decode: a bf16 copy of the module,
    the packed weights of its ``3 * num_block`` dense blocks, the same
    weights stacked per RRDB (``num_block`` packs, for ``fuse_rrdb``), and
    ``conv_last``'s float32 bias (the last conv adds it in float32)."""

    m16: SFTNet
    packs: tuple
    rrdb_packs: tuple
    last_bias: torch.Tensor


def fits_kernels(model) -> bool:
    """Whether the dense-block and whole-RRDB kernels take ``model``: a
    :class:`PreparedSFTNet`, or an :class:`SFTNet` of 64 features and
    growth 32 (the JAX video loop's test for its fused decode)."""
    if isinstance(model, PreparedSFTNet):
        return True
    return (model.conv_first.weight.shape[0] == _F
            and model.sftbody.scale0.weight.shape[0] == _G)


def prepare_sftnet(model) -> PreparedSFTNet:
    """Pack an :class:`SFTNet` for the fused decode (a
    :class:`PreparedSFTNet` is returned as it is)."""
    if isinstance(model, PreparedSFTNet):
        return model
    packs = []
    for i in range(model.num_block):
        body = getattr(model, f"body{i}")
        packs += [pack_rdb_weights(body.rdb1), pack_rdb_weights(body.rdb2),
                  pack_rdb_weights(body.rdb3, rrdb_sft=body.sft0)]
    rrdb_packs = tuple(_stack_packs(packs[i:i + 3])
                       for i in range(0, len(packs), 3))
    m16 = copy.deepcopy(model).to(torch.bfloat16).eval()
    return PreparedSFTNet(m16, tuple(packs), rrdb_packs,
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


def _check_upchain(upchain):
    if upchain not in UPCHAINS:
        raise ValueError(f"upchain must be one of {UPCHAINS}, got {upchain!r}")


_BLOCKS = trace.span("decode.blocks")


def _sftnet_trunk(prep: PreparedSFTNet, x, cond, rdb, rrdb, upchain):
    """The decode up to the post-lrelu ``conv_up1`` output (the body itself
    at scale 1) with dense-block function ``rdb`` or, when given, whole-RRDB
    function ``rrdb``: ``x [1,H,W,Cin]``, ``cond [1,H,W,num_cond]`` -> NHWC
    bf16 ``[1, 2H, 2W, 64]``."""
    _check_upchain(upchain)
    m = prep.m16
    feat, c, body, ch = sftnet_head(prep, x, cond)
    with torch.no_grad():
        with _BLOCKS:
            for i in range(m.num_block):
                if rrdb is not None:
                    body = rrdb(body, ch, prep.rrdb_packs[i])
                    continue
                xin = body
                cur = rdb(body, ch, prep.packs[3 * i])
                cur = rdb(cur, ch, prep.packs[3 * i + 1])
                body = rdb(cur, ch, prep.packs[3 * i + 2], xin=xin)
        body = body.permute(2, 0, 1)[None]
        body = m.conv_body(m.sftbody(body, c)) + feat
        body = body.permute(0, 2, 3, 1)
        if hasattr(m, "conv_up1"):
            body = _up_conv(m.conv_up1, body, upchain)
    return body


def _up_conv(conv, body, upchain):
    """``lrelu(conv3x3(nearest_up2(body)))`` on NHWC bf16 ``body``, in the
    dilated form (one transposed conv over the input, no upsampled tensor)
    or with the upsampled tensor materialized."""
    if upchain == "dilated":
        return lrelu(s2d.conv_up_dilated(
            body, conv.weight.permute(2, 3, 1, 0), conv.bias))
    return lrelu(conv(nearest_up2(body.permute(0, 3, 1, 2)))) \
        .permute(0, 2, 3, 1)


@trace.span("decode.tail")
def _sftnet_tail(prep: PreparedSFTNet, body, upchain):
    """``conv_up2`` (scale 4), ``conv_hr`` and the float32 ``conv_last`` on
    the trunk's output -> float32 ``[1, sH, sW, 3]``. These are the three
    convs that :func:`uptail_apply` fuses."""
    m = prep.m16
    with torch.no_grad():
        if hasattr(m, "conv_up2"):
            body = _up_conv(m.conv_up2, body, upchain)
        out = lrelu(m.conv_hr(body.permute(0, 3, 1, 2)))
        out = conv_nchw(out, m.conv_last.weight, None, f32_out=True) \
            + prep.last_bias[None, :, None, None]
    return out.permute(0, 2, 3, 1)


def sftnet_trunk_cuda(model, x, cond, *, fuse_rrdb: bool = False,
                      upchain: str = "materialized"):
    """The decode of :func:`sftnet_apply_cuda` up to the post-lrelu
    ``conv_up1`` output, NHWC bf16 ``[1, 2H, 2W, 64]``: the input of
    :func:`uptail_apply` (scale 4) or of the library tail."""
    return _sftnet_trunk(prepare_sftnet(model), x, cond, rdb_apply,
                         rrdb_apply if fuse_rrdb else None, upchain)


def sftnet_tail(model, up1_out, *, upchain: str = "materialized"):
    """The library tail of the decode on the trunk's output: ``conv_up2``
    (scale 4), ``conv_hr``, float32 ``conv_last``."""
    _check_upchain(upchain)
    return _sftnet_tail(prepare_sftnet(model), up1_out, upchain)


def sftnet_apply_cuda(model, x, cond, *, fuse_rrdb: bool = False,
                      upchain: str = "materialized"):
    """SFTNet decode with the 15 (``3 * num_block``) dense blocks on the
    dense-block kernel or, with ``fuse_rrdb``, the ``num_block`` RRDBs on
    the whole-RRDB kernel. ``model``: an :class:`SFTNet` or a
    :class:`PreparedSFTNet`. ``upchain`` picks the form of the two upsample
    convs: ``"materialized"`` (nearest-up, then a 3x3 conv; the default of
    the JAX function) or ``"dilated"`` (one transposed conv, what
    ``FramePipeline`` and ``render_video`` pass). ``x [1,H,W,Cin]``,
    ``cond [1,H,W,num_cond]`` -> float32 ``[1, sH, sW, 3]``."""
    prep = prepare_sftnet(model)
    body = _sftnet_trunk(prep, x, cond, rdb_apply,
                         rrdb_apply if fuse_rrdb else None, upchain)
    return _sftnet_tail(prep, body, upchain)


def sftnet_apply_plain(model, x, cond, *, fuse_rrdb: bool = False,
                       upchain: str = "materialized"):
    """:func:`sftnet_apply_cuda` with :func:`rdb_plain` for every block
    (:func:`rrdb_plain` for every RRDB with ``fuse_rrdb``)."""
    prep = prepare_sftnet(model)
    body = _sftnet_trunk(prep, x, cond, rdb_plain,
                         rrdb_plain if fuse_rrdb else None, upchain)
    return _sftnet_tail(prep, body, upchain)


@dataclasses.dataclass(frozen=True)
class UptailWeights:
    """``conv_up2`` / ``conv_hr`` / ``conv_last`` for the uptail kernel and
    its plain version. ``kup [4, 4, 64, 64]`` bf16: the 2x2 phase kernels of
    ``conv3x3(nearest_up2(.))`` as ``[2*qy+qx, 2*dy+dx, cin, cout]``, their
    taps summed in float32 and rounded to bf16 once. ``khr [9, 64, 64]`` and
    ``klast [9, 64, 8]`` bf16: tap-major HWIO, ``conv_last``'s three output
    channels zero-padded to 8. ``bias [3, 64]`` float32 (row 2: three
    values). These serve :func:`uptail_plain`; the kernel reads the same
    values in ``mma.sync`` fragment order, flat bf16: ``kupf`` (per phase,
    ``kup[ph]`` as a ``[256, 64]`` B operand, :func:`_to_fragments`),
    ``khrf`` (``khr`` as ``[576, 64]``) and ``klastf`` (``klast`` as
    ``[576, 8]``, :func:`_to_fragments8`)."""

    kup: torch.Tensor
    khr: torch.Tensor
    klast: torch.Tensor
    bias: torch.Tensor
    kupf: torch.Tensor
    khrf: torch.Tensor
    klastf: torch.Tensor


def pack_uptail_weights(model) -> UptailWeights:
    """Pack the last three convs of a scale-4 :class:`SFTNet` (float32
    weights) for :func:`uptail_apply`."""
    if not hasattr(model, "conv_up2"):
        raise ValueError("pack_uptail_weights: the fused tail needs a "
                         "scale-4 SFTNet (conv_up2)")
    bf = torch.bfloat16

    def hwio(conv, cout):
        w = conv.weight.detach()
        if w.dtype != torch.float32:
            raise ValueError("pack_uptail_weights: needs the float32 "
                             "weights (the phase kernels are summed in "
                             "float32 before their one rounding)")
        if tuple(w.shape) != (cout, _F, 3, 3):
            raise ValueError(f"expected a {(cout, _F, 3, 3)} conv, got "
                             f"{tuple(w.shape)} (num_feat 64)")
        return w.permute(2, 3, 1, 0)

    kup = s2d.up_phase_kernels(hwio(model.conv_up2, _F)) \
        .reshape(4, 4, _F, _F).to(bf).contiguous()
    khr = hwio(model.conv_hr, _F).reshape(9, _F, _F).to(bf).contiguous()
    klast = torch.zeros((9, _F, 8), dtype=bf, device=kup.device)
    klast[:, :, :3] = hwio(model.conv_last, 3).reshape(9, _F, 3).to(bf)
    bias = torch.zeros((3, _F), dtype=torch.float32, device=kup.device)
    bias[0] = model.conv_up2.bias.detach().float()
    bias[1] = model.conv_hr.bias.detach().float()
    bias[2, :3] = model.conv_last.bias.detach().float()
    return UptailWeights(kup, khr, klast, bias,
                         _to_fragments(kup.reshape(4 * 4 * _F, _F)),
                         _to_fragments(khr.reshape(9 * _F, _F)),
                         _to_fragments8(klast.reshape(9 * _F, 8)))


def uptail_plain(up1_out, w: UptailWeights):
    """Plain PyTorch fused tail with the kernel's rounding points: the
    input, ``z = lrelu(conv_up2(nearest_up2 x))`` (as four phase convs),
    ``h = lrelu(conv_hr z)`` and the RGB itself are rounded to bf16; sums
    are float32; every conv sees SAME zero padding at the frame edge.
    ``[1, H2, W2, 64]`` -> float32 ``[1, 2 H2, 2 W2, 3]``."""
    bf = torch.bfloat16
    x = up1_out.to(bf)
    rows = []
    for qy in range(2):
        row = [s2d._conv_f32(x, w.kup[2 * qy + qx].reshape(2, 2, _F, _F),
                             (1 - qy, qy, 1 - qx, qx)) for qx in range(2)]
        rows.append(torch.stack(row, 3))
    z = torch.stack(rows, 2)                       # [1, H2, 2, W2, 2, 64]
    n, h2, _, w2, _, _ = z.shape
    z = lrelu(z.reshape(n, 2 * h2, 2 * w2, _F) + w.bias[0]).to(bf)
    same = (1, 1, 1, 1)
    h = lrelu(s2d._conv_f32(z, w.khr.reshape(3, 3, _F, _F), same)
              + w.bias[1]).to(bf)
    rgb = s2d._conv_f32(h, w.klast.reshape(3, 3, _F, 8)[..., :3], same) \
        + w.bias[2, :3]
    return rgb.to(bf).float()


@trace.span("decode.tail")
def uptail_apply(up1_out, w: UptailWeights):
    """The fused x4 upsample tail in one launch: the post-lrelu ``conv_up1``
    output ``[1, H2, W2, 64]`` -> ``lrelu(conv_up2(nearest_up2 .))`` ->
    ``lrelu(conv_hr)`` -> ``conv_last`` -> float32 ``[1, 2 H2, 2 W2, 3]``
    (bf16-rounded values), with no tensor at the output resolution but the
    RGB. CUDA tensors launch the kernel (and raise if the launch fails);
    CPU tensors, and only they, take :func:`uptail_plain`."""
    tensors = [up1_out, w.kup, w.khr, w.klast, w.bias, w.kupf, w.khrf,
               w.klastf]
    if all(t.device.type == "cpu" for t in tensors):
        return uptail_plain(up1_out, w)
    dev = up1_out.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError("uptail_apply: all tensors must be on one CUDA "
                         "device (or all on the CPU for the plain version)")
    if up1_out.dim() != 4 or up1_out.shape[0] != 1 or up1_out.shape[3] != _F:
        raise ValueError("uptail_apply: input must be [1,H2,W2,64], got "
                         f"{tuple(up1_out.shape)}")
    for t, shape in ((w.kup, (4, 4, _F, _F)), (w.khr, (9, _F, _F)),
                     (w.klast, (9, _F, 8)), (w.kupf, (16 * _F * _F,)),
                     (w.khrf, (9 * _F * _F,)), (w.klastf, (9 * _F * 8,))):
        if t.dtype != torch.bfloat16 or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError("uptail_apply: bad packed weights")
    if w.bias.dtype != torch.float32 or tuple(w.bias.shape) != (3, _F) \
            or not w.bias.is_contiguous():
        raise ValueError("uptail_apply: bad packed bias")
    x = up1_out.to(torch.bfloat16).contiguous()
    H2, W2 = x.shape[1:3]
    out = torch.empty((1, 2 * H2, 2 * W2, 3), dtype=torch.float32, device=dev)
    lib = _build.load("uptail")
    fn = lib.uptail_launch
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(x.data_ptr(), out.data_ptr(), w.kupf.data_ptr(),
             w.khrf.data_ptr(), w.klastf.data_ptr(), w.bias.data_ptr(), H2, W2,
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "uptail_error_string", err, "uptail kernel")
    uptail_apply.launches += 1
    return out


uptail_apply.launches = 0


def uptail_issued_macs(H2: int, W2: int) -> int:
    """The MACs the uptail kernel issues for an ``H2 x W2`` input, its
    tiles' halo and padding included (the kernel's library reports them
    from its own tile geometry; builds it on first use)."""
    fn = _build.load("uptail").uptail_issued_macs
    fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
    return int(fn(H2, W2))
