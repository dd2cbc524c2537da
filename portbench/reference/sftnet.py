"""The reference's VC-Decoder: the SFT-conditioned RRDB network of 4K-NeRF
(frozoul/4K-NeRF ``lib/sr_esrnet.py``, ``SFTNet``) as a plain float32
function of a dict of raw weights.

Structure: ``conv_first``; a CondNet (``cond0`` 3x3, then ``cond1..3``
1x1 with leaky ReLU between) giving the 32-channel condition;
``num_block`` RRDBs of three dense blocks each (an SFT at entry, five 3x3
dense convs, the fourth output SFT-modulated before the fifth, residual
``x5 * 0.2 + x``) and a trailing SFT (residual ``* 0.2 + x``);
``conv_body(sftbody(.)) + feat``; at scale 4 two nearest-x2 + 3x3 convs
(scale 2: one), each under leaky ReLU 0.2; ``conv_hr`` under leaky ReLU;
``conv_last``. An SFT is ``x * (scale + 1) + shift`` with each of
``scale``/``shift`` two 1x1 convs with a leaky ReLU between.

:func:`param_shapes` names every weight; :func:`forward` applies them.
``rnd`` rounds each conv's weight and input to a storage type (the
control's fp8 path); the float32 reference passes none.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import common as C


def _conv(shapes, name, cin, cout, k=3):
    shapes[f"{name}.weight"] = (cout, cin, k, k)
    shapes[f"{name}.bias"] = (cout,)


def _sft(shapes, name, nf, g):
    _conv(shapes, f"{name}.scale0", 32, g, 1)
    _conv(shapes, f"{name}.scale1", g, nf, 1)
    _conv(shapes, f"{name}.shift0", 32, g, 1)
    _conv(shapes, f"{name}.shift1", g, nf, 1)


def param_shapes(dec: dict) -> dict:
    """{name: shape} of every weight, in the module's order."""
    nf, g, nb = dec["num_feat"], dec["num_grow_ch"], dec["num_block"]
    s: dict = {}
    _conv(s, "conv_first", 3, nf)
    _conv(s, "cond0", dec["num_cond"], 64)
    _conv(s, "cond1", 64, 64, 1)
    _conv(s, "cond2", 64, 64, 1)
    _conv(s, "cond3", 64, 32, 1)
    for i in range(nb):
        for j in (1, 2, 3):
            p = f"body{i}.rdb{j}"
            _sft(s, f"{p}.sft0", nf, g)
            _sft(s, f"{p}.sft1", g, g)
            for c in range(5):
                _conv(s, f"{p}.conv{c + 1}", nf + c * g, g if c < 4 else nf)
        _sft(s, f"body{i}.sft0", nf, g)
    _sft(s, "sftbody", nf, g)
    _conv(s, "conv_body", nf, nf)
    if dec["scale"] > 1:
        _conv(s, "conv_up1", nf, nf)
    if dec["scale"] == 4:
        _conv(s, "conv_up2", nf, nf)
    _conv(s, "conv_hr", nf, nf)
    _conv(s, "conv_last", nf, 3)
    return s


def is_dense_conv(name: str) -> bool:
    """A dense block's 3x3 conv (``body{i}.rdb{j}.conv{k}``)."""
    parts = name.split(".")
    return len(parts) == 4 and parts[1].startswith("rdb") \
        and parts[2].startswith("conv")


def lrelu(x):
    return F.leaky_relu(x, 0.2)


def forward(p: dict, dec: dict, x, cond, *, rnd=C.identity):
    """``x [1,H,W,3]``, ``cond [1,H,W,num_cond]`` -> ``[1, sH, sW, 3]``."""

    def conv(name, t):
        w = p[f"{name}.weight"]
        return F.conv2d(rnd(t), rnd(w), padding=w.shape[-1] // 2) \
            + p[f"{name}.bias"][None, :, None, None]

    def sft(name, t, c):
        scale = conv(f"{name}.scale1", lrelu(conv(f"{name}.scale0", c)))
        shift = conv(f"{name}.shift1", lrelu(conv(f"{name}.shift0", c)))
        return t * (scale + 1.0) + shift

    def dense_block(name, t, c):
        srcs = [sft(f"{name}.sft0", t, c)]
        for i in range(5):
            acc = conv(f"{name}.conv{i + 1}", torch.cat(srcs, 1))
            if i < 4:
                y = lrelu(acc)
                srcs.append(sft(f"{name}.sft1", y, c) if i == 3 else y)
        return acc * 0.2 + t

    def up(t):
        return t.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)

    x = x.permute(0, 3, 1, 2)
    c = conv("cond0", cond.permute(0, 3, 1, 2))
    for n in ("cond1", "cond2", "cond3"):
        c = conv(n, lrelu(c))
    feat = conv("conv_first", x)
    body = feat
    for i in range(dec["num_block"]):
        inp = body
        for j in (1, 2, 3):
            body = dense_block(f"body{i}.rdb{j}", body, c)
        body = sft(f"body{i}.sft0", body, c) * 0.2 + inp
    body = conv("conv_body", sft("sftbody", body, c)) + feat
    del feat, c
    if dec["scale"] > 1:
        body = lrelu(conv("conv_up1", up(body)))
    if dec["scale"] == 4:
        body = lrelu(conv("conv_up2", up(body)))
    out = conv("conv_last", lrelu(conv("conv_hr", body)))
    return out.permute(0, 2, 3, 1)
