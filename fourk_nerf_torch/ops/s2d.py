"""Weight-space rewrites of the SFTNet decode's convs (the JAX package's
``ops/s2d.py``), as plain PyTorch functions.

1. **Space-to-depth body**: a stride-1 3x3 conv ``C -> D`` on ``[H,W]``
   equals a 3x3 conv ``4C -> 4D`` on the space-to-depth tensor
   ``[H/2,W/2,4C]`` with the kernel of :func:`s2d_kernel`
   (``K'[dy,dx,(p,c),(q,d)] = K[a,b,c,d]``, ``a = 2*dy + py - qy``, zero
   when ``|a| > 1``). :func:`sftnet_apply_s2d` is the whole decode in that
   form.
2. **Phase-decomposed upsample**: ``conv3x3(nearest_up2(x))`` equals four
   2x2 convs on ``x``, one per output phase, with the summed-tap kernels of
   :func:`up_phase_kernels`, pixel-shuffled (:func:`conv_up_phase`).
3. **Dilated upsample**: the same function as one 4x4 conv over the
   zero-dilated input (``conv_up_dilated``): nearest-up2 is zero-up2
   followed by a 2x2 ones smear, and the smear folds into the kernel,
   ``K'[u+2] = sum_{e in {0,1}} K[u+e+1]`` per axis. In torch that is
   ``conv_transpose2d`` with stride 2, padding 1 and the flipped 4x4
   kernel.

Tensors are NHWC and kernels HWIO, as in the JAX package. All of these are
plain tensor code there too (XLA convs), so ``F.conv2d`` is their port; the
hand-written kernels of the decode live in ``ops/cuda_sr.py``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _sel() -> np.ndarray:
    """S[dy, p, q, a1] = 1 iff original tap a = a1-1 satisfies
    a == 2*(dy-1) + p - q and |a| <= 1."""
    S = np.zeros((3, 2, 2, 3), np.float32)
    for dyi in range(3):
        for p in range(2):
            for q in range(2):
                a = 2 * (dyi - 1) + p - q
                if -1 <= a <= 1:
                    S[dyi, p, q, a + 1] = 1.0
    return S


def _phase_taps() -> np.ndarray:
    """U[q, di, a1] = 1 iff tap a = a1-1 of output phase q reads input row
    ``i + di - (1 - q)``, i.e. floor((q + a) / 2) == di - (1 - q)."""
    U = np.zeros((2, 2, 3), np.float32)
    for q in range(2):
        for a in (-1, 0, 1):
            di = (q + a) // 2 + (1 - q)
            if 0 <= di <= 1:
                U[q, di, a + 1] = 1.0
    return U


_S = _sel()
_U = _phase_taps()


def s2d(x):
    """``[N,H,W,C]`` -> ``[N,H/2,W/2,4C]``, channel order (py, px, c)."""
    n, h, w, c = x.shape
    x = x.reshape(n, h // 2, 2, w // 2, 2, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(n, h // 2, w // 2, 4 * c)


def d2s(x):
    """Inverse of :func:`s2d`."""
    n, h, w, c4 = x.shape
    c = c4 // 4
    x = x.reshape(n, h, w, 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 2 * h, 2 * w, c)


def s2d_kernel(K):
    """A 3x3 conv kernel ``[3,3,C,D]`` -> its space-to-depth form
    ``[3,3,4C,4D]``; exact, 25% fill."""
    S = torch.as_tensor(_S, dtype=K.dtype, device=K.device)
    Kp = torch.einsum("ypqa,xuvb,abcd->yxpucqvd", S, S, K)
    C, D = K.shape[2], K.shape[3]
    return Kp.reshape(3, 3, 4 * C, 4 * D)


def up_phase_kernels(K):
    """conv3x3-after-nearest-up2 as four 2x2 phase kernels
    ``[2,2,2,2,C,D]``: ``out[2i+qy, 2j+qx] = conv2x2(x, K_[qy,qx])`` with
    per-phase padding (top, left) = (1-qy, 1-qx)."""
    U = torch.as_tensor(_U, dtype=K.dtype, device=K.device)
    return torch.einsum("qua,rwb,abcd->qruwcd", U, U, K)


def _conv_f32(x, K, pad):
    """NHWC ``x`` with HWIO ``K`` and (top, bottom, left, right) zero
    padding -> float32 NHWC, evaluated in float32."""
    t, b, l, r = pad
    xc = F.pad(x.float().permute(0, 3, 1, 2), (l, r, t, b))
    return F.conv2d(xc, K.float().permute(3, 2, 0, 1)).permute(0, 2, 3, 1)


def conv_up_phase(x, K, b):
    """``[N,H,W,C]`` -> ``[N,2H,2W,D]`` = conv3x3(nearest_up2(x)) by the
    four phase convs: float32 accumulation, bias added per phase, one
    rounding to ``x.dtype``."""
    Kq = up_phase_kernels(K)
    rows = []
    for qy in range(2):
        row = [_conv_f32(x, Kq[qy, qx], (1 - qy, qy, 1 - qx, qx)) + b.float()
               for qx in range(2)]
        rows.append(torch.stack(row, 3))           # [N,H,W,2,D]
    y = torch.stack(rows, 2)                       # [N,H,2,W,2,D]
    n, h, _, w, _, d = y.shape
    return y.reshape(n, 2 * h, 2 * w, d).to(x.dtype)


def up_dilated_kernel(K):
    """``[3,3,C,D]`` (HWIO) -> the fused ``[4,4,C,D]`` kernel, summed in
    float32 and rounded once to ``K.dtype``."""
    A = torch.zeros((4, 3), dtype=torch.float32, device=K.device)
    for iu in range(4):
        for e in range(2):
            a = iu - 2 + e + 1
            if 0 <= a <= 2:
                A[iu, a] = 1.0
    return torch.einsum("ua,vb,abcd->uvcd", A, A, K.float()).to(K.dtype)


def conv_up_dilated(x, K, b):
    """``[N,H,W,C]`` -> ``[N,2H,2W,D]`` = conv3x3(nearest_up2(x)) with HWIO
    ``K [3,3,C,D]`` and bias ``b [D]``: float32 accumulation and bias, then
    one rounding to ``x.dtype``. On the card a bf16 input goes to cuDNN's
    bf16 transposed conv, which rounds its float32 sum to bf16 once more
    before the bias is added."""
    K4 = up_dilated_kernel(K)
    w = K4.flip(0, 1).permute(2, 3, 0, 1)  # [C, D, 4, 4]
    xc = x.permute(0, 3, 1, 2)
    if x.dtype == torch.float32 or x.is_cuda:
        y = F.conv_transpose2d(xc, w.to(x.dtype), stride=2, padding=1)
    else:
        y = F.conv_transpose2d(xc.float(), w.float(), stride=2, padding=1)
    y = (y.float() + b.float()[None, :, None, None]).to(x.dtype)
    return y.permute(0, 2, 3, 1)


def block_diag_1x1(K):
    """A 1x1 conv kernel ``[Ci,Co]`` -> its space-to-depth form
    ``[4Ci,4Co]`` (the four phases are independent)."""
    return torch.block_diag(K, K, K, K)


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _mm(a, K):
    """``a @ K`` with a float32 sum, rounded once to ``a.dtype``."""
    return (a.float() @ K.float()).to(a.dtype)


def _conv_s2d(x, Kp, out_dtype=torch.float32):
    """SAME 3x3 conv, float32 sum, result in ``out_dtype``."""
    return _conv_f32(x, Kp, (1, 1, 1, 1)).to(out_dtype)


def _hwio(conv, dtype):
    return conv.weight.detach().permute(2, 3, 1, 0).to(dtype)


def _apply_mask(y, mask4):
    """Zero the out-of-frame pixels of a space-to-depth activation.
    ``mask4 [1,Hs,Ws,4]`` is the per-phase frame mask; activations are
    phase-major with channel blocks of width ``y.shape[-1] // 4``, so the
    mask is repeated to each activation's own width."""
    return y * mask4.repeat_interleave(y.shape[-1] // 4, dim=-1)


def _sft_s2d(sft, x, cond, bf, mask=None):
    """An ``SFTLayer`` in the space-to-depth domain: its 1x1 convs become
    block-diagonal. ``mask`` (odd frame sizes only) zeroes the out-of-frame
    phase channels so every conv sees zero padding at the true edge."""
    def m1(conv, a):
        return (_mm(a, block_diag_1x1(_hwio(conv, bf)[0, 0]))
                + conv.bias.detach().to(bf).repeat(4))
    scale = m1(sft.scale1, _lrelu(m1(sft.scale0, cond)))
    shift = m1(sft.shift1, _lrelu(m1(sft.shift0, cond)))
    y = x * (scale + 1.0) + shift
    return y if mask is None else _apply_mask(y, mask)


def _rdb_s2d(rdb, x, cond, bf, mask=None, wide_dtype=torch.float32):
    """A ``ResidualDenseBlockSFT`` in the space-to-depth domain, walked by
    source: each source feeds one wide conv whose output is split over the
    convs that read it. ``wide_dtype=torch.bfloat16`` rounds those partial
    outputs before the float32 sums across sources."""
    Fc, G = 64, 32
    ks = [_hwio(getattr(rdb, f"conv{i + 1}"), bf) for i in range(5)]
    bs = [getattr(rdb, f"conv{i + 1}").bias.detach().float().repeat(4)
          for i in range(5)]
    cum = np.cumsum([0, Fc, G, G, G, G])
    n = 5
    acc = [None] * n
    src = _sft_s2d(rdb.sft0, x, cond, bf, mask)
    for j in range(n):
        # per-(source, target) transforms side by side on the out axis, each
        # target block (q, d)-ordered like the (p, c) layout it is read in
        kj = torch.cat([s2d_kernel(ks[t][:, :, cum[j]:cum[j + 1], :])
                        for t in range(j, n)], dim=-1)
        wide = _conv_s2d(src, kj, wide_dtype)
        off = 0
        for t in range(j, n):
            cout = 4 * ks[t].shape[-1]
            w32 = wide[..., off:off + cout].float()
            acc[t] = w32 if acc[t] is None else acc[t] + w32
            off += cout
        if j < n - 1:
            y = _lrelu(acc[j] + bs[j]).to(bf)
            if mask is not None:
                y = _apply_mask(y, mask)
            src = _sft_s2d(rdb.sft1, y, cond, bf, mask) if j == 3 else y
    x5 = (acc[n - 1] + bs[n - 1]).to(bf)
    return x5 * 0.2 + x


def sftnet_apply_s2d(model, x, cond, *, wide_dtype=torch.float32):
    """The whole SFTNet decode with the space-to-depth body and the
    phase-decomposed upsample convs; bf16 activations, float32 conv sums.
    ``model``: an ``SFTNet``; ``x [1,H,W,Cin]``, ``cond [1,H,W,num_cond]``
    -> float32 ``[1, sH, sW, 3]``. Odd ``H`` or ``W`` is padded by one and
    the out-of-frame phase channels are masked after every layer."""
    bf = torch.bfloat16
    H, W = x.shape[1], x.shape[2]
    ph, pw = H % 2, W % 2

    def pad(a):
        return F.pad(a, (0, 0, 0, pw, 0, ph))

    def conv(m, a):
        return _conv_s2d(a, _hwio(m, bf), bf) + m.bias.detach().to(bf)

    with torch.no_grad():
        feat = conv(model.conv_first, pad(x.to(bf)))
        c = conv(model.cond0, pad(cond.to(bf)))
        for m in (model.cond1, model.cond2, model.cond3):
            c = _mm(_lrelu(c), _hwio(m, bf)[0, 0]) + m.bias.detach().to(bf)

        mask = None
        if ph or pw:
            ones = torch.ones((1, H, W, 1), dtype=bf, device=x.device)
            mask = s2d(pad(ones))  # [1,Hs,Ws,4] per phase

        body, cs = s2d(feat), s2d(c)
        if mask is not None:
            body = _apply_mask(body, mask)
        for i in range(model.num_block):
            rrdb = getattr(model, f"body{i}")
            xin = cur = body
            for j in (1, 2, 3):
                cur = _rdb_s2d(getattr(rrdb, f"rdb{j}"), cur, cs, bf, mask,
                               wide_dtype)
            body = _sft_s2d(rrdb.sft0, cur, cs, bf, mask) * 0.2 + xin

        body = _sft_s2d(model.sftbody, body, cs, bf, mask)
        body = (_conv_s2d(body, s2d_kernel(_hwio(model.conv_body, bf)), bf)
                + model.conv_body.bias.detach().to(bf).repeat(4))
        # exact sizes from here on: the upchain needs no mask
        body = d2s(body)[:, :H, :W] + feat[:, :H, :W]

        for name in ("conv_up1", "conv_up2"):
            if hasattr(model, name):
                m = getattr(model, name)
                body = _lrelu(conv_up_phase(body, _hwio(m, bf),
                                            m.bias.detach().to(bf)))
        out = _lrelu(conv(model.conv_hr, body))
        out = (_conv_s2d(out, _hwio(model.conv_last, bf))
               + model.conv_last.bias.detach().float())
    return out.float()
