"""Nearest-up x2 followed by a 3x3 conv, without the upsampled tensor.

``conv3x3(nearest_up2(x))`` equals one 4x4 conv over the zero-dilated input
(the JAX package's ``s2d.conv_up_dilated``, an ``lhs_dilation=2`` conv):
nearest-up2 is zero-up2 followed by a 2x2 ones smear, and the smear folds
into the kernel, ``K'[u+2] = sum_{e in {0,1}} K[u+e+1]`` per axis. In torch
that is ``conv_transpose2d`` with stride 2, padding 1 and the flipped 4x4
kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


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
