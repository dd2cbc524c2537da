"""U-Net discriminators with spectral normalization (the JAX package's
``models/sr_unetdisc.py``, after frozoul/4K-NeRF lib/sr_unetdisc.py).

A 3-down/3-up U-Net with skip connections whose inner convs are
spectrally normalized, and two conditioned variants that fuse a camera
pose or a viewdir map with a StyleGAN-style projection epilogue
(minibatch stddev, conv, dense, dot product with the condition's map).

Spectral norm is the JAX package's, written out: every call runs one
power iteration from the stored vector ``u`` (``v = l2n(W^T u)``,
``u' = l2n(W v)``, ``sigma = u'^T W v``), divides the kernel by sigma
with no gradient through sigma, and stores ``u'`` only when
``update_sn`` is true. ``torch.nn.utils.spectral_norm`` differs on all
three points, so it is not used. ``u`` is a buffer of each
:class:`SNConv`.

Inputs and outputs are NHWC, as in the JAX package; the convs run in NCHW
inside. Parameter names are flax's (``conv0..conv9``, ``feat``,
``mapping``, ``epilogue/{conv,fc,out}``; leaves ``kernel`` and ``bias``,
conv kernels OIHW, dense kernels ``[in, out]`` as in flax), so
:func:`disc_params` and :func:`disc_spectral` give the trees of the JAX
package's ``params`` and ``spectral`` collections, and
:mod:`fourk_nerf_torch.weights` carries them over by name.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from fourk_nerf_torch.models.sr_esrnet import _trunc_normal

KINDS = ("Unet", "Unet_pose", "Unet_viewdir")


def _lrelu(x):
    return F.leaky_relu(x, 0.2)


def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + 1e-12)


class Conv(nn.Module):
    """A plain conv with bias: OIHW ``kernel``, SAME padding, stride 1."""

    def __init__(self, cin: int, cout: int, k: int = 3):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return F.conv2d(x, self.kernel, self.bias,
                        padding=self.kernel.shape[-1] // 2)


class Dense(nn.Module):
    """``x @ kernel + bias`` with flax's ``[in, out]`` kernel."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):
        return x @ self.kernel + self.bias


class SNConv(nn.Module):
    """A bias-free conv normalized by its spectral norm, one power
    iteration a call from the buffer ``u``; ``padding`` 1 for the 3x3
    stride-1 convs (SAME) and the 4x4 stride-2 ones."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.register_buffer("u", torch.zeros(cout))
        self.stride = stride

    def sigma(self, update_sn: bool) -> torch.Tensor:
        """The spectral norm's estimate after one power iteration (no
        gradient); stores the new ``u`` when ``update_sn``."""
        with torch.no_grad():
            w = self.kernel.reshape(self.kernel.shape[0], -1)
            v = _l2n(w.t() @ self.u)
            u_new = _l2n(w @ v)
            sigma = (u_new @ w) @ v
            if update_sn:
                self.u.copy_(u_new)
        return sigma

    def forward(self, x, update_sn: bool = True):
        return F.conv2d(x, self.kernel / self.sigma(update_sn),
                        stride=self.stride, padding=1)


def _resize_bilinear(x, h: int, w: int):
    """NCHW bilinear resize with half-pixel centres; antialiased when it
    shrinks, as ``jax.image.resize`` is."""
    if (h, w) == tuple(x.shape[2:]):
        return x
    shrink = h < x.shape[2] or w < x.shape[3]
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False, antialias=shrink)


class _Trunk(nn.Module):
    """The U-Net trunk: ``conv0`` (plain), three stride-2 SN convs down,
    three x2 bilinear ups with SN convs and skip connections, two more SN
    convs; ``features`` returns the NCHW features before the head."""

    def __init__(self, num_feat: int = 64):
        super().__init__()
        nf = num_feat
        self.conv0 = Conv(3, nf)
        self.conv1 = SNConv(nf, nf * 2, 4, 2)
        self.conv2 = SNConv(nf * 2, nf * 4, 4, 2)
        self.conv3 = SNConv(nf * 4, nf * 8, 4, 2)
        self.conv4 = SNConv(nf * 8, nf * 4, 3)
        self.conv5 = SNConv(nf * 4, nf * 2, 3)
        self.conv6 = SNConv(nf * 2, nf, 3)
        self.conv7 = SNConv(nf, nf, 3)
        self.conv8 = SNConv(nf, nf, 3)

    def features(self, x, update_sn: bool):
        """NHWC image -> NCHW features of ``conv8``."""
        x = x.permute(0, 3, 1, 2)
        x = _resize_bilinear(x, x.shape[2] // 8 * 8, x.shape[3] // 8 * 8)
        x0 = _lrelu(self.conv0(x))
        x1 = _lrelu(self.conv1(x0, update_sn))
        x2 = _lrelu(self.conv2(x1, update_sn))
        x3 = _lrelu(self.conv3(x2, update_sn))
        skips = (x2, x1, x0)
        h = x3
        for conv, skip in zip((self.conv4, self.conv5, self.conv6), skips):
            h = _resize_bilinear(h, h.shape[2] * 2, h.shape[3] * 2)
            h = _lrelu(conv(h, update_sn)) + skip
        h = _lrelu(self.conv7(h, update_sn))
        return _lrelu(self.conv8(h, update_sn))


class UNetDiscriminatorSN(_Trunk):
    """The plain U-Net discriminator (reference lib/sr_unetdisc.py:7-62):
    ``forward(x [N,H,W,3]) -> [N, H8, W8, 1]`` logits, ``H8``/``W8`` the
    input's sides rounded down to a multiple of 8."""

    kind = "Unet"

    def __init__(self, num_feat: int = 64):
        super().__init__(num_feat)
        self.conv9 = Conv(num_feat, 1)

    def forward(self, x, update_sn: bool = True):
        return self.conv9(self.features(x, update_sn)).permute(0, 2, 3, 1)


def minibatch_std(x, group_size: int = 4):
    """NHWC ``x`` with the per-group feature stddev appended as one channel
    (reference lib/utils.py:348-369)."""
    n, h, w, c = x.shape
    g = min(group_size, n)
    y = x.reshape(g, -1, h, w, 1, c)
    y = y - y.mean(0)
    y = torch.sqrt((y ** 2).mean(0) + 1e-8)
    y = y.mean((1, 2, 4)).reshape(-1, 1, 1, 1).repeat(g, h, w, 1)
    return torch.cat([x, y], -1)


class DiscriminatorEpilogue(nn.Module):
    """StyleGAN2's conditional epilogue (reference lib/utils.py:372-433):
    minibatch stddev, a 3x3 conv, ``fc`` over the NHWC-flattened map,
    ``out`` to ``cmap_dim``, then the dot product with the condition's map
    over ``sqrt(cmap_dim)``. ``fc_in`` is the flattened size,
    ``H8 * W8 * in_channels``."""

    def __init__(self, in_channels: int, cmap_dim: int, fc_in: int):
        super().__init__()
        self.cmap_dim = cmap_dim
        self.conv = Conv(in_channels + 1, in_channels)
        self.fc = Dense(fc_in, in_channels)
        self.out = Dense(in_channels, cmap_dim)

    def forward(self, x, cmap):
        """``x`` NCHW features, ``cmap [N, cmap_dim]`` -> ``[N, 1]``."""
        x = minibatch_std(x.permute(0, 2, 3, 1))
        x = _lrelu(self.conv(x.permute(0, 3, 1, 2)))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)  # flax's order
        x = self.out(_lrelu(self.fc(x)))
        cmap = cmap.reshape(cmap.shape[0], -1)
        return (x * cmap).sum(-1, keepdim=True) * (1.0 / math.sqrt(
            self.cmap_dim))


def _normalize_2nd_moment(x, dim: int = -1, eps: float = 1e-8):
    return x * torch.rsqrt((x ** 2).mean(dim, keepdim=True) + eps)


def fc_in_for(num_feat: int, in_hw) -> int:
    """The epilogue's flattened size for an ``in_hw = (H, W)`` input:
    ``H8 * W8 * num_feat``."""
    return (in_hw[0] // 8 * 8) * (in_hw[1] // 8 * 8) * num_feat


class UNetDiscriminatorSNPose(nn.Module):
    """The pose-conditioned variant (reference lib/sr_unetdisc.py:65-129):
    the flattened 3x3 w2c rotation through ``mapping`` and a 2nd-moment
    normalization is the epilogue's condition. ``forward(x [N,H,W,3],
    pose_flat [N,9]) -> [N, 1]``. The JAX module declares an unused
    ``trunk`` that owns no parameters; there is none here."""

    kind = "Unet_pose"

    def __init__(self, num_feat: int, cmap_dim: int, fc_in: int):
        super().__init__()
        self.feat = _Trunk(num_feat)
        self.mapping = Dense(9, cmap_dim)
        self.epilogue = DiscriminatorEpilogue(num_feat, cmap_dim, fc_in)

    def forward(self, x, pose_flat, update_sn: bool = True):
        feats = self.feat.features(x, update_sn)
        cmap = _normalize_2nd_moment(self.mapping(pose_flat))
        return self.epilogue(feats, cmap)


class UNetDiscriminatorSNViewdir(nn.Module):
    """The viewdir-conditioned variant (reference
    lib/sr_unetdisc.py:132-196): a 1x1 ``mapping`` conv of the LR patch's
    viewdir PE map, normalized over channels and averaged over pixels, is
    the epilogue's condition. ``forward(x [N,H,W,3], viewdir_cond
    [N,h,w,63]) -> [N, 1]``."""

    kind = "Unet_viewdir"

    def __init__(self, num_feat: int, cmap_dim: int, fc_in: int):
        super().__init__()
        self.feat = _Trunk(num_feat)
        self.mapping = Conv(63, cmap_dim, 1)
        self.epilogue = DiscriminatorEpilogue(num_feat, cmap_dim, fc_in)

    def forward(self, x, viewdir_cond, update_sn: bool = True):
        feats = self.feat.features(x, update_sn)
        cmap = self.mapping(viewdir_cond.permute(0, 3, 1, 2))
        cmap = _normalize_2nd_moment(cmap, dim=1).mean((2, 3))
        return self.epilogue(feats, cmap)


def build(kind: str, num_feat: int = 64,
          fc_in: int | None = None) -> nn.Module:
    """The discriminator named by a config's ``d_model`` (run_sr.py:681-686):
    ``Unet``, ``Unet_pose`` (cmap 32) or ``Unet_viewdir`` (cmap 64). The
    conditioned two need the flattened size ``fc_in`` of their epilogue's
    dense layer (:func:`fc_in_for`)."""
    if kind in ("Unet_pose", "Unet_viewdir") and fc_in is None:
        raise ValueError(f"the {kind} discriminator needs fc_in")
    if kind == "Unet_pose":
        return UNetDiscriminatorSNPose(num_feat, 32, fc_in)
    if kind == "Unet_viewdir":
        return UNetDiscriminatorSNViewdir(num_feat, 64, fc_in)
    if kind != "Unet":
        raise ValueError(f"unknown discriminator {kind!r}; one of {KINDS}")
    return UNetDiscriminatorSN(num_feat)


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator):
    """Draw ``model``'s weights from flax's initialisers, in place: every
    kernel ``lecun_normal`` (a normal truncated to two standard deviations,
    variance 1/fan_in), every bias zero, every ``u`` standard normal; all
    from ``generator``. Returns ``model``."""
    for name, p in model.named_parameters():
        if name.endswith("kernel"):
            fan_in = p.shape[0] if p.dim() == 2 else p[0].numel()
            p.copy_((_trunc_normal(p.shape, generator)
                     * (math.sqrt(1.0 / fan_in) / 0.87962566103423978))
                    .to(p.device))
        else:
            p.zero_()
    for name, b in model.named_buffers():
        if name.endswith("u"):
            b.copy_(torch.randn(b.shape, generator=generator).to(b.device))
    return model


def _tree(named) -> dict:
    tree: dict = {}
    for path, t in named:
        node = tree
        parts = path.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = t
    return tree


def disc_params(model: nn.Module) -> dict:
    """The parameters as a tree of flax's names, each leaf the module's own
    tensor (conv kernels OIHW): the discriminator's MaskedAdam group."""
    return _tree(model.named_parameters())


def disc_spectral(model: nn.Module) -> dict:
    """The ``u`` buffers as the JAX ``spectral`` collection's tree
    (``{conv_i: {"u": ...}}``, under ``feat`` for the conditioned
    variants), each leaf the module's own buffer."""
    return _tree(model.named_buffers())


def d_condition(kind: str, viewdirs, w2c, patch: int):
    """The discriminator's condition (run_sr.py:861-867): None for
    ``Unet``, the flattened ``w2c [1, 9]`` for ``Unet_pose``, the viewdir
    PE map ``[1, patch, patch, 63]`` of the LR patch's rays (no gradient)
    for ``Unet_viewdir``."""
    if kind == "Unet_pose":
        if w2c is None:
            raise ValueError("the Unet_pose discriminator needs the view's "
                             "w2c in the batch")
        return w2c.reshape(1, 9)
    if kind == "Unet_viewdir":
        from fourk_nerf_torch.ops import rays as ray_ops
        vd = ray_ops.positional_encoding(viewdirs, 10)
        return vd.reshape(1, patch, patch, -1).detach()
    return None


def apply(model: nn.Module, x, cond, update_sn: bool):
    """``model(x, update_sn=...)``, or with ``cond`` when it is given."""
    if cond is None:
        return model(x, update_sn=update_sn)
    return model(x, cond, update_sn=update_sn)
