"""SR-training losses: the vanilla GAN loss, the VGG19 perceptual and style
loss, and NNFM (the JAX package's ``train/sr_losses.py``).

Parity targets: basicsr ``GANLoss(gan_type='vanilla')`` and
``PerceptualLoss(layer_weights={conv3_4: 1, conv4_4: 1, conv5_4: 1},
vgg_type='vgg19', perceptual_weight, style_weight)`` as the reference's
joint trainer wires them (frozoul/4K-NeRF run_sr.py:670-689).

The VGG19 tower is written out (torchvision is not assumed). Its weights
come from a torchvision ``vgg19-*.pth`` state dict found locally
(:func:`find_vgg19_weights`; nothing is downloaded), or from an explicit
argument; without either, :class:`PerceptualLoss` refuses unless
``allow_random_vgg`` asks for a fixed-seed random tower. The weights live
on the device once, without gradients.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from fourk_nerf_torch.device import resolve_device


# ---------------------------------------------------------------------------
# GAN loss (vanilla = BCE-with-logits)
# ---------------------------------------------------------------------------

def gan_loss(pred, target_is_real: bool, *, is_disc: bool,
             loss_weight: float = 1.0):
    """basicsr's vanilla GANLoss: BCE-with-logits against 1 or 0 in its
    stable form, the mean over all entries; the generator's side is scaled
    by ``loss_weight``, the discriminator's is not."""
    target = 1.0 if target_is_real else 0.0
    loss = (pred.clamp_min(0) - pred * target
            + torch.log1p(torch.exp(-pred.abs()))).mean()
    return loss if is_disc else loss_weight * loss


# ---------------------------------------------------------------------------
# VGG19 feature extractor
# ---------------------------------------------------------------------------

#: VGG19's conv plan: (name, out_channels); "M" a 2x2 max pool
VGG19_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), ("conv3_4", 256),
    "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), ("conv4_4", 512),
    "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512), ("conv5_4", 512),
    "M",
]

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _conv_names():
    return [item[0] for item in VGG19_PLAN if isinstance(item, tuple)]


class VGG19Features:
    """VGG19 up to the deepest requested layer; ``__call__(x [N,H,W,3] in
    [0, 1])`` returns a dict of the requested layers' activations (after
    the ReLU, before any pool), NHWC, after ImageNet normalization (basicsr
    ``use_input_norm``). ``params``: ``{conv_name: {"kernel": OIHW,
    "bias"}}`` (at least the layers up to the deepest requested), put on
    ``device`` (default ``cuda``) once, without gradients."""

    def __init__(self, layers: Sequence[str], params: dict, device=None):
        self.layers = tuple(layers)
        dev = resolve_device(device)
        wanted = set(self.layers)
        self.deepest = max(i for i, item in enumerate(VGG19_PLAN)
                           if isinstance(item, tuple) and item[0] in wanted)
        self.params = {
            name: {k: torch.as_tensor(v, dtype=torch.float32).detach()
                   .to(dev).requires_grad_(False) for k, v in p.items()}
            for name, p in params.items()
            if name in {item[0] for item in VGG19_PLAN[:self.deepest + 1]
                        if isinstance(item, tuple)}}
        self.mean = torch.tensor(_IMAGENET_MEAN, device=dev).view(1, 3, 1, 1)
        self.std = torch.tensor(_IMAGENET_STD, device=dev).view(1, 3, 1, 1)

    def __call__(self, x) -> dict:
        x = (x.permute(0, 3, 1, 2) - self.mean) / self.std
        out = {}
        for item in VGG19_PLAN[:self.deepest + 1]:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
                continue
            name = item[0]
            p = self.params[name]
            x = F.relu(F.conv2d(x, p["kernel"], p["bias"], padding=1))
            if name in self.layers:
                out[name] = x.permute(0, 2, 3, 1)  # NHWC views
        return out


def import_vgg19_torch(path: str, allow_unsafe_pickle: bool = False) -> dict:
    """A torchvision vgg19 ``features``-prefixed state dict -> the tower's
    params ``{conv_name: {"kernel": OIHW, "bias"}}`` (float32, on the
    CPU).

    A downloaded ``.pth`` can carry code: only the safe ``weights_only``
    unpickler is used unless full unpickling is asked for
    (``allow_unsafe_pickle=True`` or ``FOURK_ALLOW_UNSAFE_PICKLE=1``), so a
    malformed file cannot regain code execution by failing the safe
    parse."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception:
        if not (allow_unsafe_pickle
                or os.environ.get("FOURK_ALLOW_UNSAFE_PICKLE") == "1"):
            raise RuntimeError(
                f"import_vgg19_torch: safe (weights_only) load failed for "
                f"{path}. If you trust this file, re-run with "
                f"allow_unsafe_pickle=True or FOURK_ALLOW_UNSAFE_PICKLE=1.")
        print(f"import_vgg19_torch: weights_only load failed; falling back "
              f"to full unpickling for {path} (explicitly opted in)")
        sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    # torchvision's indexes: the convs at features.{0,2,5,7,10,12,...}
    idxs, i = [], 0
    for item in VGG19_PLAN:
        if item == "M":
            i += 1
            continue
        idxs.append(i)
        i += 2  # conv + relu
    return {name: {"kernel": torch.as_tensor(sd[f"features.{idx}.weight"],
                                             dtype=torch.float32),
                   "bias": torch.as_tensor(sd[f"features.{idx}.bias"],
                                           dtype=torch.float32)}
            for name, idx in zip(_conv_names(), idxs)}


def find_vgg19_weights() -> str | None:
    """The first ``vgg19*.pth`` in ``~/.cache/torch/hub/checkpoints``,
    ``./weights`` or ``./pretrained`` (sorted by name), else None."""
    for d in (os.path.expanduser("~/.cache/torch/hub/checkpoints"),
              "./weights", "./pretrained"):
        if os.path.isdir(d):
            for f in sorted(os.listdir(d)):
                if f.startswith("vgg19") and f.endswith(".pth"):
                    return os.path.join(d, f)
    return None


def random_vgg19_params() -> dict:
    """A fixed-seed random tower for ``allow_random_vgg``: every kernel
    lecun-normal (a normal truncated to two standard deviations, variance
    1/fan_in) from numpy ``default_rng(0)`` in the plan's order, every
    bias zero. It cannot equal the JAX package's ``PRNGKey(0)`` tower, and
    neither is the published objective's VGG: random convnet features are
    a perceptual baseline that keeps every loss term live where no
    pretrained weights exist."""
    rng = np.random.default_rng(0)
    params, cin = {}, 3
    for item in VGG19_PLAN:
        if item == "M":
            continue
        name, cout = item
        shape = (cout, cin, 3, 3)
        w = rng.standard_normal(shape)
        bad = np.abs(w) > 2
        while bad.any():
            w[bad] = rng.standard_normal(int(bad.sum()))
            bad = np.abs(w) > 2
        w *= math.sqrt(1.0 / (cin * 9)) / 0.87962566103423978
        params[name] = {"kernel": torch.as_tensor(w, dtype=torch.float32),
                        "bias": torch.zeros(cout)}
        cin = cout
    return params


def _tower_params(vgg_params, allow_random_vgg: bool, what: str):
    if vgg_params is not None:
        return vgg_params
    path = find_vgg19_weights()
    if path is not None:
        return import_vgg19_torch(path)
    if allow_random_vgg:
        return random_vgg19_params()
    raise FileNotFoundError(what)


class PerceptualLoss:
    """VGG19 perceptual + style loss as basicsr configures it for the
    reference (run_sr.py:670-678): the L1 criterion on the features of
    ``layer_weights`` (``conv3_4``, ``conv4_4``, ``conv5_4`` at weight 1),
    the style term the L1 of their Gram matrices. ``vgg_params``: the
    tower's params (``{conv_name: {"kernel": OIHW, "bias"}}``); None reads
    the local torchvision weights, or, with ``allow_random_vgg``, draws
    :func:`random_vgg19_params`; neither raises ``FileNotFoundError``."""

    def __init__(self, layer_weights: dict | None = None,
                 perceptual_weight: float = 1.0, style_weight: float = 0.0,
                 vgg_params: dict | None = None,
                 allow_random_vgg: bool = False, device=None):
        self.layer_weights = layer_weights or {"conv3_4": 1.0,
                                               "conv4_4": 1.0,
                                               "conv5_4": 1.0}
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        params = _tower_params(
            vgg_params, allow_random_vgg,
            "No pretrained VGG19 weights found (zero-egress image). Place a "
            "torchvision vgg19 .pth under ~/.cache/torch/hub/checkpoints or "
            "./weights, or pass allow_random_vgg=True.")
        self.model = VGG19Features(tuple(self.layer_weights), params, device)

    def __call__(self, x, gt):
        """``x``, ``gt``: NHWC in [0, 1]. Returns the weighted (perceptual,
        style) losses; the truth's features are taken without gradients."""
        fx = self.model(x)
        with torch.no_grad():
            fg = self.model(gt)
        percep = style = x.new_zeros(())
        for name, w in self.layer_weights.items():
            percep = percep + w * (fx[name] - fg[name]).abs().mean()
            if self.style_weight > 0:
                style = style + w * (_gram(fx[name])
                                     - _gram(fg[name])).abs().mean()
        return self.perceptual_weight * percep, self.style_weight * style


def _gram(feat):
    """The Gram matrix of NHWC features over ``c * h * w`` (basicsr
    ``_gram_mat``); the tower's views of NCHW maps reshape without a
    copy."""
    n, h, w, c = feat.shape
    f = feat.permute(0, 3, 1, 2).reshape(n, c, h * w)
    return (f @ f.transpose(1, 2)) / (c * h * w)


# ---------------------------------------------------------------------------
# NNFM: nearest-neighbour feature matching (reference lib/sr_loss.py:9-188;
# the reference's trainers register it, the published configs leave it
# off)
# ---------------------------------------------------------------------------

def nn_feature_match_loss(feat_x, feat_gt, block: int = 8192):
    """The mean cosine distance from each feature of ``feat_x`` to its
    nearest feature of ``feat_gt`` (no gradient through the latter), in
    blocks of ``block`` rows (lib/sr_loss.py:9-67). ``[N, H, W, C]``."""
    def flat_norm(f):
        v = f.reshape(-1, f.shape[-1])
        return v / (torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-8)

    x = flat_norm(feat_x)
    g = flat_norm(feat_gt.detach())
    best = torch.cat([torch.amax(x[s:s + block] @ g.t(), dim=-1)
                      for s in range(0, x.shape[0], block)])
    return (1.0 - best).mean()


class NNFMLoss:
    """VGG19 feature losses by name (``nnfm_loss``, ``gram_loss``,
    ``content_loss``) summed over ``layers``, as the reference's
    NNFMLoss.forward (lib/sr_loss.py:70-188), on the same gated tower as
    :class:`PerceptualLoss`."""

    def __init__(self, layers: Sequence[str] = ("conv3_4", "conv4_4"),
                 vgg_params=None, allow_random_vgg: bool = False,
                 device=None):
        self.layers = tuple(layers)
        params = _tower_params(vgg_params, allow_random_vgg,
                               "No pretrained VGG19 weights found.")
        self.model = VGG19Features(self.layers, params, device)

    def __call__(self, outputs, styles, loss_names=("nnfm_loss",)) -> dict:
        fx, fs = self.model(outputs), self.model(styles)
        losses = {k: 0.0 for k in loss_names}
        for name in self.layers:
            a, b = fx[name], fs[name]
            if "nnfm_loss" in losses:
                losses["nnfm_loss"] = losses["nnfm_loss"] \
                    + nn_feature_match_loss(a, b)
            if "gram_loss" in losses:
                losses["gram_loss"] = losses["gram_loss"] \
                    + ((_gram(a) - _gram(b)) ** 2).mean()
            if "content_loss" in losses:
                losses["content_loss"] = losses["content_loss"] \
                    + ((a - b) ** 2).mean()
        return losses
