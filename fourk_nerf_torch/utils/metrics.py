"""Evaluation metrics: PSNR, SSIM, 8-bit conversion, LPIPS and its proxy.

PSNR and the gaussian-window SSIM (the mip-NeRF form) give the numbers of
the JAX package's ``utils/metrics.py``; SSIM and the LPIPS proxy (the JAX
package's fixed-seed random-feature stand-in for LPIPS) are computed with
torch convolutions on the device of their inputs. :func:`rgb_lpips` is the
``lpips`` package's metric, None where the package is missing.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from fourk_nerf_torch.device import fp32_precision


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr(img, gt) -> float:
    return mse2psnr(float(np.mean(np.square(np.asarray(img) - np.asarray(gt)))))


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False):
    """Gaussian-window SSIM on ``[H, W, 3]`` float images, computed in
    float64 by torch convolutions on the device of a tensor input (a 4K
    frame scores on the card in milliseconds), else on the CPU. The map
    comes back as the inputs came: a tensor, or a numpy array."""
    tensors = [x for x in (img0, img1) if isinstance(x, torch.Tensor)]
    dev = tensors[0].device if tensors else torch.device("cpu")
    a, b = (torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                            else x).to(dev, torch.float64)
            for x in (img0, img1))
    if not (a.dim() == 3 and a.shape[-1] == 3 and a.shape == b.shape):
        raise ValueError("rgb_ssim takes two [H, W, 3] images of one shape")

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt = torch.as_tensor(filt / np.sum(filt), device=dev)

    def filt_fn(z):
        # separable 'valid' convolution along both spatial axes (the
        # window is symmetric, so correlation is convolution)
        z = z.permute(2, 0, 1)[:, None]
        z = F.conv2d(F.conv2d(z, filt.view(1, 1, -1, 1)),
                     filt.view(1, 1, 1, -1))
        return z[:, 0].permute(1, 2, 0)

    mu0, mu1 = filt_fn(a), filt_fn(b)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = (filt_fn(a * a) - mu00).clamp_min(0.0)
    sigma11 = (filt_fn(b * b) - mu11).clamp_min(0.0)
    sigma01 = filt_fn(a * b) - mu01
    sigma01 = torch.sign(sigma01) * torch.minimum(
        torch.sqrt(sigma00 * sigma11), sigma01.abs())
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    if return_map:
        return ssim_map if tensors else ssim_map.cpu().numpy()
    return float(ssim_map.mean())


_LPIPS_PROXY_FILTERS: dict = {}


def _lpips_proxy_filters(n_feats: int, seed: int) -> np.ndarray:
    """The proxy's fixed ``[3, 3, 3, n_feats]`` (HWIO) filters of one
    scale: numpy normal draws of ``seed``, zero-mean over the window, unit
    norm per output feature (the JAX package's numbers)."""
    key = (n_feats, seed)
    if key not in _LPIPS_PROXY_FILTERS:
        rng = np.random.default_rng(seed)
        f = rng.normal(size=(3, 3, 3, n_feats)).astype(np.float32)
        f -= f.mean(axis=(0, 1), keepdims=True)  # zero-mean: edge-sensitive
        f /= np.sqrt(np.sum(f * f, axis=(0, 1, 2), keepdims=True))
        _LPIPS_PROXY_FILTERS[key] = f
    return _LPIPS_PROXY_FILTERS[key]


def _random_feats(img: torch.Tensor, filters: np.ndarray) -> torch.Tensor:
    """'valid' 3x3 conv of ``img [H, W, 3]`` with ``filters`` (HWIO), relu,
    then unit norm over the features at each pixel."""
    w = torch.as_tensor(filters, device=img.device).permute(3, 2, 0, 1)
    feat = F.conv2d(img.permute(2, 0, 1)[None], w)[0].permute(1, 2, 0)
    feat = torch.relu(feat)
    return feat / (torch.linalg.vector_norm(feat, dim=-1, keepdim=True)
                   + 1e-8)


@torch.no_grad()
def rgb_lpips_proxy(gt, im, n_scales: int = 3, n_feats: int = 24,
                    seed: int = 0) -> float:
    """The JAX package's deterministic LPIPS-style distance (per scale: a
    fixed-seed random 3x3 conv, relu, unit normalization, the squared
    difference summed over features and averaged over pixels; scales
    summed, each the 2x2 mean of the one before). It is not the published
    LPIPS and is not comparable to it: it lets the best-checkpoint gate run
    where the ``lpips`` package is absent. ``gt``, ``im``: ``[H, W, 3]``
    arrays or tensors (computed on the tensors' device, in float32)."""
    dev = im.device if isinstance(im, torch.Tensor) else torch.device("cpu")
    a = torch.as_tensor(gt, dtype=torch.float32).to(dev)
    b = torch.as_tensor(im, dtype=torch.float32).to(dev)
    if a.shape != b.shape or a.dim() != 3 or a.shape[-1] != 3:
        raise ValueError("rgb_lpips_proxy takes two [H, W, 3] images of one "
                         "shape")
    total = 0.0
    with fp32_precision():
        for s in range(n_scales):
            if min(a.shape[0], a.shape[1]) < 3:
                break
            filters = _lpips_proxy_filters(n_feats, seed + s)
            fa, fb = _random_feats(a, filters), _random_feats(b, filters)
            total += float(((fa - fb) ** 2).sum(-1).mean())
            if s + 1 < n_scales:
                ha, wa = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
                a = a[:ha, :wa].reshape(ha // 2, 2, wa // 2, 2, 3).mean((1, 3))
                b = b[:ha, :wa].reshape(ha // 2, 2, wa // 2, 2, 3).mean((1, 3))
    return total


_LPIPS_CACHE: dict = {}


def rgb_lpips(gt, im, net_name: str = "vgg") -> float | None:
    """LPIPS of two ``[H, W, 3]`` images in [0, 1] by the ``lpips``
    package (its ``net_name`` network, version 0.1, on the CPU); None when
    the package is not installed."""
    try:
        import lpips  # type: ignore
    except ImportError:
        return None
    if net_name not in _LPIPS_CACHE:
        _LPIPS_CACHE[net_name] = lpips.LPIPS(net=net_name,
                                             version="0.1").eval()
    model = _LPIPS_CACHE[net_name]
    gt_t = torch.as_tensor(np.asarray(gt, dtype=np.float32)).permute(2, 0, 1)
    im_t = torch.as_tensor(np.asarray(im, dtype=np.float32)).permute(2, 0, 1)
    with torch.no_grad():
        return float(model(gt_t, im_t, normalize=True).item())
