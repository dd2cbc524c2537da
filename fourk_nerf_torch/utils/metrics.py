"""Evaluation metrics on host arrays: PSNR, SSIM, 8-bit conversion.

PSNR and the gaussian-window SSIM (the mip-NeRF form) follow the JAX
package's ``utils/metrics.py``; numpy and scipy only.
"""

from __future__ import annotations

import numpy as np


def mse2psnr(mse: float) -> float:
    return float(-10.0 * np.log10(mse))


def psnr(img, gt) -> float:
    return mse2psnr(float(np.mean(np.square(np.asarray(img) - np.asarray(gt)))))


def to8b(x) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def rgb_ssim(img0, img1, max_val=1.0, filter_size=11, filter_sigma=1.5,
             k1=0.01, k2=0.03, return_map=False):
    """Gaussian-window SSIM on ``[H, W, 3]`` float images."""
    from scipy.signal import convolve2d

    img0 = np.asarray(img0, dtype=np.float64)
    img1 = np.asarray(img1, dtype=np.float64)
    if not (img0.ndim == 3 and img0.shape[-1] == 3
            and img0.shape == img1.shape):
        raise ValueError("rgb_ssim takes two [H, W, 3] images of one shape")

    hw = filter_size // 2
    shift = (2 * hw - filter_size + 1) / 2
    f_i = ((np.arange(filter_size) - hw + shift) / filter_sigma) ** 2
    filt = np.exp(-0.5 * f_i)
    filt /= np.sum(filt)

    def filt_fn(z):
        # separable 'valid' convolution along both spatial axes
        return np.stack([
            convolve2d(convolve2d(z[..., i], filt[:, None], mode="valid"),
                       filt[None, :], mode="valid")
            for i in range(z.shape[-1])], -1)

    mu0 = filt_fn(img0)
    mu1 = filt_fn(img1)
    mu00, mu11, mu01 = mu0 * mu0, mu1 * mu1, mu0 * mu1
    sigma00 = np.maximum(0.0, filt_fn(img0 ** 2) - mu00)
    sigma11 = np.maximum(0.0, filt_fn(img1 ** 2) - mu11)
    sigma01 = filt_fn(img0 * img1) - mu01
    sigma01 = np.sign(sigma01) * np.minimum(np.sqrt(sigma00 * sigma11),
                                            np.abs(sigma01))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    numer = (2 * mu01 + c1) * (2 * sigma01 + c2)
    denom = (mu00 + mu11 + c1) * (sigma00 + sigma11 + c2)
    ssim_map = numer / denom
    return ssim_map if return_map else float(np.mean(ssim_map))
