"""SSIM, in the reference's two flavours:
  * `ssim_photometric`, the photometric loss's: 3x3 average pool after
    reflection padding, C1 = 1e-4, C2 = 9e-4 (photometric_loss.py:143-182);
  * `ssim_metric`, the eval metric's: 11x11 Gaussian window (sigma 1.5),
    zero padding, C1 = 0.01², C2 = 0.03² (ssim_torch.py).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..constants import device_constant


def _avg_pool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-1 mean after reflection padding; (b, c, h, w)."""
    return F.avg_pool2d(F.pad(x, (1, 1, 1, 1), mode="reflect"), 3, stride=1)


def ssim_photometric(x: torch.Tensor, y: torch.Tensor, C1: float = 1e-4, C2: float = 9e-4) -> torch.Tensor:
    """Per-pixel SSIM map (b, c, h, w)."""
    mu_x = _avg_pool3(x)
    mu_y = _avg_pool3(y)
    mu_xy = mu_x * mu_y
    mu_xx = mu_x * mu_x
    mu_yy = mu_y * mu_y
    sigma_x = _avg_pool3(x * x) - mu_xx
    sigma_y = _avg_pool3(y * y) - mu_yy
    sigma_xy = _avg_pool3(x * y) - mu_xy
    v1 = 2.0 * sigma_xy + C2
    v2 = sigma_x + sigma_y + C2
    return ((2.0 * mu_xy + C1) * v1) / ((mu_xx + mu_yy + C1) * v2)


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    """(size, size) normalised Gaussian window, in float64."""
    g = np.exp(-((np.arange(size) - size // 2) ** 2) / (2.0 * sigma**2))
    g = g / g.sum()
    return np.outer(g, g)


def ssim_metric(img1: torch.Tensor, img2: torch.Tensor, window_size: int = 11) -> torch.Tensor:
    """Mean SSIM over an image pair (b, c, h, w)."""
    c = img1.shape[1]
    window = device_constant(tuple(map(tuple, _gaussian_window(window_size, 1.5).tolist())),
                             img1.dtype, img1.device)
    kernel = window.expand(c, 1, window_size, window_size)
    pad = window_size // 2

    def filt(x):
        return F.conv2d(x, kernel, padding=pad, groups=c)

    mu1 = filt(img1)
    mu2 = filt(img2)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu12 = mu1 * mu2
    sigma1 = filt(img1 * img1) - mu1_sq
    sigma2 = filt(img2 * img2) - mu2_sq
    sigma12 = filt(img1 * img2) - mu12
    C1, C2 = 0.01**2, 0.03**2
    ssim_map = ((2 * mu12 + C1) * (2 * sigma12 + C2)) / ((mu1_sq + mu2_sq + C1) * (sigma1 + sigma2 + C2))
    return ssim_map.mean()
