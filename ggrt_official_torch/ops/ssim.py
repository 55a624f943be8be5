"""SSIM of the photometric loss: 3x3 average pool after reflection padding,
C1 = 1e-4, C2 = 9e-4 (the reference's photometric_loss.py:143-182)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


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
