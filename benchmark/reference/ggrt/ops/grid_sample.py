"""Bilinear grid sampling with zero padding.

The two conventions the model uses:
  * epipolar feature sampling: bilinear, zero padding, align_corners=False;
  * photometric warping / cost volumes: align_corners=True, zero padding.
Grid values are in [-1, 1] with x indexing width (torch convention).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample(
    image: torch.Tensor,
    grid: torch.Tensor,
    align_corners: bool = False,
) -> torch.Tensor:
    """image (b, c, h, w), grid (b, ho, wo, 2) -> (b, c, ho, wo)."""
    return F.grid_sample(
        image, grid, mode="bilinear", padding_mode="zeros", align_corners=align_corners
    )
