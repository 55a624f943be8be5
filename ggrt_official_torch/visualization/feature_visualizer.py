"""Feature-map visualization by PCA projection to RGB (the JAX package's
visualization/feature_visualizer.py; the reference's
visualization/feature_visualizer.py): each (c, h, w) map is projected onto
its three principal components and normalised between robust
percentiles. Torch on the input's device.
"""
from __future__ import annotations

import torch

from .color_map import apply_color_map_to_image
from .layout import resize_image


def visualize_features(features: torch.Tensor, clip_pct: float = 2.0) -> torch.Tensor:
    """(c, h, w) features -> (3, h, w) PCA-RGB in [0, 1]."""
    c, h, w = features.shape
    x = features.reshape(c, h * w).T                       # (p, c)
    x = x - x.mean(dim=0, keepdim=True)
    # Principal directions from the (c, c) covariance's eigendecomposition.
    cov = x.T @ x / x.shape[0]
    _, vecs = torch.linalg.eigh(cov)
    proj = x @ vecs[:, -3:].flip(-1)                       # (p, 3), the top 3 first
    q = torch.tensor([clip_pct / 100.0, 1.0 - clip_pct / 100.0], dtype=proj.dtype, device=proj.device)
    lo, hi = torch.quantile(proj, q, dim=0)
    proj = torch.clamp((proj - lo) / torch.clamp(hi - lo, min=1e-8), 0.0, 1.0)
    return proj.T.reshape(3, h, w)


def visualize_attention(attn: torch.Tensor, image: torch.Tensor, alpha: float = 0.6,
                        cmap: str = "inferno") -> torch.Tensor:
    """Overlay an (h, w) attention or probability map on a (3, H, W) image."""
    a = attn / torch.clamp(attn.max(), min=1e-8)
    heat = resize_image(apply_color_map_to_image(a, cmap), image.shape)
    a_up = resize_image(a[None], (1, *image.shape[1:]))
    return image * (1.0 - alpha * a_up) + heat * (alpha * a_up)
