"""RGB and depth training criteria (the reference's loss/criterion.py)."""
from __future__ import annotations

import torch

from ..geometry.depth import depth2inv

TINY = 1e-6


def img2mse(x: torch.Tensor, y: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
    if mask is None:
        return ((x - y) ** 2).mean()
    return ((x - y) ** 2 * mask[..., None]).sum() / (mask.sum() * x.shape[-1] + TINY)


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def masked_l2_image_loss(outputs: dict, gt: dict) -> torch.Tensor:
    """MSE between predicted and ground-truth rgb (ref criterion.py:23-40)."""
    return img2mse(outputs["rgb"], gt["rgb"], outputs.get("mask"))


def self_sup_depth_loss(inv_depth_prior, rendered_depth, min_depth, max_depth) -> torch.Tensor:
    """L1 between the IPO-Net inverse-depth prior and the rendered depth,
    inside the valid disparity band (ref criterion.py:82-94)."""
    valid = ((inv_depth_prior > 1.0 / max_depth) & (inv_depth_prior < 1.0 / min_depth)).to(inv_depth_prior.dtype)
    return (valid * (inv_depth_prior - depth2inv(rendered_depth)).abs()).mean()


def sup_depth_loss(inv_depths, gt_depth, min_depth, max_depth, gamma: float = 0.85) -> torch.Tensor:
    """Iteration-weighted supervised depth loss (ref criterion.py:97-117);
    inv_depths (n_iters, ...) stacked predictions."""
    n = inv_depths.shape[0]
    gt_inv = depth2inv(gt_depth)
    valid = ((gt_inv > 1.0 / max_depth) & (gt_inv < 1.0 / min_depth)).to(inv_depths.dtype)
    weights = gamma ** (n - 1 - torch.arange(n, dtype=inv_depths.dtype, device=inv_depths.device))
    per_iter = (valid[None] * (gt_inv[None] - inv_depths).abs()).mean(dim=tuple(range(1, inv_depths.dim())))
    return (weights * per_iter).sum() / weights.sum()
