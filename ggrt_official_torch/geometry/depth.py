"""Depth / disparity conversions and the edge-aware smoothness terms on
torch tensors."""
from __future__ import annotations

import torch


def relative_disparity_to_depth(
    relative_disparity: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    """0 = near, 1 = far."""
    disp_near = 1.0 / (near + eps)
    disp_far = 1.0 / (far + eps)
    return 1.0 / ((1.0 - relative_disparity) * (disp_near - disp_far) + disp_far + eps)


def depth_to_relative_disparity(
    depth: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    eps: float = 1e-10,
) -> torch.Tensor:
    disp_near = 1.0 / (near + eps)
    disp_far = 1.0 / (far + eps)
    disp = 1.0 / (depth + eps)
    return 1.0 - (disp - disp_far) / (disp_near - disp_far + eps)


def inv2depth(inv_depth: torch.Tensor) -> torch.Tensor:
    """Inverse depth -> depth; non-positive inputs map to 0."""
    depth = 1.0 / torch.clamp(inv_depth, min=1e-6)
    return torch.where(inv_depth <= 0.0, torch.zeros_like(depth), depth)


def depth2inv(depth: torch.Tensor) -> torch.Tensor:
    inv_depth = 1.0 / torch.clamp(depth, min=1e-6)
    return torch.where(depth <= 0.0, torch.zeros_like(inv_depth), inv_depth)


def disp_to_depth(disp: torch.Tensor, min_depth, max_depth):
    """Sigmoid output -> (scaled_disp, depth)."""
    min_disp = 1.0 / max_depth
    max_disp = 1.0 / min_depth
    scaled_disp = min_disp + (max_disp - min_disp) * disp
    return scaled_disp, 1.0 / scaled_disp


def gradient_x(image: torch.Tensor) -> torch.Tensor:
    """x-gradient of (..., h, w) images."""
    return image[..., :, :-1] - image[..., :, 1:]


def gradient_y(image: torch.Tensor) -> torch.Tensor:
    return image[..., :-1, :] - image[..., 1:, :]


def calc_smoothness(inv_depth: torch.Tensor, image: torch.Tensor):
    """Edge-aware smoothness terms of one scale: inv_depth (b, 1, h, w),
    image (b, 3, h, w) -> (smoothness_x, smoothness_y)."""
    mean_inv = inv_depth.mean(dim=(2, 3), keepdim=True)
    norm_inv = inv_depth / torch.clamp(mean_inv, min=1e-6)
    wx = torch.exp(-gradient_x(image).abs().mean(dim=1, keepdim=True))
    wy = torch.exp(-gradient_y(image).abs().mean(dim=1, keepdim=True))
    return gradient_x(norm_inv) * wx, gradient_y(norm_inv) * wy
