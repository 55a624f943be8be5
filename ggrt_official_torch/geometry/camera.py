"""Pinhole camera ops in *pixel* coordinates, for the IPO-Net cost volume
and the photometric loss (the reference's differentiable Camera class).

Unlike `geometry.projection`, whose intrinsics are normalized to the image
size, K here is a (..., 3, 3) pixel intrinsics matrix. `Twc` is the
world->camera transform: IPO-Net builds it from the target->reference pose
and applies it to points in the target frame.
"""
from __future__ import annotations

import torch

from .projection import invert_intrinsics, invert_se3


def scale_intrinsics(K: torch.Tensor, x_scale, y_scale) -> torch.Tensor:
    """Rescale pixel intrinsics, with the reference's ±0.5 pixel-centre shift."""
    out = K.clone()
    out[..., 0, 0] = K[..., 0, 0] * x_scale
    out[..., 1, 1] = K[..., 1, 1] * y_scale
    out[..., 0, 2] = (K[..., 0, 2] + 0.5) * x_scale - 0.5
    out[..., 1, 2] = (K[..., 1, 2] + 0.5) * y_scale - 0.5
    return out


def pixel_grid(h: int, w: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(3, h, w) homogeneous pixel-index grid (x, y, 1); x = column index."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=dtype, device=device),
                            torch.arange(w, dtype=dtype, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=0)


def reconstruct(depth: torch.Tensor, K: torch.Tensor, Twc: torch.Tensor | None = None) -> torch.Tensor:
    """Depth map (b, 1, h, w) -> (b, 3, h, w) points in the world frame; with
    no Twc the camera frame is the world frame."""
    b, _, h, w = depth.shape
    grid = pixel_grid(h, w, depth.dtype, depth.device).reshape(3, -1)
    xnorm = torch.einsum("bij,jn->bin", invert_intrinsics(K), grid)
    Xc = xnorm.reshape(b, 3, h, w) * depth
    if Twc is None:
        return Xc
    Tcw = invert_se3(Twc)
    Xw = torch.einsum("bij,bjn->bin", Tcw[..., :3, :3], Xc.reshape(b, 3, -1)) + Tcw[..., :3, 3, None]
    return Xw.reshape(b, 3, h, w)


def project(X: torch.Tensor, K: torch.Tensor, Twc: torch.Tensor | None = None,
            normalize: bool = True) -> torch.Tensor:
    """World points (b, 3, h, w) -> (b, h, w, 2) pixel coordinates, or
    coordinates in [-1, 1] with `normalize` (the grid_sample convention)."""
    b, _, h, w = X.shape
    Xf = X.reshape(b, 3, -1)
    if Twc is not None:
        Xf = torch.einsum("bij,bjn->bin", Twc[..., :3, :3], Xf) + Twc[..., :3, 3, None]
    Xc = torch.einsum("bij,bjn->bin", K, Xf)
    x, y = Xc[:, 0], Xc[:, 1]
    z = torch.clamp(Xc[:, 2], min=1e-5)
    if normalize:
        xn = 2.0 * (x / z) / (w - 1) - 1.0
        yn = 2.0 * (y / z) / (h - 1) - 1.0
    else:
        xn, yn = x / z, y / z
    return torch.stack([xn, yn], dim=-1).reshape(b, h, w, 2)
