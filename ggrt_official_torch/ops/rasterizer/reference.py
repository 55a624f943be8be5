"""Reference (oracle) Gaussian compositor: O(pixels x Gaussians), plain
PyTorch.

Per-pixel front-to-back alpha compositing of every Gaussian, as the CUDA
rasterizer does it: sort by depth, alpha = min(0.99, o·exp(-dᵀ conic d / 2)),
skip alpha < 1/255, stop when the transmittance would drop below 1e-4. The
golden for the tiled and kernel backends on tiny scenes; differentiable end
to end, camera included.
"""
from __future__ import annotations

import torch

from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, ProjectedGaussians, project_gaussians


def composite_pixels(
    pg: ProjectedGaussians,
    pixel_xy: torch.Tensor,
    background: torch.Tensor,
    tile_shape: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Alpha-composite all Gaussians at pixel centres (p, 2); returns (p, 3).

    tile_shape (tile_h, tile_w), when given, culls as the binned backends
    do: a Gaussian reaches only the pixels whose tile lies inside its extent
    AABB, so the oracle equals them up to the caps' overflow. Without it,
    every Gaussian reaches every pixel.
    """
    inf = torch.full_like(pg.depth, float("inf"))
    order = torch.argsort(torch.where(pg.valid, pg.depth, inf), stable=True)
    mean2d = pg.mean2d[order]
    conic = pg.conic[order]
    color = pg.color[order]
    opacity = pg.opacity[order]
    extent = pg.extent[order]
    valid = pg.valid[order] & (extent[:, 0] > 0.0) & (extent[:, 1] > 0.0)

    d = pixel_xy[:, None, :] - mean2d[None, :, :]                 # (p, g, 2)
    dx, dy = d[..., 0], d[..., 1]
    if tile_shape is not None:
        th, tw = tile_shape
        with torch.no_grad():
            ptx = torch.div(pixel_xy[:, 0], tw, rounding_mode="floor").to(torch.int32)
            pty = torch.div(pixel_xy[:, 1], th, rounding_mode="floor").to(torch.int32)
            ex, ey = extent[:, 0], extent[:, 1]
            gx0 = ((mean2d[:, 0] - ex) / tw).to(torch.int32)
            gx1 = torch.floor((mean2d[:, 0] + ex + tw - 1) / tw).to(torch.int32)
            gy0 = ((mean2d[:, 1] - ey) / th).to(torch.int32)
            gy1 = torch.floor((mean2d[:, 1] + ey + th - 1) / th).to(torch.int32)
            in_tile = ((ptx[:, None] >= gx0[None, :]) & (ptx[:, None] < gx1[None, :])
                       & (pty[:, None] >= gy0[None, :]) & (pty[:, None] < gy1[None, :]))
        valid = valid[None, :] & in_tile
    else:
        valid = valid[None, :]
    power = (-0.5 * (conic[None, :, 0] * dx * dx + conic[None, :, 2] * dy * dy)
             - conic[None, :, 1] * dx * dy)
    alpha = torch.clamp(opacity[None, :] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & valid & (alpha >= ALPHA_MIN), alpha,
                        torch.zeros_like(alpha))

    one_minus = 1.0 - alpha
    T_after = torch.cumprod(one_minus, dim=1)          # T after each Gaussian
    T_before = T_after / one_minus                     # alpha <= 0.99: safe
    live = torch.cumprod((T_after >= T_EPS).to(alpha.dtype), dim=1)
    weight = live * alpha * T_before                   # (p, g)
    out = weight @ color
    T_final = torch.where(live > 0, one_minus, torch.ones_like(one_minus)).prod(dim=1)
    return out + T_final[:, None] * background[None, :]


def render_reference(
    means: torch.Tensor,
    covariances: torch.Tensor,
    sh_coeffs: torch.Tensor,
    opacities: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    tile_shape: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Render one view, (3, h, w)."""
    h, w = image_shape
    pg = project_gaussians(
        means, covariances, sh_coeffs, opacities, extrinsics, intrinsics, near, far, image_shape
    )
    ys, xs = torch.meshgrid(torch.arange(h, device=means.device),
                            torch.arange(w, device=means.device), indexing="ij")
    pixel_xy = torch.stack([xs, ys], dim=-1).reshape(-1, 2).to(means.dtype)
    colors = composite_pixels(pg, pixel_xy, background, tile_shape=tile_shape)
    return colors.reshape(h, w, 3).permute(2, 0, 1)
