"""Camera-frustum drawing and 3D scene projections (the JAX package's
visualization/cameras.py; the reference's visualization/drawing/cameras.py
and validation_in_3d.py): three axis-aligned orthographic views with the
cameras' frusta and near/far planes, and a point set (Gaussian means)
projected onto the same three planes. Torch on the inputs' device; the
planes' ranges are read back to the host once per plane.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry.projection import unproject
from .annotation import add_label
from .drawing import draw_lines, draw_points
from .layout import hcat


def unproject_frustum_corners(extrinsics: torch.Tensor, intrinsics: torch.Tensor, depth) -> torch.Tensor:
    """(b, 4, 4), (b, 3, 3) normalized, (b,) depth -> (b, 4, 3) world corners."""
    corners = torch.tensor([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]], device=extrinsics.device)
    b = extrinsics.shape[0]
    xy = corners[None].expand(b, 4, 2)
    z = torch.as_tensor(depth, dtype=torch.float32, device=extrinsics.device).reshape(-1, 1).expand(b, 4)
    cam = unproject(xy, z, intrinsics[:, None])
    world = torch.einsum("bij,bpj->bpi", extrinsics[:, :3, :3], cam)
    return world + extrinsics[:, None, :3, 3]


def _depths(d, b: int, device) -> torch.Tensor:
    return torch.as_tensor(d, dtype=torch.float32, device=device).expand(b)


def compute_aabb(extrinsics: torch.Tensor, intrinsics: torch.Tensor, near=None, far=None):
    """Scene AABB over the camera origins and frustum corners."""
    pts = [extrinsics[:, :3, 3]]
    for d in (near, far):
        if d is not None:
            pts.append(unproject_frustum_corners(
                extrinsics, intrinsics, _depths(d, extrinsics.shape[0], extrinsics.device)).reshape(-1, 3))
    allp = torch.cat(pts, dim=0)
    return allp.min(dim=0).values, allp.max(dim=0).values


def _equal_aabb_with_margin(minima, maxima, margin=0.1):
    midpoint = (maxima + minima) * 0.5
    span = (maxima - minima).max() * (1.0 + margin)
    return midpoint - 0.5 * span, midpoint + 0.5 * span


def draw_cameras(resolution: int, extrinsics, intrinsics, color, near=None, far=None,
                 margin: float = 0.1, frustum_scale: float = 0.05) -> torch.Tensor:
    """Render the camera set onto the three axis-aligned planes: (3, 3,
    resolution, resolution) as [projected axis, rgb, h, w], labelled."""
    extrinsics = torch.as_tensor(extrinsics, dtype=torch.float32)
    intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=extrinsics.device)
    minima, maxima = compute_aabb(extrinsics, intrinsics, near, far)
    lo, hi = _equal_aabb_with_margin(minima, maxima, margin)
    views = _draw_camera_planes(resolution, extrinsics, intrinsics, color, near, far, lo, hi,
                                frustum_scale, label=True)
    h = min(v.shape[1] for v in views)
    return torch.stack([v[:, :h] for v in views])


def _draw_camera_planes(resolution, extrinsics, intrinsics, color, near, far, lo, hi,
                        frustum_scale, label: bool):
    """Camera frusta on the three axis planes within the caller's AABB (lo,
    hi), so that overlays (render_projections) draw points and frusta in
    one coordinate frame."""
    device = extrinsics.device
    b = extrinsics.shape[0]
    color = torch.as_tensor(color, dtype=torch.float32, device=device).reshape(-1, 3).expand(b, 3)
    span = (hi - lo).max()

    frustum = unproject_frustum_corners(extrinsics, intrinsics, (span * frustum_scale).expand(b))
    origins = extrinsics[:, :3, 3]
    lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()

    views = []
    for axis in range(3):
        ax_x, ax_y = (axis + 1) % 3, (axis + 2) % 3

        def proj(p):
            return torch.stack([p[..., ax_x], p[..., ax_y]], dim=-1)

        ranges = dict(x_range=(float(lo_h[ax_x]), float(hi_h[ax_x])),
                      y_range=(float(lo_h[ax_y]), float(hi_h[ax_y])))
        img = torch.zeros((3, resolution, resolution), dtype=torch.float32, device=device)
        fr = proj(frustum)                                   # (b, 4, 2)
        rolled = torch.roll(fr, 1, dims=1)
        colors = color.repeat_interleave(4, dim=0)
        # Frustum base edges, then apex-to-corner edges.
        img = draw_lines(img, fr.reshape(-1, 2), rolled.reshape(-1, 2), colors, width=2, **ranges)
        apex = proj(origins).repeat_interleave(4, dim=0)
        img = draw_lines(img, apex, fr.reshape(-1, 2), colors, width=2, **ranges)
        # Near/far planes in dim grey (the reference draws them at 0.25).
        for d in (near, far):
            if d is not None:
                pc = proj(unproject_frustum_corners(extrinsics, intrinsics, _depths(d, b, device)))
                img = draw_lines(img, pc.reshape(-1, 2), torch.roll(pc, 1, dims=1).reshape(-1, 2),
                                 0.25, width=1, **ranges)
        axis_name = "xyz"[ax_x] + "xyz"[ax_y]
        views.append(add_label(img, f"plane {axis_name}") if label else img)
    return views


def render_projections(points, resolution: int, extrinsics=None, intrinsics=None,
                       color=(0.35, 0.65, 1.0), radius: float = 1.0, margin: float = 0.1) -> torch.Tensor:
    """Project a 3D point set (n, 3) (Gaussian means) onto the three
    axis-aligned planes, with the camera frusta on top when cameras are
    given, all in one AABB over points and frusta. Returns (3, 3,
    resolution, resolution)."""
    points = torch.as_tensor(points, dtype=torch.float32)
    device = points.device
    pts_min, pts_max = points.min(dim=0).values, points.max(dim=0).values
    if extrinsics is not None and intrinsics is not None:
        extrinsics = torch.as_tensor(extrinsics, dtype=torch.float32, device=device)
        intrinsics = torch.as_tensor(intrinsics, dtype=torch.float32, device=device)
        cam_min, cam_max = compute_aabb(extrinsics, intrinsics)
        pts_min = torch.minimum(pts_min, cam_min)
        pts_max = torch.maximum(pts_max, cam_max)
    lo, hi = _equal_aabb_with_margin(pts_min, pts_max, margin)
    lo_h, hi_h = lo.cpu().numpy(), hi.cpu().numpy()

    views = []
    for axis in range(3):
        ax_x, ax_y = (axis + 1) % 3, (axis + 2) % 3
        xy = torch.stack([points[:, ax_x], points[:, ax_y]], dim=-1)
        img = torch.zeros((3, resolution, resolution), dtype=torch.float32, device=device)
        views.append(draw_points(img, xy, color, radius=radius,
                                 x_range=(float(lo_h[ax_x]), float(hi_h[ax_x])),
                                 y_range=(float(lo_h[ax_y]), float(hi_h[ax_y]))))
    out = torch.stack(views)
    if extrinsics is not None and intrinsics is not None:
        cams = torch.stack(_draw_camera_planes(
            resolution, extrinsics, intrinsics, torch.ones((extrinsics.shape[0], 3), device=device),
            None, None, lo, hi, frustum_scale=0.05, label=False))
        out = torch.maximum(out, cams)
    return out


def side_by_side(views: torch.Tensor) -> torch.Tensor:
    """(3, 3, h, w) plane stack -> one (3, h, 3w + gaps) strip."""
    return hcat(*[views[i] for i in range(views.shape[0])])


def plot_cameras_matplotlib(c2ws: np.ndarray, out_path: str | None = None, gt_c2ws: np.ndarray | None = None):
    """3D matplotlib camera plot (utils/visualization.py:plot_cameras), in
    place of the reference's visdom pose viewer."""
    from ..utils.visualization import plot_cameras

    return plot_cameras(c2ws, out_path=out_path, gt_c2ws=gt_c2ws)
