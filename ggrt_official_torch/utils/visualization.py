"""Visualization helpers (host-side numpy; the JAX package's
utils/visualization.py): depth colouring, camera frustum line segments,
layout, point and line stamping, and a matplotlib plot of camera sets.

Only `plot_cameras` needs matplotlib, imported when it is called;
`colorize_depth` takes its colours from the committed tables
(`visualization.color_map.host_table`).
"""
from __future__ import annotations

import numpy as np

from ..visualization.color_map import host_table


def colorize_depth(depth: np.ndarray, cmap_name: str = "jet", mask: np.ndarray | None = None) -> np.ndarray:
    """Depth map (h, w) -> colour image (h, w, 3) float in [0, 1], black
    where `mask` (default: the finite values) is false. The value in [0, 1]
    picks its colour as a matplotlib colormap call does: the float32 value
    times 256, 256 itself mapped to 255, truncated; NaN maps to black."""
    depth = np.asarray(depth, np.float32)
    if mask is None:
        mask = np.isfinite(depth)
    vmin = depth[mask].min() if mask.any() else 0.0
    vmax = depth[mask].max() if mask.any() else 1.0
    norm = (depth - vmin) / max(vmax - vmin, 1e-8)
    lut = host_table(cmap_name)
    xa = np.clip(norm, 0, 1) * np.float32(len(lut))
    xa[xa == len(lut)] = len(lut) - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.where(bad, 0, xa).astype(int)
    out = lut[idx]
    out[bad] = 0.0
    out[~mask] = 0.0
    return out.astype(np.float32)


def camera_frustum_lines(c2w: np.ndarray, intrinsics: np.ndarray, scale: float = 0.1) -> np.ndarray:
    """Line segments (n, 2, 3) drawing a camera frustum in world space.

    intrinsics normalized (3, 3); c2w (4, 4). Replaces the visdom camera
    visualizer (ref visualization/pose_visualizer.py) with raw geometry
    usable by any plotting frontend.
    """
    fx, fy = intrinsics[0, 0], intrinsics[1, 1]
    cx, cy = intrinsics[0, 2], intrinsics[1, 2]
    corners_img = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    dirs = np.stack(
        [(corners_img[:, 0] - cx) / fx, (corners_img[:, 1] - cy) / fy, np.ones(4)], axis=-1
    )
    corners_cam = dirs * scale
    corners_w = corners_cam @ c2w[:3, :3].T + c2w[:3, 3]
    center = np.broadcast_to(c2w[:3, 3], (4, 3))

    segments = []
    for i in range(4):
        segments.append([center[i], corners_w[i]])                 # rays
        segments.append([corners_w[i], corners_w[(i + 1) % 4]])    # image frame
    return np.asarray(segments, np.float32)


def side_by_side(*images: np.ndarray) -> np.ndarray:
    """Concatenate (3, h, w) images horizontally for logging."""
    return np.concatenate([np.asarray(im) for im in images], axis=-1)


# ---------------------------------------------------------------- layout
# The reference's visualization/layout.py (hcat/vcat/border).
def _to_hwc(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 2:
        img = np.repeat(img[..., None], 3, axis=-1)
    if img.shape[0] in (1, 3) and img.shape[-1] not in (1, 3):
        img = img.transpose(1, 2, 0)
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    return img.astype(np.float32)


def add_border(image: np.ndarray, width: int = 2, color=(1.0, 1.0, 1.0)) -> np.ndarray:
    img = _to_hwc(image)
    h, w, c = img.shape
    out = np.empty((h + 2 * width, w + 2 * width, c), img.dtype)
    out[...] = np.asarray(color, img.dtype)
    out[width : width + h, width : width + w] = img
    return out


def _cat(images, axis, align="center", gap=2, gap_color=(1.0, 1.0, 1.0)):
    images = [_to_hwc(im) for im in images]
    other = 1 - axis
    size = max(im.shape[other] for im in images)
    padded = []
    for im in images:
        deficit = size - im.shape[other]
        before = deficit // 2 if align == "center" else (deficit if align == "end" else 0)
        pads = [(0, 0), (0, 0), (0, 0)]
        pads[other] = (before, deficit - before)
        padded.append(np.pad(im, pads, constant_values=1.0))
    strip_shape = list(padded[0].shape)
    strip_shape[axis] = gap
    strip = np.empty(strip_shape, np.float32)
    strip[...] = np.asarray(gap_color, np.float32)
    out = []
    for i, im in enumerate(padded):
        if i:
            out.append(strip)
        out.append(im)
    return np.concatenate(out, axis=axis)


def hcat(*images, **kw) -> np.ndarray:
    """Horizontal concatenation with centering + gaps (ref layout.py)."""
    return _cat(images, axis=1, **kw)


def vcat(*images, **kw) -> np.ndarray:
    return _cat(images, axis=0, **kw)


# ---------------------------------------------------------------- drawing
# The reference's drawing/{lines,points}.py (simplified raster).
def draw_points(image: np.ndarray, xy: np.ndarray, color=(1.0, 0.0, 0.0), radius: int = 1) -> np.ndarray:
    """xy (n, 2) in [0, 1] image coords; returns (h, w, 3)."""
    img = _to_hwc(image).copy()
    h, w, _ = img.shape
    xs = np.clip((np.asarray(xy)[:, 0] * w).astype(int), 0, w - 1)
    ys = np.clip((np.asarray(xy)[:, 1] * h).astype(int), 0, h - 1)
    for dx in range(-radius, radius + 1):
        for dy in range(-radius, radius + 1):
            img[np.clip(ys + dy, 0, h - 1), np.clip(xs + dx, 0, w - 1)] = color
    return img


def draw_lines(image: np.ndarray, start_xy: np.ndarray, end_xy: np.ndarray,
               color=(1.0, 0.0, 0.0), samples: int = 64) -> np.ndarray:
    """Rasterize line segments by dense sampling (n, 2) -> image overlay."""
    t = np.linspace(0.0, 1.0, samples)[None, :, None]
    pts = np.asarray(start_xy)[:, None] * (1 - t) + np.asarray(end_xy)[:, None] * t
    return draw_points(image, pts.reshape(-1, 2), color=color, radius=0)


def plot_cameras(c2ws: np.ndarray, out_path: str | None = None,
                 gt_c2ws: np.ndarray | None = None, depth: float = 0.2):
    """Camera wireframes (ref pose_visualizer.py get_camera_mesh) rendered
    to a matplotlib 3D figure instead of visdom. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(projection="3d")
    verts = np.array([[-0.5, -0.5, 1], [0.5, -0.5, 1], [0.5, 0.5, 1],
                      [-0.5, 0.5, 1], [0, 0, 0]], np.float32) * depth
    order = [0, 1, 2, 3, 0, 4, 1, 2, 4, 3]

    def draw(poses, color):
        for p in np.asarray(poses):
            vw = verts @ p[:3, :3].T + p[:3, 3]
            wf = vw[order]
            ax.plot(wf[:, 0], wf[:, 1], wf[:, 2], color=color, linewidth=0.8)

    draw(c2ws, "tab:blue")
    if gt_c2ws is not None:
        draw(gt_c2ws, "tab:green")
    ax.set_box_aspect((1, 1, 1))
    if out_path is not None:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig
