"""Vector drawing onto images (lines, points) in torch, on the image's
device (the JAX package's visualization/drawing.py; the reference's
visualization/drawing/{lines,points,rendering,coordinate_conversion}.py).

Each primitive gets a distance field and an analytic 1-pixel smoothstep
coverage, which anti-aliases in one elementwise pass, and the primitives
are composited painter-style in order, later ones on top (the reference's
argmax-by-index rule, lines.py:72-79). The reference refines edge pixels
with MSAA passes instead.
"""
from __future__ import annotations

import torch


def _conversions(shape, x_range, y_range, device):
    """World -> pixel mapping: x_range/y_range span the image; by default
    the coordinates are pixels."""
    h, w = shape
    if x_range is None:
        x_range = (0.0, float(w))
    if y_range is None:
        y_range = (0.0, float(h))
    minima = torch.tensor([x_range[0], y_range[0]], dtype=torch.float32, device=device)
    maxima = torch.tensor([x_range[1], y_range[1]], dtype=torch.float32, device=device)
    wh = torch.tensor([w, h], dtype=torch.float32, device=device)

    def world_to_pixel(xy):
        return (xy - minima) / (maxima - minima) * wh

    return world_to_pixel


def _sample_grid(shape, device) -> torch.Tensor:
    """Pixel-centre sample positions (h, w, 2) as (x, y)."""
    h, w = shape
    x = torch.arange(w, dtype=torch.float32, device=device) + 0.5
    y = torch.arange(h, dtype=torch.float32, device=device) + 0.5
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    return torch.stack([xx, yy], dim=-1)


def _coverage(dist: torch.Tensor, feather: float = 1.0) -> torch.Tensor:
    """Distance (px, > 0 outside) -> coverage in [0, 1], 1-px smoothstep."""
    t = torch.clamp(0.5 - dist / feather, 0.0, 1.0)
    return t * t * (3.0 - 2.0 * t)


def _composite_over(image: torch.Tensor, prims: torch.Tensor) -> torch.Tensor:
    """Painter-composite (n, h, w, 4) RGBA primitives over (3, h, w), in order."""
    for rgba in prims:
        a = rgba[..., 3][None]
        image = image * (1.0 - a) + rgba[..., :3].permute(2, 0, 1) * a
    return image


def _dot2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis (of size 2) of a·b as XLA's compiled float32
    reductions take it: fma(a1, b1, a0·b0), a fused multiply-add (one
    rounding, through float64, where a1·b1 is exact)."""
    first = (a[..., 0] * b[..., 0]).double()
    return (a[..., 1].double() * b[..., 1].double() + first).float()


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot2(x, x))


def _line_distance(xy, start, end, width, cap: str) -> torch.Tensor:
    """Distance of each sample to each stroked segment: xy (h, w, 2),
    start/end (n, 2), width (n,) -> (n, h, w)."""
    delta = end - start
    norm = _norm(delta)[:, None]
    u = delta / torch.clamp(norm, min=1e-12)
    rel = xy[None] - start[:, None, None]
    par = _dot2(rel, u[:, None, None])
    hi = norm[:, 0, None, None]
    if cap == "square":
        ext = 0.5 * width[:, None, None]
        par_c = torch.minimum(torch.maximum(par, -ext), hi + ext)
    else:  # butt, or round: clamp to the segment, the radial distance forms the cap
        par_c = torch.minimum(torch.clamp(par, min=0.0), hi)
    closest = start[:, None, None] + par_c[..., None] * u[:, None, None]
    return _norm(xy[None] - closest) - 0.5 * width[:, None, None]


def _as_f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _sanitize_color(color, n: int, device) -> torch.Tensor:
    """(3,), scalar or (n, 3) -> (n, 3) float32."""
    c = _as_f32(color, device)
    if c.ndim == 0:
        c = c.expand(3)
    if c.ndim == 1:
        c = c[None]
    return c.expand(n, 3)


def _per_primitive(x, n: int, device) -> torch.Tensor:
    return _as_f32(x, device).reshape(-1).expand(n)


def _rgba(color: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    n, h, w = alpha.shape
    return torch.cat([color[:, None, None].expand(n, h, w, 3), alpha[..., None]], dim=-1)


def draw_lines(image: torch.Tensor, start, end, color, width, cap: str = "round",
               x_range=None, y_range=None) -> torch.Tensor:
    """Draw anti-aliased line segments over a (3, h, w) image.

    start/end: (n, 2) world or pixel coordinates; color (n, 3) or (3,);
    width a scalar or (n,) in pixels.
    """
    device = image.device
    _, h, w = image.shape
    start = torch.atleast_2d(_as_f32(start, device))
    end = torch.atleast_2d(_as_f32(end, device))
    n = max(start.shape[0], end.shape[0])
    start, end = start.expand(n, 2), end.expand(n, 2)
    color = _sanitize_color(color, n, device)
    width = _per_primitive(width, n, device)

    to_px = _conversions((h, w), x_range, y_range, device)
    d = _line_distance(_sample_grid((h, w), device), to_px(start), to_px(end), width, cap)
    return _composite_over(image, _rgba(color, _coverage(d)))


def draw_points(image: torch.Tensor, points, color, radius=1.0, inner_radius=0.0,
                x_range=None, y_range=None) -> torch.Tensor:
    """Draw anti-aliased discs or rings over a (3, h, w) image.

    points (n, 2); color (n, 3) or (3,); radius/inner_radius a scalar or
    (n,) in pixels.
    """
    device = image.device
    _, h, w = image.shape
    points = torch.atleast_2d(_as_f32(points, device))
    n = points.shape[0]
    color = _sanitize_color(color, n, device)
    radius = _per_primitive(radius, n, device)
    inner = _per_primitive(inner_radius, n, device)

    to_px = _conversions((h, w), x_range, y_range, device)
    dc = _norm(_sample_grid((h, w), device)[None] - to_px(points)[:, None, None])
    alpha = _coverage(dc - radius[:, None, None])
    hole = _coverage(dc - inner[:, None, None])
    alpha = alpha * torch.where(inner[:, None, None] > 0.0, 1.0 - hole, torch.ones_like(hole))
    return _composite_over(image, _rgba(color, alpha))
