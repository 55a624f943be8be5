"""Image layout: concatenation with alignment, borders, resize (the JAX
package's visualization/layout.py; the reference's visualization/layout.py).
Images are channel-first (c, h, w) float tensors in [0, 1]; every result is
made on the first image's device.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _pad_to(image: torch.Tensor, h: int, w: int, align: str, value: float) -> torch.Tensor:
    _, ih, iw = image.shape
    dh, dw = h - ih, w - iw
    if align == "start":
        pads = (0, dw, 0, dh)
    elif align == "end":
        pads = (dw, 0, dh, 0)
    else:  # center
        pads = (dw // 2, dw - dw // 2, dh // 2, dh - dh // 2)
    return F.pad(image, pads, value=value)


def _cat(images, axis: int, align: str, gap: int, gap_color: float) -> torch.Tensor:
    device = torch.as_tensor(images[0]).device
    images = [torch.as_tensor(im, dtype=torch.float32, device=device) for im in images]
    c = images[0].shape[0]
    h = max(im.shape[1] for im in images)
    w = max(im.shape[2] for im in images)
    if axis == 2:  # hcat: equalize heights
        images = [_pad_to(im, h, im.shape[2], align, gap_color) for im in images]
        spacer = torch.full((c, h, gap), gap_color, dtype=torch.float32, device=device)
    else:  # vcat: equalize widths
        images = [_pad_to(im, im.shape[1], w, align, gap_color) for im in images]
        spacer = torch.full((c, gap, w), gap_color, dtype=torch.float32, device=device)
    parts = []
    for i, im in enumerate(images):
        if i and gap:
            parts.append(spacer)
        parts.append(im)
    return torch.cat(parts, dim=axis)


def hcat(*images, align: str = "start", gap: int = 8, gap_color: float = 1.0) -> torch.Tensor:
    """Horizontal concat: align in {start, center, end} (aliases top/bottom)."""
    align = {"top": "start", "bottom": "end"}.get(align, align)
    return _cat(images, 2, align, gap, gap_color)


def vcat(*images, align: str = "start", gap: int = 8, gap_color: float = 1.0) -> torch.Tensor:
    """Vertical concat; aliases left/right accepted."""
    align = {"left": "start", "right": "end"}.get(align, align)
    return _cat(images, 1, align, gap, gap_color)


def add_border(image, border: int = 8, color: float = 1.0) -> torch.Tensor:
    """Constant border around (c, h, w)."""
    image = torch.as_tensor(image, dtype=torch.float32)
    return F.pad(image, (border, border, border, border), value=color)


def _triangle(x):
    return torch.clamp(1 - x.abs(), min=0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float):
    def kernel(x):
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi**2 * x**2, torch.ones_like(x)),
                          torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)
    return kernel


_KERNELS = {"linear": _triangle, "bilinear": _triangle, "trilinear": _triangle, "triangle": _triangle,
            "cubic": _keys_cubic, "bicubic": _keys_cubic, "tricubic": _keys_cubic,
            "lanczos3": _lanczos(3.0), "lanczos5": _lanczos(5.0)}


def _weight_mat(n_in: int, n_out: int, kernel, device) -> torch.Tensor:
    """jax.image's compute_weight_mat at translation 0, antialiased: (n_in,
    n_out) float32 weights of half-pixel-centred samples, the kernel widened
    by the scale when shrinking, each column normalised, and zero where the
    sample falls outside the input."""
    inv_scale = torch.tensor(1.0 / (n_out / n_in), dtype=torch.float32)
    kernel_scale = torch.clamp(inv_scale, min=1.0)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]).abs() / kernel_scale
    weights = kernel(x)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                          weights / torch.where(total != 0, total, torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights)).to(device)


def resize_image(image: torch.Tensor, shape, method: str = "bilinear") -> torch.Tensor:
    """jax.image.resize(image, shape, method) with its default antialias on:
    every axis whose size changes is resampled separately. "nearest" takes
    the input pixel under each output pixel's centre."""
    image = torch.as_tensor(image)
    if not image.is_floating_point():
        image = image.float()
    for d, (n_in, n_out) in enumerate(zip(image.shape, shape)):
        if n_in == n_out:
            continue
        if method == "nearest":
            offsets = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
            image = torch.index_select(image, d, torch.floor(offsets).long().to(image.device))
            continue
        w = _weight_mat(n_in, n_out, _KERNELS[method], image.device).to(image.dtype)
        image = torch.movedim(torch.tensordot(image, w, dims=([d], [0])), -1, d)
    return image


def resize(image, shape=None, width=None, height=None, method: str = "bilinear") -> torch.Tensor:
    """Resize (c, h, w); exactly one of shape/width/height (a single
    dimension keeps the aspect ratio)."""
    c, h, w = image.shape
    if sum(x is not None for x in (shape, width, height)) != 1:
        raise ValueError("give exactly one of shape, width and height")
    if width is not None:
        shape = (int(round(h * width / w)), width)
    elif height is not None:
        shape = (height, int(round(w * height / h)))
    return resize_image(image, (c, *shape), method=method)
