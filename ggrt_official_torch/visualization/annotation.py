"""Text annotation on images (the JAX package's visualization/annotation.py;
the reference's visualization/annotation.py). PIL renders only the small
label strip on the host; the strip then joins the image on the image's
device. Images are float (c, h, w) in [0, 1].
"""
from __future__ import annotations

import numpy as np
import torch

from .layout import vcat


def draw_text(text: str, width: int, height: int = 28, size: int = 14,
              color=(0.0, 0.0, 0.0), background: float = 1.0, device=None) -> torch.Tensor:
    """Rasterize a text strip -> (3, height, width) float tensor on `device`
    (the CPU by default)."""
    from PIL import Image, ImageDraw, ImageFont

    img = Image.new("RGB", (width, height), tuple(int(background * 255) for _ in range(3)))
    draw = ImageDraw.Draw(img)
    try:
        font = ImageFont.load_default(size=size)
    except TypeError:  # older PIL: no size argument
        font = ImageFont.load_default()
    draw.text((4, max((height - size) // 2 - 2, 0)), text,
              fill=tuple(int(c * 255) for c in color), font=font)
    strip = np.asarray(img, np.float32).transpose(2, 0, 1) / 255.0
    return torch.from_numpy(np.ascontiguousarray(strip)).to(device or "cpu")


def add_label(image: torch.Tensor, label: str, font_size: int = 14) -> torch.Tensor:
    """Stack a text label above a (3, h, w) image."""
    image = torch.as_tensor(image, dtype=torch.float32)
    strip = draw_text(label, width=image.shape[2], size=font_size, device=image.device)
    return vcat(strip, image, gap=0)
