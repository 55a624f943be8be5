"""Scalar-image colour mapping (the JAX package's visualization/color_map.py;
the reference's visualization/color_map.py).

A map's 256-entry table is made once per device and applied with a gather
on the input's device, so a mapped image stays where it is. The tables of
the maps the package names are committed (`color_tables`); any other map
is taken from matplotlib, where it is installed.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .color_tables import TABLES


@functools.lru_cache(maxsize=None)
def host_table(cmap: str) -> np.ndarray:
    """(256, 3) float64 RGB of `cmap` at np.linspace(0, 1, 256), matplotlib's
    own lookup table."""
    if cmap in TABLES:
        return np.asarray(TABLES[cmap], np.float64)
    try:
        import matplotlib
    except ImportError:
        raise ValueError(f"colour map {cmap!r} needs matplotlib, which is not installed; the maps "
                         f"without it are {sorted(TABLES)}") from None
    return matplotlib.colormaps[cmap](np.linspace(0.0, 1.0, 256))[:, :3]


@functools.lru_cache(maxsize=None)
def _lut(cmap: str, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(host_table(cmap).astype(np.float32)).to(device)


def apply_color_map(x: torch.Tensor, cmap: str = "inferno") -> torch.Tensor:
    """Values in [0, 1] (any shape) -> (..., 3) colours: entry
    trunc(clip(x·255, 0, 255)) of the table, as the JAX package indexes it."""
    lut = _lut(cmap, x.device)
    idx = torch.clamp(x * (lut.shape[0] - 1), 0, lut.shape[0] - 1)
    return lut[idx.long()]


def apply_color_map_to_image(image: torch.Tensor, cmap: str = "inferno") -> torch.Tensor:
    """(..., h, w) scalar image -> (..., 3, h, w) colour image."""
    return torch.movedim(apply_color_map(image, cmap), -1, -3)
