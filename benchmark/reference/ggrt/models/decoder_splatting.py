"""Splatting decoder: Gaussians + target cameras -> images and depths
(reference decoder/decoder_splatting_cuda.py). Parameter-free; flattens
(batch, view) into the rasterizer's batch axis; black background.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import DecoderCfg
from ..ops.rasterizer import api as raster
from ..ops.rasterizer import tiling
from .gaussian_adapter import Gaussians


class DecoderOutput(NamedTuple):
    color: torch.Tensor            # (b, v, 3, h, w)
    depth: Optional[torch.Tensor]  # (b, v, h, w) or None


def effective_max_per_tile(cfg: DecoderCfg, num_gaussians: int, image_shape: tuple[int, int]) -> int:
    """The per-tile capacity K a render uses.

    Small images (< 64 tiles of 8x128) raise K toward the average per-tile
    demand 4·g/tiles: a saturated cap starves most pixels of coverage. The
    raise is clamped to a constant compositor budget of 131072 pair slots
    in total and to 16384 per tile. At 320x448 (160 tiles) the configured
    K stands.
    """
    h, w = image_shape
    num_tiles = max(1, -(-h // tiling.TILE_H) * -(-w // tiling.TILE_W))
    max_per_tile = cfg.max_per_tile
    if num_tiles < 64:
        demand = -(-4 * num_gaussians // num_tiles)
        budget_k = max(128, (131072 // num_tiles) // 128 * 128)
        max_per_tile = max(max_per_tile, min(-(-demand // 128) * 128, 16384, budget_k))
    return max_per_tile


class DecoderSplatting:
    """Stateless decoder (no parameters — a plain callable)."""

    def __init__(self, cfg: DecoderCfg):
        raster.check_backend(cfg.backend)
        self.cfg = cfg

    def __call__(
        self,
        gaussians: Gaussians,
        extrinsics: torch.Tensor,  # (b, v, 4, 4)
        intrinsics: torch.Tensor,  # (b, v, 3, 3)
        near: torch.Tensor,        # (b, v)
        far: torch.Tensor,         # (b, v)
        image_shape: tuple[int, int],
        depth_mode: Optional[str] = None,
    ) -> DecoderOutput:
        b, v = extrinsics.shape[:2]
        flat = lambda t: t.reshape(b * v, *t.shape[2:])
        rep = lambda t: t.repeat_interleave(v, dim=0)  # b g ... -> (b v) g ...

        kw = dict(
            backend=self.cfg.backend,
            max_dup=self.cfg.max_dup,
            max_per_tile=effective_max_per_tile(self.cfg, gaussians.means.shape[1], image_shape),
        )
        color = raster.render(
            flat(extrinsics), flat(intrinsics), flat(near), flat(far), image_shape,
            torch.zeros((b * v, 3), dtype=extrinsics.dtype, device=extrinsics.device),
            rep(gaussians.means), rep(gaussians.covariances),
            rep(gaussians.harmonics), rep(gaussians.opacities),
            tile_chunk=self.cfg.tile_chunk, **kw,
        )
        color = color.reshape(b, v, *color.shape[1:])

        depth = None
        if depth_mode is not None:
            depth = raster.render_depth(
                flat(extrinsics), flat(intrinsics), flat(near), flat(far), image_shape,
                rep(gaussians.means), rep(gaussians.covariances), rep(gaussians.opacities),
                mode=depth_mode, **kw,
            )
            depth = depth.reshape(b, v, *depth.shape[1:])
        return DecoderOutput(color=color, depth=depth)
