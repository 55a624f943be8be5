"""Tile binning for the rasterizer, sort mode.

Each Gaussian is duplicated into the screen tiles its (mean-centred,
capped) AABB window covers; the (tile, quantized depth) pairs are packed
into one int32 key and sorted stably, so ties break by duplicate index and
each tile's list comes out front to back. Two static caps keep the shapes
fixed:

  * ``max_dup``      — tiles a single Gaussian may claim;
  * ``max_per_tile`` — per-tile list capacity K (front to back; overflow
                       drops the farthest Gaussians).

Tile geometry is (tile_h, tile_w) = (8, 128) by default.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import ProjectedGaussians

TILE_H = 8
TILE_W = 128
DEPTH_BITS = 20          # quantized-depth key width (see _quantize_depth)
_MIN_DEPTH_BITS = 12     # below this the packed key cannot order depths


def _floordiv(a: torch.Tensor, b) -> torch.Tensor:
    return torch.div(a, b, rounding_mode="floor")


def _clip(x: torch.Tensor, lo, hi) -> torch.Tensor:
    """max(x, lo) then min(., hi): the order jnp.clip applies when lo > hi."""
    return torch.minimum(torch.maximum(x, torch.as_tensor(lo, device=x.device)),
                         torch.as_tensor(hi, device=x.device))


def _quantize_depth(depth: torch.Tensor, visible: torch.Tensor, bits: int) -> torch.Tensor:
    """Monotone fixed-point depth key in [0, 2^bits), uniform over the
    visible depth range. Invisible entries get the max key so they sort
    behind everything."""
    big = torch.tensor(3.4e38, dtype=torch.float32, device=depth.device)
    lo = torch.where(visible, depth, big).min()
    hi = torch.where(visible, depth, -big).max()
    span = torch.clamp(hi - lo, min=1e-6)
    q = torch.clamp((depth - lo) / span, 0.0, 1.0) * ((1 << bits) - 2)
    q = q.to(torch.int32)
    return torch.where(visible, q, torch.full_like(q, (1 << bits) - 1))


class TileBinning(NamedTuple):
    gaussian_ids: torch.Tensor  # (num_tiles, K) int64, -1 padded, front to back
    counts: torch.Tensor        # (num_tiles,) int32
    num_tiles_y: int
    num_tiles_x: int


def _tile_aabb(pg: ProjectedGaussians, ntx: int, nty: int, tile_w: int, tile_h: int):
    """Per-Gaussian tile-index AABB (min inclusive, max exclusive) from the
    tight per-axis extents."""
    ex = pg.extent[:, 0]
    ey = pg.extent[:, 1]
    visible = pg.valid & (ex > 0.0) & (ey > 0.0)
    x0 = torch.clamp(((pg.mean2d[:, 0] - ex) / tile_w).to(torch.int32), 0, ntx)
    x1 = torch.clamp(
        torch.floor((pg.mean2d[:, 0] + ex + tile_w - 1) / tile_w).to(torch.int32), 0, ntx
    )
    y0 = torch.clamp(((pg.mean2d[:, 1] - ey) / tile_h).to(torch.int32), 0, nty)
    y1 = torch.clamp(
        torch.floor((pg.mean2d[:, 1] + ey + tile_h - 1) / tile_h).to(torch.int32), 0, nty
    )
    visible = visible & (x1 > x0) & (y1 > y0)
    return x0, x1, y0, y1, visible


def _dup_window(pg, x0, x1, y0, y1, tile_w: int, tile_h: int, max_dup: int):
    """Shrink each Gaussian's tile AABB to at most max_dup cells, centred on
    the tile containing its mean. Returns (x0', y0', nx', ny')."""
    nx = x1 - x0
    ny = y1 - y0
    nxw = torch.clamp(nx, max=max_dup)
    nyw = torch.minimum(ny, _floordiv(torch.full_like(nxw, max_dup), torch.clamp(nxw, min=1)))
    nyw = torch.maximum(nyw, torch.clamp(ny, max=1))
    tx = _clip((pg.mean2d[:, 0] / tile_w).to(torch.int32), x0, x1 - 1)
    ty = _clip((pg.mean2d[:, 1] / tile_h).to(torch.int32), y0, y1 - 1)
    x0w = _clip(tx - _floordiv(nxw - 1, 2), x0, x1 - nxw)
    y0w = _clip(ty - _floordiv(nyw - 1, 2), y0, y1 - nyw)
    return x0w, y0w, nxw, nyw


def bin_gaussians(
    pg: ProjectedGaussians,
    image_shape: tuple[int, int],
    max_dup: int = 32,
    max_per_tile: int = 1024,
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> TileBinning:
    h, w = image_shape
    ntx = -(-w // tile_w)
    nty = -(-h // tile_h)
    num_tiles = ntx * nty
    g = pg.mean2d.shape[0]
    dev = pg.mean2d.device

    tile_bits = (num_tiles + 1).bit_length()
    qbits = min(DEPTH_BITS, 31 - tile_bits)
    if qbits < _MIN_DEPTH_BITS:
        raise ValueError(
            f"{num_tiles} tiles leave {qbits} depth bits in the packed key; "
            f"at least {_MIN_DEPTH_BITS} are needed"
        )

    with torch.no_grad():
        x0, x1, y0, y1, visible = _tile_aabb(pg, ntx, nty, tile_w, tile_h)
        x0w, y0w, nxw, nyw = _dup_window(pg, x0, x1, y0, y1, tile_w, tile_h, max_dup)

        # Enumerate the (mean-centred) window row-major, ≤ max_dup cells.
        slot = torch.arange(max_dup, dtype=torch.int32, device=dev)
        nx_safe = torch.clamp(nxw, min=1)
        dy = _floordiv(slot[None, :], nx_safe[:, None])
        dx = slot[None, :] - dy * nx_safe[:, None]
        tile_id = (y0w[:, None] + dy) * ntx + (x0w[:, None] + dx)  # (g, max_dup)
        in_box = slot[None, :] < (nxw * nyw)[:, None]
        pair_valid = in_box & visible[:, None]
        flat_tile = torch.where(
            pair_valid, tile_id, torch.full_like(tile_id, num_tiles)
        ).reshape(-1).to(torch.int32)

        # Packed (tile, quantized depth) key. The stable sort's permutation
        # is the flat duplicate index gid·max_dup + slot, so ties break by
        # Gaussian id and the Gaussian is recovered at the selected slots.
        q = _quantize_depth(pg.depth, visible, qbits)
        flat_q = q[:, None].expand(g, max_dup).reshape(-1)
        packed = (flat_tile << qbits) | flat_q
        packed_sorted, didx_sorted = torch.sort(packed, stable=True)
        tile_range = torch.arange(num_tiles + 1, dtype=torch.int32, device=dev)
        starts = torch.searchsorted(
            packed_sorted, (tile_range << qbits).contiguous(), side="left", out_int32=True
        )

        counts = torch.clamp(starts[1:] - starts[:-1], max=max_per_tile)
        k = torch.arange(max_per_tile, dtype=torch.int32, device=dev)
        positions = torch.clamp(starts[:-1, None] + k[None, :], 0, didx_sorted.shape[0] - 1)
        in_seg = k[None, :] < counts[:, None]
        didx_at = didx_sorted[positions.long()]                    # (t, K)
        ids = torch.where(in_seg, _floordiv(didx_at, max_dup), torch.full_like(didx_at, -1))
    return TileBinning(gaussian_ids=ids, counts=counts, num_tiles_y=nty, num_tiles_x=ntx)
