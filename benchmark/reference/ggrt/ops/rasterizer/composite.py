"""Per-tile alpha compositing in plain PyTorch: the "tiled" backend.

Consumes any binning's lists. The compositing math is that of
`reference.composite_pixels`, on per-tile fixed-capacity lists: every
tile's Gaussians are evaluated at all its pixels at once. Tiles go in
chunks of `tile_chunk`, each under `torch.utils.checkpoint`, so activation
memory is bounded by one chunk and the backward recomputes the cumprods.
The record gather's pullback is `GatherRows`, whose backward is the
segment-sum kernel on the card.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, ProjectedGaussians
from .tiling import TILE_H, TILE_W, TileBinning


class GatherRows(torch.autograd.Function):
    """comp[max(ids, 0)]; the pullback adds the live rows' gradients into
    their Gaussians with index_add_ and drops the dead ids (< 0)."""

    @staticmethod
    def forward(ctx, comp, ids):
        ctx.save_for_backward(ids)
        ctx.g = comp.shape[0]
        return comp[ids.clamp(min=0)]

    @staticmethod
    def backward(ctx, dgath):
        (ids,) = ctx.saved_tensors
        flat = ids.reshape(-1)
        live = flat >= 0
        rows = dgath.reshape(flat.shape[0], -1)
        dcomp = rows.new_zeros((ctx.g, rows.shape[1]))
        dcomp.index_add_(0, flat[live], rows[live])
        return dcomp, None


def tile_pixel_grid(nty: int, ntx: int, tile_h: int, tile_w: int, dtype, device):
    """Pixel coordinates (x, y) of every tile's pixels: (num_tiles, th·tw, 2)."""
    ids = torch.arange(nty * ntx, device=device)
    origin = torch.stack([(ids % ntx) * tile_w, torch.div(ids, ntx, rounding_mode="floor") * tile_h],
                         dim=-1).to(dtype)
    py, px = torch.meshgrid(torch.arange(tile_h, device=device), torch.arange(tile_w, device=device),
                            indexing="ij")
    local = torch.stack([px.reshape(-1), py.reshape(-1)], dim=-1).to(dtype)
    return origin[:, None, :] + local[None, :, :]


def gather_tile_records(pg: ProjectedGaussians, gaussian_ids: torch.Tensor):
    """Per-tile records (t, K, ...): mean2d, conic, color and opacity, the
    latter zero where the list is padded. One fused (g, 9)-row gather."""
    comp = torch.cat([pg.mean2d, pg.conic, pg.color, pg.opacity[:, None]], dim=-1)
    gath = GatherRows.apply(comp, gaussian_ids)
    present = (gaussian_ids >= 0).to(gath.dtype)
    return gath[..., 0:2], gath[..., 2:5], gath[..., 5:8], gath[..., 8] * present


def _composite_chunk(m2d, con, col, opa, pix, background):
    """(c, K, ...) records and (c, P, 2) pixels -> (c, P, 3) colours."""
    d = pix[:, None, :, :] - m2d[:, :, None, :]                   # (c, K, P, 2)
    dx, dy = d[..., 0], d[..., 1]
    power = (-0.5 * (con[:, :, None, 0] * dx * dx + con[:, :, None, 2] * dy * dy)
             - con[:, :, None, 1] * dx * dy)
    alpha = torch.clamp(opa[:, :, None] * torch.exp(power), max=ALPHA_MAX)
    alpha = torch.where((power <= 0.0) & (alpha >= ALPHA_MIN), alpha, torch.zeros_like(alpha))
    one_minus = 1.0 - alpha
    T_after = torch.cumprod(one_minus, dim=1)
    T_before = T_after / one_minus
    live = torch.cumprod((T_after >= T_EPS).to(alpha.dtype), dim=1)
    weight = live * alpha * T_before                              # (c, K, P)
    out = torch.einsum("ckp,ckd->cpd", weight, col)
    T_final = torch.where(live > 0, one_minus, torch.ones_like(one_minus)).prod(dim=1)
    return out + T_final[..., None] * background[None, None, :]


def composite_gathered(mean2d, conic, color, opacity, pixels, background, tile_chunk: int = 16):
    """Composite gathered per-tile records (t, K, ...) at pixels (t, P, 2);
    returns (t, P, 3). Float32 throughout: the einsum runs in full float32
    (TF32 off), as the JAX package's HIGHEST-precision einsum does."""
    num_tiles = mean2d.shape[0]
    pad = -num_tiles % tile_chunk
    args = [torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]) for x in
            (mean2d, conic, color, opacity, pixels)]
    out = []
    for c0 in range(0, num_tiles + pad, tile_chunk):
        chunk = [x[c0:c0 + tile_chunk] for x in args] + [background]
        if torch.is_grad_enabled() and any(x.requires_grad for x in chunk):
            out.append(checkpoint(_composite_chunk, *chunk, use_reentrant=False))
        else:
            out.append(_composite_chunk(*chunk))
    return torch.cat(out)[:num_tiles]


def tiles_to_image(tile_colors: torch.Tensor, nty: int, ntx: int, image_shape: tuple[int, int],
                   tile_h: int = TILE_H, tile_w: int = TILE_W) -> torch.Tensor:
    """(num_tiles, th·tw, 3) -> (3, h, w)."""
    h, w = image_shape
    img = tile_colors.reshape(nty, ntx, tile_h, tile_w, 3).permute(4, 0, 2, 1, 3)
    return img.reshape(3, nty * tile_h, ntx * tile_w)[:, :h, :w]


def composite_tiles(
    pg: ProjectedGaussians,
    binning: TileBinning,
    background: torch.Tensor,
    image_shape: tuple[int, int],
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
    tile_chunk: int = 16,
) -> torch.Tensor:
    """Composite all tiles; returns (3, h, w). tile_chunk is the number of
    tiles per checkpointed step (the memory knob)."""
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    records = gather_tile_records(pg, binning.gaussian_ids)
    pixels = tile_pixel_grid(nty, ntx, tile_h, tile_w, pg.mean2d.dtype, pg.mean2d.device)
    tile_colors = composite_gathered(*records, pixels, background, tile_chunk)
    return tiles_to_image(tile_colors, nty, ntx, image_shape, tile_h, tile_w)
