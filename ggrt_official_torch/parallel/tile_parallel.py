"""Tile-parallel rendering over the "tp" axis (the JAX package's
parallel/tile_parallel.py).

Within one view the screen tiles are split over the tp ranks: projection,
binning and the record build run on every rank (the Gaussians are
replicated), the tile axis is padded to a multiple of tp, each rank
composites its contiguous slice of tiles, and an all-gather puts the tiles
back. The two collectives are autograd functions whose backward is the
transpose of their forward, so every rank gets the single-rank gradient:
the gather's backward keeps this rank's slice of the (replicated) image
gradient, and the slice's backward all-gathers the slices' gradients, so
the replicated records, and through them the Gaussians, get the whole
gradient everywhere. (torch.distributed.nn's all_gather sums the incoming
gradients over ranks instead, which gives tp times the gradient here,
where every rank computes the same loss.)
"""
from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from ..ops.rasterizer import composite, cuda_composite, tiling
from ..ops.rasterizer.projection import ProjectedGaussians, project_gaussians

# torch 2.13 renames all_gather_into_tensor to all_gather_single and warns
# at every call of the old name; earlier releases have only the old name.
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def _gather(local: torch.Tensor, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    out = local.new_empty((n * local.shape[0], *local.shape[1:]))
    _all_gather(out, local.contiguous(), group=group)
    return out


class GatherTiles(torch.autograd.Function):
    """Each rank's slice of tiles -> all of them, in rank order; the
    backward keeps this rank's slice."""

    @staticmethod
    def forward(ctx, local, group):
        ctx.group, ctx.n = group, local.shape[0]
        return _gather(local, group)

    @staticmethod
    def backward(ctx, grad):
        r = dist.get_rank(ctx.group)
        return grad[r * ctx.n:(r + 1) * ctx.n], None


class SliceTiles(torch.autograd.Function):
    """All tiles -> this rank's contiguous slice; the backward all-gathers
    the slices' gradients."""

    @staticmethod
    def forward(ctx, full, group):
        ctx.group = group
        n = dist.get_world_size(group)
        per = full.shape[0] // n
        r = dist.get_rank(group)
        return full[r * per:(r + 1) * per]

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group), None


class SumGrad(torch.autograd.Function):
    """Identity; the backward sums the gradient over the group: for a
    replicated input used by every rank's own slice of the work."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _pad_tiles(x: torch.Tensor, pad: int, value=0) -> torch.Tensor:
    return F.pad(x, (0, 0) * (x.dim() - 1) + (0, pad), value=value) if pad else x


def render_tile_parallel(
    mesh: DeviceMesh,
    means, covariances, sh_coeffs, opacities,
    extrinsics, intrinsics, near, far,
    image_shape: tuple[int, int],
    background,
    max_dup: int = 8,
    max_per_tile: int = 1024,
    tile_chunk: int = 16,
    backend: str = "cuda",
) -> torch.Tensor:
    """Render one view with its tiles split over the mesh's "tp" axis.

    Single-view arguments (no batch axis), no world rescale (api.render's
    scale_invariant is the caller's). Sort binning. backend "cuda" (synonym
    "pallas"; the default, as api.render's) composites each rank's slice
    of the records with the compositor kernels; "tiled" with the plain
    per-tile compositor. Returns (3, h, w), the same on every rank of the
    tp group."""
    group = mesh.get_group("tp")
    tp = dist.get_world_size(group)
    pg = project_gaussians(means, covariances, sh_coeffs, opacities,
                           extrinsics, intrinsics, near, far, image_shape)
    binning = tiling.bin_gaussians(ProjectedGaussians(*(x.detach() for x in pg)), image_shape,
                                   max_dup=max_dup, max_per_tile=max_per_tile)
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    num_tiles = nty * ntx
    pad = -num_tiles % tp

    if backend in ("cuda", "pallas"):
        records, colors, counts = cuda_composite.build_records(pg, binning)
        rec, col = (SliceTiles.apply(_pad_tiles(x, pad), group) for x in (records, colors))
        cnt = SliceTiles.apply(_pad_tiles(counts, pad), group)
        # The background is mixed in after the gather, on every rank alike.
        acc, tfin = cuda_composite.CompositeCore.apply(rec, col, cnt, tiling.TILE_H, tiling.TILE_W)
        acc = GatherTiles.apply(acc, group)[:num_tiles]
        tfin = GatherTiles.apply(tfin, group)[:num_tiles]
        tile_colors = acc[..., :3] + tfin * background[None, None, :]
        return composite.tiles_to_image(tile_colors, nty, ntx, image_shape)
    if backend != "tiled":
        raise ValueError(f"unknown backend {backend!r}; one of ('tiled', 'cuda', 'pallas')")

    ids = _pad_tiles(binning.gaussian_ids, pad, value=-1)
    tile_ids = _pad_tiles(torch.arange(num_tiles, device=ids.device), pad)
    records = composite.gather_tile_records(pg, ids)
    pixels = composite.tile_pixel_grid(nty, ntx, tiling.TILE_H, tiling.TILE_W,
                                       pg.mean2d.dtype, pg.mean2d.device)[tile_ids]
    local = [SliceTiles.apply(x, group) for x in (*records, pixels)]
    if background.requires_grad:
        # Each rank mixes the background into its own tiles only.
        background = SumGrad.apply(background, group)
    tile_colors = composite.composite_gathered(*local, background, tile_chunk)
    tile_colors = GatherTiles.apply(tile_colors, group)[:num_tiles]
    return composite.tiles_to_image(tile_colors, nty, ntx, image_shape)
