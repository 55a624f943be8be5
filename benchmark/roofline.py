"""The card's peaks and the least work of the rasterizer's compositor.

Peaks are NVIDIA's data sheet for the H100 SXM (dense, no sparsity), stated
against a 700 W power limit; a run reports its card's limit beside every
share. The compositor's work is counted by the benchmark's own reference
(`benchmark/reference/ggrt`): the (pixel, Gaussian) pairs that composite,
and the bytes of the per-Gaussian records and pixels they need, for the
Gaussians and cameras the program rendered. Nothing is read from the
program's own record buffers.
"""
from __future__ import annotations

import torch

H100_FP32_FLOPS = 67e12      # float32 outside the tensor cores
H100_BYTES_PER_S = 3.35e12   # HBM3
OPS_PER_EVAL = 21            # ~20 FLOP + 1 exp per (pixel, Gaussian) evaluation
# The backward's least work per evaluation: the forward's 21, then w,
# dwdot, the suffix, d(alpha) and its chain to six record gradients, three
# colour gradients, and the nine sums over pixels (~40).
OPS_PER_EVAL_BWD = 61
RECORD_BYTES = 9 * 4         # mean2d 2, conic 3, colour 3, opacity 1 (float32)
PIXEL_BYTES = 3 * 4          # one colour (or its gradient) per pixel


def bound_ms(ops: float, nbytes: float) -> float:
    """The least time (ms) the card could take: the operations at the fp32
    peak or the bytes at HBM bandwidth, whichever is larger."""
    return max(ops / H100_FP32_FLOPS, nbytes / H100_BYTES_PER_S) * 1e3


@torch.no_grad()
def render_work(extrinsics, intrinsics, near, far, image_shape, means, covariances, harmonics, opacities,
                max_dup: int, max_per_tile: int, tile_chunk: int = 16) -> dict:
    """The compositor's least work for one render of each view: extrinsics
    (n, 4, 4), intrinsics (n, 3, 3), near and far (n,), Gaussians (n, g,
    ...), as the decoder hands them to `render`. Returns {"pairs": the
    (pixel, Gaussian) pairs with alpha >= 1/255 in front of the pixel's
    cut-off, "entries": the (tile, Gaussian) list entries with a live pair,
    "pixels"}, summed over the views. The arithmetic is the reference's
    plain compositor's (`composite._composite_chunk`)."""
    from .reference.ggrt.ops.rasterizer import api, composite, projection, tiling

    extrinsics, covariances, means, near, far = api._rescale(extrinsics, covariances, means, near, far)
    pairs = entries = pixels = 0
    for i in range(extrinsics.shape[0]):
        pg = projection.project_gaussians(means[i], covariances[i], harmonics[i], opacities[i],
                                          extrinsics[i], intrinsics[i], near[i], far[i], image_shape)
        binning = tiling.bin_gaussians(pg, image_shape, max_dup=max_dup, max_per_tile=max_per_tile)
        nty, ntx = binning.num_tiles_y, binning.num_tiles_x
        m2d, con, _, opa = composite.gather_tile_records(pg, binning.gaussian_ids)
        pix = composite.tile_pixel_grid(nty, ntx, tiling.TILE_H, tiling.TILE_W, m2d.dtype, m2d.device)
        for c0 in range(0, nty * ntx, tile_chunk):
            sl = slice(c0, c0 + tile_chunk)
            d = pix[sl][:, None, :, :] - m2d[sl][:, :, None, :]
            dx, dy = d[..., 0], d[..., 1]
            c = con[sl]
            power = (-0.5 * (c[:, :, None, 0] * dx * dx + c[:, :, None, 2] * dy * dy)
                     - c[:, :, None, 1] * dx * dy)
            alpha = torch.clamp(opa[sl][:, :, None] * torch.exp(power), max=projection.ALPHA_MAX)
            take = (power <= 0.0) & (alpha >= projection.ALPHA_MIN)
            alpha = torch.where(take, alpha, torch.zeros_like(alpha))
            T_after = torch.cumprod(1.0 - alpha, dim=1)
            live = torch.cumprod((T_after >= projection.T_EPS).to(alpha.dtype), dim=1) > 0
            used = take & live
            pairs += int(used.sum())
            entries += int(used.any(dim=2).sum())
        h, w = image_shape
        pixels += h * w
    return {"pairs": pairs, "entries": entries, "pixels": pixels}


def fwd_bound_ms(work: dict) -> float:
    return bound_ms(OPS_PER_EVAL * work["pairs"], RECORD_BYTES * work["entries"] + PIXEL_BYTES * work["pixels"])


def bwd_bound_ms(work: dict) -> float:
    """Reads the records and the pixels' colour gradients, writes each
    entry's record gradient."""
    return bound_ms(OPS_PER_EVAL_BWD * work["pairs"],
                    2 * RECORD_BYTES * work["entries"] + PIXEL_BYTES * work["pixels"])
