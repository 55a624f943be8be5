"""Public rendering API of the Gaussian rasterizer.

Mirrors the reference's render_cuda / render_depth_cuda surface
(cuda_splatting.py:49-128, 227-269): scale-invariant world rescaling,
per-view rendering, and z-as-colour depth rendering, with three compositing
backends:

  * "cuda" (synonym "pallas"): the hand-written tile compositor kernels;
  * "tiled":     plain PyTorch per-tile compositing in checkpointed chunks;
  * "reference": the O(pixels x Gaussians) oracle (tests, tiny scenes);

and three binning modes for the first two: "sort", "counting" and
"banked" (see tiling.py). `choose_max_per_tile` picks the per-tile
capacity K by measuring the quality at each candidate.
"""
from __future__ import annotations

import math

import torch

from ...geometry.depth import depth_to_relative_disparity
from ...geometry.projection import homogenize_points, invert_se3
from ...utils.tracing import span
from . import composite, cuda_composite, reference, tiling
from .projection import ProjectedGaussians, project_gaussians

_SH_C0 = 0.28209479177387814
BACKENDS = ("cuda", "pallas", "tiled", "reference")
BINNINGS = {
    "sort": tiling.bin_gaussians,
    "counting": tiling.bin_gaussians_counting,
    "banked": tiling.bin_gaussians_banked,
}


def check_backend(backend: str) -> None:
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of {BACKENDS}")


def _render_one(
    extrinsics, intrinsics, near, far, background,
    means, covariances, sh_coeffs, opacities,
    image_shape, backend, max_dup, max_per_tile, tile_chunk, binning_mode, tile_shape,
):
    th, tw = tile_shape or (tiling.TILE_H, tiling.TILE_W)
    if backend == "reference":
        # The production tile shape, so the oracle culls at tile granularity
        # as the binned backends do.
        return reference.render_reference(
            means, covariances, sh_coeffs, opacities,
            extrinsics, intrinsics, near, far, image_shape, background,
            tile_shape=(th, tw),
        )
    with span("raster.project", device=True):
        pg = project_gaussians(
            means, covariances, sh_coeffs, opacities,
            extrinsics, intrinsics, near, far, image_shape,
        )
    # Binning is a discrete choice (which Gaussians land on which tile, in
    # what order) and carries no gradient.
    with span("raster.bin", device=True):
        binning = BINNINGS[binning_mode](
            ProjectedGaussians(*(x.detach() for x in pg)),
            image_shape, max_dup=max_dup, max_per_tile=max_per_tile,
            tile_h=th, tile_w=tw,
        )
    if backend == "tiled":
        return composite.composite_tiles(
            pg, binning, background, image_shape, tile_h=th, tile_w=tw, tile_chunk=tile_chunk
        )
    return cuda_composite.composite_tiles(
        pg, binning, background, image_shape, tile_h=th, tile_w=tw
    )


def _rescale(extrinsics, covariances, means, near, far):
    """Rescale the world so near == 1 (cuda_splatting.py:66-73): keeps the
    projection matrix exact and numerics well-ranged."""
    scale = 1.0 / near
    extrinsics = extrinsics.clone()
    extrinsics[..., :3, 3] = extrinsics[..., :3, 3] * scale[:, None]
    covariances = covariances * (scale[:, None, None, None] ** 2)
    return extrinsics, covariances, means * scale[:, None, None], near * scale, far * scale


def render(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
    background: torch.Tensor,
    means: torch.Tensor,
    covariances: torch.Tensor,
    sh_coeffs: torch.Tensor,
    opacities: torch.Tensor,
    scale_invariant: bool = True,
    backend: str = "cuda",
    max_dup: int = 32,
    max_per_tile: int = 1024,
    tile_chunk: int = 16,
    binning_mode: str = "sort",
    tile_shape: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Render a batch of views.

    extrinsics (b, 4, 4) c2w; intrinsics (b, 3, 3) normalized; near/far
    (b,); background (b, 3); means (b, g, 3); covariances (b, g, 3, 3);
    sh_coeffs (b, g, 3, d_sh); opacities (b, g). backend is one of
    BACKENDS, binning_mode one of BINNINGS; tile_chunk is the tiled
    backend's tiles per checkpointed step; tile_shape is (tile_h, tile_w),
    default (8, 128). Returns (b, 3, h, w) images.
    """
    check_backend(backend)
    if binning_mode not in BINNINGS:
        raise ValueError(f"unknown binning mode {binning_mode!r}; one of {tuple(BINNINGS)}")
    # A span inside the body, not a decorator: a wrapper's arguments would
    # keep the caller's temporaries alive past the rescale below.
    with span("raster"):
        if scale_invariant:
            extrinsics, covariances, means, near, far = _rescale(extrinsics, covariances, means, near, far)

        return torch.stack([
            _render_one(
                extrinsics[i], intrinsics[i], near[i], far[i], background[i],
                means[i], covariances[i], sh_coeffs[i], opacities[i],
                image_shape, backend, max_dup, max_per_tile, tile_chunk, binning_mode, tile_shape,
            )
            for i in range(extrinsics.shape[0])
        ])


def choose_max_per_tile(
    extrinsics, intrinsics, near, far, image_shape, background,
    means, covariances, sh_coeffs, opacities,
    *, target_db: float = 45.0, floor: int = 256, cap: int = 16384,
    max_dup: int = 8, scale_invariant: bool = True,
    tile_shape: tuple[int, int] | None = None,
) -> dict:
    """Quality-aware per-tile capacity for the first view of a batch.

    Bins once in sort mode at the demand-covering capacity k_ref
    (`tiling.recommend_max_per_tile` without a cap), renders that with the
    tiled compositor as the uncapped oracle, then renders the front-k of the
    same lists for k = floor, 2·floor, ... (the lists binning at k gives)
    and returns the smallest k within `target_db` PSNR of the oracle, with
    the demand-based K and the PSNR at every probed k. Runs without
    autograd; each probe composites one tile at a time.
    """
    with torch.no_grad():
        if scale_invariant:
            extrinsics, covariances, means, near, far = _rescale(
                extrinsics, covariances, means, near, far)
        th, tw = tile_shape or (tiling.TILE_H, tiling.TILE_W)
        pg = project_gaussians(
            means[0], covariances[0], sh_coeffs[0], opacities[0],
            extrinsics[0], intrinsics[0], near[0], far[0], image_shape,
        )
        rec = tiling.recommend_max_per_tile(pg, image_shape, max_dup=max_dup, cap=1 << 30,
                                            tile_h=th, tile_w=tw)
        k_ref = max(rec["max_per_tile"], floor)
        binning = tiling.bin_gaussians(pg, image_shape, max_dup=max_dup, max_per_tile=k_ref,
                                       tile_h=th, tile_w=tw)

        def render_front(k):
            front = binning._replace(gaussian_ids=binning.gaussian_ids[:, :k],
                                     counts=torch.clamp(binning.counts, max=k))
            return composite.composite_tiles(pg, front, background[0], image_shape,
                                             tile_h=th, tile_w=tw, tile_chunk=1)

        ref = render_front(k_ref)

        def psnr_at(k):
            mse = float(torch.mean((render_front(k).double() - ref.double()) ** 2))
            return 99.0 if mse < 1e-12 else -10.0 * math.log10(mse)

        candidates, k = [], floor
        while k < min(k_ref, cap):
            candidates.append(k)
            k *= 2
        candidates.append(min(k_ref, cap))

        probed = {}
        chosen = candidates[-1]
        for k in candidates:
            db = psnr_at(k) if k < k_ref else 99.0
            probed[int(k)] = round(db, 2)
            if db >= target_db:
                chosen = k
                break

    return {
        "max_per_tile": int(chosen),
        "demand_k": int(rec["max_per_tile"]),
        "k_ref": int(k_ref),
        "target_db": target_db,
        "psnr_at_k": probed,
        "clipped": bool(probed.get(int(chosen), 99.0) < target_db),
        "max_tile_demand": rec["max_tile_demand"],
    }


def render_depth(
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
    means: torch.Tensor,
    covariances: torch.Tensor,
    opacities: torch.Tensor,
    mode: str = "depth",
    scale_invariant: bool = True,
    backend: str = "cuda",
    **kwargs,
) -> torch.Tensor:
    """Depth rendering by splatting camera-space z as the colour channel;
    mode "depth", "disparity", "relative_disparity" or "log" transforms z
    first. Returns (b, h, w)."""
    cam_space = torch.einsum(
        "bij,bgj->bgi", invert_se3(extrinsics), homogenize_points(means)
    )
    fake_color = cam_space[..., 2]
    if mode == "disparity":
        fake_color = 1.0 / fake_color
    elif mode == "relative_disparity":
        fake_color = depth_to_relative_disparity(fake_color, near[:, None], far[:, None])
    elif mode == "log":
        fake_color = torch.log(torch.clamp(fake_color, torch.minimum(near, far)[:, None],
                                           torch.maximum(near, far)[:, None]))
    elif mode != "depth":
        raise ValueError(f"unknown depth mode {mode!r}")

    # Deliberate fix vs the reference (as in the JAX package): invert the SH
    # DC transform so the composited output is the alpha-weighted depth
    # exactly, not SH_C0·z + 0.5.
    b, g = fake_color.shape
    sh0 = fake_color[..., None, None] / _SH_C0 - 0.5 / _SH_C0
    sh0 = sh0.expand(b, g, 3, 1)
    background = torch.zeros((b, 3), dtype=means.dtype, device=means.device)
    img = render(
        extrinsics, intrinsics, near, far, image_shape, background,
        means, covariances, sh0, opacities,
        scale_invariant=scale_invariant, backend=backend, **kwargs,
    )
    return img.mean(dim=1)
