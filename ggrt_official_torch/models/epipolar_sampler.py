"""Epipolar sampling: project each pixel's ray into the other context views
and bilinearly sample features along the clipped epipolar segment
(reference encoder/epipolar/epipolar_sampler.py and
misc/heterogeneous_pairings.py). Parameter-free functions.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..constants import device_constant
from ..geometry.epipolar import project_rays
from ..geometry.projection import get_world_rays, sample_image_grid
from ..ops.grid_sample import grid_sample


def generate_heterogeneous_index(n: int) -> tuple[np.ndarray, np.ndarray]:
    """(index_self, index_other), each (n, n-1): all pairs except self."""
    arange = np.arange(n)
    index_self = np.repeat(arange[:, None], n - 1, axis=1)
    index_other = np.repeat(arange[None, :], n, axis=0) + np.triu(np.ones((n, n), dtype=np.int64))
    return index_self, index_other[:, :-1]


def generate_heterogeneous_index_transpose(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Index pair that transposes (view, other_view) tensors."""
    arange = np.arange(n)
    ones = np.ones((n, n), dtype=np.int64)
    index_self = np.repeat(arange[None, :], n, axis=0) + np.triu(ones)
    index_other = np.repeat(arange[:, None], n, axis=1) - (1 - np.triu(ones))
    return index_self[:, :-1], index_other[:, :-1]


class EpipolarSampling(NamedTuple):
    features: torch.Tensor        # (b, v, ov, r, s, c)
    valid: torch.Tensor           # (b, v, ov, r)
    xy_ray: torch.Tensor          # (b, v, r, 2)
    xy_sample: torch.Tensor       # (b, v, ov, r, s, 2)
    xy_sample_near: torch.Tensor  # (b, v, ov, r, s, 2)
    xy_sample_far: torch.Tensor   # (b, v, ov, r, s, 2)
    origins: torch.Tensor         # (b, v, r, 3)
    directions: torch.Tensor      # (b, v, r, 3)


def _index(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """An index array as a constant on `device`, made once per device."""
    return device_constant(tuple(map(tuple, a.tolist())), torch.int64, device)


def collect_other_views(x: torch.Tensor) -> torch.Tensor:
    """(b, v, ...) -> (b, v, v-1, ...): for each view, all other views."""
    _, index_other = generate_heterogeneous_index(x.shape[1])
    return x[:, _index(index_other, x.device)]


def transpose_other_views(x: torch.Tensor) -> torch.Tensor:
    """Swap 'view the ray came from' and 'view samples are drawn from'."""
    t_v, t_ov = generate_heterogeneous_index_transpose(x.shape[1])
    return x[:, _index(t_v, x.device), _index(t_ov, x.device)]


def generate_image_rays(
    image_shape: tuple[int, int],
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
):
    """Per-pixel world rays for every view.

    Returns xy (b, v, r, 2), origins/directions (b, v, r, 3).
    """
    b, v = extrinsics.shape[:2]
    h, w = image_shape
    xy, _ = sample_image_grid((h, w), device=extrinsics.device)
    xy = xy.reshape(-1, 2)
    origins, directions = get_world_rays(
        xy[None, None], extrinsics[:, :, None], intrinsics[:, :, None]
    )
    return xy[None, None].expand(b, v, h * w, 2), origins, directions


def sample_epipolar(
    features: torch.Tensor,      # (b, v, hf, wf, c) feature maps to sample from
    extrinsics: torch.Tensor,    # (b, v, 4, 4)
    intrinsics: torch.Tensor,    # (b, v, 3, 3)
    near: torch.Tensor,          # (b, v)
    far: torch.Tensor,           # (b, v)
    num_samples: int,
    rays: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
) -> EpipolarSampling:
    """Sample `num_samples` feature vectors along each ray's epipolar
    segment in every other view.

    `rays` optionally gives (xy, origins, directions) in place of the
    whole grid's: the crop path of deferred back-propagation samples for
    one tile's rays only, from the whole feature maps."""
    b, v, hf, wf, c = features.shape
    if rays is None:
        xy_ray, origins, directions = generate_image_rays((hf, wf), extrinsics, intrinsics)
    else:
        xy_ray, origins, directions = rays
    r = origins.shape[2]
    s = num_samples

    projection = project_rays(
        origins[:, :, None],                                # (b, v, 1, r, 3)
        directions[:, :, None],
        collect_other_views(extrinsics)[:, :, :, None],     # (b, v, ov, 1, 4, 4)
        collect_other_views(intrinsics)[:, :, :, None],
        near[:, :, None, None],
        far[:, :, None, None],
    )

    sample_depth = (torch.arange(s, device=features.device) + 0.5) / s
    overlap = projection.overlaps_image[..., None]
    xy_min = torch.nan_to_num(projection.xy_min, nan=0.0, posinf=0.0, neginf=0.0) * overlap
    xy_max = torch.nan_to_num(projection.xy_max, nan=0.0, posinf=0.0, neginf=0.0) * overlap
    xy_min = xy_min[..., None, :]                           # (b, v, ov, r, 1, 2)
    xy_max = xy_max[..., None, :]
    xy_sample = xy_min + sample_depth[:, None] * (xy_max - xy_min)

    # Transpose so dim 1 = the view samples are drawn FROM, then gather.
    samples_xy = transpose_other_views(xy_sample)           # (b, v, ov, r, s, 2)
    grid = samples_xy.reshape(b * v, (v - 1) * r * s, 1, 2) * 2.0 - 1.0
    feats = features.reshape(b * v, hf, wf, c).permute(0, 3, 1, 2)
    sampled = grid_sample(feats, grid, align_corners=False)  # (bv, c, ovrs, 1)
    sampled = sampled[..., 0].transpose(1, 2).reshape(b, v, v - 1, r, s, c)
    sampled = transpose_other_views(sampled)
    sampled = sampled * projection.overlaps_image[..., None, None]

    half_span = 0.5 / s
    return EpipolarSampling(
        features=sampled,
        valid=projection.overlaps_image,
        xy_ray=xy_ray,
        xy_sample=xy_sample,
        xy_sample_near=xy_min + (sample_depth[:, None] - half_span) * (xy_max - xy_min),
        xy_sample_far=xy_min + (sample_depth[:, None] + half_span) * (xy_max - xy_min),
        origins=origins,
        directions=directions,
    )
