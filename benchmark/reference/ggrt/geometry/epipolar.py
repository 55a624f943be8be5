"""Epipolar line projection on torch tensors, branch-free.

The reference's case analysis over (min_valid, max_valid) is written with
`torch.where`, so one expression covers every ray and no shape depends on
the data.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .projection import (
    get_world_rays,
    homogenize_points,
    homogenize_vectors,
    intersect_rays,
    invert_se3,
    project_camera_space,
)


class PointProjection(NamedTuple):
    t: torch.Tensor        # ray parameter
    xy: torch.Tensor       # normalized image xy
    valid: torch.Tensor    # in-bounds & in-front & positive-t


class RaySegmentProjection(NamedTuple):
    t_min: torch.Tensor
    t_max: torch.Tensor
    xy_min: torch.Tensor
    xy_max: torch.Tensor
    overlaps_image: torch.Tensor


def _is_in_bounds(xy: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return (xy >= -epsilon).all(dim=-1) & (xy <= 1 + epsilon).all(dim=-1)


def _is_in_front_of_camera(xyz: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return xyz[..., -1] > -epsilon


def _is_positive_t(t: torch.Tensor, epsilon: float = 1e-6) -> torch.Tensor:
    return t > -epsilon


def _intersect_image_coordinate(
    intrinsics: torch.Tensor,
    origins: torch.Tensor,
    directions: torch.Tensor,
    dim: int,
    coordinate_value: float,
) -> PointProjection:
    """Intersect the projected ray with the image-frame line x=v (dim 0) or
    y=v (dim 1)."""
    other_dim = 1 - dim
    fs = intrinsics[..., dim, dim]
    fo = intrinsics[..., other_dim, other_dim]
    cs = intrinsics[..., dim, 2]
    co = intrinsics[..., other_dim, 2]
    os_ = origins[..., dim]
    oo = origins[..., other_dim]
    ds = directions[..., dim]
    do = directions[..., other_dim]
    oz = origins[..., 2]
    dz = directions[..., 2]
    c = (coordinate_value - cs) / fs

    t = (c * oz - os_) / (ds - c * dz)
    coord_other = co + fo * (oo * (c * dz - ds) + do * (os_ - c * oz)) / (dz * os_ - ds * oz)
    coord_same = torch.full_like(coord_other, coordinate_value)
    if dim == 0:
        xy = torch.stack([coord_same, coord_other], dim=-1)
    else:
        xy = torch.stack([coord_other, coord_same], dim=-1)
    xyz = origins + t[..., None] * directions
    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    # Invalid entries may hold inf/nan; sanitize so the lerp between the
    # segment's ends stays finite.
    t = torch.nan_to_num(t, nan=0.0, posinf=1e10, neginf=-1e10)
    xy = torch.nan_to_num(xy, nan=0.0, posinf=1e4, neginf=-1e4)
    return PointProjection(t, xy, valid)


def _reduce_projections(projections: list[PointProjection], reduction: str) -> PointProjection:
    """Pick, per ray, the intersection with the min/max t among the valid ones."""
    t = torch.stack([p.t for p in projections], dim=0)
    xy = torch.stack([p.xy for p in projections], dim=0)
    valid = torch.stack([p.valid for p in projections], dim=0)

    lowest = float("inf") if reduction == "min" else float("-inf")
    t_masked = torch.where(valid, t, torch.full_like(t, lowest))
    selector = t_masked.argmin(dim=0) if reduction == "min" else t_masked.argmax(dim=0)

    take = lambda arr: torch.gather(arr, 0, selector[None])[0]
    take2 = lambda arr: torch.gather(
        arr, 0, selector[None, ..., None].expand(1, *selector.shape, arr.shape[-1])
    )[0]
    return PointProjection(take(t_masked), take2(xy), take(valid))


def _compute_point_projection(
    xyz: torch.Tensor, t: torch.Tensor, intrinsics: torch.Tensor
) -> PointProjection:
    xy = project_camera_space(xyz, intrinsics)
    valid = _is_in_bounds(xy) & _is_in_front_of_camera(xyz) & _is_positive_t(t)
    return PointProjection(t, xy, valid)


def project_rays(
    origins: torch.Tensor,
    directions: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
) -> RaySegmentProjection:
    """Project world-space rays into another camera, clipping the epipolar
    segment to the image frame and to the near/far planes.

    Shapes broadcast: origins/directions (..., 3), extrinsics (..., 4, 4),
    intrinsics (..., 3, 3), near/far (...).
    """
    world_to_cam = invert_se3(extrinsics)
    origins_cam = torch.einsum(
        "...ij,...j->...i", world_to_cam, homogenize_points(origins)
    )[..., :3]
    directions_cam = torch.einsum(
        "...ij,...j->...i", world_to_cam, homogenize_vectors(directions)
    )[..., :3]

    frame_intersections = [
        _intersect_image_coordinate(intrinsics, origins_cam, directions_cam, 0, 0.0),
        _intersect_image_coordinate(intrinsics, origins_cam, directions_cam, 0, 1.0),
        _intersect_image_coordinate(intrinsics, origins_cam, directions_cam, 1, 0.0),
        _intersect_image_coordinate(intrinsics, origins_cam, directions_cam, 1, 1.0),
    ]
    fi_min = _reduce_projections(frame_intersections, "min")
    fi_max = _reduce_projections(frame_intersections, "max")

    batch_shape = fi_min.t.shape
    t_near = near.expand(batch_shape)
    at_near = _compute_point_projection(
        origins_cam + t_near[..., None] * directions_cam, t_near, intrinsics
    )
    t_far = far.expand(batch_shape)
    at_far = _compute_point_projection(
        origins_cam + t_far[..., None] * directions_cam, t_far, intrinsics
    )

    # If the endpoint projection is valid use it, otherwise fall back to the
    # frame intersection.
    def pick(valid, endpoint: PointProjection, frame: PointProjection):
        t = torch.where(valid, endpoint.t, frame.t)
        xy = torch.where(valid[..., None], endpoint.xy, frame.xy)
        ok = torch.where(valid, endpoint.valid, frame.valid)
        return t, xy, ok

    t_min, xy_min, min_ok = pick(at_near.valid, at_near, fi_min)
    t_max, xy_max, max_ok = pick(at_far.valid, at_far, fi_max)

    return RaySegmentProjection(
        t_min=t_min,
        t_max=t_max,
        xy_min=xy_min,
        xy_max=xy_max,
        overlaps_image=min_ok & max_ok,
    )


def lift_to_3d(
    origins: torch.Tensor,
    directions: torch.Tensor,
    xy: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> torch.Tensor:
    """3D positions of 2D points on the epipolar lines."""
    xy_origins, xy_directions = get_world_rays(xy, extrinsics, intrinsics)
    return intersect_rays(origins, directions, xy_origins, xy_directions)


def get_depth(
    origins: torch.Tensor,
    directions: torch.Tensor,
    xy: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> torch.Tensor:
    """Depths (distance from ray origin) of 2D epipolar samples."""
    xyz = lift_to_3d(origins, directions, xy, extrinsics, intrinsics)
    return torch.linalg.norm(xyz - origins, dim=-1)
