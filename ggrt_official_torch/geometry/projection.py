"""Ray/point projection helpers on torch tensors.

Conventions (identical to the JAX package and the reference):
  * Intrinsics are *normalized* 3x3 matrices: focal lengths and principal
    point are in units of image size, so pixel coordinates live in
    [0, 1] x [0, 1] with x = column/width.
  * Extrinsics are camera-to-world (c2w) 4x4 matrices.
All functions broadcast over leading batch dims.
"""
from __future__ import annotations

import torch

from ..constants import device_constant

_F32_EPS = float(torch.finfo(torch.float32).eps)


def homogenize_points(points: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz1."""
    return torch.cat([points, torch.ones_like(points[..., :1])], dim=-1)


def homogenize_vectors(vectors: torch.Tensor) -> torch.Tensor:
    """(..., d) xyz -> (..., d+1) xyz0."""
    return torch.cat([vectors, torch.zeros_like(vectors[..., :1])], dim=-1)


def transform_rigid(homogeneous: torch.Tensor, transformation: torch.Tensor) -> torch.Tensor:
    """Apply a rigid transform to homogeneous points/vectors: T @ x."""
    return torch.einsum("...ij,...j->...i", transformation, homogeneous)


def transform_cam2world(homogeneous: torch.Tensor, extrinsics: torch.Tensor) -> torch.Tensor:
    return transform_rigid(homogeneous, extrinsics)


def invert_se3(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of an SE(3) matrix (..., 4, 4)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    t_inv = -torch.einsum("...ij,...j->...i", Rt, t)
    top = torch.cat([Rt, t_inv[..., None]], dim=-1)
    bottom = device_constant((0.0, 0.0, 0.0, 1.0), T.dtype, T.device)
    bottom = bottom.expand(*top.shape[:-2], 1, 4)
    return torch.cat([top, bottom], dim=-2)


def invert_intrinsics(K: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a pinhole intrinsics matrix (..., 3, 3)."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    zeros = torch.zeros_like(fx)
    ones = torch.ones_like(fx)
    row0 = torch.stack([1.0 / fx, zeros, -cx / fx], dim=-1)
    row1 = torch.stack([zeros, 1.0 / fy, -cy / fy], dim=-1)
    row2 = torch.stack([zeros, zeros, ones], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def project_camera_space(
    points: torch.Tensor,
    intrinsics: torch.Tensor,
    epsilon: float = _F32_EPS,
    infinity: float = 1e8,
) -> torch.Tensor:
    """Perspective-divide camera-space points and apply intrinsics."""
    points = points / (points[..., -1:] + epsilon)
    points = torch.nan_to_num(points, posinf=infinity, neginf=-infinity)
    points = torch.einsum("...ij,...j->...i", intrinsics, points)
    return points[..., :-1]


def unproject(coordinates: torch.Tensor, z: torch.Tensor, intrinsics: torch.Tensor) -> torch.Tensor:
    """Normalized image xy + depth -> camera-space points."""
    coordinates = homogenize_points(coordinates)
    directions = torch.einsum("...ij,...j->...i", invert_intrinsics(intrinsics), coordinates)
    return directions * z[..., None]


def get_world_rays(
    coordinates: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalized image xy -> world-space ray (origins, unit directions)."""
    directions = unproject(coordinates, torch.ones_like(coordinates[..., 0]), intrinsics)
    directions = directions / torch.linalg.norm(directions, dim=-1, keepdim=True)
    directions = transform_cam2world(homogenize_vectors(directions), extrinsics)[..., :-1]
    origins = extrinsics[..., :-1, -1].expand(directions.shape)
    return origins, directions


def sample_image_grid(
    shape: tuple[int, int], device=None, dtype=torch.float32
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pixel-center coordinates for an image.

    Returns:
      coordinates: (h, w, 2) float xy in (0, 1), x along width.
      indices: (h, w, 2) integer (row, col).
    """
    h, w = shape
    rows = torch.arange(h, device=device)
    cols = torch.arange(w, device=device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    indices = torch.stack([rr, cc], dim=-1)
    x = (cc.to(dtype) + 0.5) / w
    y = (rr.to(dtype) + 0.5) / h
    return torch.stack([x, y], dim=-1), indices


def intersect_rays(
    origins_x: torch.Tensor,
    directions_x: torch.Tensor,
    origins_y: torch.Tensor,
    directions_y: torch.Tensor,
    eps: float = 1e-5,
    inf: float = 1e10,
) -> torch.Tensor:
    """Least-squares intersection of two ray bundles (parallel -> inf).

    Parallel pairs are solved against a regularized system and overwritten
    with `inf` through a mask, so every shape stays static.
    """
    shape = torch.broadcast_shapes(
        origins_x.shape, directions_x.shape, origins_y.shape, directions_y.shape
    )
    ox = origins_x.expand(shape)
    dx = directions_x.expand(shape)
    oy = origins_y.expand(shape)
    dy = directions_y.expand(shape)

    parallel = (dx * dy).sum(dim=-1) > 1 - eps
    eye = torch.eye(3, dtype=ox.dtype, device=ox.device)

    def normal_mat(d):
        return d[..., :, None] * d[..., None, :] - eye

    nx = normal_mat(dx)
    ny = normal_mat(dy)
    lhs = nx + ny
    rhs = torch.einsum("...ij,...j->...i", nx, ox) + torch.einsum("...ij,...j->...i", ny, oy)
    lhs = lhs + parallel.to(lhs.dtype)[..., None, None] * eye
    # solve_ex without its error check: linalg.solve reads the factorisation's
    # status back from the device, a host sync on every call.
    solution = torch.linalg.solve_ex(lhs, rhs[..., None])[0][..., 0]
    return torch.where(parallel[..., None], torch.full_like(solution, inf), solution)


def get_fov(intrinsics: torch.Tensor) -> torch.Tensor:
    """Field of view (fov_x, fov_y) from normalized intrinsics (..., 3, 3)."""
    k_inv = invert_intrinsics(intrinsics)

    def bearing(v):
        v = device_constant(v, intrinsics.dtype, intrinsics.device)
        v = torch.einsum("...ij,j->...i", k_inv, v)
        return v / torch.linalg.norm(v, dim=-1, keepdim=True)

    left = bearing((0.0, 0.5, 1.0))
    right = bearing((1.0, 0.5, 1.0))
    top = bearing((0.5, 0.0, 1.0))
    bottom = bearing((0.5, 1.0, 1.0))
    fov_x = torch.arccos(torch.clamp((left * right).sum(dim=-1), -1.0, 1.0))
    fov_y = torch.arccos(torch.clamp((top * bottom).sum(dim=-1), -1.0, 1.0))
    return torch.stack([fov_x, fov_y], dim=-1)
