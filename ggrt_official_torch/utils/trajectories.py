"""Camera trajectory generators (the JAX package's utils/trajectories.py;
the reference's pixelsplat wobble.py, interpolatation.py and the LLFF
spiral of its video renderers).

The wobble, interpolation and easing functions take and return torch
tensors on the inputs' device; `spiral_path` is host-side numpy, as in
the JAX package.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import linspace
from ..geometry.se3 import so3_exp, so3_log


def _eye4(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(4, dtype=like.dtype, device=like.device).expand(n, 4, 4).clone()


def generate_wobble_transformation(radius, t: torch.Tensor, num_rotations: int = 1,
                                   scale_radius_with_t: bool = True) -> torch.Tensor:
    """(t,) times -> (t, 4, 4) wobble transforms (ref wobble.py)."""
    tf = _eye4(t.shape[0], t)
    radius = radius * (t if scale_radius_with_t else 1.0)
    tf[:, 0, 3] = torch.cos(2 * math.pi * num_rotations * t) * radius
    tf[:, 1, 3] = torch.sin(2 * math.pi * num_rotations * t) * radius
    return tf


def generate_wobble(extrinsics: torch.Tensor, radius, t: torch.Tensor) -> torch.Tensor:
    """Wobble around a base camera: (4, 4), a radius, (t,) -> (t, 4, 4)."""
    return extrinsics[None] @ generate_wobble_transformation(radius, t)


def interpolate_intrinsics(k0: torch.Tensor, k1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Linear intrinsics interpolation (t, 3, 3)."""
    return k0[None] * (1 - t)[:, None, None] + k1[None] * t[:, None, None]


def interpolate_extrinsics(e0: torch.Tensor, e1: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Geodesic pose interpolation: slerp on SO(3), lerp on the translation."""
    R0, R1 = e0[:3, :3], e1[:3, :3]
    w = so3_log(R0.T @ R1)
    Rt = torch.einsum("ij,tjk->tik", R0, so3_exp(w[None] * t[:, None]))
    out = _eye4(t.shape[0], e0)
    out[:, :3, :3] = Rt
    out[:, :3, 3] = e0[:3, 3][None] * (1 - t)[:, None] + e1[:3, 3][None] * t[:, None]
    return out


def spiral_path(c2w_avg: np.ndarray, up: np.ndarray, rads: np.ndarray, focal: float,
                zrate: float = 0.5, rots: int = 2, n_frames: int = 120) -> np.ndarray:
    """LLFF-style spiral render path (ref llff_data_utils.render_path_spiral)."""
    from ..data.llff import normalize, viewmatrix

    render_poses = []
    rads = np.asarray(list(rads) + [1.0])
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, n_frames + 1)[:-1]:
        c = c2w_avg[:3, :4] @ (np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]) * rads)
        z = normalize(c - c2w_avg[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        pose = np.eye(4)
        pose[:3, :4] = viewmatrix(z, up, c)
        render_poses.append(pose)
    return np.stack(render_poses)


def cosine_ease(n_frames: int, device=None) -> torch.Tensor:
    """The reference's smooth time parameterization (pixelsplat.py:214-215)."""
    t = linspace(0.0, 1.0, n_frames, device=device)
    return (torch.cos(math.pi * (t + 1)) + 1) / 2
