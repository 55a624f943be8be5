"""Raw features -> 3D Gaussian parameters (reference
encoder/common/gaussian_adapter.py and gaussians.py).

scales: sigmoid to [scale_min, scale_max] · depth · pixel-size multiplier;
rotations: normalized xyzw quaternions; covariance R S Sᵀ Rᵀ rotated to
world; SH coefficients masked toward the DC term and rotated by the c2w
rotation; means = ray origin + direction · depth. Parameter-free.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..config import GaussianAdapterCfg
from ..constants import device_constant
from ..geometry.projection import get_world_rays, invert_intrinsics
from ..ops.sh import rotate_sh


class Gaussians(NamedTuple):
    means: torch.Tensor        # (..., 3)
    covariances: torch.Tensor  # (..., 3, 3)
    harmonics: torch.Tensor    # (..., 3, d_sh)
    opacities: torch.Tensor    # (...)
    scales: torch.Tensor       # (..., 3)
    rotations: torch.Tensor    # (..., 4)


def quaternion_to_matrix(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """xyzw quaternion -> rotation matrix."""
    i, j, k, r = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    two_s = 2.0 / ((q * q).sum(dim=-1) + eps)
    o = torch.stack(
        [
            1 - two_s * (j * j + k * k), two_s * (i * j - k * r), two_s * (i * k + j * r),
            two_s * (i * j + k * r), 1 - two_s * (i * i + k * k), two_s * (j * k - i * r),
            two_s * (i * k - j * r), two_s * (j * k + i * r), 1 - two_s * (i * i + j * j),
        ],
        dim=-1,
    )
    return o.reshape(*q.shape[:-1], 3, 3)


def build_covariance(scale: torch.Tensor, rotation_xyzw: torch.Tensor) -> torch.Tensor:
    """R S Sᵀ Rᵀ."""
    R = quaternion_to_matrix(rotation_xyzw)
    return torch.einsum("...ij,...j,...kj->...ik", R, scale * scale, R)


class GaussianAdapter(nn.Module):
    def __init__(self, cfg: GaussianAdapterCfg):
        super().__init__()
        self.cfg = cfg
        mask = torch.ones(self.d_sh)
        for degree in range(1, cfg.sh_degree + 1):
            mask[degree**2:(degree + 1) ** 2] = 0.1 * 0.25**degree
        self.register_buffer("sh_mask", mask, persistent=False)

    @property
    def d_sh(self) -> int:
        return (self.cfg.sh_degree + 1) ** 2

    @property
    def d_in(self) -> int:
        return 7 + 3 * self.d_sh

    def forward(
        self,
        extrinsics: torch.Tensor,     # (..., 4, 4)
        intrinsics: torch.Tensor,     # (..., 3, 3)
        coordinates: torch.Tensor,    # (..., 2) normalized image xy
        depths: torch.Tensor,         # (...)
        opacities: torch.Tensor,      # (...)
        raw_gaussians: torch.Tensor,  # (..., 7 + 3*d_sh)
        image_shape: tuple[int, int],
        eps: float = 1e-8,
    ) -> Gaussians:
        h, w = image_shape
        scales, rotations, sh = torch.split(
            raw_gaussians, [3, 4, raw_gaussians.shape[-1] - 7], dim=-1
        )

        c = self.cfg
        scales = c.gaussian_scale_min + (c.gaussian_scale_max - c.gaussian_scale_min) * torch.sigmoid(scales)
        pixel_size = device_constant((1.0 / w, 1.0 / h), raw_gaussians.dtype, raw_gaussians.device)
        multiplier = 0.1 * torch.einsum(
            "...ij,j->...i", invert_intrinsics(intrinsics)[..., :2, :2], pixel_size
        ).sum(dim=-1)
        scales = scales * depths[..., None] * multiplier[..., None]

        # rsqrt(sum + eps²) keeps the gradient finite at a zero quaternion.
        rotations = rotations * torch.rsqrt((rotations * rotations).sum(dim=-1, keepdim=True) + eps * eps)

        sh = sh.reshape(*sh.shape[:-1], 3, self.d_sh)
        sh = sh.expand(*opacities.shape, 3, self.d_sh) * self.sh_mask

        covariances = build_covariance(scales, rotations)
        c2w_rot = extrinsics[..., :3, :3]
        covariances = c2w_rot @ covariances @ c2w_rot.transpose(-1, -2)

        origins, directions = get_world_rays(coordinates, extrinsics, intrinsics)
        means = origins + directions * depths[..., None]

        return Gaussians(
            means=means,
            covariances=covariances,
            harmonics=rotate_sh(sh, c2w_rot[..., None, :, :]),
            opacities=opacities,
            scales=scales,
            rotations=rotations.expand(*scales.shape[:-1], 4),
        )
