"""SE(3) helpers for IPO-Net's 6-vector poses (translation ‖ euler angles,
the reference's Pose.from_vec, pose_util.py:143-158)."""
from __future__ import annotations

import torch


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the row [0, 0, 0, 1] appended."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=top.dtype, device=top.device)
    return torch.cat([top, bottom.expand(*top.shape[:-2], 1, 4)], dim=-2)


def euler_angle_to_R(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) = (x, y, z) -> R = Rx @ Ry @ Rz (..., 3, 3),
    each the standard rotation about its axis (pose_util.py:52-81)."""
    x, y, z = angle[..., 0], angle[..., 1], angle[..., 2]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)

    def mat(*entries):
        return torch.stack(entries, dim=-1).reshape(*x.shape, 3, 3)

    cz, sz = torch.cos(z), torch.sin(z)
    cy, sy = torch.cos(y), torch.sin(y)
    cx, sx = torch.cos(x), torch.sin(x)
    zmat = mat(cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones)
    ymat = mat(cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy)
    xmat = mat(ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx)
    return xmat @ ymat @ zmat


def pose_from_vec(vec: torch.Tensor) -> torch.Tensor:
    """6-vector (..., 6) = (tvec ‖ euler xyz) -> (..., 4, 4) SE(3) matrix."""
    R = euler_angle_to_R(vec[..., 3:])
    return _bottom_row(torch.cat([R, vec[..., :3, None]], dim=-1))


def relative_to_source_c2w(target_c2w: torch.Tensor, rel_pose_vec: torch.Tensor) -> torch.Tensor:
    """Predicted target->source relative poses (..., 6) -> source c2w
    matrices (the reference's Projector.get_train_poses, projection.py:44-64):
    R_ref = R_target @ R_rel^T, t_ref = t_target - R_ref @ t_rel."""
    rel = pose_from_vec(rel_pose_vec)
    R_ref = target_c2w[..., :3, :3] @ rel[..., :3, :3].transpose(-1, -2)
    t_ref = target_c2w[..., :3, 3] - torch.einsum("...ij,...j->...i", R_ref, rel[..., :3, 3])
    return _bottom_row(torch.cat([R_ref, t_ref[..., None]], dim=-1))
