"""SE(3)/SO(3) helpers: IPO-Net's 6-vector poses (translation ‖ euler
angles, the reference's Pose.from_vec, pose_util.py:143-158), the Lie
exp/log maps with Taylor branches near θ = 0, and the rotation distance of
the pose-error protocol.

`torch.where` differentiates both branches, so each Taylor-safe function
feeds its unsafe branch θ² = 1 where θ² is small: the gradient at θ = 0 is
then the Taylor branch's, not NaN.
"""
from __future__ import annotations

import torch


def _bottom_row(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the row [0, 0, 0, 1] appended, made
    on the device (no host-to-device copy, which would wait for the card)."""
    bottom = top.new_zeros(*top.shape[:-2], 1, 4)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def skew(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    w0, w1, w2 = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(w0)
    return torch.stack([
        torch.stack([zeros, -w2, w1], dim=-1),
        torch.stack([w2, zeros, -w0], dim=-1),
        torch.stack([-w1, w0, zeros], dim=-1),
    ], dim=-2)


def _safe_theta(theta_sq: torch.Tensor, eps: float = 1e-8):
    """(small, θ): θ = sqrt(θ²) where θ² >= eps, else sqrt(1)."""
    small = theta_sq < eps
    return small, torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))


def _taylor_A_sq(theta_sq):
    """sin(θ)/θ as a function of θ²."""
    small, theta = _safe_theta(theta_sq)
    return torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)


def _taylor_B_sq(theta_sq):
    """(1 - cos θ)/θ² as a function of θ²."""
    small, theta = _safe_theta(theta_sq)
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / ts_safe)


def _taylor_C_sq(theta_sq):
    """(θ - sin θ)/θ³ as a function of θ²."""
    small, theta = _safe_theta(theta_sq)
    ts_safe = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    return torch.where(small, 1.0 / 6.0 - theta_sq / 120.0, (theta - torch.sin(theta)) / (ts_safe * theta))


def _taylor_A(x):
    return _taylor_A_sq(x * x)


def _taylor_B(x):
    return _taylor_B_sq(x * x)


def _taylor_C(x):
    return _taylor_C_sq(x * x)


def axis_angle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta_sq = (v * v).sum(dim=-1)[..., None, None]
    wx = skew(v)
    eye = torch.eye(3, dtype=v.dtype, device=v.device)
    return eye + _taylor_A_sq(theta_sq) * wx + _taylor_B_sq(theta_sq) * (wx @ wx)


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


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    return axis_angle_to_R(w)


def so3_log(R: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """SO(3) -> so(3) (..., 3). Safe away from θ = π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    theta = torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))[..., None, None]
    lnR = 0.5 / torch.clamp(_taylor_A(theta), min=eps) * (R - R.transpose(-1, -2))
    return torch.stack([lnR[..., 2, 1], lnR[..., 0, 2], lnR[..., 1, 0]], dim=-1)


def se3_exp(wu: torch.Tensor) -> torch.Tensor:
    """se(3) 6-vector (w ‖ u) -> SE(3) 4x4 matrix."""
    w, u = wu[..., :3], wu[..., 3:]
    wx = skew(w)
    theta_sq = (w * w).sum(dim=-1)[..., None, None]
    eye = torch.eye(3, dtype=wu.dtype, device=wu.device)
    R = eye + _taylor_A_sq(theta_sq) * wx + _taylor_B_sq(theta_sq) * (wx @ wx)
    V = eye + _taylor_B_sq(theta_sq) * wx + _taylor_C_sq(theta_sq) * (wx @ wx)
    t = torch.einsum("...ij,...j->...i", V, u)
    return _bottom_row(torch.cat([R, t[..., None]], dim=-1))


def se3_log(T: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """SE(3) -> se(3) 6-vector (w ‖ u). θ is sqrt(Σw²), as jnp.linalg.norm
    computes it: at the identity its gradient is NaN in both packages."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    w = so3_log(R)
    wx = skew(w)
    theta = torch.sqrt((w * w).sum(dim=-1))[..., None, None]
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    A = _taylor_A(theta)
    B = _taylor_B(theta)
    invV = eye - 0.5 * wx + (1.0 - A / (2.0 * B)) / (theta**2 + eps) * (wx @ wx)
    u = torch.einsum("...ij,...j->...i", invV, t)
    return torch.cat([w, u], dim=-1)


def compose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_new(x) = pose_b(pose_a(x)); both (..., 4, 4)."""
    return pose_b @ pose_a


def rotation_distance(R1: torch.Tensor, R2: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Angular distance between rotation matrices (radians)."""
    R_diff = R1 @ R2.transpose(-1, -2)
    trace = R_diff[..., 0, 0] + R_diff[..., 1, 1] + R_diff[..., 2, 2]
    return torch.arccos(torch.clamp((trace - 1.0) / 2.0, -1.0 + eps, 1.0 - eps))


def relative_to_source_c2w(target_c2w: torch.Tensor, rel_pose_vec: torch.Tensor) -> torch.Tensor:
    """Predicted target->source relative poses (..., 6) -> source c2w
    matrices (the reference's Projector.get_train_poses, projection.py:44-64):
    R_ref = R_target @ R_rel^T, t_ref = t_target - R_ref @ t_rel."""
    rel = pose_from_vec(rel_pose_vec)
    R_ref = target_c2w[..., :3, :3] @ rel[..., :3, :3].transpose(-1, -2)
    t_ref = target_c2w[..., :3, 3] - torch.einsum("...ij,...j->...i", R_ref, rel[..., :3, 3])
    return _bottom_row(torch.cat([R_ref, t_ref[..., None]], dim=-1))
