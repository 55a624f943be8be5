"""Trajectory alignment and pose errors: Umeyama sim3 ATE alignment
(the reference's align_poses.py, align_ate_c2b_use_a2b) and the pose-error
protocol of eval_ggrt.py:277-282 / train_ggrt_stable.py:212-240.
"""
from __future__ import annotations

import math

import torch

from .se3 import _bottom_row, rotation_distance


def align_umeyama(model: torch.Tensor, data: torch.Tensor, known_scale: bool = False):
    """Umeyama least-squares sim3, model ≈ s·R @ data + t, for (n, 3) point
    sets. Returns (s, R (3, 3), t (3,)); the sign of det(U)·det(Vᵀ) keeps R
    a rotation where the best orthogonal fit is a reflection."""
    mu_m = model.mean(dim=0)
    mu_d = data.mean(dim=0)
    model_c = model - mu_m
    data_c = data - mu_d
    n = model.shape[0]

    C = (model_c.T @ data_c) / n
    sigma2 = (data_c * data_c).sum(dim=-1).mean()
    U, D, Vt = torch.linalg.svd(C)
    sign = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt.T))
    S = torch.diag(torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign]))
    R = U @ S @ Vt
    s = 1.0 if known_scale else torch.trace(torch.diag(D) @ S) / sigma2
    t = mu_m - s * (R @ mu_d)
    return s, R, t


def align_ate_c2b_use_a2b(traj_a: torch.Tensor, traj_b: torch.Tensor,
                          traj_c: torch.Tensor | None = None) -> torch.Tensor:
    """Align trajectory c to b with the sim3 fitted from a's camera centres
    to b's; all (n, 4, 4) c2w. Rotations become R @ R_c, translations
    s·R @ t_c + t (align_poses.py:142+)."""
    if traj_c is None:
        traj_c = traj_a
    s, R, t = align_umeyama(traj_b[:, :3, 3], traj_a[:, :3, 3])
    R_new = torch.einsum("ij,njk->nik", R, traj_c[:, :3, :3])
    t_new = s * torch.einsum("ij,nj->ni", R, traj_c[:, :3, 3]) + t
    return _bottom_row(torch.cat([R_new, t_new[..., None]], dim=-1))


def _median(x: torch.Tensor) -> torch.Tensor:
    """The mean of the two middle values for an even count, as jnp.median
    computes it (torch.median returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def evaluate_camera_alignment(aligned_pred: torch.Tensor, poses_gt: torch.Tensor) -> dict:
    """R (degrees) and t error statistics between (n, 4, 4) poses."""
    R_err = rotation_distance(aligned_pred[:, :3, :3], poses_gt[:, :3, :3])
    t_err = torch.linalg.norm(aligned_pred[:, :3, 3] - poses_gt[:, :3, 3], dim=-1)
    deg = 180.0 / math.pi
    return {
        "R_error_mean": R_err.mean() * deg,
        "R_error_med": _median(R_err) * deg,
        "t_error_mean": t_err.mean(),
        "t_error_med": _median(t_err),
    }
