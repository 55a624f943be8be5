"""Quaternion / Lie-group library (the JAX package's geometry/lie_group.py;
the reference's class-based lib under ggrt/geometry/lie_group/: so3.py,
so3q.py, se3.py, se3q.py, se3_common.py).

Pure functions over batched tensors: (..., 4) unit quaternions (w, x, y,
z), scalar first, kept on the w >= 0 hemisphere; (..., 7) quat+trans
vectors; (..., 3, 3) / (..., 4, 4) matrices; with the analytic Jacobians
the reference exposes for pose-graph optimisation. Small-angle branches use
geometry/se3.py's Taylor guards, each fed a safe argument where its branch
is not taken, so gradients stay finite at θ = 0.
"""
from __future__ import annotations

import torch

from .se3 import _taylor_A_sq, _taylor_B_sq, _taylor_C_sq, se3_exp, se3_log, skew


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# Quaternions (w, x, y, z), scalar first as the reference (pytorch3d's order).


def quat_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    q = torch.zeros(*shape, 4, dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unit length and the canonical hemisphere w >= 0 (normalize_quat_trans,
    se3_common.py:12-21), so log maps stay in (-π, π]."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    q = q / torch.clamp(n, min=eps)
    return torch.where(q[..., 0:1] < 0, -q, q)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ], dim=-1)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate points `v` (..., 3) by unit quaternion(s) `q` (..., 4)."""
    qv, w = q[..., 1:], q[..., 0:1]
    qv, v = torch.broadcast_tensors(qv, v)
    t = 2.0 * torch.linalg.cross(qv, v)
    return v + w * t + torch.linalg.cross(qv, t)


def quat_to_R(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation matrix (se3_common.py quattrans2mat)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack([
        torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
        torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
        torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
    ], dim=-2)


def R_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion, branch-free Shepperd: the
    candidate built on the largest of the four 4|q_i|² magnitudes, the first
    of them where two tie (torch.argmax, as jnp.argmax, takes the first)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    qw2 = torch.clamp(1 + m00 + m11 + m22, min=0.0)
    qx2 = torch.clamp(1 + m00 - m11 - m22, min=0.0)
    qy2 = torch.clamp(1 - m00 + m11 - m22, min=0.0)
    qz2 = torch.clamp(1 - m00 - m11 + m22, min=0.0)
    qw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], -1)
    best = torch.argmax(torch.stack([qw2, qx2, qy2, qz2], -1), dim=-1)
    cands = torch.stack([qw, qx, qy, qz], dim=-2)                 # (..., 4 pivots, 4)
    q = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 4))[..., 0, :]
    return quat_normalize(q)


def quat_exp(w: torch.Tensor) -> torch.Tensor:
    """so(3) tangent (..., 3) -> unit quaternion [cos θ/2, sin(θ/2)·ŵ] (so3q.py
    exp). cos(θ/2) is Taylor-guarded near 0, where the unused branch gets
    θ² = 1, so the gradient at θ = 0 is finite."""
    theta_sq = (w * w).sum(dim=-1, keepdim=True)
    half_sq = theta_sq / 4.0
    small = theta_sq < 1e-8
    theta_safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq), theta_sq))
    cos_half = torch.where(small, 1.0 - half_sq / 2.0 + half_sq * half_sq / 24.0, torch.cos(theta_safe / 2.0))
    sinc_half = _taylor_A_sq(half_sq) / 2.0
    return quat_normalize(torch.cat([cos_half, sinc_half * w], dim=-1))


def quat_log(q: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Unit quaternion -> so(3) tangent (..., 3) (so3q.py log)."""
    q = quat_normalize(q)
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    half = torch.atan2(vn, w)  # in [0, π/2] on the w >= 0 hemisphere
    scale = torch.where(vn > eps, 2.0 * half / torch.clamp(vn, min=eps), 2.0 / torch.clamp(w, min=eps))
    return scale * v


# ---------------------------------------------------------------------------
# SE(3) as quat+trans 7-vectors [qw qx qy qz tx ty tz] (se3q.py's layout).


def se3q_identity(shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    v = torch.zeros(*shape, 7, dtype=dtype, device=device)
    v[..., 0] = 1.0
    return v


def se3q_from_matrix(T: torch.Tensor) -> torch.Tensor:
    return torch.cat([R_to_quat(T[..., :3, :3]), T[..., :3, 3]], dim=-1)


def se3q_to_matrix(v: torch.Tensor) -> torch.Tensor:
    R = quat_to_R(quat_normalize(v[..., :4]))
    top = torch.cat([R, v[..., 4:, None]], dim=-1)
    bottom = torch.zeros(*v.shape[:-1], 1, 4, dtype=v.dtype, device=v.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3q_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    q = quat_mul(a[..., :4], b[..., :4])
    t = quat_rotate(a[..., :4], b[..., 4:]) + a[..., 4:]
    return torch.cat([quat_normalize(q), t], dim=-1)


def se3q_inv(v: torch.Tensor) -> torch.Tensor:
    qi = quat_conj(quat_normalize(v[..., :4]))
    return torch.cat([qi, -quat_rotate(qi, v[..., 4:])], dim=-1)


def se3q_transform(v: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply quat+trans poses (..., 7) to points (..., n, 3)."""
    return quat_rotate(v[..., None, :4], pts) + v[..., None, 4:]


def se3q_exp(wu: torch.Tensor) -> torch.Tensor:
    """se(3) tangent (..., 6) [ω‖u] -> quat+trans (as se3_exp)."""
    return se3q_from_matrix(se3_exp(wu))


def se3q_log(v: torch.Tensor) -> torch.Tensor:
    return se3_log(se3q_to_matrix(v))


# ---------------------------------------------------------------------------
# Retractions and analytic Jacobians (liegroupbase.py boxplus_*, se3.py:183-233).


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """J_l(ω) = I + B(θ)[ω]× + C(θ)[ω]×², the series se3_exp's V shares."""
    theta_sq = (w * w).sum(dim=-1)[..., None, None]
    W = skew(w)
    return _eye(3, w) + _taylor_B_sq(theta_sq) * W + _taylor_C_sq(theta_sq) * (W @ W)


def so3_right_jacobian(w: torch.Tensor) -> torch.Tensor:
    return so3_left_jacobian(w).transpose(-1, -2)


def boxplus_left(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """exp(δ) · T for (..., 4, 4) poses, δ (..., 6) (liegroupbase.py:51)."""
    return se3_exp(delta) @ T


def boxplus_right(T: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """T · exp(δ) (liegroupbase.py:58)."""
    return T @ se3_exp(delta)


def se3_adjoint(T: torch.Tensor) -> torch.Tensor:
    """Ad_T (6x6), mapping a right tangent to a left one: [R 0; [t]×R R]."""
    R, t = T[..., :3, :3], T[..., :3, 3]
    top = torch.cat([R, torch.zeros_like(R)], dim=-1)
    bot = torch.cat([skew(t) @ R, R], dim=-1)
    return torch.cat([top, bot], dim=-2)


def jacob_expeD_de(D: torch.Tensor) -> torch.Tensor:
    """d vec(exp(ε)·D) / dε at ε = 0: (..., 12, 6), row-major over D's top
    3x4 block (reference se3.py:183-209). Column j of [R | t] moves by
    -[col_j]× with ω; the translation column by I with u."""
    batch = D.shape[:-2]
    cols = D[..., :3, :4].transpose(-1, -2)                       # (..., 4, 3)
    J = D.new_zeros(*batch, 3, 4, 6)
    J[..., :, :, :3] = (-skew(cols)).transpose(-3, -2)
    J[..., :, 3, 3:] = _eye(3, D)
    return J.reshape(*batch, 12, 6)


def jacob_Dexpe_de(D: torch.Tensor) -> torch.Tensor:
    """d vec(D·exp(ε)) / dε at ε = 0: (..., 12, 6) (se3.py:211-232). Rotation
    column j moves by R·(-[e_j]×) with ω; the translation column by R with u."""
    R = D[..., :3, :3]
    batch = D.shape[:-2]
    J = D.new_zeros(*batch, 3, 4, 6)
    eye3 = _eye(3, D)
    for j in range(3):
        J[..., :, j, :3] = R @ (-skew(eye3[j]))
    J[..., :, 3, 3:] = R
    return J.reshape(*batch, 12, 6)
