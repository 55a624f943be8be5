"""Real spherical harmonics up to degree 4: evaluation and rotation.

Basis convention: the standard 3DGS ordering — for each degree l the 2l+1
coefficients are ordered m = -l..l, with the degree-1 basis being
(-C1*y, C1*z, -C1*x), matching the CUDA 3DGS kernel's constants.
Rotation uses the Ivanic–Ruedenberg recurrence (J. Phys. Chem. 1996, with
the 1998 erratum), differentiable in the rotation matrix.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..constants import device_constant

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)
SH_C4 = (2.5033429417967046, -1.7701307697799304, 0.9461746957575601,
         -0.6690465435572892, 0.10578554691520431, -0.6690465435572892,
         0.47308734787878004, -1.7701307697799304, 0.6258357354491761)


def num_sh_coeffs(degree: int) -> int:
    return (degree + 1) ** 2


def eval_sh_basis(directions: torch.Tensor, degree: int) -> torch.Tensor:
    """Real SH basis along unit directions (..., 3) -> (..., (degree+1)^2)."""
    if degree > 4:
        raise ValueError(f"sh degree {degree} > 4 unsupported")
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        out += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [
            SH_C2[0] * xy,
            SH_C2[1] * yz,
            SH_C2[2] * (2.0 * zz - xx - yy),
            SH_C2[3] * xz,
            SH_C2[4] * (xx - yy),
        ]
    if degree >= 3:
        out += [
            SH_C3[0] * y * (3.0 * xx - yy),
            SH_C3[1] * xy * z,
            SH_C3[2] * y * (4.0 * zz - xx - yy),
            SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            SH_C3[4] * x * (4.0 * zz - xx - yy),
            SH_C3[5] * z * (xx - yy),
            SH_C3[6] * x * (xx - 3.0 * yy),
        ]
    if degree >= 4:
        out += [
            SH_C4[0] * xy * (xx - yy),
            SH_C4[1] * yz * (3.0 * xx - yy),
            SH_C4[2] * xy * (7.0 * zz - 1.0),
            SH_C4[3] * yz * (7.0 * zz - 3.0),
            SH_C4[4] * (zz * (35.0 * zz - 30.0) + 3.0),
            SH_C4[5] * xz * (7.0 * zz - 3.0),
            SH_C4[6] * (xx - yy) * (7.0 * zz - 1.0),
            SH_C4[7] * xz * (xx - 3.0 * yy),
            SH_C4[8] * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(out, dim=-1)


def eval_sh(coeffs: torch.Tensor, directions: torch.Tensor) -> torch.Tensor:
    """SH coefficients (..., c, d_sh) + unit directions (..., 3) -> colors
    (..., c), with the 3DGS +0.5 offset and clamp at zero."""
    d_sh = coeffs.shape[-1]
    degree = int(round(d_sh**0.5)) - 1
    basis = eval_sh_basis(directions, degree)
    color = (coeffs * basis[..., None, :]).sum(dim=-1) + 0.5
    return torch.clamp(color, min=0.0)


def _ivanic_uvw(l: int):
    """Static u, v, w coefficient tables for degree l (shape (2l+1, 2l+1))."""
    m = np.arange(-l, l + 1)
    m1, m2 = np.meshgrid(m, m, indexing="ij")  # m1 = row (target m), m2 = col
    delta = (m1 == 0).astype(np.float64)
    abs_m1 = np.abs(m1)
    denom = np.where(np.abs(m2) < l, (l + m2) * (l - m2), (2 * l) * (2 * l - 1))
    u = np.sqrt((l + m1) * (l - m1) / denom)
    v = 0.5 * np.sqrt(
        (1 + delta) * (l + abs_m1 - 1) * (l + abs_m1) / denom
    ) * (1 - 2 * delta)
    w = -0.5 * np.sqrt((l - abs_m1 - 1) * (l - abs_m1) / denom) * (1 - delta)
    return u, v, w


def _P(i: int, m1, m2, l: int, r1: torch.Tensor, r_prev: torch.Tensor) -> torch.Tensor:
    """Helper P_i^{m1,m2} of the recurrence (batched over rotations)."""
    def R1(a, b):
        return r1[..., a + 1, b + 1]

    def Rp(a, b):
        return r_prev[..., a + l - 1, b + l - 1]

    if m2 == l:
        return R1(i, 1) * Rp(m1, l - 1) - R1(i, -1) * Rp(m1, -(l - 1))
    if m2 == -l:
        return R1(i, 1) * Rp(m1, -(l - 1)) + R1(i, -1) * Rp(m1, l - 1)
    return R1(i, 0) * Rp(m1, m2)


def _sh_rotation_matrix_l(l: int, r1: torch.Tensor, r_prev: torch.Tensor) -> torch.Tensor:
    """Degree-l SH rotation (..., 2l+1, 2l+1) from degree 1 and degree l-1."""
    u_t, v_t, w_t = _ivanic_uvw(l)
    sqrt2 = math.sqrt(2.0)
    rows = []
    for m1 in range(-l, l + 1):
        cols = []
        for m2 in range(-l, l + 1):
            u, v, w = (float(t[m1 + l, m2 + l]) for t in (u_t, v_t, w_t))
            term = torch.zeros_like(r1[..., 0, 0])
            if u != 0.0 and abs(m1) <= l - 1:
                term = term + u * _P(0, m1, m2, l, r1, r_prev)
            if v != 0.0:
                if m1 == 0:
                    V = _P(1, 1, m2, l, r1, r_prev) + _P(-1, -1, m2, l, r1, r_prev)
                elif m1 == 1:
                    V = _P(1, 0, m2, l, r1, r_prev) * sqrt2
                elif m1 > 1:
                    V = _P(1, m1 - 1, m2, l, r1, r_prev) - _P(-1, -m1 + 1, m2, l, r1, r_prev)
                elif m1 == -1:
                    V = _P(-1, 0, m2, l, r1, r_prev) * sqrt2
                else:
                    V = _P(1, m1 + 1, m2, l, r1, r_prev) + _P(-1, -m1 - 1, m2, l, r1, r_prev)
                term = term + v * V
            if w != 0.0:
                if m1 > 0:
                    W = _P(1, m1 + 1, m2, l, r1, r_prev) + _P(-1, -m1 - 1, m2, l, r1, r_prev)
                else:  # m1 < 0 (w == 0 when m1 == 0)
                    W = _P(1, m1 - 1, m2, l, r1, r_prev) - _P(-1, -m1 + 1, m2, l, r1, r_prev)
                term = term + w * W
            cols.append(term)
        rows.append(torch.stack(cols, dim=-1))
    return torch.stack(rows, dim=-2)


def sh_rotation_matrices(R: torch.Tensor, degree: int) -> list[torch.Tensor]:
    """Per-degree rotation matrices [(..., 2l+1, 2l+1) for l in 0..degree],
    acting on 3DGS-ordered (signed-basis) coefficients."""
    mats = [torch.ones((*R.shape[:-2], 1, 1), dtype=R.dtype, device=R.device)]
    if degree == 0:
        return mats
    # Degree-1 rotation in basis order (y, z, x), conjugated by
    # S = diag(-1, 1, -1) for the signed 3DGS basis (-y, z, -x).
    idx = device_constant((1, 2, 0), torch.int64, R.device)
    r1 = R[..., idx[:, None], idx[None, :]]
    S = device_constant((-1.0, 1.0, -1.0), R.dtype, R.device)
    r1_signed = r1 * S[:, None] * S[None, :]
    mats.append(r1_signed)
    r_prev = r1_signed
    for l in range(2, degree + 1):
        r_prev = _sh_rotation_matrix_l(l, r1_signed, r_prev)
        mats.append(r_prev)
    return mats


def rotate_sh(coeffs: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """Rotate SH coefficient vectors (..., d_sh) by rotations R (..., 3, 3),
    so that f'(d) = f(R^T d). Leading dims broadcast."""
    d_sh = coeffs.shape[-1]
    degree = int(round(d_sh**0.5)) - 1
    mats = sh_rotation_matrices(R, degree)
    out = []
    for l, m in enumerate(mats):
        block = coeffs[..., l * l : (l + 1) * (l + 1)]
        out.append(torch.matmul(m, block[..., None])[..., 0])
    return torch.cat(out, dim=-1)
