"""Gaussian -> screen projection (EWA splatting preprocess) on torch tensors.

Perspective projection of the 3D means, EWA projection of the 3D
covariances (J W Σ Wᵀ Jᵀ + 0.3·I low-pass), conic and binning extents, and
SH->RGB along the view directions — the preprocess stage of the CUDA 3DGS
rasterizer, with the JAX package's clamps and tight binning extents.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...constants import device_constant
from ...geometry.projection import get_fov, invert_se3
from .. import sh as sh_ops

# Constants mirroring the CUDA kernel's behavior.
NEAR_CLIP = 0.2          # view-space z cull threshold
LOWPASS = 0.3            # screen-space covariance dilation
ALPHA_MIN = 1.0 / 255.0  # minimum contribution
ALPHA_MAX = 0.99         # alpha clamp
T_EPS = 1e-4             # transmittance early-out


class ProjectedGaussians(NamedTuple):
    """Per-Gaussian screen-space quantities for one camera."""

    mean2d: torch.Tensor   # (g, 2) pixel coordinates
    conic: torch.Tensor    # (g, 3) inverse 2D covariance (a, b, c) for [[a,b],[b,c]]
    depth: torch.Tensor    # (g,) view-space z
    radius: torch.Tensor   # (g,) screen-space radius in pixels (float)
    extent: torch.Tensor   # (g, 2) tight per-axis AABB half-widths (pixels)
    color: torch.Tensor    # (g, 3) RGB from SH evaluation
    opacity: torch.Tensor  # (g,)
    valid: torch.Tensor    # (g,) bool — in front of camera & invertible cov


def get_projection_matrix(
    near: torch.Tensor, far: torch.Tensor, intrinsics: torch.Tensor
) -> torch.Tensor:
    """Frustum -> NDC matrix honoring the principal point: x/y map to
    (-1, 1), z to (0, 1), focal terms scaled by `near`."""
    fx = intrinsics[..., 0, 0]
    fy = intrinsics[..., 1, 1]
    cx = intrinsics[..., 0, 2]
    cy = intrinsics[..., 1, 2]
    zeros = torch.zeros_like(near)
    ones = torch.ones_like(near)
    row0 = torch.stack([2.0 * near * fx, zeros, 2.0 * cx - 1.0, zeros], dim=-1)
    row1 = torch.stack([zeros, 2.0 * near * fy, 2.0 * cy - 1.0, zeros], dim=-1)
    row2 = torch.stack([zeros, zeros, far / (far - near), -(far * near) / (far - near)], dim=-1)
    row3 = torch.stack([zeros, zeros, ones, zeros], dim=-1)
    return torch.stack([row0, row1, row2, row3], dim=-2)


def ndc_to_pixel(ndc: torch.Tensor, size: torch.Tensor) -> torch.Tensor:
    """((v + 1) * S - 1) / 2, the CUDA ndc2Pix convention."""
    return ((ndc + 1.0) * size - 1.0) * 0.5


def project_gaussians(
    means: torch.Tensor,
    covariances: torch.Tensor,
    sh_coeffs: torch.Tensor,
    opacities: torch.Tensor,
    extrinsics: torch.Tensor,
    intrinsics: torch.Tensor,
    near: torch.Tensor,
    far: torch.Tensor,
    image_shape: tuple[int, int],
) -> ProjectedGaussians:
    """Project one camera's view of the Gaussians to screen space.

    means (g, 3), covariances (g, 3, 3), sh_coeffs (g, 3, d_sh),
    opacities (g,), extrinsics (4, 4) c2w, intrinsics (3, 3) normalized,
    near/far 0-d tensors, image_shape (h, w).
    """
    h, w = image_shape
    view = invert_se3(extrinsics)  # world -> camera
    proj = get_projection_matrix(near, far, intrinsics)
    full_proj = proj @ view

    means_h = torch.cat([means, torch.ones_like(means[..., :1])], dim=-1)
    p_view = (means_h @ view.T)[..., :3]
    tz = p_view[..., 2]
    # Culled Gaussians (tz <= NEAR_CLIP) are never binned, so their screen
    # quantities reach no pixel. They take a stand-in depth of 1 below: at
    # tz = 0 the formulas give inf and NaN, and a zero cotangent times an
    # infinite derivative would make the whole gradient NaN.
    in_front = tz > NEAR_CLIP
    tz_safe = torch.where(in_front, tz, torch.ones_like(tz))
    p_hom = means_h @ full_proj.T
    p_w = 1.0 / (torch.where(in_front, p_hom[..., 3], torch.ones_like(tz)) + 1e-7)
    p_ndc = p_hom[..., :3] * p_w[..., None]

    size = device_constant((float(w), float(h)), means.dtype, means.device)
    mean2d = torch.clamp(ndc_to_pixel(p_ndc[..., :2], size), -1e6, 1e6)

    # EWA: cov2d = J W Σ Wᵀ Jᵀ with the CUDA kernel's frustum clamping.
    fov = get_fov(intrinsics[None])[0]
    tan_fovx = torch.tan(0.5 * fov[0])
    tan_fovy = torch.tan(0.5 * fov[1])
    focal_x = w / (2.0 * tan_fovx)
    focal_y = h / (2.0 * tan_fovy)

    limx = 1.3 * tan_fovx
    limy = 1.3 * tan_fovy
    txtz = torch.minimum(torch.maximum(p_view[..., 0] / tz_safe, -limx), limx)
    tytz = torch.minimum(torch.maximum(p_view[..., 1] / tz_safe, -limy), limy)
    tx = txtz * tz_safe
    ty = tytz * tz_safe

    # Rows of M = J @ W: m0 = j0*W[0] + j2x*W[2]; m1 = j1*W[1] + j2y*W[2].
    W3 = view[:3, :3]
    j0 = focal_x / tz_safe
    j2x = -(focal_x * tx) / (tz_safe * tz_safe)
    j1 = focal_y / tz_safe
    j2y = -(focal_y * ty) / (tz_safe * tz_safe)
    m0 = j0[:, None] * W3[0][None, :] + j2x[:, None] * W3[2][None, :]  # (g, 3)
    m1 = j1[:, None] * W3[1][None, :] + j2y[:, None] * W3[2][None, :]
    u0 = (covariances * m0[:, None, :]).sum(dim=-1)  # (g, 3)
    u1 = (covariances * m1[:, None, :]).sum(dim=-1)
    a = (m0 * u0).sum(dim=-1) + LOWPASS
    b = (m0 * u1).sum(dim=-1)
    c = (m1 * u1).sum(dim=-1) + LOWPASS

    # Degenerate-pose guard: keep a*c finite in f32 so det never becomes
    # inf - inf; real scenes sit many orders below the bound.
    a = torch.clamp(a, -1e15, 1e15)
    b = torch.clamp(b, -1e15, 1e15)
    c = torch.clamp(c, -1e15, 1e15)

    det = a * c - b * b
    det_valid = det > 0.0
    det_safe = torch.where(det_valid, det, torch.ones_like(det))
    conic = torch.clamp(
        torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1), -1e15, 1e15
    )

    # Radius and extents are binning metadata (integer pixels), not
    # differentiable quantities.
    with torch.no_grad():
        mid = 0.5 * (a + c)
        lambda1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
        radius = torch.ceil(3.0 * torch.sqrt(torch.clamp(lambda1, min=1e-8)))
        # Tight, lossless per-axis extents: the exact AABB of the ellipse
        # outside which op·exp(-q/2) < 1/255, i.e. q ≤ 2·ln(255·opacity).
        q_max = torch.clamp(
            2.0 * torch.log(torch.clamp(opacities, min=1e-12) * (1.0 / ALPHA_MIN)), min=0.0
        )
        extent = torch.ceil(
            torch.sqrt(q_max[:, None] * torch.clamp(torch.stack([a, c], dim=-1), min=0.0))
        )

    # SH -> RGB along the (world) view direction from the camera center.
    campos = extrinsics[:3, 3]
    dirs = means - campos
    dirs = dirs * torch.rsqrt((dirs * dirs).sum(dim=-1, keepdim=True) + 1e-12)
    color = sh_ops.eval_sh(sh_coeffs, dirs)

    valid = det_valid & in_front
    radius = torch.where(valid, radius, torch.zeros_like(radius))
    extent = torch.where(valid[:, None], extent, torch.zeros_like(extent))

    return ProjectedGaussians(
        mean2d=mean2d,
        conic=conic,
        depth=tz,
        radius=radius,
        extent=extent,
        color=color,
        opacity=opacities,
        valid=valid,
    )
