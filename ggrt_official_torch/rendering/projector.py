"""Projection of 3D ray samples into the source views (the JAX package's
rendering/projector.py; the reference's projection.py, Projector): project
the samples with the packed 34-vector cameras, gather rgb and deep features
bilinearly with align_corners=True, build the ray-angle features (direction
difference and dot product) and the validity masks.

The image size is read from the cameras as tensors and stays on their
device; the pose inverse is `inv_ex`, which reads no status back.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import relative_to_source_c2w
from ..ops.grid_sample import grid_sample


def _inbound(pix, h, w):
    return (pix[..., 0] <= w - 1.0) & (pix[..., 0] >= 0.0) & (pix[..., 1] <= h - 1.0) & (pix[..., 1] >= 0.0)


def compute_projections(xyz, train_intrinsics, train_poses):
    """xyz (n, 3); intrinsics and poses (v, 4, 4) -> pixel locations
    (v, n, 2), in-front mask (v, n)."""
    xyz_h = torch.cat([xyz, torch.ones_like(xyz[:, :1])], dim=-1)  # (n, 4)
    proj = torch.einsum("vij,vjk,nk->vni", train_intrinsics, torch.linalg.inv_ex(train_poses).inverse, xyz_h)
    pix = proj[..., :2] / torch.clamp(proj[..., 2:3], min=1e-8)
    pix = torch.clamp(pix, -1e6, 1e6)
    in_front = proj[..., 2] > 0
    return pix, in_front


def compute_angle(xyz, query_pose, train_poses):
    """Ray-angle features (v, n, 4) (the reference's projection.py:95-124)."""
    ray2tar = query_pose[:3, 3][None, None] - xyz[None]
    ray2tar = ray2tar / (torch.linalg.norm(ray2tar, dim=-1, keepdim=True) + 1e-6)
    ray2train = train_poses[:, None, :3, 3] - xyz[None]
    ray2train = ray2train / (torch.linalg.norm(ray2train, dim=-1, keepdim=True) + 1e-6)
    ray_diff = ray2tar - ray2train
    norm = torch.linalg.norm(ray_diff, dim=-1, keepdim=True)
    dot = torch.sum(ray2tar * ray2train, dim=-1, keepdim=True)
    direction = ray_diff / torch.clamp(norm, min=1e-6)
    return torch.cat([direction, dot], dim=-1)


def project_and_gather(pts, query_camera, src_rgbs, src_cameras, feat_maps, rel_poses=None):
    """pts (r, s, 3); query_camera (34,); src_rgbs (v, h, w, 3); src_cameras
    (v, 34); feat_maps (v, hf, wf, d); rel_poses (v, 6) predicted
    target->source or None. Returns (rgb_feat (r, s, v, 3+d), ray_diff
    (r, s, v, 4), mask (r, s, v, 1))."""
    r, s, _ = pts.shape
    xyz = pts.reshape(-1, 3)
    v = src_cameras.shape[0]
    h, w = src_cameras[0, 0], src_cameras[0, 1]
    train_intrinsics = src_cameras[:, 2:18].reshape(-1, 4, 4)
    train_poses = src_cameras[:, 18:34].reshape(-1, 4, 4)
    query_pose = query_camera[18:34].reshape(4, 4)

    if rel_poses is not None:
        train_poses = relative_to_source_c2w(query_pose.expand(v, 4, 4), rel_poses)

    pix, in_front = compute_projections(xyz, train_intrinsics, train_poses)
    resize = torch.stack([w - 1.0, h - 1.0])
    grid = 2.0 * pix / resize - 1.0  # (v, n, 2)

    rgb = grid_sample(src_rgbs.permute(0, 3, 1, 2), grid[:, :, None, :], align_corners=True)[..., 0]
    feat = grid_sample(feat_maps.permute(0, 3, 1, 2), grid[:, :, None, :], align_corners=True)[..., 0]
    rgb_feat = torch.cat([rgb, feat], dim=1).transpose(1, 2)  # (v, n, 3+d)

    ray_diff = compute_angle(xyz, query_pose, train_poses)
    mask = (_inbound(pix, h, w) & in_front).to(rgb_feat.dtype)

    def to_rsv(t):
        return t.transpose(0, 1).reshape(r, s, v, -1)

    return to_rsv(rgb_feat), to_rsv(ray_diff), mask.T.reshape(r, s, v, 1)
