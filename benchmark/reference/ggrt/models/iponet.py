"""IPO-Net: iterative pose and depth optimizer (the reference's
depth_pose_network.py, DepthPoseNet).

RAFT-style recurrence: a shared ResNet feature net over [target; refs], init
heads for inverse depth and per-view 6-DoF relative poses, then
`iters // seq_len` outer iterations of `seq_len` ConvGRU steps each, driven
by feature-warp costs. As in the JAX package the views ride on the batch
axis, so each head, GRU and warp runs once for all views, and the outer
iterations are cut apart by `.detach()`, the reference's own detach.

NCHW inside; the public layouts are the JAX package's: inv_depths
(n_preds, 1, 1, h, w), rel_poses (1, n_views, n_preds, 6), fmap
(1, hf, wf, c).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..config import IPONetCfg
from ..geometry import camera as cam
from ..geometry.depth import disp_to_depth, inv2depth
from ..geometry.se3 import pose_from_vec
from ..ops.grid_sample import grid_sample
from .backbone import ResNetEncoder, resize_bilinear_align_corners
from .heads import BasicUpdateBlockDepth, BasicUpdateBlockPose, DepthHead, PoseHead, UpMaskNet


class IPONetOutput(NamedTuple):
    inv_depths: torch.Tensor   # (n_preds, 1, 1, h, w) full-resolution inverse depths
    rel_poses: torch.Tensor    # (1, n_views, n_preds, 6)
    fmap: torch.Tensor         # (1, hf, wf, c) target feature map


def upsample_depth_convex(depth: torch.Tensor, mask: torch.Tensor, ratio: int,
                          image_size: tuple[int, int]) -> torch.Tensor:
    """Convex upsampling of a stride-`ratio` depth map (ref :50-66).

    depth (b, 1, hf, wf); mask (b, 9·ratio², hf, wf), channel k·ratio² + r
    for neighbour k and sub-pixel r. Returns (b, 1, H, W), resized
    (align_corners=True) to image_size where that differs.
    """
    b, _, hf, wf = depth.shape
    mask = torch.softmax(mask.reshape(b, 9, ratio * ratio, hf, wf), dim=1)
    neighborhoods = F.unfold(depth, 3, padding=1).reshape(b, 9, 1, hf, wf)
    up = (neighborhoods * mask).sum(dim=1)                 # (b, ratio², hf, wf)
    up = F.pixel_shuffle(up, ratio)                        # (b, 1, hf·r, wf·r)
    if tuple(up.shape[2:]) != tuple(image_size):
        up = resize_bilinear_align_corners(up, tuple(image_size))
    return up


def warp_cost(pose_vecs, fmap, fmaps_ref, depth, K, ref_Ks, scale_factor):
    """Feature-warp cost, views on the batch axis (ref get_cost_each :68-89).

    pose_vecs (nv, 6) target->ref; fmap (1, c, hf, wf); fmaps_ref
    (nv, c, hf, wf); depth (1, 1, hf, wf); K (1, 3, 3) and ref_Ks (nv, 3, 3)
    pixel intrinsics at full image scale. Returns (nv, c, hf, wf).
    """
    nv = pose_vecs.shape[0]
    pose = pose_from_vec(pose_vecs)
    Ks = cam.scale_intrinsics(K.expand(nv, 3, 3), scale_factor, scale_factor)
    ref_Ks = cam.scale_intrinsics(ref_Ks, scale_factor, scale_factor)
    world = cam.reconstruct(depth.expand(nv, *depth.shape[1:]), Ks)
    coords = cam.project(world, ref_Ks, Twc=pose, normalize=True)
    warped = grid_sample(fmaps_ref, coords, align_corners=True)
    return (fmap - warped) ** 2


class IPONet(nn.Module):
    def __init__(self, cfg: IPONetCfg):
        super().__init__()
        self.cfg = cfg
        fd, hd, cd, ratio = cfg.foutput_dim, cfg.hidden_dim, cfg.context_dim, cfg.feat_ratio
        self.fnet = ResNetEncoder(3, fd, ratio)
        self.pose_head = PoseHead(2 * fd, fd)
        self.depth_head = DepthHead(fd, fd)
        self.upmask_net = UpMaskNet(fd, fd, ratio)
        self.cnet_depth = ResNetEncoder(3, hd + cd, ratio)
        self.cnet_pose = ResNetEncoder(6, hd + cd, ratio)
        self.update_block_depth = BasicUpdateBlockDepth(fd, hd, ratio, cd)
        self.update_block_pose = BasicUpdateBlockPose(fd, hd, cd)

    def forward(self, target_image, ref_imgs, target_intrinsics, ref_intrinsics,
                min_depth=0.1, max_depth=100.0) -> IPONetOutput:
        """target_image (1, 3, h, w); ref_imgs (nv, 3, h, w); intrinsics
        (1, 3, 3) and (nv, 3, 3) in pixels."""
        cfg = self.cfg
        nv = ref_imgs.shape[0]
        h, w = target_image.shape[-2:]
        ratio = cfg.feat_ratio
        hd = cfg.hidden_dim
        sf = 1.0 / ratio

        def scale_inv_depth(d):
            return disp_to_depth(d, min_depth, max_depth)[0]

        fmaps = self.fnet(torch.cat([target_image, ref_imgs], dim=0))
        fmap1, fmaps_ref = fmaps[:1], fmaps[1:]

        fmap1_nv = fmap1.expand(nv, *fmap1.shape[1:])
        poses = self.pose_head(torch.cat([fmap1_nv, fmaps_ref], dim=1))     # (nv, 6)
        inv_depth = self.depth_head(fmap1, act=torch.sigmoid)               # (1, 1, hf, wf)
        inv_depth_up0 = upsample_depth_convex(inv_depth, self.upmask_net(fmap1), ratio, (h, w))

        cnet_depth = self.cnet_depth(target_image)
        hidden_d = torch.tanh(cnet_depth[:, :hd])
        inp_d = F.relu(cnet_depth[:, hd:])
        pairs = torch.cat([target_image.expand(nv, *target_image.shape[1:]), ref_imgs], dim=1)
        cnet_pose = self.cnet_pose(pairs)
        hidden_p = torch.tanh(cnet_pose[:, :hd])
        inp_p = F.relu(cnet_pose[:, hd:])

        K, ref_K = target_intrinsics, ref_intrinsics
        inv_depth_preds = [scale_inv_depth(inv_depth_up0)]
        pose_preds = [poses]
        for _ in range(cfg.iters // cfg.seq_len):
            inv_depth = inv_depth.detach()
            poses = poses.detach()
            # The pose update uses the depth from the *start* of the outer
            # iteration (the reference's partial() captures it eagerly,
            # depth_pose_network.py:176-178).
            depth_fixed = inv2depth(scale_inv_depth(inv_depth))

            net_d, up_mask = hidden_d, None
            for _ in range(cfg.seq_len):
                depth_now = inv2depth(scale_inv_depth(inv_depth))
                cost = warp_cost(poses, fmap1, fmaps_ref, depth_now, K, ref_K, sf).mean(dim=0, keepdim=True)
                net_d, inv_depth, up_mask = self.update_block_depth(net_d, inv_depth, cost, inp_d)
            hidden_d = net_d
            inv_depth_up = upsample_depth_convex(inv_depth, up_mask, ratio, (h, w))
            inv_depth_preds.append(scale_inv_depth(inv_depth_up))

            net_p = hidden_p
            for _ in range(cfg.seq_len):
                cost = warp_cost(poses, fmap1, fmaps_ref, depth_fixed, K, ref_K, sf)
                net_p, poses = self.update_block_pose(net_p, poses, cost, inp_p)
            hidden_p = net_p
            pose_preds.append(poses)

        return IPONetOutput(
            inv_depths=torch.stack(inv_depth_preds, dim=0),           # (n_preds, 1, 1, h, w)
            rel_poses=torch.stack(pose_preds, dim=1)[None],           # (1, nv, n_preds, 6)
            fmap=fmap1.permute(0, 2, 3, 1),
        )
