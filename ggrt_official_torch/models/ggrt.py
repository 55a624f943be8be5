"""Composite GGRt model: IPO-Net + PixelSplat, and the joint loss (the
reference's dgaussian.py, DGaussianModel).

The reference's pose_only / nerf_only / joint state machine toggles
requires_grad; here, as in the JAX package, the trainer gates each
optimizer's gradients instead (training/state.py).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import GGRtConfig
from ..losses.photometric import photometric_decay_loss
from ..weights import init_flax_defaults
from .iponet import IPONet, IPONetOutput
from .pixelsplat import PixelSplat


def unpack_camera(camera: torch.Tensor):
    """34-vector camera -> (hw, intrinsics 4x4, c2w 4x4) (ref dgaussian.py:70-71)."""
    lead = camera.shape[:-1]
    return camera[..., :2], camera[..., 2:18].reshape(*lead, 4, 4), camera[..., 18:34].reshape(*lead, 4, 4)


def compose_joint_loss(sfm_loss, nerf_loss, step, coefficient: float = 1e-5):
    """alpha·sfm + (1 - alpha)·nerf with alpha = 2^(-c·step) (ref :113-121).
    At the reference's coefficient the Gaussian term carries almost no
    weight for thousands of steps; at step 0 exactly none."""
    alpha = 2.0 ** (-coefficient * float(step))
    return alpha * sfm_loss + (1.0 - alpha) * nerf_loss


class GGRtModel(nn.Module):
    """The pose learner and the Gaussian model as submodules, keyed
    'pose_learner' and 'gaussian' as in the reference checkpoints."""

    def __init__(self, cfg: GGRtConfig, device="cuda", generator: Optional[torch.Generator] = None):
        """Builds both parts with flax's default initialisers drawn from
        `generator` (seed 0 when None) on `device`."""
        super().__init__()
        self.cfg = cfg
        generator = generator or torch.Generator().manual_seed(0)
        self.pose_learner = IPONet(cfg.iponet)
        init_flax_defaults(self.pose_learner, generator)
        self.pose_learner.to(device)
        self.gaussian = PixelSplat(cfg.encoder, cfg.decoder, device=device, generator=generator)

    def iponet(self, target_image, ref_imgs, target_camera, ref_cameras, min_depth, max_depth):
        """Run IPO-Net and the photometric SfM loss.

        target_image (1, h, w, 3) and ref_imgs (1, nv, h, w, 3), the loader's
        layout; cameras (1, 34) and (1, nv, 34). Returns (inv_depths,
        rel_poses (nv, n_preds, 6), sfm, fmap), as dgaussian.py:55-87.
        """
        target_K = unpack_camera(target_camera)[1][..., :3, :3]
        ref_K = unpack_camera(ref_cameras[0])[1][..., :3, :3]
        tgt = target_image.permute(0, 3, 1, 2)
        refs = ref_imgs[0].permute(0, 3, 1, 2)
        out: IPONetOutput = self.pose_learner(tgt, refs, target_K, ref_K,
                                              min_depth=min_depth, max_depth=max_depth)
        sfm = photometric_decay_loss(
            tgt, refs, out.inv_depths, target_K, ref_K, out.rel_poses,
            valid_mask=self.cfg.train.sfm_valid_mask, oob_weight=self.cfg.train.sfm_oob_weight,
        )
        return out.inv_depths, out.rel_poses[0], sfm, out.fmap

    def pose_teacher_render(self, batch, cams_c2w, global_step):
        """Render the context views at the given cameras (b, v, 4, 4) from a
        frozen teacher field, the Gaussians encoded at the dataset's context
        poses: gradients reach the cameras only. Returns (b, v, 3, h, w)."""
        ctx = batch["context"]
        with torch.no_grad():
            g = self.gaussian.encode_pairs(ctx, global_step, deterministic=True)
        h, w = ctx["image"].shape[-2:]
        return self.gaussian.decoder(g, cams_c2w, ctx["intrinsics"], ctx["near"], ctx["far"],
                                     (h, w), depth_mode=None).color
