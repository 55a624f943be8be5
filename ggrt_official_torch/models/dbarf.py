"""DBARF model: IBRNet with a pose learner, the legacy volume-rendering path
(the JAX package's models/dbarf.py; the reference's model/dbarf.py and
model/ibrnet.py:139-193): coarse(+fine) IBRNet nets, the ResUNet feature
extractor, and IPO-Net behind `correct_poses`. eval_dbarf renders with it.

Both models are built with flax's default initialisers drawn from a
`torch.Generator` (seed 0 when None), on `device`. On a card, building one
turns TF32 off in cuDNN and cuBLAS, process-wide, as PixelSplat does: the
reference computes in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import GGRtConfig
from ..weights import init_flax_defaults
from .feature_unet import ResUNet
from .ibrnet import IBRNet
from .iponet import IPONet, IPONetOutput


class IBRNetModel(nn.Module):
    """Coarse(+fine) IBRNet and the feature net as one module."""

    def __init__(self, cfg: GGRtConfig, coarse_feat_dim: int = 64, fine_feat_dim: int = 32,
                 coarse_only: bool = True, n_samples: int = 64, n_importance: int = 0,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg, self.coarse_only = cfg, coarse_only
        self.net_coarse = IBRNet(in_feat_ch=coarse_feat_dim, n_samples=n_samples)
        if not coarse_only:
            self.net_fine = IBRNet(in_feat_ch=fine_feat_dim, n_samples=n_samples + n_importance)
        self.feature_net = ResUNet(coarse_out_ch=coarse_feat_dim, fine_out_ch=fine_feat_dim,
                                   coarse_only=coarse_only)
        init_flax_defaults(self, generator or torch.Generator().manual_seed(0))
        if torch.device(device).type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.to(device)

    def extract_features(self, src_rgbs):
        """(v, h, w, 3) -> (coarse (v, h/2, w/2, d), fine or None)."""
        return self.feature_net(src_rgbs)

    def coarse(self, rgb_feat, ray_diff, mask):
        return self.net_coarse(rgb_feat, ray_diff, mask)

    def fine(self, rgb_feat, ray_diff, mask):
        if self.coarse_only:
            raise ValueError("a coarse_only IBRNetModel has no fine net")
        return self.net_fine(rgb_feat, ray_diff, mask)


class DBARFModel(nn.Module):
    """IBRNetModel and the pose learner (the reference's dbarf.py:11-112)."""

    def __init__(self, cfg: GGRtConfig, coarse_only: bool = True, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        generator = generator or torch.Generator().manual_seed(0)
        self.ibrnet = IBRNetModel(cfg, coarse_feat_dim=64, fine_feat_dim=32, coarse_only=coarse_only,
                                  device=device, generator=generator)
        self.pose_learner = IPONet(cfg.iponet)
        init_flax_defaults(self.pose_learner, generator)
        self.pose_learner.to(device)

    def correct_poses(self, target_image, ref_imgs, target_intrinsics, ref_intrinsics,
                      min_depth=0.1, max_depth=100.0) -> IPONetOutput:
        """Inverse depths and relative poses (the reference's dbarf.py:31-63):
        target_image (1, 3, h, w), ref_imgs (nv, 3, h, w), pixel intrinsics
        (1, 3, 3) and (nv, 3, 3)."""
        return self.pose_learner(target_image, ref_imgs, target_intrinsics, ref_intrinsics,
                                 min_depth=min_depth, max_depth=max_depth)

    def extract_features(self, src_rgbs):
        return self.ibrnet.extract_features(src_rgbs)

    def coarse(self, rgb_feat, ray_diff, mask):
        return self.ibrnet.coarse(rgb_feat, ray_diff, mask)
