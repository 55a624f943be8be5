"""Epipolar encoder: context images -> per-pixel 3D Gaussians (reference
encoder/encoder_epipolar.py).

Pipeline: backbone -> projection -> epipolar transformer -> high-res skip
conv -> monocular depth PDF -> to_gaussians linear -> GaussianAdapter.
Besides the whole image it supports, as the JAX package does:
  * `just_return_features`: the projected backbone features only;
  * `features=`: precomputed backbone features in place of the backbone;
  * `crop=(clip_h, clip_w, crop_size)`: encode one tile of a
    crop_size x crop_size grid only (reference encoder_epipolar.py:127-157),
    for the deferred back-propagation of the per-scene finetune.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..config import EncoderCfg
from ..constants import device_constant
from ..geometry.projection import sample_image_grid
from .backbone import BackboneResnet
from .depth_predictor import DepthPredictorMonocular
from .epipolar_sampler import generate_image_rays
from .epipolar_transformer import EpipolarTransformer
from .gaussian_adapter import GaussianAdapter, Gaussians


def map_pdf_to_opacity(pdf: torch.Tensor, cfg: EncoderCfg, global_step) -> torch.Tensor:
    """Warm-up opacity mapping (reference encoder_epipolar.py:97-110)."""
    o = cfg.opacity_mapping
    x = o.initial + min(global_step / max(o.warm_up, 1), 1.0) * (o.final - o.initial)
    exponent = 2.0**x
    return 0.5 * (1.0 - (1.0 - pdf) ** exponent + pdf ** (1.0 / exponent))


class EncoderEpipolar(nn.Module):
    def __init__(self, cfg: EncoderCfg):
        super().__init__()
        self.cfg = cfg
        bb = cfg.backbone
        self.backbone = BackboneResnet(bb.model, bb.num_layers, bb.d_out)
        self.backbone_projection = nn.Sequential(nn.ReLU(), nn.Linear(bb.d_out, cfg.d_feature))
        if cfg.use_epipolar_transformer:
            self.epipolar_transformer = EpipolarTransformer(cfg.epipolar_transformer, cfg.d_feature)
        self.high_resolution_skip = nn.Sequential(
            nn.Conv2d(3, cfg.d_feature, 7, padding=3), nn.ReLU()
        )
        self.depth_predictor = DepthPredictorMonocular(
            cfg.d_feature, cfg.num_monocular_samples, cfg.num_surfaces, cfg.use_transmittance
        )
        self.gaussian_adapter = GaussianAdapter(cfg.gaussian_adapter)
        self.to_gaussians = nn.Sequential(
            nn.ReLU(), nn.Linear(cfg.d_feature, cfg.num_surfaces * (2 + self.gaussian_adapter.d_in))
        )
        if cfg.predict_opacity:
            self.to_opacity = nn.Sequential(nn.ReLU(), nn.Linear(cfg.d_feature, 1))

    def forward(
        self,
        context: dict,
        global_step,
        deterministic: bool = False,
        uniforms: Optional[torch.Tensor] = None,
        features: Optional[torch.Tensor] = None,
        crop: Optional[tuple[int, int, int]] = None,
        just_return_features: bool = False,
    ):
        """context: image (b, v, 3, h, w), extrinsics (b, v, 4, 4),
        intrinsics (b, v, 3, 3), near/far (b, v). `features` (b, v, h, w,
        d_feature) replace the backbone's. With `crop` = (clip_h, clip_w,
        crop_size) only the tile of rows [clip_h·hc, +hc) and columns
        [clip_w·wc, +wc) is encoded, hc = h // crop_size and
        wc = w // crop_size, from the whole images and features. `uniforms`
        (b, v, r, srf, gaussians_per_pixel), r = hc·wc, are the
        depth-sampling draws when not deterministic. Returns the backbone
        features if `just_return_features`, else Gaussians with leading
        shape (b, v*r*srf*gpp)."""
        cfg = self.cfg
        images = context["image"]
        b, v, _, h, w = images.shape

        if features is None:
            feats = self.backbone_projection(self.backbone(images.permute(0, 1, 3, 4, 2)))
        else:
            feats = features
        if just_return_features:
            return feats

        if crop is not None:
            clip_h, clip_w, crop_size = crop
            hc, wc = h // crop_size, w // crop_size
            y0, x0 = clip_h * hc, clip_w * wc
        else:
            hc, wc, y0, x0 = h, w, 0, 0

        if cfg.use_epipolar_transformer:
            rays = token_slice = None
            if crop is not None:
                # The tile's query rays at the downscaled resolution, cut
                # out of the whole grid's.
                ds = cfg.epipolar_transformer.downscale
                full = generate_image_rays((h // ds, w // ds), context["extrinsics"],
                                           context["intrinsics"])

                def crop_rays(t):
                    t = t.reshape(b, v, h // ds, w // ds, t.shape[-1])
                    t = t[:, :, y0 // ds:y0 // ds + hc // ds, x0 // ds:x0 // ds + wc // ds]
                    return t.reshape(b, v, -1, t.shape[-1])

                rays = tuple(crop_rays(t) for t in full)
                token_slice = (y0 // ds, x0 // ds, hc // ds, wc // ds)
            feats, _ = self.epipolar_transformer(
                feats, context["extrinsics"], context["intrinsics"],
                context["near"], context["far"], rays=rays, token_slice=token_slice,
            )

        # The high-resolution skip convolves the tile of the image alone, so
        # its zero padding falls at the tile's border, as in the JAX package.
        skip_in = images[:, :, :, y0:y0 + hc, x0:x0 + wc].reshape(b * v, 3, hc, wc)
        skip = self.high_resolution_skip(skip_in)
        feats = feats + skip.permute(0, 2, 3, 1).reshape(b, v, hc, wc, cfg.d_feature)
        feats = feats.reshape(b, v, hc * wc, cfg.d_feature)

        gpp = 1 if deterministic else cfg.gaussians_per_pixel
        depths, densities = self.depth_predictor(
            feats, context["near"], context["far"], deterministic, gpp, uniforms=uniforms
        )

        raw = self.to_gaussians(feats)
        raw = raw.reshape(b, v, hc * wc, cfg.num_surfaces, 2 + self.gaussian_adapter.d_in)

        # The tile's pixel centres in the whole image; the pixel size and
        # the adapter's image shape stay the whole image's.
        xy_ray, _ = sample_image_grid((h, w), device=images.device)
        xy_ray = xy_ray[y0:y0 + hc, x0:x0 + wc].reshape(-1, 2)
        offset_xy = torch.sigmoid(raw[..., :2])
        pixel_size = device_constant((1.0 / w, 1.0 / h), torch.float32, images.device)
        xy_ray = xy_ray[None, None, :, None, :] + (offset_xy - 0.5) * pixel_size

        gaussians = self.gaussian_adapter(
            context["extrinsics"][:, :, None, None, None],
            context["intrinsics"][:, :, None, None, None],
            xy_ray[..., None, :],                          # (b, v, r, srf, 1, 2)
            depths,
            map_pdf_to_opacity(densities, cfg, global_step) / cfg.gaussians_per_pixel,
            raw[..., None, 2:],
            (h, w),
        )

        opacities = gaussians.opacities
        if cfg.predict_opacity:
            opacities = opacities * torch.sigmoid(self.to_opacity(feats))[..., None, :]

        def flatten(t, trailing):
            return t.reshape(b, -1, *trailing)

        return Gaussians(
            means=flatten(gaussians.means, (3,)),
            covariances=flatten(gaussians.covariances, (3, 3)),
            harmonics=flatten(gaussians.harmonics, gaussians.harmonics.shape[-2:]),
            opacities=opacities.reshape(b, -1),
            scales=flatten(gaussians.scales, (3,)),
            rotations=flatten(gaussians.rotations, (4,)),
        )
