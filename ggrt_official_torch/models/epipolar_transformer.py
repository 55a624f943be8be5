"""Epipolar transformer (reference encoder/epipolar/epipolar_transformer.py
and image_self_attention.py).

Each downscaled pixel token cross-attends to `num_samples` features sampled
along its epipolar segments in the other context views, with the samples'
triangulated depths positionally encoded into the keys/values. The
feed-forward is convolutional with a patch-token image self-attention.

flax's ConvTranspose does not flip its kernel and torch's does; the weight
loader (weights.py) flips it, so the layers here are plain torch layers.
Convs with kernel = stride = 4 pad nothing, as flax 'SAME' does when h and
w divide by 16 (the patch shim guarantees it); 7x7 convs pad 3. Those that
cuDNN runs on its generic NHWC engine at a request's shapes (the
refinement's two, the feed-forward's first) run through ops/conv7.py: on a
card a kernel with that engine's summation order and the GELU, bias and
residual fused. The feed-forward's second stays an nn.Conv2d: cuDNN runs it
at 80x112 as an FFT, faster than the kernel and with other bits. The modules keep their nn.Conv2d
parameters and state-dict keys.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..config import EpipolarTransformerCfg, ImageSelfAttentionCfg
from ..geometry.depth import depth_to_relative_disparity
from ..geometry.epipolar import get_depth
from ..ops.conv7 import GELU, RESIDUAL, conv7
from .epipolar_sampler import EpipolarSampling, collect_other_views, sample_epipolar
from .transformer import PositionalEncoding, Transformer


class ImageSelfAttention(nn.Module):
    """Patch-token self-attention over the image. NCHW in, NCHW out."""

    def __init__(self, cfg: ImageSelfAttentionCfg, d_in: int, d_out: int):
        super().__init__()
        p = cfg.patch_size
        self.patch_embedder = nn.Sequential(nn.Conv2d(d_in, cfg.d_token, p, stride=p), nn.ReLU())
        # The reference builds a positional encoding but never adds it to
        # the tokens (image_self_attention.py:75-80); the layer exists only
        # so that checkpoints line up.
        pe = PositionalEncoding(cfg.num_octaves)
        self.positional_encoding = nn.Sequential(pe, nn.Linear(pe.d_out(2), cfg.d_token))
        self.transformer = Transformer(
            cfg.d_token, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp
        )
        self.resampler = nn.ConvTranspose2d(cfg.d_token, d_out, p, stride=p)

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embedder(image)
        bv, d, nh, nw = tokens.shape
        tokens = self.transformer(tokens.flatten(2).transpose(1, 2))  # (bv, nh*nw, d)
        tokens = tokens.transpose(1, 2).reshape(bv, d, nh, nw)
        return self.resampler(tokens)


class ConvFeedForward(nn.Module):
    """Conv feed-forward + image self-attention, on flattened pixel tokens;
    `bv`, `h`, `w` restore the image layout."""

    def __init__(self, self_attention: ImageSelfAttentionCfg, d_in: int, d_hidden: int):
        super().__init__()
        self.d_in = d_in
        self.self_attention = ImageSelfAttention(self_attention, d_in, d_in)
        # The reference's Sequential(Conv, GELU, Dropout, Conv, Dropout);
        # dropout is 0, so its slot holds an Identity and keeps the indices.
        # forward applies layers[0] with its GELU through conv7.
        self.layers = nn.Sequential(
            nn.Conv2d(d_in, d_hidden, 7, padding=3), nn.GELU(approximate="tanh"),
            nn.Identity(), nn.Conv2d(d_hidden, d_in, 7, padding=3),
        )

    def forward(self, x: torch.Tensor, bv: int, h: int, w: int) -> torch.Tensor:
        img = x.reshape(bv, h, w, self.d_in).permute(0, 3, 1, 2)
        img = self.self_attention(img) + img
        img = self.layers[3](conv7(img, self.layers[0], GELU))
        return img.permute(0, 2, 3, 1).reshape(bv * h * w, 1, self.d_in)


class EpipolarTransformer(nn.Module):
    def __init__(self, cfg: EpipolarTransformerCfg, d_in: int):
        super().__init__()
        self.cfg = cfg
        self.d_in = d_in
        if cfg.num_octaves > 0:
            pe = PositionalEncoding(cfg.num_octaves)
            self.depth_encoding = nn.Sequential(pe, nn.Linear(pe.d_out(1), d_in))
        self.transformer = Transformer(
            d_in, cfg.num_layers, cfg.num_heads, cfg.d_dot, cfg.d_mlp,
            selfatt=False, kv_dim=d_in,
            feed_forward_factory=lambda: ConvFeedForward(cfg.self_attention, d_in, cfg.d_mlp),
        )
        if cfg.downscale:
            k = cfg.downscale
            self.downscaler = nn.Conv2d(d_in, d_in, k, stride=k)
            self.upscaler = nn.ConvTranspose2d(d_in, d_in, k, stride=k)
            self.upscale_refinement = nn.Sequential(
                nn.Conv2d(d_in, 2 * d_in, 7, padding=3), nn.GELU(approximate="tanh"),
                nn.Conv2d(2 * d_in, d_in, 7, padding=3),
            )

    def forward(
        self,
        features: torch.Tensor,     # (b, v, h, w, c)
        extrinsics: torch.Tensor,   # (b, v, 4, 4)
        intrinsics: torch.Tensor,   # (b, v, 3, 3)
        near: torch.Tensor,         # (b, v)
        far: torch.Tensor,          # (b, v)
        rays: tuple | None = None,
        token_slice: tuple[int, int, int, int] | None = None,
    ) -> tuple[torch.Tensor, EpipolarSampling]:
        """Returns refined features (b, v, h, w, c) and the sampling record.

        The crop path of deferred back-propagation passes the tile's `rays`
        (see sample_epipolar) and its `token_slice` (y0, x0, hq, wq) in
        downscaled tokens: sampling, attention, the upscaler and the
        refinement convolutions then run on the tile's queries only, while
        the sampled source features stay whole. Returns (b, v, hq·ds,
        wq·ds, c) then."""
        c = self.cfg
        b, v, h, w, ch = features.shape
        d = self.d_in

        down = features
        if c.downscale:
            x = self.downscaler(features.reshape(b * v, h, w, ch).permute(0, 3, 1, 2))
            down = x.permute(0, 2, 3, 1).reshape(b, v, h // c.downscale, w // c.downscale, d)
        hd, wd = down.shape[2], down.shape[3]

        sampling = sample_epipolar(down, extrinsics, intrinsics, near, far, c.num_samples, rays=rays)

        kv = sampling.features
        if c.num_octaves > 0:
            depths = get_depth(
                sampling.origins[:, :, None, :, None],
                sampling.directions[:, :, None, :, None],
                sampling.xy_sample,
                collect_other_views(extrinsics)[:, :, :, None, None],
                collect_other_views(intrinsics)[:, :, :, None, None],
            )
            n5, f5 = near[..., None, None, None], far[..., None, None, None]
            depths = torch.minimum(torch.maximum(depths, n5), f5)
            depths = depth_to_relative_disparity(depths, n5, f5)
            kv = kv + self.depth_encoding(depths[..., None])

        # Queries: the (tile's) downscaled pixel tokens; keys/values: the
        # epipolar samples for that pixel across the other views.
        if token_slice is not None:
            y0, x0, hq, wq = token_slice
            q_tokens = down[:, :, y0:y0 + hq, x0:x0 + wq]
        else:
            q_tokens, hq, wq = down, hd, wd
        r = kv.shape[3]
        assert r == hq * wq, f"ray/token mismatch: {r} vs {hq}x{wq}"
        q = q_tokens.reshape(b * v * hq * wq, 1, d)
        s = kv.shape[4]
        kv_flat = kv.permute(0, 1, 3, 2, 4, 5).reshape(b * v * hq * wq, (v - 1) * s, d)
        out = self.transformer(q, z=kv_flat, bv=b * v, h=hq, w=wq)
        out = out.reshape(b, v, hq, wq, d)

        if c.downscale:
            up = self.upscaler(out.reshape(b * v, hq, wq, d).permute(0, 3, 1, 2))
            r = self.upscale_refinement
            out = conv7(conv7(up, r[0], GELU), r[2], RESIDUAL, residual=up)
            out = out.permute(0, 2, 3, 1).reshape(b, v, hq * c.downscale, wq * c.downscale, d)
        return out, sampling
