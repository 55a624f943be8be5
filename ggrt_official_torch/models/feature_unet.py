"""ResUNet feature extractor for the IBRNet path (the JAX package's
models/feature_unet.py; the reference's model/feature_network.py:157-271):
a resnet34-style encoder (stride-2 stem and three stride-2 stages of basic
blocks) with an upconv decoder and skip connections, emitting coarse(+fine)
feature maps at half resolution; affine instance norm everywhere.

NHWC at the public functions, as in the JAX package; NCHW inside. Two
details follow flax and jax.image rather than torch's habits:
  * every convolution pads as flax's "SAME": a total of
    max((ceil(n/s) - 1)·s + k - n, 0) per axis, the smaller half before.
    A stride-2 convolution on an even size pads (0, 1) for 3x3 and (2, 3)
    for 7x7, where torch's padding=k//2 would be symmetric;
  * `jax.image.resize(..., "bilinear")` samples at half-pixel centres and
    renormalises at the borders, which for upsampling is
    F.interpolate(mode="bilinear", align_corners=False).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def same_pad(n: int, k: int, s: int) -> tuple[int, int]:
    """flax "SAME" padding of one axis of size n: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class SameConv2d(nn.Conv2d):
    """A Conv2d that pads as flax's "SAME", from the input's size."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1, bias: bool = True):
        super().__init__(cin, cout, k, stride=stride, padding=0, bias=bias)

    def forward(self, x):
        (k_h, k_w), (s_h, s_w) = self.kernel_size, self.stride
        top, bottom = same_pad(x.shape[-2], k_h, s_h)
        left, right = same_pad(x.shape[-1], k_w, s_w)
        return super().forward(F.pad(x, (left, right, top, bottom)))


class AffineInstanceNorm(nn.Module):
    """(x - mean) / sqrt(var + eps) over each map's pixels, then scale and
    bias per channel (NCHW)."""

    def __init__(self, channels: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        mean = torch.mean(x, dim=(2, 3), keepdim=True)
        var = torch.var(x, dim=(2, 3), keepdim=True, unbiased=False)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight[:, None, None] + self.bias[:, None, None]


class UNetBasicBlock(nn.Module):
    def __init__(self, cin: int, features: int, stride: int = 1):
        super().__init__()
        self.conv1 = SameConv2d(cin, features, 3, stride, bias=False)
        self.norm1 = AffineInstanceNorm(features)
        self.conv2 = SameConv2d(features, features, 3, bias=False)
        self.norm2 = AffineInstanceNorm(features)
        # flax's block adds the projection where the identity's shape
        # differs; in ResUNet that is exactly each stage's strided first block.
        self.has_downsample = stride != 1 or cin != features
        if self.has_downsample:
            self.downsample = SameConv2d(cin, features, 1, stride, bias=False)
            self.downsample_norm = AffineInstanceNorm(features)

    def forward(self, x):
        y = F.relu(self.norm1(self.conv1(x)))
        y = self.norm2(self.conv2(y))
        identity = self.downsample_norm(self.downsample(x)) if self.has_downsample else x
        return F.relu(y + identity)


class ResUNet(nn.Module):
    def __init__(self, coarse_out_ch: int = 32, fine_out_ch: int = 32, coarse_only: bool = False):
        super().__init__()
        self.coarse_out_ch, self.coarse_only = coarse_out_ch, coarse_only
        out_ch = coarse_out_ch + (0 if coarse_only else fine_out_ch)
        self.conv1 = SameConv2d(3, 64, 7, 2, bias=False)
        self.norm1 = AffineInstanceNorm(64)
        cin = 64
        for name, width, n_blocks in (("layer1", 64, 3), ("layer2", 128, 4), ("layer3", 256, 6)):
            for i in range(n_blocks):
                setattr(self, f"{name}_b{i}", UNetBasicBlock(cin, width, stride=2 if i == 0 else 1))
                cin = width
        self.upconv3 = SameConv2d(256, 128, 3)
        self.upconv3_norm = AffineInstanceNorm(128)
        self.iconv3 = SameConv2d(256, 128, 3)
        self.iconv3_norm = AffineInstanceNorm(128)
        self.upconv2 = SameConv2d(128, 64, 3)
        self.upconv2_norm = AffineInstanceNorm(64)
        self.iconv2 = SameConv2d(128, out_ch, 3)
        self.iconv2_norm = AffineInstanceNorm(out_ch)
        self.out_conv = SameConv2d(out_ch, out_ch, 1)

    def _stage(self, x, name: str, n_blocks: int):
        for i in range(n_blocks):
            x = getattr(self, f"{name}_b{i}")(x)
        return x

    @staticmethod
    def _resize(x, hw):
        return F.interpolate(x, size=tuple(hw), mode="bilinear", align_corners=False)

    def forward(self, images):
        """images (n, h, w, 3) -> (coarse (n, h//2, w//2, c), fine or None)."""
        x = images.permute(0, 3, 1, 2)
        h2, w2 = x.shape[2] // 2, x.shape[3] // 2
        x = F.relu(self.norm1(self.conv1(x)))
        x1 = self._stage(x, "layer1", 3)    # h/4
        x2 = self._stage(x1, "layer2", 4)   # h/8
        x3 = self._stage(x2, "layer3", 6)   # h/16

        y = F.elu(self.upconv3_norm(self.upconv3(self._resize(x3, x2.shape[2:]))))
        y = F.elu(self.iconv3_norm(self.iconv3(torch.cat([x2, y], dim=1))))
        y = F.elu(self.upconv2_norm(self.upconv2(self._resize(y, x1.shape[2:]))))
        y = F.elu(self.iconv2_norm(self.iconv2(torch.cat([x1, y], dim=1))))
        y = self.out_conv(y)
        # The decoder tops out at layer1's resolution (h/4); the reference
        # delivers features at half the input's, so resize up.
        y = self._resize(y, (h2, w2)).permute(0, 2, 3, 1)
        if self.coarse_only:
            return y, None
        return y[..., : self.coarse_out_ch], y[..., self.coarse_out_ch:]
