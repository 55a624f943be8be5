"""ResNet feature backbones, NCHW inside, JAX-package layouts at the edges.

  * `BackboneResnet`, the pixelSplat context-image backbone: ResNet trunk
    with affine-free instance norm, per-stage 1x1 projections upsampled to
    full resolution and summed (reference backbone_resnet.py:28-100).
  * `ResNetEncoder`, the IPO-Net feature/context net: a resnet18 trunk
    (frozen batch norm by default; affine-free instance norm or 8-group
    group norm on request) to stride 16, upsampled and fused back to stride
    8 or 4 (reference feature_network.py:274-381).

Module names follow the reference checkpoint keys (`model.conv1`,
`model.layer{s}.{b}.conv{c}`, `model.layer{s}.{b}.downsample.0`,
`projections.layer{i}`; `conv1`, `bn1`, `layer{s}.{b}.bn{c}`, `upconv1.0`,
`out_conv` for the encoder), so a converted checkpoint loads by name.

Conversion-exact details shared with the JAX package:
  * every trunk conv pads symmetrically (k // 2), as torch does;
  * the projections upsample with align_corners=True
    (backbone_resnet.py:91);
  * the reference's `use_first_pool` is dead code (`index == 0` never holds
    inside `range(1, num_layers)`, backbone_resnet.py:83): no maxpool.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class InstanceNorm(nn.Module):
    """Affine-free instance norm over the spatial dims, biased variance,
    eps 1e-5 (the reference's InstanceNorm2d(affine=False))."""

    def __init__(self, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.instance_norm(x, eps=self.epsilon)


def _conv(cin: int, cout: int, k: int, stride: int = 1, bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=k // 2, bias=bias)


def resize_bilinear(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    """Half-pixel bilinear resize of (b, c, h, w), as jax.image.resize
    gives it for the upsampling the encoders do."""
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=False)


def resize_bilinear_align_corners(x: torch.Tensor, hw: tuple[int, int]) -> torch.Tensor:
    return F.interpolate(x, size=hw, mode="bilinear", align_corners=True)


class FrozenBatchNorm(nn.Module):
    """Batch norm with fixed running statistics: y = (x - mean)/sqrt(var +
    eps)·weight + bias. The statistics are buffers, so no optimizer sees
    them, as the JAX package stop-gradients them."""

    def __init__(self, c: int, epsilon: float = 1e-5):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.epsilon = epsilon

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + self.epsilon) * self.weight
        return x * inv[:, None, None] + (self.bias - self.running_mean * inv)[:, None, None]


GROUP_NORM_EPS = 1e-6  # flax's GroupNorm default; torch's is 1e-5


def make_norm(kind: str):
    """The ResNetEncoder's norm factory, c -> module, as the JAX package's
    make_norm: "batch" (frozen statistics), "instance" (affine-free, eps
    1e-5 over H and W) or "group" (8 groups, affine, eps 1e-6)."""
    if kind == "batch":
        return FrozenBatchNorm
    if kind == "instance":
        return lambda c: InstanceNorm()
    if kind == "group":
        return lambda c: nn.GroupNorm(8, c, eps=GROUP_NORM_EPS)
    raise ValueError(kind)


class BasicBlock(nn.Module):
    """Basic residual block; `norm(c)` makes each of its norms: instance
    norm in the pixelSplat trunk, frozen batch norm (named bn1, bn2 and
    downsample.1, as the reference's) in the IPO-Net encoder."""

    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1, norm=lambda c: InstanceNorm()):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.bn1 = norm(width)
        self.conv2 = _conv(width, width, 3)
        self.bn2 = norm(width)
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(_conv(cin, width, 1, stride), norm(width))

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        out = width * 4
        self.conv1 = _conv(cin, width, 1)
        self.conv2 = _conv(width, width, 3, stride)
        self.conv3 = _conv(width, out, 1)
        self.norm = InstanceNorm()
        self.downsample = None
        if stride != 1 or cin != out:
            self.downsample = nn.Sequential(_conv(cin, out, 1, stride), InstanceNorm())

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = F.relu(self.norm(self.conv2(y)))
        y = self.norm(self.conv3(y))
        residual = x if self.downsample is None else self.downsample(x)
        return F.relu(y + residual)


RESNET_LAYERS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "dino_resnet50": (Bottleneck, (3, 4, 6, 3)),
}


class ResNetTrunk(nn.Module):
    """conv1 + layer1..layer{num_layers-1}, returning every stage's features
    (NCHW)."""

    def __init__(self, model: str = "resnet50", num_layers: int = 5):
        super().__init__()
        block, layers = RESNET_LAYERS[model]
        self.conv1 = _conv(3, 64, 7, 2)
        self.norm = InstanceNorm()
        self.out_channels = [64]
        cin = 64
        for stage in range(1, num_layers):
            width = (64, 128, 256, 512)[stage - 1]
            blocks = []
            for b in range(layers[stage - 1]):
                stride = 2 if (stage > 1 and b == 0) else 1
                blocks.append(block(cin, width, stride))
                cin = width * block.expansion
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))
            self.out_channels.append(cin)
        self.num_layers = num_layers

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        x = F.relu(self.norm(self.conv1(x)))
        feats = [x]
        for stage in range(1, self.num_layers):
            x = getattr(self, f"layer{stage}")(x)
            feats.append(x)
        return feats


class BackboneResnet(nn.Module):
    """Input (b, v, h, w, 3) -> output (b, v, h, w, d_out), channels last
    as the JAX package's BackboneResnet."""

    def __init__(self, model: str = "resnet50", num_layers: int = 5, d_out: int = 512):
        super().__init__()
        self.model = ResNetTrunk(model, num_layers)
        self.projections = nn.ModuleDict({
            f"layer{i}": nn.Conv2d(c, d_out, 1)
            for i, c in enumerate(self.model.out_channels)
        })
        self.d_out = d_out

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        b, v, h, w, c = images.shape
        x = images.reshape(b * v, h, w, c).permute(0, 3, 1, 2)
        total = None
        for i, f in enumerate(self.model(x)):
            p = F.interpolate(self.projections[f"layer{i}"](f), size=(h, w),
                              mode="bilinear", align_corners=True)
            total = p if total is None else total + p
        return total.permute(0, 2, 3, 1).reshape(b, v, h, w, self.d_out)


class ResNetEncoder(nn.Module):
    """IPO-Net feature/context encoder, resnet18 with the `norm` kind of
    make_norm (frozen batch norm by default; its modules keep the
    reference's names bn1, bn{c} and downsample.1 whatever the kind):
    conv1/s2 + norm + maxpool/s2 +
    layer1 + layer2/s2 + layer3/s2, then bilinear upsampling and conv fusion
    back to stride 8 (or 4), in the reference's order.

    Input (b, in_chs, h, w) -> (b, out_chs, h/stride, w/stride), NCHW."""

    def __init__(self, in_chs: int = 3, out_chs: int = 128, stride: int = 8, norm: str = "batch"):
        super().__init__()
        if stride not in (4, 8):
            raise ValueError(f"stride {stride} unsupported")
        self.stride = stride
        norm_fn = make_norm(norm)
        self.conv1 = _conv(in_chs, 64, 7, 2)
        self.bn1 = norm_fn(64)
        cin = 64
        for stage, (width, n, first_stride) in enumerate(
                zip((64, 128, 256), RESNET_LAYERS["resnet18"][1][:3], (1, 2, 2)), start=1):
            blocks = []
            for i in range(n):
                blocks.append(BasicBlock(cin, width, first_stride if i == 0 else 1, norm_fn))
                cin = width
            self.add_module(f"layer{stage}", nn.Sequential(*blocks))

        def conv_relu(a, b):
            return nn.Sequential(nn.Conv2d(a, b, 3, padding=1), nn.ReLU())

        self.upconv1 = conv_relu(256, 128)
        self.upconv1_fusion = conv_relu(256, 128)
        if stride == 4:
            self.upconv2 = conv_relu(128, 64)
            self.upconv2_fusion = conv_relu(128, 64)
        self.out_conv = nn.Conv2d(128 if stride == 8 else 64, out_chs, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        # -inf padding, as flax's max_pool pads.
        x = F.max_pool2d(x, 3, stride=2, padding=1)
        s4 = x = self.layer1(x)
        s8 = x = self.layer2(x)
        x = self.layer3(x)
        x = self.upconv1(resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3])))
        x = torch.cat([x, resize_bilinear(s8, x.shape[2:])], dim=1)
        x = self.upconv1_fusion(x)
        if self.stride == 4:
            x = self.upconv2(resize_bilinear(x, (2 * x.shape[2], 2 * x.shape[3])))
            x = torch.cat([x, resize_bilinear(s4, x.shape[2:])], dim=1)
            x = self.upconv2_fusion(x)
        return self.out_conv(x)
