"""pixelSplat context-image backbone: ResNet trunk with affine-free instance
norm, per-stage 1x1 projections upsampled to full resolution and summed
(reference backbone_resnet.py:28-100).

Module names follow the reference checkpoint keys (`model.conv1`,
`model.layer{s}.{b}.conv{c}`, `model.layer{s}.{b}.downsample.0`,
`projections.layer{i}`), so a converted checkpoint loads by name.

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


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, width: int, stride: int = 1):
        super().__init__()
        self.conv1 = _conv(cin, width, 3, stride)
        self.conv2 = _conv(width, width, 3)
        self.norm = InstanceNorm()
        self.downsample = None
        if stride != 1 or cin != width:
            self.downsample = nn.Sequential(_conv(cin, width, 1, stride), InstanceNorm())

    def forward(self, x):
        y = F.relu(self.norm(self.conv1(x)))
        y = self.norm(self.conv2(y))
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
