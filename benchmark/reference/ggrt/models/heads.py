"""IPO-Net heads and ConvGRU update blocks (the reference's optimizer.py:
DepthHead, PoseHead, SepConvGRU, ProjectionInput{Depth,Pose}, UpMaskNet,
BasicUpdateBlock{Depth,Pose}).

NCHW throughout. Every conv pads to keep the size ("SAME" for the odd
kernels used here) and carries a bias, as flax's nn.Conv does. Module names
are the reference checkpoint keys, so a converted checkpoint loads by name.
The seq_len loops live in iponet.py; these modules are the per-step cells.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


def conv(cin: int, cout: int, k) -> nn.Conv2d:
    kh, kw = (k, k) if isinstance(k, int) else k
    return nn.Conv2d(cin, cout, (kh, kw), padding=(kh // 2, kw // 2))


class DepthHead(nn.Module):
    def __init__(self, cin: int, hidden_dim: int = 128):
        super().__init__()
        self.conv1 = conv(cin, hidden_dim, 3)
        self.conv2 = conv(hidden_dim, 1, 3)

    def forward(self, x, act=torch.tanh):
        return act(self.conv2(F.relu(self.conv1(x))))


class PoseHead(nn.Module):
    """6-DoF head: (b, c, h, w) -> (b, 6); the last three entries (the euler
    angles, as pose_from_vec reads them) are scaled by 0.01."""

    def __init__(self, cin: int, hidden_dim: int = 128):
        super().__init__()
        self.conv1_pose = conv(cin, hidden_dim, 3)
        self.conv2_pose = conv(hidden_dim, 6, 3)

    def forward(self, x):
        out = self.conv2_pose(F.relu(self.conv1_pose(x))).mean(dim=(2, 3))
        return torch.cat([out[:, :3], 0.01 * out[:, 3:]], dim=1)


class UpMaskNet(nn.Module):
    def __init__(self, cin: int, hidden_dim: int = 128, ratio: int = 8):
        super().__init__()
        self.mask = nn.Sequential(conv(cin, hidden_dim * 2, 3), nn.ReLU(),
                                  conv(hidden_dim * 2, ratio * ratio * 9, 1))

    def forward(self, feat):
        return 0.25 * self.mask(feat)  # scaled to balance gradients


class SepConvGRU(nn.Module):
    """Separable 1x5 / 5x1 ConvGRU (ref optimizer.py:51-78)."""

    def __init__(self, hidden_dim: int, input_dim: int):
        super().__init__()
        cin = hidden_dim + input_dim
        for suffix, k in (("1", (1, 5)), ("2", (5, 1))):
            for gate in ("z", "r", "q"):
                self.add_module(f"conv{gate}{suffix}", conv(cin, hidden_dim, k))

    def _half(self, h, x, suffix):
        hx = torch.cat([h, x], dim=1)
        z = torch.sigmoid(getattr(self, f"convz{suffix}")(hx))
        r = torch.sigmoid(getattr(self, f"convr{suffix}")(hx))
        q = torch.tanh(getattr(self, f"convq{suffix}")(torch.cat([r * h, x], dim=1)))
        return (1 - z) * h + z * q

    def forward(self, h, x):
        return self._half(self._half(h, x, "1"), x, "2")


class ProjectionInputDepth(nn.Module):
    def __init__(self, cost_dim: int, hidden_dim: int, out_chs: int):
        super().__init__()
        self.convc1 = conv(cost_dim, hidden_dim, 1)
        self.convc2 = conv(hidden_dim, hidden_dim, 3)
        self.convd1 = conv(1, hidden_dim, 7)
        self.convd2 = conv(hidden_dim, 64, 3)
        self.convd = conv(hidden_dim + 64, out_chs - 1, 3)

    def forward(self, depth, cost):
        cor = F.relu(self.convc2(F.relu(self.convc1(cost))))
        dfm = F.relu(self.convd2(F.relu(self.convd1(depth))))
        out_d = F.relu(self.convd(torch.cat([cor, dfm], dim=1)))
        return torch.cat([out_d, depth], dim=1)


class ProjectionInputPose(nn.Module):
    def __init__(self, cost_dim: int, hidden_dim: int, out_chs: int):
        super().__init__()
        self.convc1 = conv(cost_dim, hidden_dim, 1)
        self.convc2 = conv(hidden_dim, hidden_dim, 3)
        self.convp1 = conv(6, hidden_dim, 7)
        self.convp2 = conv(hidden_dim, 64, 3)
        self.convp = conv(hidden_dim + 64, out_chs - 6, 3)

    def forward(self, pose, cost):
        b, _, h, w = cost.shape
        cor = F.relu(self.convc2(F.relu(self.convc1(cost))))
        pose_map = pose[:, :, None, None].expand(b, 6, h, w)
        pfm = F.relu(self.convp2(F.relu(self.convp1(pose_map))))
        out_p = F.relu(self.convp(torch.cat([cor, pfm], dim=1)))
        return torch.cat([out_p, pose_map], dim=1)


class BasicUpdateBlockDepth(nn.Module):
    """One GRU step of the depth update (ref optimizer.py:145-174): returns
    (net, inv_depth + delta, upsampling mask)."""

    def __init__(self, cost_dim: int, hidden_dim: int = 128, ratio: int = 8, context_dim: int = 32):
        super().__init__()
        self.encoder = ProjectionInputDepth(cost_dim, hidden_dim, hidden_dim)
        self.depth_gru = SepConvGRU(hidden_dim, context_dim + hidden_dim)
        self.depth_head = DepthHead(hidden_dim, hidden_dim)
        self.mask = nn.Sequential(conv(hidden_dim, hidden_dim * 2, 3), nn.ReLU(),
                                  conv(hidden_dim * 2, ratio * ratio * 9, 1))

    def forward(self, net, inv_depth, cost, context):
        inp = torch.cat([context, self.encoder(inv_depth, cost)], dim=1)
        net = self.depth_gru(net, inp)
        # The per-step inverse-depth delta is tanh-squashed (optimizer.py:14).
        delta = self.depth_head(net, act=torch.tanh)
        return net, inv_depth + delta, 0.25 * self.mask(net)


class BasicUpdateBlockPose(nn.Module):
    """One GRU step of the pose update (ref optimizer.py:177-199)."""

    def __init__(self, cost_dim: int, hidden_dim: int = 128, context_dim: int = 32):
        super().__init__()
        self.encoder = ProjectionInputPose(cost_dim, hidden_dim, hidden_dim)
        self.pose_gru = SepConvGRU(hidden_dim, context_dim + hidden_dim)
        self.pose_head = PoseHead(hidden_dim, hidden_dim)

    def forward(self, net, pose, cost, context):
        inp = torch.cat([context, self.encoder(pose, cost)], dim=1)
        net = self.pose_gru(net, inp)
        return net, pose + self.pose_head(net)
