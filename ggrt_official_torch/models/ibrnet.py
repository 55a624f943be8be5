"""IBRNet: the per-ray-sample view-aggregation MLP (the JAX package's
models/ibrnet.py; the reference's model/ibrnet.py:17-136 and
mlp_network.py): anti-alias-pooled view weights, mean/variance fusion,
visibility refinement, ray attention over the samples (a post-LN
transformer block), softmax colour blending -> (rgb, sigma).

Module names are the flax names, so `weights.ibrnet_name_map` maps one to
one. Two flaws of the reference are kept on purpose, as the JAX package
keeps them: the ray attention's mask (r, s, 1) broadcasts as (r, 1, s, 1)
against the scores (r, h, s, s), so it masks query rows, not keys; and its
LayerNorm takes eps 1e-6.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


def fused_mean_variance(x, weight):
    """Weighted mean and variance over the views axis (dim 2)."""
    mean = torch.sum(x * weight, dim=2, keepdim=True)
    var = torch.sum(weight * (x - mean) ** 2, dim=2, keepdim=True)
    return mean, var


def _ray_posenc(n_samples: int, d_hid: int = 16) -> np.ndarray:
    """The sinusoid table (1, n_samples, d_hid), float64 then float32."""
    position = np.arange(n_samples)[:, None]
    hid = np.arange(d_hid)[None, :]
    table = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return table.astype(np.float32)[None]


class MultiHeadAttention(nn.Module):
    """Post-LN residual attention (the reference's mlp_network.py:69-120)."""

    def __init__(self, n_head: int, d_model: int, d_k: int, d_v: int):
        super().__init__()
        self.n_head, self.d_k, self.d_v = n_head, d_k, d_v
        self.w_qs = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_ks = nn.Linear(d_model, n_head * d_k, bias=False)
        self.w_vs = nn.Linear(d_model, n_head * d_v, bias=False)
        self.fc = nn.Linear(n_head * d_v, d_model, bias=False)
        self.layer_norm = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, q, k, v, mask=None):
        residual = q
        b, lq, _ = q.shape
        qh = self.w_qs(q).reshape(b, lq, self.n_head, self.d_k).transpose(1, 2)
        kh = self.w_ks(k).reshape(b, -1, self.n_head, self.d_k).transpose(1, 2)
        vh = self.w_vs(v).reshape(b, -1, self.n_head, self.d_v).transpose(1, 2)

        attn = torch.einsum("bhqd,bhkd->bhqk", qh / (self.d_k**0.5), kh)
        if mask is not None:
            attn = torch.where(mask[:, None] == 0, torch.full_like(attn, -1e9), attn)
        attn = torch.softmax(attn, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", attn, vh)
        out = out.transpose(1, 2).reshape(b, lq, self.n_head * self.d_v)
        out = self.layer_norm(self.fc(out) + residual)
        return out, attn


class IBRNet(nn.Module):
    def __init__(self, in_feat_ch: int = 32, n_samples: int = 64, anti_alias_pooling: bool = True):
        super().__init__()
        self.in_feat_ch, self.n_samples, self.anti_alias_pooling = in_feat_ch, n_samples, anti_alias_pooling
        c = in_feat_ch + 3
        self.ray_dir_fc0 = nn.Linear(4, 16)
        self.ray_dir_fc1 = nn.Linear(16, c)
        if anti_alias_pooling:
            self.s = nn.Parameter(torch.tensor(0.2))
        self.base_fc0 = nn.Linear(3 * c, 64)
        self.base_fc1 = nn.Linear(64, 32)
        self.vis_fc0 = nn.Linear(32, 32)
        self.vis_fc1 = nn.Linear(32, 33)
        self.vis_fc2_0 = nn.Linear(32, 32)
        self.vis_fc2_1 = nn.Linear(32, 1)
        self.geometry_fc0 = nn.Linear(65, 64)
        self.geometry_fc1 = nn.Linear(64, 16)
        self.ray_attention = MultiHeadAttention(4, 16, 4, 4)
        self.out_geometry_fc0 = nn.Linear(16, 16)
        self.out_geometry_fc1 = nn.Linear(16, 1)
        self.rgb_fc0 = nn.Linear(32 + 1 + 4, 16)
        self.rgb_fc1 = nn.Linear(16, 8)
        self.rgb_fc2 = nn.Linear(8, 1)
        # Made here, so a forward copies nothing from the host.
        self.register_buffer("posenc", torch.from_numpy(_ray_posenc(n_samples)), persistent=False)

    def forward(self, rgb_feat, ray_diff, mask):
        """rgb_feat (r, s, v, 3+f); ray_diff (r, s, v, 4); mask (r, s, v, 1)
        -> (r, s, 4) rgb+sigma."""
        elu = F.elu
        direction_feat = elu(self.ray_dir_fc1(elu(self.ray_dir_fc0(ray_diff))))

        rgb_in = rgb_feat[..., :3]
        rgb_feat = rgb_feat + direction_feat
        if self.anti_alias_pooling:
            dot_prod = ray_diff[..., 3:]
            exp_dot = torch.exp(torch.abs(self.s) * (dot_prod - 1.0))
            weight = (exp_dot - torch.amin(exp_dot, dim=2, keepdim=True)) * mask
            weight = weight / (torch.sum(weight, dim=2, keepdim=True) + 1e-8)
        else:
            weight = mask / (torch.sum(mask, dim=2, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(rgb_feat, weight)
        global_feat = torch.cat([mean, var], dim=-1)
        x = torch.cat([global_feat.expand(*rgb_feat.shape[:3], global_feat.shape[-1]), rgb_feat], dim=-1)
        x = elu(self.base_fc1(elu(self.base_fc0(x))))

        x_vis = elu(self.vis_fc1(elu(self.vis_fc0(x * weight))))
        x_res, vis = x_vis[..., :-1], x_vis[..., -1:]
        vis = torch.sigmoid(vis) * mask
        x = x + x_res
        v2 = self.vis_fc2_1(elu(self.vis_fc2_0(x * vis)))
        vis = torch.sigmoid(v2) * mask
        weight = vis / (torch.sum(vis, dim=2, keepdim=True) + 1e-8)

        mean, var = fused_mean_variance(x, weight)
        global_feat = torch.cat([mean[:, :, 0], var[:, :, 0], torch.mean(weight, dim=2)], dim=-1)  # (r, s, 65)
        g = elu(self.geometry_fc1(elu(self.geometry_fc0(global_feat))))

        num_valid_obs = torch.sum(mask, dim=2)  # (r, s, 1)
        s_actual = g.shape[1]
        if s_actual > self.posenc.shape[1]:  # more samples than built for: one copy, kept
            self.posenc = torch.from_numpy(_ray_posenc(s_actual)).to(g.device)
        g = g + self.posenc[:, :s_actual]
        g, _ = self.ray_attention(g, g, g, mask=(num_valid_obs > 1).to(g.dtype))
        sigma = F.relu(self.out_geometry_fc1(elu(self.out_geometry_fc0(g))))
        sigma_out = torch.where(num_valid_obs < 1, torch.zeros_like(sigma), sigma)

        x = torch.cat([x, vis, ray_diff], dim=-1)
        x = self.rgb_fc2(elu(self.rgb_fc1(elu(self.rgb_fc0(x)))))
        x = torch.where(mask == 0, torch.full_like(x, -1e9), x)
        blending = torch.softmax(x, dim=2)
        rgb_out = torch.sum(rgb_in * blending, dim=2)
        return torch.cat([rgb_out, sigma_out], dim=-1)
