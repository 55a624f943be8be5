"""Vanilla NeRF and BARF (the JAX package's models/nerf.py; the reference's
model/nerf.py and barf.py): a positional-encoding MLP, BARF's
coarse-to-fine annealing of the encoding's bands, per-camera se(3) pose
corrections, and the stratified-sampling renderer of the NeRF/BARF path.

Module names are the flax names (`weights.nerf_mlp_name_map`). The
annealing weights are laid out as the JAX package lays them,
repeat(repeat(w, 2), 3) over the (3, L, 2) encoding: encoding entry j takes
w[j // 6], not the weight of its own band. That flaw is kept on purpose.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..constants import linspace
from ..geometry.se3 import se3_exp
from ..rendering.volume import cumprod_positive


def positional_encoding(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """(..., d) -> (..., d·2·num_freqs) NeRF encoding in (d, L, sin/cos) order."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device) * math.pi
    angles = x[..., None] * freqs  # (..., d, L)
    enc = torch.stack([torch.sin(angles), torch.cos(angles)], dim=-1)
    return enc.reshape(*x.shape[:-1], x.shape[-1] * num_freqs * 2)


def barf_annealing_weights(num_freqs: int, progress, device=None) -> torch.Tensor:
    """BARF's coarse-to-fine weights w_k(alpha), alpha = progress·L: 0 before
    band k opens, a cosine ramp while it opens, 1 after. A float `progress`
    is rounded to float32 first, as the JAX package's traced scalar is; the
    tensor is filled on the device, not copied there."""
    if not isinstance(progress, torch.Tensor):
        progress = torch.full((), progress, dtype=torch.float32, device=device)
    alpha = progress * num_freqs
    k = torch.arange(num_freqs, dtype=torch.float32, device=device)
    t = torch.clamp(alpha - k, 0.0, 1.0)
    return (1.0 - torch.cos(t * math.pi)) / 2.0


class NeRFMLP(nn.Module):
    def __init__(self, depth: int = 8, width: int = 256, num_freqs_xyz: int = 10, num_freqs_dir: int = 4,
                 skip_layer: int = 4):
        super().__init__()
        self.depth, self.skip_layer = depth, skip_layer
        self.num_freqs_xyz, self.num_freqs_dir = num_freqs_xyz, num_freqs_dir
        d_in = 3 + 3 * 2 * num_freqs_xyz
        cin = d_in
        for i in range(depth):
            setattr(self, f"fc{i}", nn.Linear(cin, width))
            cin = width + (d_in if i == skip_layer else 0)
        self.sigma = nn.Linear(cin, 1)
        self.feat = nn.Linear(cin, width)
        self.rgb_fc = nn.Linear(width + 3 + 3 * 2 * num_freqs_dir, width // 2)
        self.rgb = nn.Linear(width // 2, 3)

    def forward(self, xyz, view_dirs, pe_weights: Optional[torch.Tensor] = None):
        """xyz (..., 3), view_dirs (..., 3) -> (..., 4) rgb+sigma."""
        enc = positional_encoding(xyz, self.num_freqs_xyz)
        if pe_weights is not None:
            w = torch.repeat_interleave(torch.repeat_interleave(pe_weights, 2), 3)
            enc = enc * w
        h = torch.cat([xyz, enc], dim=-1)
        inp = h
        for i in range(self.depth):
            h = F.relu(getattr(self, f"fc{i}")(h))
            if i == self.skip_layer:
                h = torch.cat([h, inp], dim=-1)
        sigma = self.sigma(h)
        feat = self.feat(h)
        dir_enc = positional_encoding(view_dirs, self.num_freqs_dir)
        h = F.relu(self.rgb_fc(torch.cat([feat, view_dirs, dir_enc], dim=-1)))
        rgb = torch.sigmoid(self.rgb(h))
        return torch.cat([rgb, F.relu(sigma)], dim=-1)


class BARFModel(nn.Module):
    """NeRF, learnable per-camera se(3) pose corrections and PE annealing."""

    def __init__(self, num_cameras: int, depth: int = 8, width: int = 256, num_freqs_xyz: int = 10):
        super().__init__()
        self.num_freqs_xyz = num_freqs_xyz
        self.nerf = NeRFMLP(depth=depth, width=width, num_freqs_xyz=num_freqs_xyz)
        self.pose_refine = nn.Parameter(torch.zeros(num_cameras, 6))

    def corrected_pose(self, cam_idx: torch.Tensor, base_c2w: torch.Tensor) -> torch.Tensor:
        """base_c2w @ se3_exp(pose_refine[cam_idx]); cam_idx an integer
        tensor of any shape, gathered on the card (no read-back)."""
        delta = torch.index_select(self.pose_refine, 0, cam_idx.reshape(-1).long())
        return base_c2w @ se3_exp(delta.reshape(*cam_idx.shape, 6))

    def forward(self, xyz, view_dirs, progress=1.0):
        w = barf_annealing_weights(self.num_freqs_xyz, progress, device=xyz.device)
        return self.nerf(xyz, view_dirs, pe_weights=w)


def render_nerf_rays(apply_fn, rays_o, rays_d, near: float, far: float, n_samples: int = 64,
                     uniforms: Optional[torch.Tensor] = None):
    """The stratified-sampling renderer of the NeRF/BARF path. With
    `uniforms` (r, n_samples) each sample is jittered in its interval (the
    JAX package draws them from its key there); without, the samples sit on
    jnp.linspace(near, far, n_samples)'s grid (`constants.linspace`: the same
    ends, one sample at `near` when n_samples is 1, and within two float32
    spacings of JAX's entries between them)."""
    r = rays_o.shape[0]
    t = linspace(near, far, n_samples, device=rays_o.device)
    z = t.expand(r, n_samples)
    if uniforms is not None:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * uniforms
    pts = rays_o[:, None] + z[..., None] * rays_d[:, None]
    dirs = (rays_d[:, None] / torch.linalg.norm(rays_d, dim=-1, keepdim=True)[:, None]).expand(pts.shape)
    raw = apply_fn(pts, dirs)
    rgb, sigma = raw[..., :3], raw[..., 3]
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full((r, 1), 1e10, device=z.device)], dim=-1)
    alpha = 1.0 - torch.exp(-sigma * dists)
    T = cumprod_positive(1.0 - alpha + 1e-10, dim=-1)
    T = torch.cat([torch.ones((r, 1), device=z.device), T[:, :-1]], dim=-1)
    weights = alpha * T
    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    depth_map = torch.sum(weights * z, dim=-1)
    return {"rgb": rgb_map, "depth": depth_map, "weights": weights}
