"""Ray generation for the IBRNet volume-rendering path (the JAX package's
rendering/rays.py; the reference's sample_ray.py, RaySamplerSingleImage):
pixel-corner rays with no half-pixel offset, not normalised, the 34-vector
camera, render_stride subsampling.
"""
from __future__ import annotations

import torch


def parse_camera(params: torch.Tensor):
    """(n, 34) -> (W, H, intrinsics (n, 4, 4), c2w (n, 4, 4))."""
    h = params[:, 0]
    w = params[:, 1]
    intrinsics = params[:, 2:18].reshape(-1, 4, 4)
    c2w = params[:, 18:34].reshape(-1, 4, 4)
    return w, h, intrinsics, c2w


def get_rays_single_image(h: int, w: int, intrinsics: torch.Tensor, c2w: torch.Tensor,
                          render_stride: int = 1):
    """Returns (rays_o, rays_d), each (ceil(h/stride)·ceil(w/stride), 3), on
    the cameras' device. K is inverted with `inv_ex`, which reads no status
    back to the host."""
    dev = c2w.device
    u = torch.arange(0, w, render_stride, dtype=torch.float32, device=dev)
    v = torch.arange(0, h, render_stride, dtype=torch.float32, device=dev)
    uu, vv = torch.meshgrid(u, v, indexing="xy")  # (h', w')
    pixels = torch.stack([uu.reshape(-1), vv.reshape(-1), torch.ones_like(uu).reshape(-1)], dim=0)
    K = intrinsics[0, :3, :3]
    R = c2w[0, :3, :3]
    rays_d = (R @ torch.linalg.inv_ex(K).inverse @ pixels).T
    rays_o = c2w[0, :3, 3].expand(rays_d.shape)
    return rays_o, rays_d
