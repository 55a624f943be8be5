"""Volume rendering for the legacy IBRNet path (the JAX package's
rendering/volume.py; the reference's render_ray.py and render_image.py):
samples along camera rays, inverse-CDF importance sampling, alpha
compositing, coarse(+fine) ray rendering and the chunked whole-image loop.

The reference's sigma-to-alpha ignores the sample intervals
(render_ray.py:152-156); so does this. Every random draw is an argument:
`uniforms` where the caller has them (the tests pass JAX's own draws), or a
`torch.Generator` on the rays' device.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..constants import linspace
from .projector import project_and_gather


class _CumprodPositive(torch.autograd.Function):
    """torch.cumprod whose backward assumes no zero factor. torch's own
    backward asks the host whether any factor is zero (a read-back that
    waits for the card) before it takes this same formula."""

    @staticmethod
    def forward(ctx, x, dim: int):
        out = torch.cumprod(x, dim=dim)
        ctx.save_for_backward(x, out)
        ctx.dim = dim
        return out

    @staticmethod
    def backward(ctx, grad):
        x, out = ctx.saved_tensors
        d = ctx.dim
        return torch.flip(torch.cumsum(torch.flip(grad * out, [d]), dim=d), [d]) / x, None


def cumprod_positive(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Cumulative product of factors that are all > 0 (the transmittances'
    1 - alpha + 1e-10), differentiable without a host sync."""
    return _CumprodPositive.apply(x, dim)


def _uniform(shape, like: torch.Tensor, uniforms, generator):
    if uniforms is not None:
        return uniforms
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def sample_pdf(bins, weights, n_samples, det=False, uniforms=None, generator=None):
    """Inverse-CDF importance sampling (the reference's render_ray.py:25-73).

    bins (r, m+1), weights (r, m) -> samples (r, n_samples). With `det` the
    samples are drawn at jnp.linspace(0, 1, n_samples) (a single one at 0);
    without, at `uniforms` (r, n_samples), or from `generator`.
    """
    r, m = weights.shape
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)  # (r, m+1)

    if det:
        u = linspace(0.0, 1.0, n_samples, dtype=weights.dtype, device=weights.device).expand(r, n_samples)
    else:
        u = _uniform((r, n_samples), weights, uniforms, generator)

    above = torch.sum((u[:, None, :] >= cdf[:, :m, None]).to(torch.int64), dim=1)
    below = torch.clamp(above - 1, 0, m)
    above = torch.clamp(above, 0, m)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def sample_along_camera_ray(ray_o, ray_d, depth_range, n_samples, inv_uniform=False, det=False,
                            inv_depth_prior=None, uniforms=None, generator=None):
    """(r, 3) rays -> pts (r, s, 3), z_vals (r, s) (the reference's
    render_ray.py:76-133). depth_range (2,) on the rays' device; without
    `det` each sample is jittered in its interval by `uniforms` (r, s) or
    draws from `generator`."""
    near = depth_range[0]
    far = depth_range[1]
    r = ray_d.shape[0]
    i = torch.arange(n_samples, dtype=ray_d.dtype, device=ray_d.device)

    if inv_uniform:
        start = 1.0 / near
        step = (1.0 / far - start) / (n_samples - 1)
        z_vals = (1.0 / (start + i[None, :] * step)).expand(r, n_samples)
    else:
        step = (far - near) / (n_samples - 1)
        z_vals = (near + i[None, :] * step).expand(r, n_samples)

    if inv_depth_prior is not None:
        depth_interval = 1.0
        near_p = torch.clamp(1.0 / inv_depth_prior - depth_interval, near, far)  # (r,)
        far_p = torch.clamp(1.0 / inv_depth_prior + depth_interval, near, far)
        start = 1.0 / near_p
        step = (1.0 / far_p - start) / (n_samples - 1)
        z_vals = 1.0 / (start[:, None] + i[None, :] * step[:, None])

    if not det:
        mids = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
        upper = torch.cat([mids, z_vals[:, -1:]], dim=-1)
        lower = torch.cat([z_vals[:, :1], mids], dim=-1)
        t_rand = _uniform(z_vals.shape, z_vals, uniforms, generator)
        z_vals = lower + (upper - lower) * t_rand

    pts = z_vals[..., None] * ray_d[:, None, :] + ray_o[:, None, :]
    return pts, z_vals


def raw2outputs(raw, z_vals, mask, white_bkgd=False):
    """Alpha compositing (the reference's render_ray.py:140-180)."""
    rgb = raw[:, :, :3]
    sigma = raw[:, :, 3]
    alpha = 1.0 - torch.exp(-sigma)
    T = cumprod_positive(1.0 - alpha + 1e-10, dim=-1)[:, :-1]
    T = torch.cat([torch.ones_like(T[:, :1]), T], dim=-1)
    weights = alpha * T
    rgb_map = torch.sum(weights[..., None] * rgb, dim=1)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - torch.sum(weights, dim=-1, keepdim=True))
    mask_out = torch.sum(mask.to(torch.float32), dim=1) > 8
    depth_map = torch.sum(weights * z_vals, dim=-1)
    return {"rgb": rgb_map, "depth": depth_map, "weights": weights, "mask": mask_out,
            "alpha": alpha, "z_vals": z_vals}


def render_rays(ray_batch: dict, apply_coarse: Callable, feat_maps, n_samples: int,
                inv_uniform: bool = False, n_importance: int = 0, det: bool = False,
                white_bkgd: bool = False, apply_fine: Optional[Callable] = None,
                inv_depth_prior=None, rel_poses=None, uniforms=None, generator=None):
    """Coarse(+fine) ray rendering (the reference's render_ray.py:183-269).

    apply_coarse / apply_fine: (rgb_feat, ray_diff, mask) -> (r, s, 4).
    feat_maps: (coarse (v, hf, wf, d), fine or None). uniforms: None or
    (the depth jitter (r, n_samples), the importance draws (r,
    n_importance)), either None to draw it from `generator`.
    """
    u_depth, u_pdf = uniforms if uniforms is not None else (None, None)
    pts, z_vals = sample_along_camera_ray(
        ray_batch["ray_o"], ray_batch["ray_d"], ray_batch["depth_range"], n_samples,
        inv_uniform=inv_uniform, det=det, inv_depth_prior=inv_depth_prior,
        uniforms=u_depth, generator=generator,
    )

    rgb_feat, ray_diff, mask = project_and_gather(
        pts, ray_batch["camera"], ray_batch["src_rgbs"], ray_batch["src_cameras"], feat_maps[0],
        rel_poses=rel_poses,
    )
    pixel_mask = torch.sum(mask[..., 0], dim=2) > 1
    raw_coarse = apply_coarse(rgb_feat, ray_diff, mask)
    outputs_coarse = raw2outputs(raw_coarse, z_vals, pixel_mask, white_bkgd)
    ret = {"outputs_coarse": outputs_coarse, "outputs_fine": None}

    if n_importance > 0:
        if apply_fine is None:
            raise ValueError("n_importance > 0 needs apply_fine")
        weights = outputs_coarse["weights"].detach()
        if inv_uniform:
            inv_z = 1.0 / z_vals
            inv_mid = 0.5 * (inv_z[:, 1:] + inv_z[:, :-1])
            w = weights[:, 1:-1]
            inv_samples = sample_pdf(torch.flip(inv_mid, dims=[1]), torch.flip(w, dims=[1]), n_importance,
                                     det=det, uniforms=u_pdf, generator=generator)
            z_samples = 1.0 / inv_samples
        else:
            z_mid = 0.5 * (z_vals[:, 1:] + z_vals[:, :-1])
            z_samples = sample_pdf(z_mid, weights[:, 1:-1], n_importance, det=det, uniforms=u_pdf,
                                   generator=generator)

        z_all = torch.sort(torch.cat([z_vals, z_samples], dim=-1), dim=-1).values
        pts = z_all[..., None] * ray_batch["ray_d"][:, None, :] + ray_batch["ray_o"][:, None, :]
        rgb_feat, ray_diff, mask = project_and_gather(
            pts, ray_batch["camera"], ray_batch["src_rgbs"], ray_batch["src_cameras"], feat_maps[1],
            rel_poses=rel_poses,
        )
        pixel_mask = torch.sum(mask[..., 0], dim=2) > 1
        raw_fine = apply_fine(rgb_feat, ray_diff, mask)
        ret["outputs_fine"] = raw2outputs(raw_fine, z_all, pixel_mask, white_bkgd)

    return ret


def render_image(ray_batch_full: dict, apply_coarse: Callable, feat_maps, n_samples: int,
                 chunk_size: int = 2048, uniforms=None, generator=None, **kwargs):
    """Chunked whole-image rendering (the reference's render_image.py:22-113):
    the rays are padded with zeros to whole chunks of `chunk_size` and the
    chunks rendered one after another (the JAX package's lax.map). uniforms:
    None or one `render_rays` uniforms tuple per chunk. Returns the coarse
    rgb (n, 3) and depth (n,) of the unpadded rays."""
    n_rays = ray_batch_full["ray_o"].shape[0]
    n_chunks = -(-n_rays // chunk_size)
    pad = n_chunks * chunk_size - n_rays

    def pad0(x):
        return torch.cat([x, x.new_zeros(pad, *x.shape[1:])]) if pad else x

    rays_o = pad0(ray_batch_full["ray_o"]).reshape(n_chunks, chunk_size, 3)
    rays_d = pad0(ray_batch_full["ray_d"]).reshape(n_chunks, chunk_size, 3)
    rgbs, depths = [], []
    for c in range(n_chunks):
        rb = {**ray_batch_full, "ray_o": rays_o[c], "ray_d": rays_d[c]}
        out = render_rays(rb, apply_coarse, feat_maps, n_samples,
                          uniforms=None if uniforms is None else uniforms[c], generator=generator,
                          **kwargs)["outputs_coarse"]
        rgbs.append(out["rgb"])
        depths.append(out["depth"])
    return torch.cat(rgbs)[:n_rays], torch.cat(depths)[:n_rays]
