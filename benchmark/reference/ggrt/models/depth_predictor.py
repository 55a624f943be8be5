"""Monocular depth PDF predictor (reference encoder/epipolar/
depth_predictor_monocular.py, distribution_sampler.py and
misc/discrete_probability_distribution.py).

Features -> softmax PDF over `num_samples` relative-disparity buckets plus
per-bucket sigmoid offsets; pick `gaussians_per_pixel` buckets (top-k when
deterministic, inverse-CDF sampling otherwise) and map them to metric depth.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..geometry.depth import relative_disparity_to_depth

_EPS = float(torch.finfo(torch.float32).eps)


def sample_discrete_distribution(pdf: torch.Tensor, uniforms: torch.Tensor):
    """Inverse-CDF sampling with the caller's uniform draws
    (..., num_samples) in [0, 1); returns (index, density)."""
    bucket = pdf.shape[-1]
    normalized = pdf / (_EPS + pdf.sum(dim=-1, keepdim=True))
    cdf = torch.cumsum(normalized, dim=-1)
    # searchsorted(side='right'): count the buckets whose cdf <= u.
    index = (cdf[..., :, None] <= uniforms[..., None, :]).sum(dim=-2)
    index = torch.clamp(index, 0, bucket - 1)
    return index, torch.gather(normalized, -1, index)


def gather_discrete_topk(pdf: torch.Tensor, num_samples: int):
    """The `num_samples` largest buckets, ties to the lower index as
    jax.lax.top_k breaks them (torch.topk does not promise an order)."""
    normalized = pdf / (_EPS + pdf.sum(dim=-1, keepdim=True))
    index = torch.sort(pdf, dim=-1, descending=True, stable=True).indices[..., :num_samples]
    return index, torch.gather(normalized, -1, index)


class DepthPredictorMonocular(nn.Module):
    """While `capture` holds a list, each call appends its detached depth
    PDF (b, v, r, srf, s) to it (the JAX package's "depth_pdf" sow tap);
    it is None otherwise."""

    def __init__(self, d_in: int, num_samples: int, num_surfaces: int, use_transmittance: bool):
        super().__init__()
        self.num_samples = num_samples
        self.num_surfaces = num_surfaces
        self.use_transmittance = use_transmittance
        self.projection = nn.Sequential(nn.ReLU(), nn.Linear(d_in, 2 * num_samples * num_surfaces))
        self.capture: Optional[list] = None

    def forward(
        self,
        features: torch.Tensor,  # (b, v, r, c)
        near: torch.Tensor,      # (b, v)
        far: torch.Tensor,       # (b, v)
        deterministic: bool,
        gaussians_per_pixel: int,
        uniforms: Optional[torch.Tensor] = None,  # (b, v, r, srf, gpp)
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (depths, opacities), each (b, v, r, srf, gpp)."""
        s = self.num_samples
        x = self.projection(features)
        # Reference einops "... (dpt srf c) -> c ... srf dpt": the flat
        # channel is ((dpt*srf)+srf_i)*2 + c.
        x = x.reshape(*x.shape[:-1], s, self.num_surfaces, 2)
        pdf = torch.softmax(x[..., 0].transpose(-1, -2), dim=-1)  # (b, v, r, srf, s)
        offset = torch.sigmoid(x[..., 1].transpose(-1, -2))
        if self.capture is not None:
            self.capture.append(pdf.detach())

        if deterministic:
            index, pdf_i = gather_discrete_topk(pdf, gaussians_per_pixel)
        else:
            if uniforms is None:
                raise ValueError("stochastic depth sampling needs uniform draws")
            index, pdf_i = sample_discrete_distribution(pdf, uniforms)

        offset_i = torch.gather(offset, -1, index)
        relative_disparity = (index.to(pdf.dtype) + offset_i) / s
        depth = relative_disparity_to_depth(
            relative_disparity, near[:, :, None, None, None], far[:, :, None, None, None]
        )

        if self.use_transmittance:
            partial = torch.cumsum(pdf, dim=-1)
            partial = torch.cat([torch.zeros_like(partial[..., :1]), partial[..., :-1]], dim=-1)
            opacity = torch.gather(pdf / (1.0 - partial + 1e-10), -1, index)
        else:
            opacity = pdf_i
        return depth, opacity
