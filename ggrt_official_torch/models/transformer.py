"""Transformer primitives (reference pixelsplat/transformer/ and
encodings/positional_encoding.py).

Module names follow the reference checkpoint keys: `layers.{i}.0` is the
pre-normed attention (`.norm`, `.fn.to_q` / `.fn.to_kv` / `.fn.to_qkv`,
`.fn.to_out.0`) and `layers.{i}.1` the pre-normed feed-forward
(`.fn.net.0`, `.fn.net.3`).

Numerics follow the JAX package, which follows flax's defaults:
LayerNorm eps 1e-6 (torch's default is 1e-5) and the tanh approximation of
GELU. Attention is an explicit matmul and softmax, as the JAX code does.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
from torch import nn

from ..constants import device_constant

LAYER_NORM_EPS = 1e-6


class PositionalEncoding(nn.Module):
    """Octave sin/cos encoding of values in [0, 1]."""

    def __init__(self, num_octaves: int):
        super().__init__()
        self.num_octaves = num_octaves

    def forward(self, samples: torch.Tensor) -> torch.Tensor:
        octaves = torch.arange(self.num_octaves, dtype=samples.dtype, device=samples.device)
        freqs = 2.0 * math.pi * 2.0**octaves  # (f,)
        phases = device_constant((0.0, 0.5 * math.pi), samples.dtype, samples.device)
        # (..., d) -> (..., d, f, p) -> (..., d*f*p)
        angle = samples[..., None, None] * freqs[:, None] + phases[None, :]
        return torch.sin(angle).reshape(*samples.shape[:-1], -1)

    def d_out(self, dimensionality: int) -> int:
        return self.num_octaves * 2 * dimensionality


class Attention(nn.Module):
    """Multi-head attention; cross-attention when `selfatt=False`."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 selfatt: bool = True, kv_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        self.heads = heads
        self.dim_head = dim_head
        self.selfatt = selfatt
        if selfatt:
            self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        else:
            self.to_q = nn.Linear(dim, inner, bias=False)
            self.to_kv = nn.Linear(kv_dim or dim, inner * 2, bias=False)
        self.to_out = None
        if not (heads == 1 and dim_head == dim):
            self.to_out = nn.Sequential(nn.Linear(inner, dim))

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.selfatt:
            q, k, v = self.to_qkv(x).chunk(3, dim=-1)
        else:
            q = self.to_q(x)
            k, v = self.to_kv(z).chunk(2, dim=-1)

        def split_heads(t):
            b, n, _ = t.shape
            return t.reshape(b, n, self.heads, self.dim_head).transpose(1, 2)

        q, k, v = map(split_heads, (q, k, v))
        dots = torch.matmul(q, k.transpose(-1, -2)) * (self.dim_head**-0.5)
        attn = torch.softmax(dots, dim=-1)
        out = torch.matmul(attn, v)
        b, h, n, d = out.shape
        out = out.transpose(1, 2).reshape(b, n, h * d)
        return out if self.to_out is None else self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, dim: int, hidden_dim: int):
        super().__init__()
        # The reference's Sequential(Linear, GELU, Dropout, Linear, Dropout);
        # dropout is 0, so its slot holds an Identity and keeps the indices.
        self.net = nn.Sequential(
            nn.Linear(dim, hidden_dim), nn.GELU(approximate="tanh"), nn.Identity(),
            nn.Linear(hidden_dim, dim),
        )

    def forward(self, x: torch.Tensor, **_) -> torch.Tensor:
        return self.net(x)


class PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.fn = fn


class Transformer(nn.Module):
    """Pre-norm transformer; `feed_forward_factory` lets the epipolar
    transformer substitute its conv feed-forward."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 selfatt: bool = True, kv_dim: Optional[int] = None,
                 feed_forward_factory: Optional[Callable[[], nn.Module]] = None):
        super().__init__()
        self.layers = nn.ModuleList()
        for _ in range(depth):
            ff = FeedForward(dim, mlp_dim) if feed_forward_factory is None else feed_forward_factory()
            self.layers.append(nn.ModuleList([
                PreNorm(dim, Attention(dim, heads, dim_head, selfatt, kv_dim)),
                PreNorm(dim, ff),
            ]))

    def forward(self, x: torch.Tensor, z: Optional[torch.Tensor] = None, **ff_kwargs) -> torch.Tensor:
        for attn, ff in self.layers:
            x = x + attn.fn(attn.norm(x), z=z)
            x = x + ff.fn(ff.norm(x), **ff_kwargs)
        return x
