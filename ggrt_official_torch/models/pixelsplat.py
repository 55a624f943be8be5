"""PixelSplat: pairwise context encoding -> Gaussians -> decode (reference
pixelsplat/pixelsplat.py:127-270).

The reference loops over adjacent view pairs; here the pairs are stacked on
the batch axis and encoded in as few calls as `MAX_PIXELS_PER_CALL` allows
(one at 320x448, one pair a call at 640x960) — the same math, since the
encoder never mixes batch entries.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..config import DecoderCfg, EncoderCfg
from ..utils.tracing import span
from ..weights import init_flax_defaults
from .decoder_splatting import DecoderOutput, DecoderSplatting
from .encoder_epipolar import EncoderEpipolar
from .gaussian_adapter import Gaussians


# The context pixels one encoder call takes at most. A call's activations
# grow with its pixels: 4 pairs at 640x960 in one call (4,915,200 pixels)
# peak at 75.2 GiB of an H100's 79.2 under inference mode. Above this, the
# pairs are encoded in groups and their Gaussians concatenated.
MAX_PIXELS_PER_CALL = 1 << 21


def make_pair_batch(context: dict, order: Optional[Sequence[int]] = None) -> dict:
    """Stack the v-1 adjacent view pairs onto the batch axis: (b, v, ...)
    tensors become (b*(v-1), 2, ...). `order` optionally permutes the views
    first (the reference sorts them by frame index, pixelsplat.py:177-184);
    it is a host sequence of view indices, so that no index is copied to
    the device."""
    v = context["image"].shape[1]

    def cut(t):
        if order is not None:
            t = torch.stack([t[:, int(k)] for k in order], dim=1)
        pairs = torch.stack([t[:, k:k + 2] for k in range(v - 1)], dim=1)
        return pairs.reshape(-1, 2, *t.shape[2:])

    return {k: cut(x) for k, x in context.items() if isinstance(x, torch.Tensor)}


def merge_pair_gaussians(g: Gaussians, batch: int) -> Gaussians:
    """(b*(v-1), n, ...) -> (b, (v-1)*n, ...)."""
    return Gaussians(*(t.reshape(batch, -1, *t.shape[2:]) for t in g))


class PixelSplat(nn.Module):
    """Encoder + parameter-free decoder; the parameters are exactly the
    encoder's ('gaussian' component of the reference checkpoints, under
    `encoder.`)."""

    def __init__(self, encoder_cfg: EncoderCfg, decoder_cfg: DecoderCfg,
                 device="cuda", generator: Optional[torch.Generator] = None):
        """Builds the model with flax's default initialisers drawn from
        `generator` (seed 0 when None) and moves it to `device`.

        On a CUDA device this also turns TF32 off for cuDNN convolutions and
        cuBLAS matmuls, process-wide: the reference computes in float32 and
        TF32 keeps about three decimal digits.
        """
        super().__init__()
        self.encoder = EncoderEpipolar(encoder_cfg)
        self.decoder = DecoderSplatting(decoder_cfg)
        init_flax_defaults(self, generator or torch.Generator().manual_seed(0))
        device = torch.device(device)
        if device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.to(device)

    @span("encoder", device=True)
    def encode_pairs(self, context: dict, global_step, deterministic: bool = False,
                     uniforms: Optional[torch.Tensor] = None, order: Optional[Sequence[int]] = None,
                     features: Optional[torch.Tensor] = None,
                     crop: Optional[tuple[int, int, int]] = None) -> Gaussians:
        """Encode all adjacent context pairs into one merged Gaussian set,
        in groups of at most MAX_PIXELS_PER_CALL context pixels a call.
        `features` (b, v, h, w, d) are the context views' backbone features
        (encode_features); `crop` encodes one tile (EncoderEpipolar)."""
        b = context["image"].shape[0]
        pairs = make_pair_batch(context, order)
        pair_feats = None
        if features is not None:
            pair_feats = make_pair_batch({"image": features}, order)["image"]
        n, _, _, h, w = pairs["image"].shape
        group = max(1, MAX_PIXELS_PER_CALL // (2 * h * w))

        def part(t, lo):
            return None if t is None else t[lo:lo + group]
        parts = [self.encoder({k: x[lo:lo + group] for k, x in pairs.items()}, global_step,
                              deterministic=deterministic, uniforms=part(uniforms, lo),
                              features=part(pair_feats, lo), crop=crop)
                 for lo in range(0, n, group)]
        g = parts[0] if len(parts) == 1 else Gaussians(*(torch.cat(ts, dim=0) for ts in zip(*parts)))
        return merge_pair_gaussians(g, b)

    def encode_features(self, context: dict, global_step) -> torch.Tensor:
        """The backbone's projected features of the context views (b, v, h,
        w, d), for encode_pairs(features=...)."""
        return self.encoder(context, global_step, just_return_features=True)

    def forward(
        self,
        batch: dict,
        global_step,
        deterministic: bool = False,
        uniforms: Optional[torch.Tensor] = None,
        depth_mode: Optional[str] = "depth",
        crop: Optional[tuple[int, int, int]] = None,
    ) -> tuple[dict, dict]:
        """Returns (ret, target_gt): ret['rgb'] (b, v_t, 3, h, w) and
        ret['depth'] (b, v_t, h, w) (None without `depth_mode`), as the
        reference does. With `crop` only one tile's Gaussians are encoded,
        and the whole target view is rendered from them."""
        target = batch["target"]
        h, w = target["image"].shape[-2:]
        gaussians = self.encode_pairs(batch["context"], global_step, deterministic=deterministic,
                                      uniforms=uniforms, crop=crop)
        out: DecoderOutput = self.decoder(
            gaussians, target["extrinsics"], target["intrinsics"],
            target["near"], target["far"], (h, w), depth_mode=depth_mode,
        )
        return {"rgb": out.color, "depth": out.depth}, {"rgb": target["image"]}
