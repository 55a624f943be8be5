"""Weights: flax params -> the port's state_dict, and flax's default
initialisers for freshly built modules.

The name map is a private copy of the rows the JAX package's
training/convert.py builds for the pixelSplat encoder
(`encoder_name_map`, `backbone_resnet_name_map` and their helpers), read in
reverse: each row is (reference torch key, flax path, kind), and the port's
module names ARE the reference torch keys, so a row maps one flax leaf onto
one entry of the port's state_dict. Layout conversions, the inverse of
convert.py's:

  flax Dense kernel (in, out)            -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)     -> torch Conv2d weight (out, in, kh, kw)
  flax ConvTranspose (kh, kw, in, out)   -> torch ConvTranspose2d (in, out, kh, kw),
                                            spatially flipped: flax does not flip
                                            the kernel, torch does
  flax LayerNorm scale/bias              -> torch weight/bias
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

_RESNET_BLOCKS = {"resnet18": (2, 2, 2, 2), "resnet34": (3, 4, 6, 3),
                  "resnet50": (3, 4, 6, 3), "dino_resnet50": (3, 4, 6, 3)}


# --- name-map rows (copied from training/convert.py) -----------------------

def dense_map(torch_prefix: str, flax_path: tuple[str, ...]):
    return [
        (f"{torch_prefix}.weight", (*flax_path, "kernel"), "dense"),
        (f"{torch_prefix}.bias", (*flax_path, "bias"), "bias"),
    ]


def conv_map(torch_prefix: str, flax_path: tuple[str, ...], bias: bool = True):
    rows = [(f"{torch_prefix}.weight", (*flax_path, "kernel"), "conv")]
    if bias:
        rows.append((f"{torch_prefix}.bias", (*flax_path, "bias"), "bias"))
    return rows


def ln_map(torch_prefix: str, flax_path: tuple[str, ...]):
    return [
        (f"{torch_prefix}.weight", (*flax_path, "scale"), "raw"),
        (f"{torch_prefix}.bias", (*flax_path, "bias"), "raw"),
    ]


def conv_transpose_map(torch_prefix: str, flax_path: tuple[str, ...]):
    return [
        (f"{torch_prefix}.weight", (*flax_path, "kernel"), "conv_transpose"),
        (f"{torch_prefix}.bias", (*flax_path, "bias"), "bias"),
    ]


def transformer_name_map(torch_prefix, flax_path, depth, selfatt=True, conv_ff=False, sa_cfg=None):
    """srt Transformer: layers.{i}.0 = pre-normed attention, layers.{i}.1 =
    pre-normed feed-forward."""
    rows: list = []
    for i in range(depth):
        a = f"{torch_prefix}.layers.{i}.0"
        rows += ln_map(f"{a}.norm", (*flax_path, f"attn_norm_{i}"))
        if selfatt:
            rows.append((f"{a}.fn.to_qkv.weight", (*flax_path, f"attn_{i}", "to_qkv", "kernel"), "dense"))
        else:
            rows.append((f"{a}.fn.to_q.weight", (*flax_path, f"attn_{i}", "to_q", "kernel"), "dense"))
            rows.append((f"{a}.fn.to_kv.weight", (*flax_path, f"attn_{i}", "to_kv", "kernel"), "dense"))
        rows += dense_map(f"{a}.fn.to_out.0", (*flax_path, f"attn_{i}", "to_out"))
        f = f"{torch_prefix}.layers.{i}.1"
        rows += ln_map(f"{f}.norm", (*flax_path, f"ff_norm_{i}"))
        if conv_ff:
            rows += conv_map(f"{f}.fn.layers.0", (*flax_path, f"ff_{i}", "conv1"))
            rows += conv_map(f"{f}.fn.layers.3", (*flax_path, f"ff_{i}", "conv2"))
            rows += image_self_attention_name_map(
                f"{f}.fn.self_attention", (*flax_path, f"ff_{i}", "self_attn"), sa_cfg
            )
        else:
            rows += dense_map(f"{f}.fn.net.0", (*flax_path, f"ff_{i}", "Dense_0"))
            rows += dense_map(f"{f}.fn.net.3", (*flax_path, f"ff_{i}", "Dense_1"))
    return rows


def image_self_attention_name_map(torch_prefix, flax_path, cfg):
    rows: list = []
    rows += dense_map(f"{torch_prefix}.positional_encoding.1", (*flax_path, "pos_proj"))
    rows += conv_map(f"{torch_prefix}.patch_embedder.0", (*flax_path, "patch_embedder"))
    rows += transformer_name_map(
        f"{torch_prefix}.transformer", (*flax_path, "transformer"),
        cfg.num_layers, selfatt=True, conv_ff=False,
    )
    rows += conv_transpose_map(f"{torch_prefix}.resampler", (*flax_path, "resampler"))
    return rows


def epipolar_transformer_name_map(cfg, torch_prefix="epipolar_transformer",
                                  flax_path=("epipolar_transformer",)):
    rows: list = []
    if cfg.num_octaves > 0:
        rows += dense_map(f"{torch_prefix}.depth_encoding.1", (*flax_path, "depth_proj"))
    rows += transformer_name_map(
        f"{torch_prefix}.transformer", (*flax_path, "transformer"),
        cfg.num_layers, selfatt=False, conv_ff=True, sa_cfg=cfg.self_attention,
    )
    if cfg.downscale:
        rows += conv_map(f"{torch_prefix}.downscaler", (*flax_path, "downscaler"))
        rows += conv_transpose_map(f"{torch_prefix}.upscaler", (*flax_path, "upscaler"))
        rows += conv_map(f"{torch_prefix}.upscale_refinement.0", (*flax_path, "refine1"))
        rows += conv_map(f"{torch_prefix}.upscale_refinement.2", (*flax_path, "refine2"))
    return rows


def trunk_block_map(stage, block, bottleneck=True, downsample=False,
                    torch_root="backbone.model", flax_root=("backbone", "trunk")):
    """torchvision layer{stage}.{block} -> trunk layer{stage}_block{block};
    instance norm, so the norms carry no parameters."""
    t = f"{torch_root}.layer{stage}.{block}"
    f = (*flax_root, f"layer{stage}_block{block}")
    n_convs = 3 if bottleneck else 2
    rows = []
    for c in range(1, n_convs + 1):
        rows += conv_map(f"{t}.conv{c}", (*f, f"Conv_{c-1}"), bias=False)
    if downsample:
        rows += conv_map(f"{t}.downsample.0", (*f, f"Conv_{n_convs}"), bias=False)
    return rows


def backbone_resnet_name_map(model: str = "resnet50", num_layers: int = 5):
    layers = _RESNET_BLOCKS[model]
    bottleneck = model in ("resnet50", "dino_resnet50")
    rows = conv_map("model.conv1", ("trunk", "conv1"), bias=False)
    for stage in range(1, num_layers):
        for b in range(layers[stage - 1]):
            ds = b == 0 and (stage > 1 or bottleneck)
            rows += trunk_block_map(stage, b, bottleneck=bottleneck, downsample=ds,
                                    torch_root="model", flax_root=("trunk",))
    for i in range(num_layers):
        rows += conv_map(f"projections.layer{i}", (f"projection{i}",))
    return rows


def prefix_map(rows, torch_prefix: str, flax_prefix: tuple[str, ...]):
    return [(f"{torch_prefix}.{k}", (*flax_prefix, *p), kind) for (k, p, kind) in rows]


def encoder_name_map(cfg) -> list[tuple[str, tuple[str, ...], str]]:
    """Every parameter of EncoderEpipolar: (torch key, flax path, kind)."""
    rows: list = []
    rows += dense_map("backbone_projection.1", ("backbone_projection",))
    rows += dense_map("depth_predictor.projection.1", ("depth_predictor", "projection"))
    rows += dense_map("to_gaussians.1", ("to_gaussians",))
    rows += conv_map("high_resolution_skip.0", ("high_resolution_skip",))
    rows += prefix_map(
        backbone_resnet_name_map(cfg.backbone.model, cfg.backbone.num_layers),
        "backbone", ("backbone",),
    )
    if cfg.use_epipolar_transformer:
        rows += epipolar_transformer_name_map(cfg.epipolar_transformer)
    if cfg.predict_opacity:
        rows += dense_map("to_opacity.1", ("to_opacity",))
    return rows


# --- conversion -------------------------------------------------------------

def _from_flax(kind: str, value: np.ndarray) -> np.ndarray:
    if kind == "dense":
        return value.T
    if kind == "conv":
        return np.transpose(value, (3, 2, 0, 1))
    if kind == "conv_transpose":
        return np.transpose(value[::-1, ::-1], (2, 3, 0, 1))
    if kind in ("bias", "raw"):
        return value
    raise ValueError(kind)


def params_from_jax(flax_params: dict, encoder_cfg) -> dict:
    """flax PixelSplat params (nested dicts of numpy arrays, as
    `model.init` returns them, with or without the 'params' level) -> a
    state_dict for the port's PixelSplat."""
    tree = flax_params.get("params", flax_params)["encoder"]
    state = {}
    for key, path, kind in encoder_name_map(encoder_cfg):
        node = tree
        for part in path:
            node = node[part]
        state["encoder." + key] = torch.tensor(np.ascontiguousarray(_from_flax(kind, np.asarray(node))))
    return state


# --- flax default initialisers ---------------------------------------------

def _lecun_normal_(weight: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's lecun_normal: variance_scaling(1, 'fan_in', 'truncated_normal'),
    a normal truncated at ±2σ whose std is corrected for the truncation."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std, generator=generator)


@torch.no_grad()
def init_flax_defaults(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every Linear, Conv2d and ConvTranspose2d as flax does by
    default (lecun-normal kernels over the kernel's fan-in, zero biases);
    LayerNorms start at weight 1, bias 0 in both."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            fan_in = m.in_features
        elif isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            fan_in = m.in_channels * m.kernel_size[0] * m.kernel_size[1]
        else:
            continue
        _lecun_normal_(m.weight, fan_in, generator)
        if m.bias is not None:
            m.bias.zero_()
