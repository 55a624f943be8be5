"""Weights: flax params -> the port's state_dict, and flax's default
initialisers for freshly built modules.

The name map is a private copy of the rows the JAX package's
training/convert.py builds for the pixelSplat encoder
(`encoder_name_map`, `backbone_resnet_name_map` and their helpers) and for
IPO-Net (`depth_pose_net_name_map`, `resnet_encoder_name_map`,
`sep_conv_gru_map`, `bn_map`), read in reverse: each row is (reference torch key, flax path, kind), and the port's
module names ARE the reference torch keys, so a row maps one flax leaf onto
one entry of the port's state_dict. Layout conversions, the inverse of
convert.py's:

  flax Dense kernel (in, out)            -> torch Linear weight (out, in)
  flax Conv kernel (kh, kw, in, out)     -> torch Conv2d weight (out, in, kh, kw)
  flax ConvTranspose (kh, kw, in, out)   -> torch ConvTranspose2d (in, out, kh, kw),
                                            spatially flipped: flax does not flip
                                            the kernel, torch does
  flax LayerNorm scale/bias              -> torch weight/bias
  flax FrozenBatchNorm scale/bias/mean/var -> torch weight/bias/running_mean/running_var
  flax GroupNorm scale/bias               -> torch weight/bias
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


def bn_map(torch_prefix: str, flax_path: tuple[str, ...]):
    """torch BatchNorm2d / the port's FrozenBatchNorm -> flax FrozenBatchNorm."""
    return [
        (f"{torch_prefix}.weight", (*flax_path, "scale"), "raw"),
        (f"{torch_prefix}.bias", (*flax_path, "bias"), "raw"),
        (f"{torch_prefix}.running_mean", (*flax_path, "mean"), "raw"),
        (f"{torch_prefix}.running_var", (*flax_path, "var"), "raw"),
    ]


# GroupNorm's weight/bias map as LayerNorm's (scale/bias).
_NORM_MAPS = {"batch": (bn_map, "FrozenBatchNorm"), "group": (ln_map, "GroupNorm")}


def trunk_block_map(stage, block, bottleneck=True, downsample=False,
                    torch_root="backbone.model", flax_root=("backbone", "trunk"),
                    norm="instance"):
    """torchvision layer{stage}.{block} -> trunk layer{stage}_block{block}.
    Instance norm carries no parameters; with batch or group norm (the
    IPO-Net encoder) bn{c} and downsample.1 map onto FrozenBatchNorm_{i} or
    GroupNorm_{i}, numbered in flax's creation order (Conv_0, ..._0, ...)."""
    t = f"{torch_root}.layer{stage}.{block}"
    f = (*flax_root, f"layer{stage}_block{block}")
    n_convs = 3 if bottleneck else 2
    norm_map, flax_name = _NORM_MAPS.get(norm, (None, None))
    rows = []
    for c in range(1, n_convs + 1):
        rows += conv_map(f"{t}.conv{c}", (*f, f"Conv_{c-1}"), bias=False)
        if norm_map:
            rows += norm_map(f"{t}.bn{c}", (*f, f"{flax_name}_{c-1}"))
    if downsample:
        rows += conv_map(f"{t}.downsample.0", (*f, f"Conv_{n_convs}"), bias=False)
        if norm_map:
            rows += norm_map(f"{t}.downsample.1", (*f, f"{flax_name}_{n_convs}"))
    return rows


def resnet_encoder_name_map(model: str = "resnet18", stride: int = 8, norm: str = "batch"):
    """The IPO-Net ResNetEncoder (basic blocks) with the `norm` kind of
    models/backbone.make_norm."""
    rows = conv_map("conv1", ("conv1",), bias=False)
    if norm in _NORM_MAPS:
        rows += _NORM_MAPS[norm][0]("bn1", ("norm1",))
    for stage in (1, 2, 3):
        for b in range(_RESNET_BLOCKS[model][stage - 1]):
            rows += trunk_block_map(stage, b, bottleneck=False, downsample=(stage > 1 and b == 0),
                                    torch_root="", flax_root=(), norm=norm)
    rows = [(k.lstrip("."), p, kind) for (k, p, kind) in rows]
    for name in ("upconv1", "upconv1_fusion") + (("upconv2", "upconv2_fusion") if stride == 4 else ()):
        rows += conv_map(f"{name}.0", (name,))
    rows += conv_map("out_conv", ("out_conv",))
    return rows


def sep_conv_gru_map(torch_prefix: str, flax_path: tuple[str, ...]):
    rows = []
    for name in ("convz1", "convr1", "convq1", "convz2", "convr2", "convq2"):
        rows += conv_map(f"{torch_prefix}.{name}", (*flax_path, name))
    return rows


def depth_pose_net_name_map(stride: int = 8):
    """Every parameter of IPONet: feature and context trunks, init heads,
    the upsampling-mask net and both GRU update blocks."""
    rows: list = []
    enc = resnet_encoder_name_map("resnet18", stride=stride)
    for net in ("fnet", "cnet_depth", "cnet_pose"):
        rows += prefix_map(enc, net, (net,))
    rows += conv_map("depth_head.conv1", ("depth_head", "conv1"))
    rows += conv_map("depth_head.conv2", ("depth_head", "conv2"))
    rows += conv_map("pose_head.conv1_pose", ("pose_head", "conv1"))
    rows += conv_map("pose_head.conv2_pose", ("pose_head", "conv2"))
    rows += conv_map("upmask_net.mask.0", ("upmask_net", "conv1"))
    rows += conv_map("upmask_net.mask.2", ("upmask_net", "conv2"))
    d = "update_block_depth"
    for c in ("convc1", "convc2", "convd1", "convd2", "convd"):
        rows += conv_map(f"{d}.encoder.{c}", (d, "encoder", c))
    rows += sep_conv_gru_map(f"{d}.depth_gru", (d, "depth_gru"))
    rows += conv_map(f"{d}.depth_head.conv1", (d, "depth_head", "conv1"))
    rows += conv_map(f"{d}.depth_head.conv2", (d, "depth_head", "conv2"))
    rows += conv_map(f"{d}.mask.0", (d, "mask1"))
    rows += conv_map(f"{d}.mask.2", (d, "mask2"))
    p = "update_block_pose"
    for c in ("convc1", "convc2", "convp1", "convp2", "convp"):
        rows += conv_map(f"{p}.encoder.{c}", (p, "encoder", c))
    rows += sep_conv_gru_map(f"{p}.pose_gru", (p, "pose_gru"))
    rows += conv_map(f"{p}.pose_head.conv1_pose", (p, "pose_head", "conv1"))
    rows += conv_map(f"{p}.pose_head.conv2_pose", (p, "pose_head", "conv2"))
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


def encoder_name_map(cfg=None) -> list[tuple[str, tuple[str, ...], str]]:
    """Every parameter of EncoderEpipolar: (torch key, flax path, kind).
    With cfg None, only the heads and the five backbone projections, the
    JAX converter's partial map (its convert.py:177-180)."""
    rows: list = []
    rows += dense_map("backbone_projection.1", ("backbone_projection",))
    rows += dense_map("depth_predictor.projection.1", ("depth_predictor", "projection"))
    rows += dense_map("to_gaussians.1", ("to_gaussians",))
    rows += conv_map("high_resolution_skip.0", ("high_resolution_skip",))
    if cfg is None:
        for i in range(5):
            rows += conv_map(f"backbone.projections.layer{i}", ("backbone", f"projection{i}"))
        return rows
    rows += prefix_map(
        backbone_resnet_name_map(cfg.backbone.model, cfg.backbone.num_layers),
        "backbone", ("backbone",),
    )
    if cfg.use_epipolar_transformer:
        rows += epipolar_transformer_name_map(cfg.epipolar_transformer)
    if cfg.predict_opacity:
        rows += dense_map("to_opacity.1", ("to_opacity",))
    return rows


# --- the legacy IBRNet / DBARF / NeRF / BARF path ----------------------------
# The port's module names there are the flax names, except the norms
# (flax's scale -> weight) and the basic block's auto-named children.

def ibrnet_name_map(anti_alias_pooling: bool = True):
    """Every parameter of models/ibrnet.IBRNet."""
    rows: list = []
    for name in ("ray_dir_fc0", "ray_dir_fc1", "base_fc0", "base_fc1", "vis_fc0", "vis_fc1", "vis_fc2_0",
                 "vis_fc2_1", "geometry_fc0", "geometry_fc1", "out_geometry_fc0", "out_geometry_fc1",
                 "rgb_fc0", "rgb_fc1", "rgb_fc2"):
        rows += dense_map(name, (name,))
    if anti_alias_pooling:
        rows.append(("s", ("s",), "raw"))
    for name in ("w_qs", "w_ks", "w_vs", "fc"):
        rows.append((f"ray_attention.{name}.weight", ("ray_attention", name, "kernel"), "dense"))
    rows += ln_map("ray_attention.layer_norm", ("ray_attention", "LayerNorm_0"))
    return rows


def resunet_name_map():
    """Every parameter of models/feature_unet.ResUNet. A basic block's
    children are flax's Conv_i / AffineInstanceNorm_i in creation order:
    conv1, norm1, conv2, norm2, then the projection where there is one."""
    rows = conv_map("conv1", ("conv1",), bias=False) + ln_map("norm1", ("norm1",))
    for stage, n_blocks in (("layer1", 3), ("layer2", 4), ("layer3", 6)):
        for b in range(n_blocks):
            block = f"{stage}_b{b}"
            children = [("conv1", "norm1"), ("conv2", "norm2")] + ([("downsample", "downsample_norm")] if b == 0 else [])
            for i, (conv, norm) in enumerate(children):
                rows += conv_map(f"{block}.{conv}", (block, f"Conv_{i}"), bias=False)
                rows += ln_map(f"{block}.{norm}", (block, f"AffineInstanceNorm_{i}"))
    for name in ("upconv3", "iconv3", "upconv2", "iconv2"):
        rows += conv_map(name, (name,)) + ln_map(f"{name}_norm", (f"{name}_norm",))
    rows += conv_map("out_conv", ("out_conv",))
    return rows


def ibrnet_model_name_map(coarse_only: bool = True):
    """Every parameter of models/dbarf.IBRNetModel."""
    rows = prefix_map(ibrnet_name_map(), "net_coarse", ("net_coarse",))
    if not coarse_only:
        rows += prefix_map(ibrnet_name_map(), "net_fine", ("net_fine",))
    return rows + prefix_map(resunet_name_map(), "feature_net", ("feature_net",))


def dbarf_name_map(iponet_cfg, coarse_only: bool = True):
    """Every parameter of models/dbarf.DBARFModel: the IBRNet model and the
    IPO-Net rows of `depth_pose_net_name_map`."""
    return (prefix_map(ibrnet_model_name_map(coarse_only), "ibrnet", ("ibrnet",))
            + prefix_map(depth_pose_net_name_map(iponet_cfg.feat_ratio), "pose_learner", ("pose_learner",)))


def nerf_mlp_name_map(depth: int = 8):
    """Every parameter of models/nerf.NeRFMLP."""
    rows: list = []
    for name in [f"fc{i}" for i in range(depth)] + ["sigma", "feat", "rgb_fc", "rgb"]:
        rows += dense_map(name, (name,))
    return rows


def barf_name_map(depth: int = 8):
    """Every parameter of models/nerf.BARFModel."""
    return prefix_map(nerf_mlp_name_map(depth), "nerf", ("nerf",)) + [("pose_refine", ("pose_refine",), "raw")]


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


def _convert(tree: dict, rows, prefix: str) -> dict:
    state = {}
    for key, path, kind in rows:
        node = tree
        for part in path:
            node = node[part]
        value = _from_flax(kind, np.asarray(node))
        state[prefix + key] = torch.tensor(np.ascontiguousarray(value).reshape(value.shape))
    return state


def params_from_jax(flax_params: dict, encoder_cfg) -> dict:
    """flax PixelSplat params (nested dicts of numpy arrays, as
    `model.init` returns them, with or without the 'params' level) -> a
    state_dict for the port's PixelSplat."""
    tree = flax_params.get("params", flax_params)["encoder"]
    return _convert(tree, encoder_name_map(encoder_cfg), "encoder.")


def iponet_params_from_jax(flax_params: dict, iponet_cfg) -> dict:
    """flax IPONet params -> a state_dict for the port's IPONet."""
    tree = flax_params.get("params", flax_params)
    return _convert(tree, depth_pose_net_name_map(iponet_cfg.feat_ratio), "")


def ggrt_params_from_jax(flax_params: dict, cfg) -> dict:
    """The JAX package's whole GGRtModel params, {"params": {"pose_learner",
    "gaussian"}} as numpy -> a state_dict for the port's GGRtModel."""
    tree = flax_params.get("params", flax_params)
    state = {"pose_learner." + k: v
             for k, v in iponet_params_from_jax(tree["pose_learner"], cfg.iponet).items()}
    state.update({"gaussian." + k: v for k, v in params_from_jax(tree["gaussian"], cfg.encoder).items()})
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


def _params(flax_params: dict) -> dict:
    return flax_params.get("params", flax_params)


def ibrnet_params_from_jax(flax_params: dict, anti_alias_pooling: bool = True) -> dict:
    """flax IBRNet params -> a state_dict for the port's IBRNet."""
    return _convert(_params(flax_params), ibrnet_name_map(anti_alias_pooling), "")


def resunet_params_from_jax(flax_params: dict) -> dict:
    """flax ResUNet params -> a state_dict for the port's ResUNet."""
    return _convert(_params(flax_params), resunet_name_map(), "")


def ibrnet_model_params_from_jax(flax_params: dict, coarse_only: bool = True) -> dict:
    """flax IBRNetModel params -> a state_dict for the port's IBRNetModel."""
    return _convert(_params(flax_params), ibrnet_model_name_map(coarse_only), "")


def dbarf_params_from_jax(flax_params: dict, iponet_cfg, coarse_only: bool = True) -> dict:
    """flax DBARFModel params {"ibrnet", "pose_learner"} -> a state_dict for
    the port's DBARFModel; the IPO-Net rows through `iponet_params_from_jax`."""
    tree = _params(flax_params)
    state = {"ibrnet." + k: v for k, v in ibrnet_model_params_from_jax(tree["ibrnet"], coarse_only).items()}
    state.update({"pose_learner." + k: v for k, v in iponet_params_from_jax(tree["pose_learner"], iponet_cfg).items()})
    return state


def nerf_params_from_jax(flax_params: dict, depth: int = 8) -> dict:
    """flax NeRFMLP params -> a state_dict for the port's NeRFMLP."""
    return _convert(_params(flax_params), nerf_mlp_name_map(depth), "")


def barf_params_from_jax(flax_params: dict, depth: int = 8) -> dict:
    """flax BARFModel params {"nerf", "pose_refine"} -> a state_dict for the
    port's BARFModel."""
    return _convert(_params(flax_params), barf_name_map(depth), "")
