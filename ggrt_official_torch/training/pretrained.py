"""Pretrained trunk weights (the JAX package's training/pretrained.py).

The reference starts its encoders from torchvision ImageNet ResNets
(feature_network.py:325-335, with conv1 replicated across
num_input_images and divided) and from dino_resnet50 (backbone_dino.py:21).
No machine here has network access, so the weights arrive as .npz files
converted offline. The converters below turn a torchvision-style ResNet
state_dict into the JAX package's flax trees, and the .npz files hold
those trees, so a file either package writes loads in both. Loading reads
a tree back through the port's name maps (weights.py) into the modules:
leaves the tree lacks, and leaves of another shape (cnet_pose's 6-channel
conv1 against a 3-channel kernel), keep their values, as the reference's
strict=False load does.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch
from torch import nn

from ..weights import _from_flax, backbone_resnet_name_map, resnet_encoder_name_map
from .convert import convert_tensor


def _tree(state_dict: dict, rows) -> dict:
    """The nested flax tree of the rows whose torch key the state_dict has."""
    out: dict = {}
    for key, path, kind in rows:
        if key not in state_dict:
            continue
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = convert_tensor(kind, state_dict[key])
    return out


def convert_torchvision_resnet_for_backbone(state_dict: dict, model: str = "resnet50",
                                            num_layers: int = 5) -> dict:
    """torchvision ResNet state_dict -> the BackboneResnet trunk's flax tree.
    The 1x1 projections are GGRt's own and keep their initial values."""
    rows = [(k.removeprefix("model."), path, kind)
            for k, path, kind in backbone_resnet_name_map(model, num_layers) if k.startswith("model.")]
    return _tree(state_dict, rows)


def convert_imagenet_resnet_for_ipo(state_dict: dict, num_input_images: int = 1, stride: int = 8) -> dict:
    """torchvision resnet18 state_dict -> an IPO-Net ResNetEncoder's flax
    tree, conv1 replicated across the input images and divided
    (feature_network.py:326-328). The upsampling heads keep their values."""
    sd = dict(state_dict)
    if num_input_images > 1:
        w = np.asarray(sd["conv1.weight"])
        sd["conv1.weight"] = np.concatenate([w] * num_input_images, axis=1) / num_input_images
    return _tree(sd, resnet_encoder_name_map("resnet18", stride=stride))


def save_pretrained_npz(path: str, converted: dict) -> None:
    np.savez(path, params=np.asarray(converted, dtype=object))


def load_pretrained_npz(path: str) -> dict:
    """A converted tree from an .npz that a converter of this package or of
    the JAX package wrote (a pickled dict: only load files made so)."""
    with np.load(path, allow_pickle=True) as loaded:
        return loaded["params"].item()


@torch.no_grad()
def load_tree(module: nn.Module, tree: dict, rows) -> int:
    """Copy the tree's leaves into `module`'s parameters and buffers by the
    name-map rows; returns how many were copied."""
    state = module.state_dict()
    copied = 0
    for key, path, kind in rows:
        node = tree
        for part in path:
            if not isinstance(node, dict) or part not in node:
                break
            node = node[part]
        else:
            value = torch.as_tensor(np.ascontiguousarray(_from_flax(kind, np.asarray(node))))
            if key in state and tuple(value.shape) == tuple(state[key].shape):
                state[key].copy_(value)
                copied += 1
    return copied


def maybe_load_backbone(module: nn.Module, npz_path: str | None, rows) -> bool:
    """Load a converted tree from `npz_path` into `module`. No path, or a
    file that does not exist (with a warning), leaves it untouched."""
    if not npz_path:
        return False
    if not os.path.exists(npz_path):
        warnings.warn(f"[pretrained] {npz_path} not found — training from scratch", stacklevel=2)
        return False
    return load_tree(module, load_pretrained_npz(npz_path), rows) > 0


def load_pretrained_trunks(model, cfg) -> None:
    """The trunks of a GGRtModel from cfg.encoder.backbone.pretrained_path
    (the PixelSplat backbone) and cfg.iponet.pretrained_path (IPO-Net's
    fnet, cnet_depth and cnet_pose), as the JAX package's init_full does."""
    bb = cfg.encoder.backbone
    if maybe_load_backbone(model.gaussian.encoder.backbone, bb.pretrained_path,
                           backbone_resnet_name_map(bb.model, bb.num_layers)):
        print(f"[pretrained] loaded encoder backbone from {bb.pretrained_path}")
    ip = cfg.iponet.pretrained_path
    rows = resnet_encoder_name_map("resnet18", stride=cfg.iponet.feat_ratio)
    loaded = [maybe_load_backbone(getattr(model.pose_learner, net), ip, rows)
              for net in ("fnet", "cnet_depth", "cnet_pose")]
    if loaded[-1]:
        print(f"[pretrained] loaded IPO trunks from {ip}")
