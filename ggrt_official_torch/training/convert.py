"""The reference's torch checkpoints -> the port's GGRtModel state_dict (the
JAX package's training/convert.py).

The reference ships composite checkpoints (generalized_llff_best.pth):
{'pose_learner': a DepthPoseNet state_dict, 'gaussian': a PixelSplat
state_dict whose learnable keys all live under 'encoder.*'}. The port's
module names are the reference's torch keys and its layouts are torch's,
so each row (torch key, flax path, kind) of the name maps in weights.py
carries a checkpoint entry onto the state_dict entry of the same name,
unchanged. The flax path and kind serve the torch -> flax layout helpers
below, which write the flax trees that both packages read
(training/pretrained.py's .npz files):

  torch Linear weight (out, in)            -> flax Dense kernel (in, out)
  torch Conv2d weight (out, in, kh, kw)    -> flax Conv kernel (kh, kw, in, out)
  torch ConvTranspose2d (in, out, kh, kw)  -> flax ConvTranspose (kh, kw, in, out),
                                              spatially flipped
  torch LayerNorm / norm weight, bias      -> flax scale, bias
"""
from __future__ import annotations

import numpy as np
import torch

from ..weights import depth_pose_net_name_map, encoder_name_map


def linear_to_dense(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).T)


def conv_to_flax(w) -> np.ndarray:
    # (O, I, kh, kw) -> (kh, kw, I, O)
    return np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))


def conv_transpose_to_flax(w) -> np.ndarray:
    # torch (I, O, kh, kw) -> flax ConvTranspose (kh, kw, I, O), the kernel
    # flipped spatially: torch's transposed convolution correlates with the
    # flipped kernel relative to flax's.
    w = np.transpose(w, (2, 3, 0, 1))
    return np.ascontiguousarray(w[::-1, ::-1])


def convert_tensor(kind: str, value) -> np.ndarray:
    """One torch tensor or array -> its flax layout, by the row's kind."""
    value = np.asarray(value)
    if kind == "dense":
        return linear_to_dense(value)
    if kind == "conv":
        return conv_to_flax(value)
    if kind == "conv_transpose":
        return conv_transpose_to_flax(value)
    if kind in ("bias", "raw"):
        return value
    raise ValueError(kind)


def apply_name_map(state_dict: dict, rows, prefix: str = "") -> dict:
    """{prefix + torch key: tensor} for every row; a row whose key the
    state_dict lacks raises KeyError."""
    out = {}
    for key, _, _ in rows:
        if key not in state_dict:
            raise KeyError(f"missing torch key: {key}")
        out[prefix + key] = torch.as_tensor(state_dict[key])
    return out


def assert_tree_shapes_match(converted: dict, template: dict) -> None:
    """Every converted entry that the template holds has the template's
    shape (ValueError otherwise); entries it does not hold are allowed
    (partial conversion)."""
    for key, tval in template.items():
        if key in converted and tuple(converted[key].shape) != tuple(tval.shape):
            raise ValueError(f"shape mismatch at {key}: {tuple(converted[key].shape)} vs {tuple(tval.shape)}")


def merge_params(template: dict, converted: dict, strict_shapes: bool = False) -> dict:
    """The template's entries with the converted ones laid over them, on the
    template's devices: the reference's strict=False partial load. A
    converted entry of another shape keeps the template's value, or raises
    ValueError with strict_shapes; entries the template lacks are dropped."""
    out = {}
    for key, tval in template.items():
        cval = converted.get(key, tval)
        if tuple(cval.shape) != tuple(tval.shape):
            if strict_shapes:
                raise ValueError(f"shape mismatch for {key}: {tuple(cval.shape)} vs {tuple(tval.shape)}")
            cval = tval
        out[key] = cval.to(tval.device)
    return out


def convert_reference_checkpoint(ckpt: dict, model, encoder_cfg=None, iters: int = 12) -> dict:
    """A reference training checkpoint ({'pose_learner': ..., 'gaussian':
    ...}, torch tensors or arrays) -> the state_dict of the port's
    GGRtModel `model`, keys 'pose_learner.*' and 'gaussian.encoder.*', for
    `model.load_state_dict`.

    'pose_learner' goes through IPO-Net's rows (stride 8, as the reference's
    DepthPoseNet); 'gaussian''s 'encoder.*' entries through the encoder's
    rows for `encoder_cfg` (None: the heads and the five backbone
    projections only). Entries the checkpoint does not name keep the
    model's values. `iters` is the JAX converter's argument, which its map
    ignores too."""
    converted: dict = {}
    if "pose_learner" in ckpt:
        converted.update(apply_name_map(ckpt["pose_learner"], depth_pose_net_name_map(8), "pose_learner."))
    if "gaussian" in ckpt:
        enc = {k.removeprefix("encoder."): v for k, v in ckpt["gaussian"].items() if k.startswith("encoder.")}
        converted.update(apply_name_map(enc, encoder_name_map(encoder_cfg), "gaussian.encoder."))
    template = model.state_dict()
    assert_tree_shapes_match(converted, template)
    return merge_params(template, converted)
