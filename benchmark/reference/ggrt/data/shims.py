"""Batch shims (host-side numpy, applied before the batch moves to the
device): the patch shim crops h/w to a multiple of the patch size and
rescales intrinsics (reference dataset/shims/patch_shim.py); the bounds
shim sets near/far from the camera baseline and target disparities
(bounds_shim.py); the augmentation shim reflects an example horizontally
at random (augmentation_shim.py) and the crop shim rescales and centre-crops
it (crop_shim.py, with PIL's Lanczos filter).
"""
from __future__ import annotations

import numpy as np


def _patch_views(views: dict, patch_size: int) -> dict:
    b, v, c, h, w = views["image"].shape
    assert h % 2 == 0 and w % 2 == 0
    h_new = (h // patch_size) * patch_size
    w_new = (w // patch_size) * patch_size
    row = (h - h_new) // 2
    col = (w - w_new) // 2
    image = views["image"][:, :, :, row:row + h_new, col:col + w_new]
    intrinsics = np.array(views["intrinsics"])
    intrinsics[:, :, 0, 0] *= w / w_new
    intrinsics[:, :, 1, 1] *= h / h_new
    return {**views, "image": image, "intrinsics": intrinsics}


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    return {
        **batch,
        "context": _patch_views(batch["context"], patch_size),
        "target": _patch_views(batch["target"], patch_size),
    }


def _depth_for_disparity(extrinsics, intrinsics, image_shape, disparity, delta_min=1e-6):
    origins = np.asarray(extrinsics)[:, :, :3, 3]
    deltas = np.linalg.norm(origins[:, None] - origins[:, :, None], axis=-1)
    deltas = np.clip(deltas, delta_min, None)
    baselines = deltas.reshape(deltas.shape[0], -1).max(axis=1)

    h, w = image_shape
    pixel_size = np.array([1.0 / w, 1.0 / h])
    inv = np.linalg.inv(np.asarray(intrinsics)[..., :2, :2])
    pix = np.einsum("bvij,j->bvi", inv, pixel_size)
    mean_pixel_size = pix.mean(axis=(1, 2))
    return baselines / (disparity * mean_pixel_size)


def apply_bounds_shim(batch: dict, near_disparity: float, far_disparity: float) -> dict:
    context = batch["context"]
    _, cv, _, h, w = context["image"].shape
    near = _depth_for_disparity(context["extrinsics"], context["intrinsics"], (h, w), near_disparity)
    far = _depth_for_disparity(context["extrinsics"], context["intrinsics"], (h, w), far_disparity)
    target = batch["target"]
    tv = target["image"].shape[1]
    # float32, as the JAX package's jnp.asarray gives without x64.
    rep = lambda x, n: np.repeat(x[:, None], n, axis=1).astype(np.float32)
    return {
        **batch,
        "context": {**context, "near": rep(near, cv), "far": rep(far, cv)},
        "target": {**target, "near": rep(near, tv), "far": rep(far, tv)},
    }


def _reflect_views(views: dict) -> dict:
    reflect = np.diag([-1.0, 1.0, 1.0, 1.0]).astype(np.float32)
    extr = np.einsum("ij,...jk,kl->...il", reflect, np.asarray(views["extrinsics"]), reflect)
    image = np.asarray(views["image"])[..., ::-1].copy()
    return {**views, "image": image, "extrinsics": extr}


def apply_augmentation_shim(batch: dict, rng: np.random.RandomState | None = None) -> dict:
    """Random horizontal reflection of the whole example: flip the images
    and conjugate the extrinsics by diag(-1, 1, 1, 1); skipped with
    probability 0.5 (augmentation_shim.py:8-37)."""
    rng = rng or np.random
    if rng.rand() < 0.5:
        return batch
    return {
        **batch,
        "context": _reflect_views(batch["context"]),
        "target": _reflect_views(batch["target"]),
    }


def _rescale_lanczos(image_chw: np.ndarray, shape) -> np.ndarray:
    from PIL import Image

    h, w = shape
    img = (np.clip(image_chw, 0, 1) * 255).astype(np.uint8).transpose(1, 2, 0)
    img = np.asarray(Image.fromarray(img).resize((w, h), Image.LANCZOS)) / 255.0
    return img.transpose(2, 0, 1).astype(np.float32)


def _crop_views(views: dict, shape) -> dict:
    images = np.asarray(views["image"])
    intrinsics = np.array(views["intrinsics"])
    *batch, c, h_in, w_in = images.shape
    h_out, w_out = shape
    scale = max(h_out / h_in, w_out / w_in)
    hs, ws = round(h_in * scale), round(w_in * scale)
    flat = images.reshape(-1, c, h_in, w_in)
    flat = np.stack([_rescale_lanczos(im, (hs, ws)) for im in flat])
    images = flat.reshape(*batch, c, hs, ws)

    row, col = (hs - h_out) // 2, (ws - w_out) // 2
    images = images[..., :, row:row + h_out, col:col + w_out]
    # Normalized intrinsics: the centre crop narrows the field of view.
    intrinsics[..., 0, 0] *= ws / w_out
    intrinsics[..., 1, 1] *= hs / h_out
    return {**views, "image": images, "intrinsics": intrinsics}


def apply_crop_shim(batch: dict, shape) -> dict:
    """Rescale and centre-crop the example to `shape` (crop_shim.py)."""
    return {
        **batch,
        "context": _crop_views(batch["context"], shape),
        "target": _crop_views(batch["target"], shape),
    }


def get_data_shim(encoder_cfg) -> callable:
    """Composed shim for the epipolar encoder (reference
    encoder_epipolar.py:240-255)."""

    def shim(batch: dict) -> dict:
        patch = (
            encoder_cfg.epipolar_transformer.self_attention.patch_size
            * encoder_cfg.epipolar_transformer.downscale
        )
        batch = apply_patch_shim(batch, patch)
        if encoder_cfg.apply_bounds_shim:
            _, _, _, h, w = batch["context"]["image"].shape
            near_disparity = encoder_cfg.near_disparity * min(h, w)
            batch = apply_bounds_shim(batch, near_disparity, 0.5)
        return batch

    return shim
