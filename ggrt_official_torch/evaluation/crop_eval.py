"""Crop-tiled evaluation of large images (the JAX package's
evaluation/crop_eval.py; the reference's eval_crop.py, concat.py and
compare.py).

A view is rendered crop by crop through principal-point-shifted
intrinsics: interior crops lie on a regular grid, boundary crops are
shifted inward (so they overlap their neighbours) and trimmed when the
crops are stitched. The crops are cut from the batch's tensors on their
device; the stitch and the PSNR run on the host after one copy per view,
as in the JAX package.
"""
from __future__ import annotations

from math import ceil

import numpy as np
import torch


def crop_centers(h: int, w: int, crop_h: int, crop_w: int):
    """Grid of clamped crop centres, row-major (ref eval_crop.py:203-218):
    a list of (i, j, center_h, center_w)."""
    rows, cols = ceil(h / crop_h), ceil(w / crop_w)
    out = []
    for i in range(rows):
        ch = min(crop_h // 2 + i * crop_h, h - crop_h // 2)
        for j in range(cols):
            cw = min(crop_w // 2 + j * crop_w, w - crop_w // 2)
            out.append((i, j, ch, cw))
    return out


def crop_batch(batch: dict, size, center) -> dict:
    """Crop the context and target images around `center` and shift their
    normalized intrinsics so that rendering the crop is exact (ref
    eval_crop.py:78-108). Tensors stay on their device."""
    out_h, out_w = size
    ch, cw = center
    y0, x0 = ch - out_h // 2, cw - out_w // 2

    def crop_views(views):
        img = views["image"]
        h, w = img.shape[-2:]
        K = views["intrinsics"].clone()
        K[..., 0, 0] *= w / out_w
        K[..., 1, 1] *= h / out_h
        K[..., 0, 2] = (K[..., 0, 2] * w - x0) / out_w
        K[..., 1, 2] = (K[..., 1, 2] * h - y0) / out_h
        return {**views, "image": img[..., y0:y0 + out_h, x0:x0 + out_w], "intrinsics": K}

    return {**batch, "context": crop_views(batch["context"]), "target": crop_views(batch["target"])}


def stitch_tiles(tiles: dict, h: int, w: int, crop_h: int, crop_w: int) -> np.ndarray:
    """Assemble {(i, j): (crop_h, crop_w, c)} tiles into an (h, w, c) image,
    trimming the inward-shifted boundary tiles (ref concat.py)."""
    sample = next(iter(tiles.values()))
    out = np.zeros((h, w, *sample.shape[2:]), dtype=sample.dtype)
    for (i, j), tile in tiles.items():
        y0 = min(i * crop_h, h - crop_h)
        x0 = min(j * crop_w, w - crop_w)
        ty = i * crop_h - y0   # trimmed rows (boundary tiles only)
        tx = j * crop_w - x0
        out[i * crop_h:min((i + 1) * crop_h, h),
            j * crop_w:min((j + 1) * crop_w, w)] = tile[ty:, tx:][:h - i * crop_h, :w - j * crop_w]
    return out


def psnr_compare(pred: np.ndarray, gt: np.ndarray, eps: float = 1e-6) -> float:
    """Stitched-against-GT PSNR (ref compare.py:36-52)."""
    pred = np.clip(np.asarray(pred, np.float32), 0.0, 1.0)
    gt = np.asarray(gt, np.float32)
    mse = np.mean((pred - gt) ** 2)
    return float(-10.0 * np.log(mse + eps) / np.log(10.0))


def eval_crop_view(render_fn, batch: dict, crop_h: int, crop_w: int):
    """Render a whole view crop by crop and stitch the crops.

    render_fn(cropped batch) -> (3, crop_h, crop_w) rendered target rgb
    (a tensor). The crops are rendered on the batch's device and copied to
    the host together. Returns (stitched (h, w, 3), PSNR against the
    batch's target)."""
    img = batch["target"]["image"]
    h, w = img.shape[-2:]
    grid = crop_centers(h, w, crop_h, crop_w)
    rgbs = torch.stack([render_fn(crop_batch(batch, (crop_h, crop_w), (ch, cw))) for _, _, ch, cw in grid])
    gt = img.reshape(-1, 3, h, w)[0]
    # One copy to the host for the crops and the target together.
    host = torch.cat([rgbs.permute(0, 2, 3, 1).reshape(-1), gt.permute(1, 2, 0).reshape(-1)]).cpu().numpy()
    rgbs, gt = host[:rgbs.numel()].reshape(len(grid), crop_h, crop_w, 3), host[rgbs.numel():].reshape(h, w, 3)
    stitched = stitch_tiles({(i, j): rgb for (i, j, _, _), rgb in zip(grid, rgbs)}, h, w, crop_h, crop_w)
    return stitched, psnr_compare(stitched, gt)
