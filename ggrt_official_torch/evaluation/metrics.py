"""Evaluation metrics: PSNR, SSIM, LPIPS (where weights are given) and the
ATE-aligned pose errors with their conditioning gate (the JAX package's evaluation/metrics.py; the
reference's utils_loc.py img2psnr, ssim_torch.py and the pose-error
protocol of eval_ggrt.py:277-282).
"""
from __future__ import annotations

import os

import torch

from ..geometry.alignment import align_ate_c2b_use_a2b, evaluate_camera_alignment
from ..ops.ssim import ssim_metric


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    mse = ((pred - gt) ** 2).mean()
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-10))


def ssim(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """pred/gt: (3, h, w) or (b, 3, h, w)."""
    if pred.ndim == 3:
        pred, gt = pred[None], gt[None]
    return ssim_metric(pred, gt)


def lpips(pred, gt):
    """LPIPS(alex) of (3, h, w) images in [0, 1] (tensors or arrays), with the
    network of evaluation/lpips.py and the weights of the .npz that
    $GGRT_LPIPS_WEIGHTS names, on the images' device (the CPU for arrays).
    None without weights: no number is reported from random weights."""
    path = os.environ.get("GGRT_LPIPS_WEIGHTS")
    if not (path and os.path.exists(path)):
        return None
    from .lpips import lpips_fn

    device = pred.device if isinstance(pred, torch.Tensor) else "cpu"
    return lpips_fn(path, device)(pred, gt)


def _spread(c2w: torch.Tensor) -> torch.Tensor:
    c = c2w[:, :3, 3]
    return torch.sqrt(((c - c.mean(dim=0)) ** 2).sum(dim=-1).mean())


def evaluate_pose_errors(pred_c2w: torch.Tensor, gt_c2w: torch.Tensor) -> dict:
    """ATE-align the predictions to GT and report R/t errors (degrees /
    units), with *_unaligned variants (no sim3 fit) always reported.

    The aligned errors are gated (NaN, `alignment_valid` 0.0) where the fit
    on camera centres is meaningless: fewer than 3 views, coincident GT
    centres (spread <= 1e-8), a predicted/GT spread ratio outside (0.2, 5),
    or aligned rotations more than 20 degrees worse than unaligned ones
    (the sim3 is a gauge fix and cannot make rotations worse)."""
    aligned = align_ate_c2b_use_a2b(pred_c2w, gt_c2w)
    out = evaluate_camera_alignment(aligned, gt_c2w)
    raw = evaluate_camera_alignment(pred_c2w, gt_c2w)

    n = gt_c2w.shape[0]
    sp_pred, sp_gt = _spread(pred_c2w), _spread(gt_c2w)
    ratio = sp_pred / torch.clamp(sp_gt, min=1e-9)
    ok = (sp_gt > 1e-8) & (ratio > 0.2) & (ratio < 5.0) & (out["R_error_mean"] <= raw["R_error_mean"] + 20.0)
    ok = ok & (n >= 3)
    out = {k: torch.where(ok, v, torch.full_like(v, float("nan"))) for k, v in out.items()}
    out["alignment_valid"] = ok.to(torch.float32)
    out.update({f"{k}_unaligned": v for k, v in raw.items()})
    return out
