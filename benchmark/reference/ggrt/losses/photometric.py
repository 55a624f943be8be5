"""Multi-view photometric SfM loss (the reference's photometric_loss.py,
MultiViewPhotometricDecayLoss).

For each IPO-Net iterate's (depth, poses): warp every reference image into
the target, L1 + SSIM (weight 0.85) with mean + 0.5·std clipping, take the
minimum over the warped references and the unwarped ones (automask),
weight the iterates by gamma-decay (0.85), and add an edge-aware smoothness
term. The views ride on the batch axis; the clipping statistics stay per
view, as the reference computes them one view at a time.
"""
from __future__ import annotations

import torch

from ..geometry import camera as cam
from ..geometry.depth import calc_smoothness, inv2depth
from ..geometry.se3 import pose_from_vec
from ..ops.grid_sample import grid_sample
from ..ops.ssim import ssim_photometric


def warp_ref_image(inv_depth, ref_image, K, ref_K, pose_mat):
    """Warp reference images into the target frame via depth and pose
    (target->ref). inv_depth (b, 1, h, w); ref_image (b, 3, h, w). Returns
    the warped images, the (b, 1, h, w) in-frame mask and the coordinates."""
    world = cam.reconstruct(inv2depth(inv_depth), K)
    coords = cam.project(world, ref_K, Twc=pose_mat, normalize=True)
    warped = grid_sample(ref_image, coords, align_corners=True)
    valid = ((coords[..., 0].abs() <= 1.0) & (coords[..., 1].abs() <= 1.0))[:, None]
    return warped, valid.to(warped.dtype), coords


def _photometric_map(t_est, images, ssim_weight, C1, C2, clip):
    """Per-pixel L1 + SSIM residual (b, 1, h, w), clipped per batch entry at
    mean + clip·std (unbiased std, as torch.Tensor.std)."""
    l1 = (t_est - images).abs()
    if ssim_weight > 0.0:
        ssim_loss = torch.clamp((1.0 - ssim_photometric(t_est, images, C1=C1, C2=C2)) / 2.0, 0.0, 1.0)
        loss = ssim_weight * ssim_loss.mean(dim=1, keepdim=True) + (1.0 - ssim_weight) * l1.mean(dim=1, keepdim=True)
    else:
        loss = l1
    if clip > 0.0:
        flat = loss.reshape(loss.shape[0], -1)
        cap = flat.mean(dim=1) + clip * flat.std(dim=1)
        loss = torch.minimum(loss, cap[:, None, None, None])
    return loss


def photometric_decay_loss(
    image: torch.Tensor,       # (1, 3, h, w) target
    ref_imgs: torch.Tensor,    # (nv, 3, h, w)
    inv_depths: torch.Tensor,  # (n_iters, 1, 1, h, w)
    K: torch.Tensor,           # (1, 3, 3) pixel intrinsics
    ref_Ks: torch.Tensor,      # (nv, 3, 3)
    poses: torch.Tensor,       # (1, nv, n_iters, 6)
    ssim_weight: float = 0.85,
    smooth_weight: float = 0.01,
    C1: float = 1e-4,
    C2: float = 9e-4,
    clip: float = 0.5,
    gamma: float = 0.85,
    automask: bool = True,
    valid_mask: bool = False,
    oob_weight: float = 0.0,
) -> dict:
    """Returns {'loss': scalar, 'metrics': {...}}. `valid_mask` and
    `oob_weight` are the JAX package's extensions (off for reference
    parity): out-of-frame residuals excluded from the minimum, and a
    boundary penalty mean(relu(|xy| - 1)²) on the warp coordinates."""
    n_iters = inv_depths.shape[0]
    nv = ref_imgs.shape[0]
    poses = poses[0]                                          # (nv, n_iters, 6)
    target = image.expand(nv, *image.shape[1:])
    Ks = K.expand(nv, 3, 3)
    auto = _photometric_map(ref_imgs, target, ssim_weight, C1, C2, clip) if automask else None

    per_iter, oob_terms = [], []
    for i in range(n_iters):
        warped, valid, coords = warp_ref_image(
            inv_depths[i].expand(nv, *inv_depths.shape[2:]), ref_imgs, Ks, ref_Ks,
            pose_from_vec(poses[:, i]))
        res = _photometric_map(warped, target, ssim_weight, C1, C2, clip)   # (nv, 1, h, w)
        valids = valid
        if valid_mask:
            # A Python scalar: a tensor made on the host would be copied to
            # the card, which waits for it, on every call.
            res = torch.where(valid > 0.5, res, 1e4)
        if oob_weight > 0.0:
            oob_terms.append(torch.clamp(coords.abs() - 1.0, min=0.0).pow(2).mean(dim=(1, 2, 3)))
        residuals = res
        if automask:
            residuals = torch.cat([res, auto], dim=0)
            valids = torch.cat([valid, torch.ones_like(valid)], dim=0)
        # Minimum over views and automask copies (amin shares the gradient
        # among ties, as jnp.min does), then the mean over pixels.
        min_res = torch.amin(residuals[:, 0], dim=0)
        if valid_mask:
            any_valid = torch.amax(valids[:, 0], dim=0) > 0.5
            per_iter.append(torch.where(any_valid, min_res, torch.zeros_like(min_res)).sum()
                            / torch.clamp(any_valid.to(image.dtype).sum(), min=1.0))
        else:
            per_iter.append(min_res.mean())

    weights = gamma ** (n_iters - 1 - torch.arange(n_iters, dtype=image.dtype, device=image.device))
    photo = (weights * torch.stack(per_iter)).sum()
    metrics = {"photometric_loss": photo}
    loss = photo
    if oob_weight > 0.0:
        oob = oob_weight * torch.cat(oob_terms).mean()
        metrics["oob_loss"] = oob
        loss = loss + oob
    if smooth_weight > 0.0:
        terms = []
        for i in range(n_iters):
            sx, sy = calc_smoothness(inv_depths[i], image)
            # The divisor is the reference's per-scale octave factor
            # (photometric_loss.py:438-440).
            terms.append((sx.abs().mean() + sy.abs().mean()) / (2.0**i))
        smooth = smooth_weight * torch.stack(terms).sum() / n_iters
        metrics["smoothness_loss"] = smooth
        loss = loss + smooth
    return {"loss": loss, "metrics": metrics}


class MultiViewPhotometricDecayLoss:
    """Thin class around photometric_decay_loss, the reference's API: the
    keyword settings are given once, the tensors at each call."""

    def __init__(self, **kwargs):
        self.kwargs = kwargs

    def __call__(self, image, ref_imgs, inv_depths, K, ref_Ks, poses):
        return photometric_decay_loss(image, ref_imgs, inv_depths, K, ref_Ks, poses, **self.kwargs)
