"""Evaluation protocol (the reference's eval/eval_ggrt.py; the JAX
package's evaluation/harness.py).

Per test view: IPO-Net predicts the source poses, optionally refined at
test time; the poses are ATE-aligned against GT for R/t errors; the
Gaussian model renders the target; PSNR/SSIM are taken, and per-dataset
means are written to results.json (parity with eval_ggrt.py:194-503).

The evaluator runs on `device` ("cuda" unless the caller asks for "cpu").
Each test-time refinement step is dispatched from Python (JAX runs them in
one lax.scan); no step waits for the card, and the pick between the two
starts is made on the card.
"""
from __future__ import annotations

import json
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch
from PIL import Image

from ..config import GGRtConfig
from ..data.datasets import collate_batch
from ..data.shims import get_data_shim
from ..geometry.se3 import relative_to_source_c2w
from ..losses.photometric import photometric_decay_loss
from ..models.ggrt import GGRtModel
from ..training.trainer import prepare_batch
from ..utils.visualization import plot_cameras
from . import metrics


def _no_nan(obj):
    """Non-finite floats become None (strict-JSON null), recursively."""
    if isinstance(obj, dict):
        return {k: _no_nan(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_no_nan(v) for v in obj]
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


def adam_descent(loss_fn, v0: torch.Tensor, steps: int, lr: float) -> torch.Tensor:
    """`steps` Adam steps (optax.adam's defaults: betas 0.9, 0.999, eps 1e-8)
    on loss_fn from v0; returns the detached result."""
    vec = v0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([vec], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    for _ in range(steps):
        opt.zero_grad(set_to_none=True)
        loss_fn(vec).backward()
        opt.step()
    return vec.detach()


class Evaluator:
    def __init__(self, cfg: GGRtConfig, model: GGRtModel, refine_depth_source: str = "field",
                 refine_depth_rounds: int = 3, device="cuda"):
        """`refine_depth_source` is the warp geometry of the test-time
        refinement: "field" renders depth from the Gaussian model at the
        current pose estimate each round, "iponet" keeps IPO-Net's depth."""
        self.cfg = cfg
        self.model = model
        self.device = torch.device(device)
        self.refine_depth_source = refine_depth_source
        self.refine_depth_rounds = refine_depth_rounds
        self.data_shim = get_data_shim(cfg.encoder)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _prepare_batch(self, batch_raw: dict) -> dict:
        return prepare_batch(batch_raw, self.data_shim, self.device)

    @torch.no_grad()
    def _pose(self, batch: dict):
        """IPO-Net without the SfM loss: (inv_depth (1, 1, h, w), rel_poses
        (nv, n_preds, 6))."""
        inv_depths, rel_poses, _, _ = self.model.iponet(
            batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
            batch["depth_range"][0, 0], batch["depth_range"][0, 1], compute_sfm_loss=False)
        return inv_depths[-1], rel_poses

    @torch.no_grad()
    def _render(self, batch: dict):
        return self.model.gaussian(batch, 0, deterministic=True)

    @staticmethod
    def _warp_inputs(batch: dict):
        """(target (1, 3, h, w), references (nv, 3, h, w), K (1, 3, 3),
        reference Ks (nv, 3, 3)) for the photometric warp."""
        tgt = batch["rgb"].permute(0, 3, 1, 2)
        refs = batch["src_rgbs"][0].permute(0, 3, 1, 2)
        K = batch["camera"][0, 2:18].reshape(4, 4)[:3, :3][None]
        refK = batch["src_cameras"][0, :, 2:18].reshape(-1, 4, 4)[:, :3, :3]
        return tgt, refs, K, refK

    @staticmethod
    def _with_context_poses(batch: dict, c2w: torch.Tensor) -> dict:
        return {**batch, "context": {**batch["context"], "extrinsics": c2w[None]}}

    def _refine(self, vec0, inv_depth, tgt, refs, K, refK, steps: int, lr: float = 1e-2):
        """Test-time pose refinement, self-supervised: Adam on the raw
        6-vector relative poses (nv, 6) against the photometric warp loss
        with the given inverse depth (1, 1, h, w), `steps` steps from the
        prediction and `steps` from zeros; the start with the lower final
        loss is kept (ties to the prediction), so a prediction outside
        every basin does not pin the result. Only the input views are used,
        no GT poses."""

        def loss_fn(vec):
            return photometric_decay_loss(
                tgt, refs, inv_depth[None], K, refK, vec[None, :, None, :],
                valid_mask=True, oob_weight=0.1,
            )["loss"]

        with torch.enable_grad():
            vec_a = adam_descent(loss_fn, vec0, steps, lr)
            vec_b = adam_descent(loss_fn, torch.zeros_like(vec0), steps, lr)
        with torch.no_grad():
            return torch.where(loss_fn(vec_a) <= loss_fn(vec_b), vec_a, vec_b)

    def pose_targets(self, batch_raw: dict, steps: int = 400, inv_depth=None) -> np.ndarray:
        """Self-supervised pose targets for training-time pose distillation
        (config.pose_selfdistill_weight): the same dual-start refinement on
        a training view, returning the refined (nv, 6) relative poses. No
        GT poses. `inv_depth` ((1, 1, h, w) inverse depth, e.g. a teacher
        render's) overrides the warp geometry; IPO-Net's depth otherwise."""
        batch = self._prepare_batch(batch_raw)
        ipo_inv_depth, rel_poses = self._pose(batch)
        inv = ipo_inv_depth if inv_depth is None else torch.as_tensor(inv_depth, device=self.device)
        vec = self._refine(rel_poses[:, -1, :], inv, *self._warp_inputs(batch), steps=steps)
        return vec.cpu().numpy()

    def time_render(self, batch_raw: dict, iters: int = 20) -> float:
        """Steady-state render latency (ms per view) of the Gaussian forward
        (encode + rasterize) after one warm-up, without data preparation,
        pose correction, metrics or image copies."""
        batch = self._prepare_batch(batch_raw)
        self._render(batch)
        self._sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            self._render(batch)
        self._sync()
        return (time.perf_counter() - t0) / iters * 1e3

    def evaluate_view(self, batch_raw: dict, use_pred_pose: bool = True, refine_steps: int = 0) -> dict:
        batch = self._prepare_batch(batch_raw)
        lo, hi = batch["depth_range"][0, 0], batch["depth_range"][0, 1]

        t0 = time.perf_counter()
        inv_depth, rel_poses = self._pose(batch)
        rel_final = rel_poses[:, -1, :]
        nv = batch["src_cameras"].shape[1]
        target_pose = batch["camera"][0, -16:].reshape(4, 4).expand(nv, 4, 4)
        if refine_steps > 0:
            warp = self._warp_inputs(batch)
            # The refinement floor is depth-limited: with "field" each round
            # renders the target's depth from the trained field at the
            # current pose estimate (inputs and model only), so better poses
            # give better depth. IPO depth is the fallback when the decoder
            # renders no depth.
            for _ in range(max(self.refine_depth_rounds, 1)):
                inv = inv_depth
                if self.refine_depth_source == "field":
                    cur = relative_to_source_c2w(target_pose, rel_final)
                    ret_d, _ = self._render(self._with_context_poses(batch, cur))
                    if ret_d["depth"] is not None:
                        inv = 1.0 / torch.clamp(ret_d["depth"][0, 0], lo, hi)[None, None]
                rel_final = self._refine(rel_final, inv, *warp, steps=refine_steps)
        pred_c2w = relative_to_source_c2w(target_pose, rel_final)
        gt_c2w = batch["context"]["extrinsics"][0]
        pose_err = metrics.evaluate_pose_errors(pred_c2w, gt_c2w)

        if use_pred_pose:
            batch = self._with_context_poses(batch, pred_c2w)
        ret, gt = self._render(batch)
        self._sync()
        dt = time.perf_counter() - t0

        pred = ret["rgb"][0, 0]
        gt_img = gt["rgb"][0, 0]
        out = {
            "psnr": float(metrics.psnr(pred, gt_img)),
            "ssim": float(metrics.ssim(pred, gt_img)),
            # Empty-render canary: a diverged pose can push every Gaussian
            # out of the frustum and render pure background, which psnr
            # alone cannot tell from a blurry render.
            "pred_var": float(pred.var(correction=0)),
            "seconds": dt,
            "pred": pred.cpu().numpy(),
            "gt": gt_img.cpu().numpy(),
            "depth": None if ret["depth"] is None else ret["depth"][0, 0].cpu().numpy(),
            **{k: float(v) for k, v in pose_err.items()},
        }
        lp = metrics.lpips(pred, gt_img)
        if lp is not None:
            out["lpips"] = lp
        return out

    def evaluate_dataset(self, dataset, out_dir: Optional[str] = None, limit: Optional[int] = None,
                         use_pred_pose: bool = True, refine_steps: int = 0) -> dict:
        """Per-view rows and their means over the finite values (NaN where
        none is: every view's aligned fit gated); with `out_dir`,
        results.json with non-finite floats written as null, and, where they
        can be made, each view's prediction as pred_{i:04d}.png and the last
        view's cameras as poses_pred_vs_gt.png (`plot_poses`)."""
        rows = []
        n = len(dataset) if limit is None else min(limit, len(dataset))
        for i in range(n):
            row = self.evaluate_view(collate_batch(dataset[i]), use_pred_pose=use_pred_pose,
                                     refine_steps=refine_steps)
            rows.append({k: v for k, v in row.items() if not isinstance(v, np.ndarray) and v is not None})
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                try:
                    img8 = (np.clip(row["pred"].transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
                    Image.fromarray(img8).save(os.path.join(out_dir, f"pred_{i:04d}.png"))
                except Exception as e:  # the image is best-effort, as in the JAX package
                    warnings.warn(f"pred_{i:04d}.png not written: {e!r}")

        summary = {}
        for key in rows[0]:
            vals = np.asarray([r[key] for r in rows], np.float64)
            finite = vals[np.isfinite(vals)]
            summary[key] = float(finite.mean()) if finite.size else float("nan")
        summary["rendered_empty"] = bool(summary.get("pred_var", 1.0) < 1e-6)
        summary["n_views"] = n
        summary["render_ms"] = self.time_render(collate_batch(dataset[n - 1]))
        if "lpips" not in summary:
            summary["lpips"] = None
            summary["lpips_status"] = "unavailable: no weights offline"
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(os.path.join(out_dir, "results.json"), "w") as f:
                json.dump(_no_nan({"summary": summary, "per_view": rows}), f, indent=2)
            try:
                self.plot_poses(collate_batch(dataset[n - 1]), os.path.join(out_dir, "poses_pred_vs_gt.png"))
            except Exception as e:  # best-effort, as in the JAX package: matplotlib may be absent
                warnings.warn(f"poses_pred_vs_gt.png not written: {e!r}")
        return summary

    def plot_poses(self, batch_raw: dict, path: str):
        """Predicted against GT source-camera wireframes (the reference's
        visdom pose view, eval_ggrt.py:253,279), written to `path` with
        matplotlib: IPO-Net's final relative poses, unrefined, placed from
        the target camera, beside the dataset's context cameras."""
        batch = self._prepare_batch(batch_raw)
        _, rel_poses = self._pose(batch)
        nv = batch["src_cameras"].shape[1]
        target_pose = batch["camera"][0, -16:].reshape(4, 4).expand(nv, 4, 4)
        pred = relative_to_source_c2w(target_pose, rel_poses[:, -1, :])
        return plot_cameras(pred.cpu().numpy(), path, gt_c2ws=batch["context"]["extrinsics"][0].cpu().numpy())
