"""Trainers: generalizable pretraining (the reference's
train_ggrt_stable.py:30-195, GGRtTrainer.train_iteration) and the
per-scene finetune with deferred back-propagation
(finetune_ggrt_stable.py:81-160).

One pretrain step: IPO-Net forward, detached inverse-depth prior, predicted
poses injected into the context extrinsics, PixelSplat forward (rgb and
depth renders), rgb + self-supervised depth + SfM losses, one backward, and
the two state-machine-gated optimizer steps. The render's backward runs the
compositor backward kernel and the segment-sum scatter kernel.

One finetune step renders the whole target view without gradients, takes
the rgb loss's gradient with respect to that image, and then re-renders
from each tile of a crop_size x crop_size grid of the context views with
gradients, back-propagating the matching slice of the pixel gradients: the
Gaussian model's gradients add up over the tiles, while only one tile's
graph is alive at a time.

The trainer runs on `device` ("cuda" unless the caller asks for "cpu") and
never moves work elsewhere. Its depth-sampling draws come from its own
torch.Generator; `train_iteration` also takes them explicitly.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import GGRtConfig
from ..data.shims import get_data_shim
from ..geometry.se3 import relative_to_source_c2w
from ..losses.criterion import img2mse, masked_l2_image_loss, mse2psnr, self_sup_depth_loss, sup_depth_loss
from ..models.ggrt import GGRtModel, compose_joint_loss
from . import state as state_lib
from .pretrained import load_pretrained_trunks
from .state import TrainState


def _inject_predicted_poses(batch: dict, rel_poses: torch.Tensor, detach: bool = True) -> dict:
    """Replace the context extrinsics with the poses the predicted relative
    poses give (train_ggrt_stable.py:102-106). detach=True is the
    reference's `.detach()`; detach=False (cfg.train.pose_render_grad) lets
    the rgb loss reach IPO-Net through the rasterizer's camera gradients."""
    target_pose = batch["camera"][0, -16:].reshape(4, 4)
    nv = batch["src_cameras"].shape[1]
    context_poses = relative_to_source_c2w(target_pose.expand(nv, 4, 4), rel_poses[:, -1, :])
    if detach:
        context_poses = context_poses.detach()
    return {**batch, "context": {**batch["context"], "extrinsics": context_poses[None]}}


def make_pretrain_loss_fn(model: GGRtModel, cfg: GGRtConfig, machine_id: int = state_lib.STATE_JOINT):
    """The loss body: (batch, step, uniforms) -> (loss_all, aux), with the
    model's parameters as the variables. `uniforms` are the depth-sampling
    draws (pairs, 2, h·w, surfaces, gaussians_per_pixel)."""
    tc = cfg.train

    def loss_fn(batch: dict, step: int, uniforms: torch.Tensor):
        min_d, max_d = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
        inv_depths, rel_poses, sfm, _ = model.iponet(
            batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"], min_d, max_d)
        inv_depth_prior = inv_depths[-1].detach().reshape(-1, 1)

        b = batch
        # No injection in nerf_only: G-3DGS pretraining sees the dataset's
        # poses (the reference only injects in its 'joint' pretrain).
        if tc.use_pred_pose and machine_id != state_lib.STATE_NERF_ONLY:
            b = _inject_predicted_poses(batch, rel_poses, detach=not tc.pose_render_grad)

        ret, gt = model.gaussian(b, step, deterministic=False, uniforms=uniforms)
        coarse_loss = masked_l2_image_loss(ret, gt)

        loss_depth = torch.zeros((), device=coarse_loss.device)
        if tc.use_depth_loss:
            rendered_depth = ret["depth"][0].permute(1, 2, 0).reshape(-1, 1)
            loss_depth = self_sup_depth_loss(1.0 / inv_depth_prior, rendered_depth, min_d, max_d)

        sfm_loss = sfm["loss"]
        # sfm_weight scales the warp term in pose_only only.
        pose_loss = tc.sfm_weight * sfm_loss
        aux = {}
        if tc.pose_depth_distill > 0.0 and ret["depth"] is not None:
            # The frozen Gaussian model's rendered depth, distilled into the
            # IPO-Net iterates.
            rend = ret["depth"][0, 0].detach()
            aux["pose_distill_loss"] = sup_depth_loss(inv_depths, rend[None, None], min_d, max_d)
            pose_loss = pose_loss + tc.pose_depth_distill * aux["pose_distill_loss"]
        if tc.pose_render_grad and tc.use_pred_pose:
            pose_loss = pose_loss + coarse_loss
        if tc.pose_selfdistill_weight > 0.0 and "pose_target" in batch:
            # Regress refined 6-vector targets with the iteration-weighted
            # loss (gamma 0.85) over the GRU iterates.
            tgt_vec = batch["pose_target"][0].detach()
            n_it = rel_poses.shape[1]
            gammas = 0.85 ** torch.arange(n_it - 1, -1, -1, dtype=rel_poses.dtype, device=rel_poses.device)
            per_it = ((rel_poses - tgt_vec[:, None, :]) ** 2).mean(dim=(0, 2))
            aux["pose_selfdistill_loss"] = (gammas * per_it).sum() / gammas.sum()
            pose_loss = pose_loss + tc.pose_selfdistill_weight * aux["pose_selfdistill_loss"]
        if tc.pose_anchor_weight > 0.0:
            pose_loss = pose_loss + tc.pose_anchor_weight * (rel_poses**2).sum(dim=-1).mean()
        if tc.pose_teacher_weight > 0.0:
            # Render the context views at the predicted cameras from the
            # frozen teacher field; the gradient reaches IPO-Net through the
            # rasterizer's camera gradients only.
            target_pose = batch["camera"][0, -16:].reshape(4, 4)
            nv = rel_poses.shape[0]
            pred_c2w = relative_to_source_c2w(target_pose.expand(nv, 4, 4), rel_poses[:, -1, :])
            rend = model.pose_teacher_render(batch, pred_c2w[None], step)
            aux["pose_teacher_loss"] = ((rend - batch["context"]["image"]) ** 2).mean()
            pose_loss = pose_loss + tc.pose_teacher_weight * aux["pose_teacher_loss"]

        if machine_id == state_lib.STATE_JOINT:
            loss_all = compose_joint_loss(sfm_loss, coarse_loss, step, tc.joint_coefficient)
        elif machine_id == state_lib.STATE_POSE_ONLY:
            loss_all = pose_loss
        else:
            loss_all = coarse_loss + loss_depth.detach() * 0.04
        aux = {
            "loss_all": loss_all,
            "gaussian_loss": coarse_loss,
            "sfm_loss": sfm_loss,
            "depth_loss": loss_depth,
            "psnr": mse2psnr(img2mse(ret["rgb"], gt["rgb"])),
            "rel_poses": rel_poses,
            # Drift canary: mean 6-vector norm of the final pose iterate.
            "pose_vec_norm": rel_poses[:, -1, :].norm(dim=-1).mean(),
            **aux,
        }
        return loss_all, aux

    return loss_fn


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.as_tensor(tree, device=device)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def prepare_batch(batch: dict, data_shim, device) -> dict:
    """Shim a loader's numpy batch and move it to `device`."""
    batch = {k: v for k, v in batch.items() if k not in ("rgb_path", "scaled_shape")}
    shimmed = data_shim({"context": batch["context"], "target": batch["target"]})
    batch["context"], batch["target"] = shimmed["context"], shimmed["target"]
    return _to_device(batch, device)


class GGRtTrainer:
    """Generalizable training (pretrain_ggrt_stable equivalent)."""

    def __init__(self, cfg: GGRtConfig, device="cuda"):
        """On a CUDA device this turns TF32 off for cuDNN convolutions and
        cuBLAS matmuls, process-wide: the reference computes in float32."""
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.data_shim = get_data_shim(cfg.encoder)
        self.generator = torch.Generator(device=self.device).manual_seed(cfg.train.seed)
        self.model: Optional[GGRtModel] = None
        self.state: Optional[TrainState] = None

    def prepare_batch(self, batch: dict) -> dict:
        """Shim the loader's numpy batch and move it to the device."""
        return prepare_batch(batch, self.data_shim, self.device)

    def init_full(self) -> TrainState:
        """Build the composite model (pose learner + Gaussian model) with
        random weights from cfg.train.seed, load the pretrained trunks the
        config names (training/pretrained.py; a missing file leaves them
        random, with a warning), and build its optimizers. Unlike the JAX
        package's, it needs no example batch."""
        self.model = GGRtModel(self.cfg, device=self.device,
                               generator=torch.Generator().manual_seed(self.cfg.train.seed))
        load_pretrained_trunks(self.model, self.cfg)
        self.state = TrainState(self.cfg, self.model)
        return self.state

    def draw_uniforms(self, batch: dict, pairs: Optional[int] = None,
                      pixels: Optional[int] = None) -> torch.Tensor:
        """Depth-sampling draws for a prepared batch, from the trainer's
        generator: (pairs, 2, pixels, surfaces, gaussians_per_pixel), by
        default every context pair and h·w pixels."""
        b, v, _, h, w = batch["context"]["image"].shape
        enc = self.cfg.encoder
        shape = (pairs or b * (v - 1), 2, pixels or h * w, enc.num_surfaces, enc.gaussians_per_pixel)
        return torch.rand(shape, generator=self.generator, device=self.device)

    def train_iteration(self, batch: dict, machine: str = "joint",
                        uniforms: Optional[torch.Tensor] = None) -> dict:
        """One train step on a loader batch; returns the detached aux."""
        if self.state is None:
            raise RuntimeError("call init_full() first")
        batch = self.prepare_batch(batch)
        if uniforms is None:
            uniforms = self.draw_uniforms(batch)
        machine_id = state_lib.state_id(machine)
        self.state.zero_grad()
        loss_all, aux = make_pretrain_loss_fn(self.model, self.cfg, machine_id)(
            batch, self.state.step, uniforms.to(self.device))
        loss_all.backward()
        self.state.apply_updates(machine_id)
        return {k: v.detach() for k, v in aux.items()}


class GGRtFinetuneTrainer(GGRtTrainer):
    """Per-scene finetune with crop-tiled deferred back-propagation (the JAX
    package's GGRtFinetuneTrainer; there a lax.scan over the tiles bounds
    the compile time, here the tiles are a plain loop). A step has three
    parts, each a method: pose_pass, pixel_grads and tile_pass."""

    def draw_step_uniforms(self, batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
        """A step's depth-sampling draws for a prepared batch: the whole
        render's (pairs, 2, h·w, srf, gpp) and each tile's (pairs, 2,
        hc·wc, srf, gpp), from the trainer's generator."""
        c = self.cfg.train.crop_size
        h, w = batch["context"]["image"].shape[-2:]
        full = self.draw_uniforms(batch)
        return full, [self.draw_uniforms(batch, pixels=(h // c) * (w // c)) for _ in range(c * c)]

    def pose_pass(self, batch: dict) -> torch.Tensor:
        """IPO-Net with the SfM loss, back-propagated: the pose learner's
        gradients come from it alone. Returns the relative poses."""
        min_d, max_d = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
        _, rel_poses, sfm, _ = self.model.iponet(
            batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"], min_d, max_d,
            compute_sfm_loss=True)
        sfm["loss"].backward()
        return rel_poses

    def pixel_grads(self, batch: dict, uniforms: torch.Tensor):
        """The whole target view rendered without gradients, and the rgb
        loss's gradient with respect to it: (rgb, gt, rgb_grad)."""
        with torch.no_grad():
            ret, gt = self.model.gaussian(batch, self.state.step, deterministic=False,
                                          uniforms=uniforms.to(self.device), depth_mode=None)
        rgb = ret["rgb"].requires_grad_(True)
        (rgb_grad,) = torch.autograd.grad(masked_l2_image_loss({"rgb": rgb}, gt), rgb)
        return rgb.detach(), gt, rgb_grad

    def tile_pass(self, batch: dict, rgb_grad: torch.Tensor, uniforms: list[torch.Tensor]) -> None:
        """Each tile of the crop_size x crop_size grid rendered with
        gradients (row i = k // c, column j = k % c, the JAX package's
        order), back-propagating the matching slice of `rgb_grad`; the
        Gaussian model's .grad sums over the tiles, and each tile's graph
        is freed before the next."""
        c = self.cfg.train.crop_size
        h, w = rgb_grad.shape[-2:]
        out_h, out_w = h // c, w // c
        for k in range(c * c):
            i, j = divmod(k, c)
            ret, _ = self.model.gaussian(batch, self.state.step, crop=(i, j, c), deterministic=False,
                                         uniforms=uniforms[k].to(self.device), depth_mode=None)
            rows, cols = slice(out_h * i, out_h * (i + 1)), slice(out_w * j, out_w * (j + 1))
            ret["rgb"][..., rows, cols].backward(rgb_grad[..., rows, cols])
            del ret

    def train_iteration(self, batch: dict, machine: str = "joint", uniforms=None) -> dict:
        """One finetune step on a loader batch; `uniforms` are the draws as
        (whole, [tile_0, ..., tile_{c²-1}]), else drawn by
        draw_step_uniforms. No render reads depth. Returns the detached aux:
        loss_all and psnr of the whole render, rel_poses."""
        if self.state is None:
            raise RuntimeError("call init_full() first")
        batch = self.prepare_batch(batch)
        full_u, tile_u = uniforms if uniforms is not None else self.draw_step_uniforms(batch)
        self.state.zero_grad()
        rel_poses = self.pose_pass(batch)
        # The predicted poses enter the renders as constants, whatever
        # pose_render_grad says: in the JAX package the tiles' VJP is taken
        # with respect to the parameters through concrete poses.
        b = _inject_predicted_poses(batch, rel_poses) if self.cfg.train.use_pred_pose else batch
        rgb, gt, rgb_grad = self.pixel_grads(b, full_u)
        self.tile_pass(b, rgb_grad, tile_u)
        self.state.apply_updates(state_lib.state_id(machine))
        mse = img2mse(rgb, gt["rgb"])
        return {"loss_all": mse, "psnr": mse2psnr(mse), "rel_poses": rel_poses.detach()}
