"""Cache-aware generalizable trainer (the reference's cross-iteration
Gaussian cache inside PixelSplat.forward, pixelsplat.py:177-199): a frozen
copy of the port's `training/trainer_cached.py`, without its spans.

Per-frame Gaussians are reused across train iterations, read back
detached, so each step encodes only the pairs whose first frame newly
entered the context window, one pair per encoder call. One step: IPO-Net
with the SfM loss, the missing pairs encoded, cached then fresh Gaussians
concatenated and rendered, the pretrain losses (without the optional pose
terms), one backward, the two gated optimizer steps; then the fresh
Gaussians go into the cache, detached. Gradients reach the Gaussian model
through the fresh pairs only.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..config import GGRtConfig
from ..losses.criterion import img2mse, masked_l2_image_loss, mse2psnr, self_sup_depth_loss
from ..models.gaussian_adapter import Gaussians
from ..models.ggrt import compose_joint_loss
from . import state as state_lib
from .gaussian_cache import GaussianCache
from .trainer import GGRtTrainer, _inject_predicted_poses


class CachedGGRtTrainer(GGRtTrainer):
    def __init__(self, cfg: GGRtConfig, device="cuda", cache_capacity: int = 32):
        super().__init__(cfg, device)
        self.cache = GaussianCache(cache_capacity)
        self.hits = 0
        self.misses = 0

    def train_iteration(self, batch: dict, machine: str = "joint",
                        uniforms: Optional[Sequence[torch.Tensor]] = None) -> dict:
        """One step on a loader batch. `uniforms` are the depth-sampling
        draws of the missing pairs, one (1, 2, h·w, srf, gpp) tensor each
        in sorted order, else drawn from the trainer's generator. Returns
        the detached aux."""
        if self.state is None:
            raise RuntimeError("call init_full() first")
        # The loader's numpy index: reading it back from the device would
        # wait for the device.
        cached, missing = self.cache.plan(batch["context"]["index"][0])
        self.hits += len(cached)
        self.misses += len(missing)
        batch = self.prepare_batch(batch)
        if uniforms is None:
            uniforms = [self.draw_uniforms(batch, pairs=1) for _ in missing]

        cfg, tc = self.cfg, self.cfg.train
        machine_id = state_lib.state_id(machine)
        step = self.state.step
        self.state.zero_grad()
        min_d, max_d = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
        inv_depths, rel_poses, sfm, _ = self.model.iponet(
            batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"], min_d, max_d,
            compute_sfm_loss=True)
        inv_depth_prior = inv_depths[-1].detach().reshape(-1, 1)
        b = _inject_predicted_poses(batch, rel_poses) if tc.use_pred_pose else batch

        ctx = b["context"]
        fresh = []
        for (_, _, i, j), u in zip(missing, uniforms):
            pair = {name: torch.stack([x[:, i], x[:, j]], dim=1) for name, x in ctx.items()}
            fresh.append(self.model.gaussian.encoder(pair, step, deterministic=False,
                                                     uniforms=u.to(self.device)))
        parts = [g for _, g in cached] + fresh
        gaussians = Gaussians(*(torch.cat(ts, dim=1) for ts in zip(*parts)))

        target = b["target"]
        h, w = target["image"].shape[-2:]
        out = self.model.gaussian.decoder(
            gaussians, target["extrinsics"], target["intrinsics"], target["near"], target["far"],
            (h, w), depth_mode="depth" if tc.use_depth_loss else None)
        gt = {"rgb": target["image"]}
        coarse_loss = masked_l2_image_loss({"rgb": out.color}, gt)
        loss_depth = torch.zeros((), device=self.device)
        if tc.use_depth_loss:
            rendered_depth = out.depth[0].permute(1, 2, 0).reshape(-1, 1)
            loss_depth = self_sup_depth_loss(1.0 / inv_depth_prior, rendered_depth, min_d, max_d)

        sfm_loss = sfm["loss"]
        if machine_id == state_lib.STATE_JOINT:
            loss_all = compose_joint_loss(sfm_loss, coarse_loss, step, tc.joint_coefficient)
        elif machine_id == state_lib.STATE_POSE_ONLY:
            loss_all = sfm_loss
        else:
            loss_all = coarse_loss + loss_depth.detach() * 0.04
        if loss_all.requires_grad:   # not when every pair is cached and no SfM term counts
            loss_all.backward()
        self.state.apply_updates(machine_id)
        for (_, key, _, _), g in zip(missing, fresh):
            self.cache.put(key, g)
        aux = {"loss_all": loss_all, "gaussian_loss": coarse_loss, "sfm_loss": sfm_loss,
               "psnr": mse2psnr(img2mse(out.color, gt["rgb"]))}
        return {k: v.detach() for k, v in aux.items()}
