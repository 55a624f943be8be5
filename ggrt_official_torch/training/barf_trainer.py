"""The standalone NeRF/BARF trainer (the JAX package's
training/barf_trainer.py; the reference's model/nerf.py and barf.py trainer
surface): joint field and per-camera pose training over ray batches with
BARF's coarse-to-fine annealing, and test-time pose optimisation that
freezes the field and descends one se(3) correction.

Two Adam groups, as optax.multi_transform's: the field at `lr`,
`pose_refine` at `lr_pose` (betas 0.9, 0.999, eps 1e-8). The annealing
progress is a host float each step; the stratified draws are `uniforms`
or come from the trainer's generator on its device. `train_step` returns
the loss as a tensor on the device and `optimize_test_pose` copies its
losses to the host once, at the end, so neither waits for the card inside
its loop.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..geometry.se3 import se3_exp
from ..models.nerf import BARFModel, render_nerf_rays
from ..weights import init_flax_defaults


@dataclass
class BARFTrainConfig:
    num_cameras: int = 8
    depth: int = 4
    width: int = 64
    num_freqs_xyz: int = 6
    n_samples: int = 32
    near: float = 1.0
    far: float = 8.0
    lr: float = 5e-4
    lr_pose: float = 1e-3
    # BARF schedule: annealing progress ramps 0 -> 1 over this fraction of
    # training (the reference's barf.py coarse-to-fine schedule).
    anneal_start: float = 0.1
    anneal_end: float = 0.5


def _world_rays(c2w, rays_o, rays_d):
    """Camera-local rays to world through c2w (..., 4, 4)."""
    R, t = c2w[..., :3, :3], c2w[..., :3, 3]
    return (R @ rays_o[..., None])[..., 0] + t, (R @ rays_d[..., None])[..., 0]


class BARFTrainer:
    """Joint field and per-camera pose training over ray batches."""

    def __init__(self, cfg: BARFTrainConfig, device="cuda", generator: Optional[torch.Generator] = None,
                 seed: int = 0):
        """`generator` (CPU, seed 0 when None) draws the initial weights;
        the stratified draws come from a generator on `device` seeded with
        `seed`."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.init_generator = generator or torch.Generator().manual_seed(0)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        if self.device.type == "cuda":
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = None
        self.opt = None

    def progress(self, step: int, n_iters: int) -> float:
        c = self.cfg
        x = (step / max(n_iters, 1) - c.anneal_start) / max(c.anneal_end - c.anneal_start, 1e-6)
        return float(min(max(x, 0.0), 1.0))

    def init(self) -> None:
        """Build the model with flax's default initialisers (pose_refine at
        zero) and the two Adam groups. The JAX trainer's example rays only
        fix shapes; here the configuration does."""
        c = self.cfg
        model = BARFModel(num_cameras=c.num_cameras, depth=c.depth, width=c.width, num_freqs_xyz=c.num_freqs_xyz)
        init_flax_defaults(model, self.init_generator)
        self.model = model.to(self.device)
        self.opt = torch.optim.Adam([
            {"params": list(self.model.nerf.parameters()), "lr": c.lr},
            {"params": [self.model.pose_refine], "lr": c.lr_pose},
        ], betas=(0.9, 0.999), eps=1e-8)

    # -- joint training -------------------------------------------------------
    def render(self, rays_o, rays_d, cam_idx, base_c2w, progress, uniforms=None):
        """Rays in each camera's LOCAL frame; the learned-corrected pose maps
        them to world, so pose gradients flow through the transform."""
        c2w = self.model.corrected_pose(cam_idx, base_c2w)
        o_w, d_w = _world_rays(c2w, rays_o, rays_d)
        return render_nerf_rays(lambda pts, dirs: self.model(pts, dirs, progress), o_w, d_w,
                                self.cfg.near, self.cfg.far, self.cfg.n_samples, uniforms)

    def train_step(self, batch: dict, step: int, n_iters: int, uniforms: Optional[torch.Tensor] = None):
        """One Adam step of both groups on mean((rgb - batch rgb)²). batch:
        rays_o, rays_d (r, 3), rgb (r, 3), cam_idx (integer tensor), base_c2w
        (4, 4), on the trainer's device. uniforms (r, n_samples) or None to
        draw them. Returns the loss, a 0-dim tensor on the device."""
        r = batch["rays_o"].shape[0]
        if uniforms is None:
            uniforms = torch.rand((r, self.cfg.n_samples), generator=self.generator, device=self.device)
        self.opt.zero_grad(set_to_none=True)
        out = self.render(batch["rays_o"], batch["rays_d"], batch["cam_idx"], batch["base_c2w"],
                          self.progress(step, n_iters), uniforms)
        loss = torch.mean((out["rgb"] - batch["rgb"]) ** 2)
        loss.backward()
        self.opt.step()
        return loss.detach()

    # -- test-time pose optimisation (the reference's barf.py eval protocol) ---
    def optimize_test_pose(self, rays_o, rays_d, rgb_gt, base_c2w, n_steps: int = 50):
        """Freeze the field and fit an se(3) correction for an unseen camera
        with Adam at lr_pose. Returns (corrected c2w, the per-step losses as
        floats, copied once after the last step)."""
        delta = torch.zeros(6, device=self.device, requires_grad=True)
        opt = torch.optim.Adam([delta], lr=self.cfg.lr_pose, betas=(0.9, 0.999), eps=1e-8)
        losses = []
        for _ in range(n_steps):
            c2w = base_c2w @ se3_exp(delta)
            o_w, d_w = _world_rays(c2w, rays_o, rays_d)
            out = render_nerf_rays(lambda pts, dirs: self.model(pts, dirs, 1.0), o_w, d_w,
                                   self.cfg.near, self.cfg.far, self.cfg.n_samples)
            loss = torch.mean((out["rgb"] - rgb_gt) ** 2)
            (grad,) = torch.autograd.grad(loss, [delta])
            delta.grad = grad
            opt.step()
            losses.append(loss.detach())
        with torch.no_grad():
            c2w = base_c2w @ se3_exp(delta)
        return c2w, torch.stack(losses).tolist()
