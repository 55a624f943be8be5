"""Train state: two Adam optimizers, their schedules and the state-machine
gating (the reference's train_ggrt_stable.py:43-66, the JAX package's
training/state.py on optax).

  * the Gaussian optimizer: Adam(lr) with a linear warm-up from lr/warm to
    lr over warm_up_steps (optax.linear_schedule);
  * the pose optimizer: Adam(lrate_pose), halved every
    lrate_decay_pose_steps (optax.exponential_decay, staircase);
  * each clips its own gradients to a global norm first, as
    optax.clip_by_global_norm does: g·max/norm when norm ≥ max, no epsilon.

The state machine gates gradients: 'pose_only' zeroes the Gaussian
model's, 'nerf_only' the pose learner's, 'joint' keeps both. A gated group
still takes its Adam step, with zero gradients, so after a 'joint' step its
parameters keep moving on their momentum, as they do in the JAX package.
Learning rates are taken at each optimizer's count before its update.
"""
from __future__ import annotations

import torch

from ..config import GGRtConfig
from ..utils.tracing import span

STATE_POSE_ONLY = 0
STATE_NERF_ONLY = 1
STATE_JOINT = 2

_STATE_NAMES = {"pose_only": STATE_POSE_ONLY, "nerf_only": STATE_NERF_ONLY, "joint": STATE_JOINT}


def state_id(name: str) -> int:
    return _STATE_NAMES[name]


def gaussian_lr(cfg: GGRtConfig, count: int) -> float:
    """optax.linear_schedule(lr/warm, lr, warm) at `count`."""
    warm = max(cfg.train.optimizer.warm_up_steps, 1)
    lr = cfg.train.optimizer.lr
    frac = 1.0 - min(max(count, 0), warm) / warm
    return (lr / warm - lr) * frac + lr


def pose_lr(cfg: GGRtConfig, count: int) -> float:
    """optax.exponential_decay(lrate_pose, steps, factor, staircase) at `count`."""
    steps = max(cfg.train.lrate_decay_pose_steps, 1)
    return cfg.train.lrate_pose * cfg.train.lrate_decay_factor ** (count // steps)


class GatedAdam:
    """Clip-then-Adam over one parameter group, with the group's gate."""

    def __init__(self, params, lr_fn, clip: float):
        self.params = [p for p in params if p.requires_grad]
        self.lr_fn = lr_fn
        self.clip = clip
        self.count = 0
        self.opt = torch.optim.Adam(self.params, lr=lr_fn(0), betas=(0.9, 0.999), eps=1e-8)

    @torch.no_grad()
    def step(self, on: bool) -> None:
        grads = []
        for p in self.params:
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads.append(g if on else g * 0.0)
        if self.clip and self.clip > 0:
            norm = torch.sqrt(sum((g * g).sum() for g in grads))
            scale = torch.where(norm < self.clip, torch.ones_like(norm), self.clip / norm)
            grads = [g * scale for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g
        for group in self.opt.param_groups:
            group["lr"] = self.lr_fn(self.count)
        self.opt.step()
        self.count += 1

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


class TrainState:
    """Step counter and the two optimizers over a GGRtModel's parameters."""

    def __init__(self, cfg: GGRtConfig, model):
        clip = cfg.train.optimizer.grad_clip_norm
        self.step = 0
        self.gaussian_opt = GatedAdam(model.gaussian.parameters(), lambda c: gaussian_lr(cfg, c), clip)
        self.pose_opt = GatedAdam(model.pose_learner.parameters(), lambda c: pose_lr(cfg, c), clip)

    def zero_grad(self) -> None:
        self.gaussian_opt.zero_grad()
        self.pose_opt.zero_grad()

    @span("optimizer")
    def apply_updates(self, machine_state: int) -> None:
        """Gate, clip and step both optimizers; advance the step."""
        self.pose_opt.step(machine_state in (STATE_POSE_ONLY, STATE_JOINT))
        self.gaussian_opt.step(machine_state in (STATE_NERF_ONLY, STATE_JOINT))
        self.step += 1
