"""The training loop (the reference's BaseTrainer.train(),
base/trainer.py:195-307; the JAX package's training/loop.py).

Resume from a checkpoint, then per iteration: scalar logging every
`n_tensorboard` steps, a checkpoint every `n_checkpoint` steps with a
validation score every `n_validation` steps (best-score tracking), and a
final checkpoint on exit. Scalars go to `metrics.jsonl` and messages to
`log.txt` and stdout, in place of the reference's tensorboard.

A checkpoint holds the trainer's whole state: the model's state_dict (keys
`pose_learner.*` and `gaussian.*`, the reference's components), each
optimizer's torch.optim state and count, the train step and the state of
the trainer's generator; `restore_state` loads it back, or only the model.
"""
from __future__ import annotations

import json
import os
import time
from typing import Callable, Iterable, Optional

import torch

from .checkpoint import CheckPointManager


class MetricsLogger:
    """Scalar logger: JSONL file + stdout."""

    def __init__(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        self.path = os.path.join(out_dir, "metrics.jsonl")
        self.log_path = os.path.join(out_dir, "log.txt")

    def log_scalars(self, step: int, scalars: dict):
        record = {"step": int(step), **{k: float(v) for k, v in scalars.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def log_info(self, msg: str):
        line = f"[{time.strftime('%Y-%m-%d %H:%M:%S')}] {msg}"
        print(line, flush=True)
        with open(self.log_path, "a") as f:
            f.write(line + "\n")


def _optimizers(trainer) -> dict:
    return {"gaussian": trainer.state.gaussian_opt, "pose": trainer.state.pose_opt}


def checkpoint_state(trainer) -> dict:
    """What a checkpoint of `trainer` holds (see the module docstring)."""
    return {
        "model": trainer.model.state_dict(),
        "optimizers": {k: {"adam": o.opt.state_dict(), "count": o.count}
                       for k, o in _optimizers(trainer).items()},
        "train_step": trainer.state.step,
        "generator": trainer.generator.get_state(),
    }


def restore_state(trainer, state: dict, model_only: bool = False) -> None:
    """Load a checkpoint's state into a built trainer; with `model_only`
    the weights alone, as the reference's partial loads do."""
    trainer.model.load_state_dict(state["model"])
    if model_only:
        return
    for k, o in _optimizers(trainer).items():
        o.opt.load_state_dict(state["optimizers"][k]["adam"])
        o.count = state["optimizers"][k]["count"]
    trainer.state.step = state["train_step"]
    trainer.generator.set_state(state["generator"])


def _profiler_activities(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _write_trace(prof, device: torch.device, profile_dir: str, logger: MetricsLogger) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    logger.log_info(f"profiler trace written to {profile_dir}")


def train_loop(
    trainer,
    batches: Iterable[dict],
    out_dir: str,
    n_iters: Optional[int] = None,
    machine_schedule: Optional[Callable[[int], str]] = None,
    validate_fn: Optional[Callable[[object], float]] = None,
    resume: bool = True,
):
    """Run training with the logging and checkpoint cadences of the config.

    `batches` yields collated examples; `machine_schedule(step) -> state`
    defaults to cfg.train.machine ('joint', the reference's live
    configuration, train_ggrt_stable.py:91). With cfg.train.profile_dir set,
    steps [profile_step, profile_step + 3) are traced by torch.profiler and
    written there as a Chrome trace.
    """
    cfg = trainer.cfg
    n_iters = n_iters or cfg.train.n_iters
    logger = MetricsLogger(out_dir)
    ckpt = CheckPointManager(os.path.join(out_dir, "checkpoints"))

    start_step = 0
    it = iter(batches)
    first = next(it)
    if trainer.state is None:
        trainer.init_full()

    if resume:
        payload = ckpt.load(cfg.train.ckpt_path)
        if payload is not None:
            restore_state(trainer, payload["state"])
            start_step = payload["step"]
            logger.log_info(f"resumed from step {start_step}")

    logger.log_info(f"training for {n_iters} iterations from {start_step}")
    t_last = time.perf_counter()

    step = start_step
    batch = first
    prof = None
    try:
        while step < n_iters:
            if cfg.train.profile_dir and step == cfg.train.profile_step:
                prof = torch.profiler.profile(activities=_profiler_activities(trainer.device))
                prof.start()
            machine = machine_schedule(step) if machine_schedule else cfg.train.machine
            aux = trainer.train_iteration(batch, machine=machine)
            step += 1
            if prof is not None and step >= cfg.train.profile_step + 3:
                _write_trace(prof, trainer.device, cfg.train.profile_dir, logger)
                prof = None

            if step % cfg.train.n_tensorboard == 0:
                scalars = {k: v for k, v in aux.items() if getattr(v, "ndim", 0) == 0}
                dt = time.perf_counter() - t_last
                t_last = time.perf_counter()
                scalars["iters_per_s"] = cfg.train.n_tensorboard / dt
                logger.log_scalars(step, scalars)
                logger.log_info(f"step {step}: loss={float(aux['loss_all']):.5f} "
                                f"psnr={float(aux.get('psnr', float('nan'))):.2f}")

            if step % cfg.train.n_checkpoint == 0:
                score = None
                if validate_fn is not None and step % cfg.train.n_validation == 0:
                    score = validate_fn(trainer)
                    logger.log_info(f"validation score at {step}: {score}")
                ckpt.save(step, checkpoint_state(trainer), score=score)

            batch = next(it)
    finally:
        if prof is not None:
            _write_trace(prof, trainer.device, cfg.train.profile_dir, logger)
        # Final checkpoint on exit (BaseTrainer.__del__ parity).
        ckpt.save(step, checkpoint_state(trainer))
    return trainer
