"""Cross-process global-step tracker (the JAX package's
utils/step_tracker.py; the reference's misc/step_tracker.py): a shared step
counter that dataloader worker processes can read, for curriculum-style
view selection. Plain multiprocessing shared memory behind a lock. The
lock's manager process is spawned, not forked: a fork of a process that
runs threads (torch's, a loader's) may deadlock.
"""
from __future__ import annotations

import multiprocessing


class StepTracker:
    def __init__(self):
        ctx = multiprocessing.get_context("spawn")
        self.lock = ctx.Manager().RLock()
        self.step = ctx.Value("i", 0, lock=False)

    def set_step(self, step: int) -> None:
        with self.lock:
            self.step.value = int(step)

    def get_step(self) -> int:
        with self.lock:
            return int(self.step.value)
