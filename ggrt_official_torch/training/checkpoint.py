"""Checkpoint manager over torch.save (the JAX package's
training/checkpoint.py over orbax; the reference's
base/checkpoint_manager.py).

Layout under `save_path`: one `ckpt_{step:08d}/` directory per save holding
`state.pt`, a `latest` symlink to the newest, a `best` copy of the save with
the highest score, and a `checkpoints.json` manifest of the kept saves and
the best score. Only the newest `max_to_keep` saves are kept. A save is
written into a temporary directory and then renamed into place, so a
reader never sees half a checkpoint.

The port does not read the JAX package's orbax checkpoints.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

STATE_FILE = "state.pt"


class CheckPointManager:
    def __init__(self, save_path: str, max_to_keep: int = 1000):
        self.save_path = save_path
        self.max_to_keep = max_to_keep
        self._kept: list[tuple[int, str]] = []
        self._best_score = -np.inf
        os.makedirs(save_path, exist_ok=True)
        self._manifest_path = os.path.join(save_path, "checkpoints.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                manifest = json.load(f)
            self._kept = [tuple(x) for x in manifest.get("kept", [])]
            self._best_score = manifest.get("best_score", -np.inf)

    def _write_manifest(self):
        with open(self._manifest_path, "w") as f:
            json.dump({"kept": self._kept, "best_score": float(self._best_score)}, f)

    def save(self, step: int, state: Any, score: Optional[float] = None):
        """Save `state` (anything torch.save takes) at `step`; keep `latest`,
        `best` and the manifest up to date and prune past max_to_keep."""
        name = f"ckpt_{step:08d}"
        path = os.path.join(self.save_path, name)
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        torch.save({"step": int(step), "state": state}, os.path.join(tmp, STATE_FILE))
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)

        latest = os.path.join(self.save_path, "latest")
        if os.path.lexists(latest + ".tmp"):
            os.remove(latest + ".tmp")
        os.symlink(name, latest + ".tmp")
        os.replace(latest + ".tmp", latest)

        if score is not None and score > self._best_score:
            self._best_score = float(score)
            best = os.path.join(self.save_path, "best")
            if os.path.exists(best):
                shutil.rmtree(best)
            shutil.copytree(path, best)

        self._kept.append((int(step), name))
        while len(self._kept) > self.max_to_keep:
            _, old = self._kept.pop(0)
            old_path = os.path.join(self.save_path, old)
            if os.path.exists(old_path):
                shutil.rmtree(old_path)
        self._write_manifest()

    def load(self, ckpt_path: Optional[str] = None) -> Optional[dict]:
        """{"step", "state"} from `ckpt_path`, else from `latest`, else None
        (train from scratch). Tensors come back on the CPU."""
        candidates = ([ckpt_path] if ckpt_path else []) + [os.path.join(self.save_path, "latest")]
        for c in candidates:
            f = os.path.join(c, STATE_FILE)
            if os.path.exists(f):
                return torch.load(f, map_location="cpu", weights_only=True)
        return None
