"""Cross-iteration Gaussian cache (host-side state; the reference's
pixelsplat.py:177-199): a frozen copy of the port's
`training/gaussian_cache.py`, without `CachedPairEncoder`.

Per-reference-frame Gaussians are kept across train iterations, keyed by
the dataset frame index of the pair's first view in sorted order; frames
that left the context window are evicted. Entries are read back detached,
so gradients flow only through the pairs encoded in the current step.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.gaussian_adapter import Gaussians


class GaussianCache:
    def __init__(self, capacity: int = 32):
        self.capacity = capacity
        self.store: dict[int, Gaussians] = {}

    def evict_unused(self, current_ids) -> None:
        """Drop the keys outside `current_ids`, then the oldest entries
        (insertion order) past the capacity."""
        current = {int(i) for i in current_ids}
        for key in list(self.store):
            if key not in current:
                del self.store[key]
        while len(self.store) > self.capacity:
            self.store.pop(next(iter(self.store)))

    def plan(self, index) -> tuple[list[tuple[int, Gaussians]], list[tuple[int, int, int, int]]]:
        """Key a context's adjacent pairs (views in sorted frame order) by
        their first frame, after evicting the frames outside this window.

        `index` (v,) are the context's frame indices: the loader's numpy
        array, or a tensor, read back (and waited for) if it lies on a
        device. Returns the hits as (pair position, Gaussians) and the
        misses as (pair position, key, view i, view j), each in sorted
        order."""
        if isinstance(index, torch.Tensor):
            index = index.cpu()
        index = np.asarray(index)
        order = np.argsort(index)
        self.evict_unused(index[order[:-1]])
        cached, missing = [], []
        for k in range(len(order) - 1):
            key = int(index[order[k]])
            g = self.get(key)
            if g is not None:
                cached.append((k, g))
            else:
                missing.append((k, key, int(order[k]), int(order[k + 1])))
        return cached, missing

    def get(self, frame_id: int) -> Optional[Gaussians]:
        """The entry (detached, as `put` stores it) or None."""
        return self.store.get(int(frame_id))

    def put(self, frame_id: int, gaussians: Gaussians) -> None:
        """Store detached tensors, so that an entry holds no autograd graph."""
        self.store[int(frame_id)] = Gaussians(*(t.detach() for t in gaussians))
