"""Constant tensors on a device, made once per (values, dtype, device).

A tensor built from a Python list is a host-to-device copy, and on a CUDA
device that copy waits for the card on every call. The render path takes
its constants from here, so after its first call it queues its work
without waiting.
"""
from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=None)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype, device), made on the first call and
    shared after it: callers must not write into it. It is made outside
    inference mode, so that a first call under torch.inference_mode() does
    not leave an inference tensor that autograd may not save later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)
