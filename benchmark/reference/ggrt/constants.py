"""Constant tensors on a device, made once per (values, dtype, device),
and `linspace`, jnp.linspace's sample grid made on the device.

A tensor built from a Python list is a host-to-device copy, and on a CUDA
device that copy waits for the card on every call. The render path takes
its constants from here, so after its first call it queues its work
without waiting.
"""
from __future__ import annotations

from functools import lru_cache

import torch


@lru_cache(maxsize=4096)
def device_constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """torch.tensor(values, dtype, device), made on the first call and
    shared after it (the 4096 most recent tables: the SfM path keys some by
    image size): callers must not write into it. It is made outside
    inference mode, so that a first call under torch.inference_mode() does
    not leave an inference tensor that autograd may not save later."""
    with torch.inference_mode(False):
        return torch.tensor(values, dtype=dtype, device=device)


def linspace(start: float, stop: float, num: int, dtype: torch.dtype = torch.float32,
             device=None) -> torch.Tensor:
    """jnp.linspace(start, stop, num) made on `device`: [start] at num = 1
    (empty at 0); otherwise start·(1 - t) + stop·t at t = i/(num - 1) for
    i < num - 1, then `stop` itself, as JAX's formula is. Both ends are
    exact. XLA may take t as i·(1/(num - 1)) and fuse the sum into an FMA,
    so an entry between the ends can differ from JAX's by up to two float32
    spacings of max(|start|, |stop|)."""
    if num <= 1:
        return torch.full((num,), start, dtype=dtype, device=device)
    t = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    out = start * (1 - t) + stop * t
    return torch.cat([out, torch.full((1,), stop, dtype=dtype, device=device)])
