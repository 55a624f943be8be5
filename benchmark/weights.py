"""Seeded random weights, made on the device in one call.

The same seed and the same (name, shape) list give the same tensors, which
the benchmark loads into the program and into the reference alike. The
scale of each leaf follows its shape, not anything the program made:

- a matrix or kernel (2 or more axes) is uniform with variance 1/fan_in,
  fan_in the product of all axes but the first;
- a vector named `*.weight` (a norm's scale) is 1 + U(-0.1, 0.1);
- any other vector (a bias) is U(-0.01, 0.01).
"""
from __future__ import annotations

import math

import torch


def make_params(shapes: list[tuple[str, tuple[int, ...]]], seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor} for the (name, shape) list, from one `torch.rand` of
    their total size on `device` (a generator on that device, seeded by
    `seed`)."""
    sizes = [math.prod(shape) for _, shape in shapes]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=dtype).mul_(2).sub_(1)
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        u = flat[at:at + n].view(shape)
        at += n
        if len(shape) >= 2:
            out[name] = u.mul_(math.sqrt(3.0 / math.prod(shape[1:])))
        elif name.endswith(".weight"):
            out[name] = u.mul_(0.1).add_(1.0)
        else:
            out[name] = u.mul_(0.01)
    return out


def param_shapes(module: torch.nn.Module) -> list[tuple[str, tuple[int, ...]]]:
    """The module's parameters as a sorted (name, shape) list."""
    return sorted((k, tuple(p.shape)) for k, p in module.named_parameters())


@torch.no_grad()
def load_params(module: torch.nn.Module, params: dict) -> None:
    """Copy `params` into the module's parameters in place (the optimizers
    keep their references); every parameter must be given, with its shape."""
    own = dict(module.named_parameters())
    if set(own) != set(params):
        missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
        raise ValueError(f"parameters differ: missing {missing[:5]}, unknown {extra[:5]}")
    for k, p in own.items():
        if tuple(p.shape) != tuple(params[k].shape):
            raise ValueError(f"{k}: shape {tuple(p.shape)} against {tuple(params[k].shape)}")
        p.copy_(params[k])
