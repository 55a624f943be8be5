"""Data-parallel train step over the "dp" axis (the JAX package's
parallel/sharded_step.py).

The reference runs DDP over NCCL with one example per GPU
(base/trainer.py:115-117, dgaussian.py:32-45); the JAX package runs a
shard_map over "dp" with `pmean` of the gradients. Here each rank trains
its own example and, after its backward, averages with explicit
collectives over the dp group, in JAX's order: the gradients (one flat
buffer of every parameter's, in the model's parameter order, a parameter
without a gradient counted as zeros on every rank, as JAX's zero
cotangents are, so that every rank issues the same collectives), then
every aux entry; then the same gated, clipped Adam update runs everywhere
(clipping inside the update, after the average, as JAX's apply_updates
does after its pmean). Averaging is a sum, then a division by dp: the
same on gloo and NCCL. Not DistributedDataParallel: it renames the
parameters under `module.`, needs find_unused_parameters for pose_only
and buckets in its own order.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..config import GGRtConfig
from ..training import state as state_lib
from ..training.trainer import _to_device


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: the current card for a "cuda" mesh."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_example(examples: list, mesh: DeviceMesh) -> dict:
    """Rank r of the dp axis takes examples[r], on its device (the JAX
    package's stack_examples + shard_batch, one rank's share)."""
    return _to_device(examples[mesh.get_local_rank("dp")], mesh_device(mesh))


def shard_batch(batch, mesh: DeviceMesh):
    """A batch whose leaves carry a leading dp axis -> this rank's slice of
    it, on its device."""
    r = mesh.get_local_rank("dp")
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    return _to_device(batch[r], mesh_device(mesh))


def _mean(tensors: list, group) -> list:
    """The element-wise mean of `tensors` over `group`, in one collective."""
    n = dist.get_world_size(group)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat /= n
    return [x.view(t.shape) for x, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


@torch.no_grad()
def replicate(model: torch.nn.Module, mesh: DeviceMesh) -> None:
    """Every parameter and buffer of `model` from the mesh's first rank
    (along dp, then along tp), so that ranks built from different seeds
    start equal; the JAX package's state is replicated by construction.
    Called once, at setup, before the first step."""
    for dim in ("dp", "tp"):
        group = mesh.get_group(dim)
        src = dist.get_global_rank(group, 0)
        for t in model.state_dict().values():
            dist.broadcast(t, src=src, group=group)


def make_dp_train_step(cfg: GGRtConfig, mesh: DeviceMesh, loss_fn: Callable) -> Callable:
    """The data-parallel train step: step(trainer_state, model,
    local_batch, local_uniforms) -> aux, averaged over dp, detached.

    `loss_fn` is (batch, step, uniforms) -> (loss, aux) on one example
    (training/trainer.make_pretrain_loss_fn), `trainer_state` the
    TrainState over `model`'s parameters, which `replicate` has made
    equal on every rank."""
    group = mesh.get_group("dp")

    def step(trainer_state: state_lib.TrainState, model: torch.nn.Module, local_batch: dict,
             local_uniforms: torch.Tensor) -> dict:
        trainer_state.zero_grad()
        loss, aux = loss_fn(local_batch, trainer_state.step, local_uniforms)
        loss.backward()
        params = [p for p in model.parameters() if p.requires_grad]
        grads = _mean([p.grad if p.grad is not None else torch.zeros_like(p) for p in params], group)
        for p, g in zip(params, grads):
            p.grad = g
        aux = dict(zip(aux, _mean(list(aux.values()), group)))
        trainer_state.apply_updates(state_lib.STATE_JOINT)
        return aux

    return step
