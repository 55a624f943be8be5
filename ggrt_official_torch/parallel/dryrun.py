"""The multi-rank proof (the JAX package's __graft_entry__.dryrun_multichip),
and `spawn`, which runs a function on n ranks of a fresh process group.

    python -m ggrt_official_torch.parallel.dryrun --n 4 --device cpu

Stages, each with its wall time, at dryrun_config() widths on a 32x64
synthetic scene with 3 source views:
  1. a render of 512 Gaussians with the tiles split over tp = n, "tiled";
  2. the same render, "cuda" (the compositor kernels on each rank's tiles
     on the card, their plain versions on the CPU), within 1e-3 of stage 1;
  3. one whole train step (IPO-Net + PixelSplat + losses + both
     optimizers, use_pred_pose) on a dp x tp mesh, dp 2 when n >= 4: each
     dp rank trains its own example; the loss must be finite.
Ranks talk over gloo on the CPU and NCCL on the card; NCCL takes one rank
per card.
"""
from __future__ import annotations

import argparse
import datetime
import math
import os
import pickle
import tempfile
import time
from typing import Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

GROUP_TIMEOUT_S = 60.0


def _rank_main(rank: int, fn: Callable, n: int, device: str, tmp: str, args: tuple) -> None:
    if device == "cpu":
        torch.set_num_threads(1)
    dist.init_process_group("gloo" if device == "cpu" else "nccl", init_method=f"file://{tmp}/store",
                            world_size=n, rank=rank, timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        result = fn(rank, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, n: int, device: str = "cuda", args: tuple = (), timeout: float = 600.0) -> list:
    """fn(rank, *args) on n spawned ranks of a process group (gloo for
    device "cpu", NCCL otherwise; a file:// store in a fresh temporary
    directory, a 60 s collective timeout). Returns each rank's (picklable)
    result in rank order. A rank that raises raises here; ranks still
    running after `timeout` seconds are terminated and TimeoutError is
    raised. `fn` must be importable by name."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(_rank_main, args=(fn, n, device, tmp, args), nprocs=n, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks of {getattr(fn, '__name__', fn)} still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                    p.join(10)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _scene(n_gaussians: int, device) -> tuple:
    """The dryrun's Gaussians (JAX's: uniform means in [-1, 1]^3 + (0, 0, 3),
    isotropic covariance 0.01, SH degree 1 at 0.3 sigma, opacity 0.7), from a
    seeded torch generator."""
    gen = torch.Generator().manual_seed(1)
    means = torch.rand(n_gaussians, 3, generator=gen) * 2.0 - 1.0 + torch.tensor([0.0, 0.0, 3.0])
    cov = torch.eye(3).expand(n_gaussians, 3, 3) * 0.01
    sh = torch.randn(n_gaussians, 3, 4, generator=gen) * 0.3
    opa = torch.full((n_gaussians,), 0.7)
    return tuple(x.to(device) for x in (means, cov, sh, opa))


def _dryrun_rank(rank: int, n: int, device: str) -> dict:
    from ..config import dryrun_config
    from ..data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
    from ..training.trainer import GGRtTrainer, make_pretrain_loss_fn
    from .mesh import make_mesh
    from .sharded_step import local_example, make_dp_train_step, mesh_device, replicate
    from .tile_parallel import render_tile_parallel

    t_start = time.perf_counter()
    stages = []

    def stage(msg):
        stages.append((msg, time.perf_counter() - t_start))
        if rank == 0:
            print(f"dryrun_multichip({n}): {msg} [t+{stages[-1][1]:.1f}s]", flush=True)

    cfg = dryrun_config()
    ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)

    # Stages 1 and 2: tile-parallel renders over tp = n.
    tp_mesh = make_mesh(data_parallel=1, tile_parallel=n, device_type=device)
    dev = mesh_device(tp_mesh)
    trainer = GGRtTrainer(cfg, device=dev)
    ctx = trainer.prepare_batch(collate_batch(ds[0]))["context"]
    args = (*_scene(512, dev), ctx["extrinsics"][0, 0], ctx["intrinsics"][0, 0], ctx["near"][0, 0],
            ctx["far"][0, 0], (32, 64), torch.zeros(3, device=dev))
    with torch.no_grad():
        img = render_tile_parallel(tp_mesh, *args, max_per_tile=128, backend="tiled")
        if not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"tp{n} render: non-finite image")
        stage(f"tp{n} render ok {tuple(img.shape)}")
        img_k = render_tile_parallel(tp_mesh, *args, max_per_tile=128, backend="cuda")
        err = float((img_k - img).abs().max())
    if not err < 1e-3:
        raise RuntimeError(f"tp{n} cuda render deviates from the tiled render: {err}")
    stage(f"tp{n} cuda render ok (err {err:.2e})")

    # Stage 3: one whole train step on the dp x tp mesh.
    dp = 2 if n >= 4 else max(n, 1)
    tpn = n // dp
    mesh = make_mesh(data_parallel=dp, tile_parallel=tpn, device_type=device)
    result = {"render_err": err, "dp": dp, "tp": tpn}
    if mesh.get_coordinate() is not None:
        trainer.init_full()
        replicate(trainer.model, mesh)
        step = make_dp_train_step(cfg, mesh, make_pretrain_loss_fn(trainer.model, cfg))
        local = local_example([trainer.prepare_batch(collate_batch(ds[i % len(ds)])) for i in range(dp)], mesh)
        trainer.generator.manual_seed(cfg.train.seed + mesh.get_local_rank("dp"))
        aux = step(trainer.state, trainer.model, local, trainer.draw_uniforms(local))
        loss, psnr = float(aux["loss_all"]), float(aux["psnr"])
        if not math.isfinite(loss):
            raise RuntimeError(f"dp{dp}xtp{tpn} step produced a non-finite loss: {loss}")
        stage(f"dp{dp}xtp{tpn} FULL train step ok loss={loss:.4f} psnr={psnr:.2f}")
        result.update(loss=loss, psnr=psnr)
    result["stages"] = stages
    return result


def dryrun_multichip(n_devices: int, device: str = "cuda", timeout: float = 600.0) -> dict:
    """Run the three stages on n_devices spawned ranks; returns rank 0's
    {"stages": [(message, seconds since its start)], "render_err", "dp",
    "tp", "loss", "psnr"}."""
    return spawn(_dryrun_rank, n_devices, device, args=(n_devices, device), timeout=timeout)[0]


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=None,
                   help="ranks to spawn; by default one per card on cuda (NCCL takes no more), 8 on cpu")
    p.add_argument("--device", default="cuda", help="cuda (NCCL, one rank per card) or cpu (gloo)")
    a = p.parse_args(argv)
    n = a.n if a.n is not None else (torch.cuda.device_count() if a.device == "cuda" else 8)
    if a.device == "cuda" and not 0 < n <= torch.cuda.device_count():
        raise SystemExit(f"--n {n}: NCCL takes one rank per card, and there are {torch.cuda.device_count()}")
    dryrun_multichip(n, a.device)
    print("dryrun ok")


if __name__ == "__main__":
    main()
