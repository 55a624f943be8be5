"""What the loops share: the two sides' configurations, the precision
switch, the cell's stored limits, the comparisons, and device calls that
also run on the CPU (for the harness's own tests)."""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
_T0 = time.perf_counter()


def note(msg: str) -> None:
    """A set-up stage on standard error, with the seconds since start."""
    print(f"[{time.perf_counter() - _T0:8.2f} s] {msg}", file=sys.stderr, flush=True)


def program_config(cell: dict):
    """The program's GGRtConfig as the cell's configuration file states it."""
    from ggrt_official_torch import config

    return config.apply_overrides(config.GGRtConfig(), cell["config"]["model"])


def reference_config(cell: dict):
    from .reference.ggrt import config

    return config.apply_overrides(config.GGRtConfig(), cell["config"]["model"])


def image_size(cell: dict) -> tuple[int, int]:
    return tuple(cell["config"]["image_size"])


def source_views(cell: dict) -> int:
    return int(cell["config"]["model"]["train"]["num_source_views"])


def set_tf32(on: bool) -> None:
    """TF32 in cuBLAS and cuDNN, process-wide: off is the configurations'
    float32, on is the control's lower precision."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def cell_data(name: str) -> dict:
    """benchmark/cells/<cell>.json: the cell's limits and its FLOPs per item."""
    path = HERE / "cells" / f"{name}.json"
    return json.loads(path.read_text()) if path.is_file() else {}


def limit(ctx: dict, key: str) -> float:
    return float(ctx.get("limits", cell_data(ctx["name"]).get("limits", {}))[key])


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def seeded(seed: int, *salt: int) -> int:
    """A 63-bit generator seed for (seed, salt...), any seed size."""
    ss = np.random.SeedSequence([int(seed) % 2**64, *salt])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def max_gap(a, b) -> float:
    """Largest |a - b|, over the largest |b|: the widest gap as a share of
    the reference's scale."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    scale = max(float(np.abs(b).max()), 1e-30)
    return float(np.abs(a - b).max()) / scale


def leaf_norms(named: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in named.items()}


def worst_leaf(prog: dict, ref: dict, keep=None) -> tuple[float, str]:
    """The worst leaf's |norm_program - norm_reference| over the larger of
    that leaf's reference norm and the median leaf's: (gap, leaf)."""
    names = [k for k in ref if keep is None or k in keep]
    med = float(np.median([ref[k] for k in names])) if names else 0.0
    worst, which = 0.0, ""
    for k in names:
        if k not in prog:
            return float("inf"), k
        gap = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if not np.isfinite(gap) or gap > worst:
            worst, which = (gap if np.isfinite(gap) else float("inf")), k
    return worst, which


def adam_first_grads(model: torch.nn.Module, optimizers) -> dict:
    """Each leaf's gradient as its Adam got it at the first step, from the
    state after that step: exp_avg / (1 - beta1)."""
    by_id = {id(p): k for k, p in model.named_parameters()}
    out = {}
    for opt in optimizers:
        beta1 = opt.param_groups[0]["betas"][0]
        for p, st in opt.state.items():
            out[by_id[id(p)]] = st["exp_avg"] / (1.0 - beta1)
    return out
