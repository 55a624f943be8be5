"""Small cells for the CPU tests: a cell of BENCHMARK.json with the port's
`tiny_config()` widths at a small image, run on the CPU through the
harness's own loop (the kernels' plain versions stand in for them there)."""
from __future__ import annotations

import dataclasses
import json
import time

import torch

from benchmark import run, spec


def tiny_cell(name: str, image=(32, 64), **traffic) -> dict:
    from ggrt_official_torch import config

    cell = spec.cell(spec.load(), name)
    cfg = config.tiny_config()
    if cell["workload"]["config"].startswith("finetune"):
        cfg.train = config.finetune_config().train
    model = json.loads(json.dumps(dataclasses.asdict(cfg)))
    cell["config"] = {**cell["config"], "model": model, "image_size": list(image)}
    cell["traffic"] = {**cell["traffic"], **traffic}
    return cell


SMALL = {
    "pretrain-llff.serve": {"scenes": 2, "checked_requests": 2, "warmup": 1},
    "pretrain-llff.frames": {"frames_per_leg": 2, "checked_positions": 3, "warmup": 1},
    "finetune-llff.step": {},
    "pretrain-llff.train": {"scenes": 2, "compared_steps": 2},
}


def ctx_of(name: str, seed: int = 2**31 + 11) -> dict:
    return {"cell": tiny_cell(name, **SMALL[name]), "name": name, "seed": seed, "trace": False,
            "device": torch.device("cpu")}


def run_cell(name: str, seconds: float = 0.5, seed: int = 2**31 + 11) -> dict:
    """One whole run of a small cell on the CPU, past the look for a card:
    set-up, window, reference and metrics. Returns the result line."""
    ctx = ctx_of(name, seed)
    cell = ctx["cell"]
    readers = {m["name"]: spec.metric(m["name"]) for m in cell["end_to_end"]}
    return run.execute(ctx, spec.loop(cell["traffic"]["loop"]), readers, seconds, {"platform": "cpu"},
                       time.perf_counter())
