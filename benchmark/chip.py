"""The card a run uses: the check that there is one, its name and power
limit, and the check that no JAX module came into the process."""
from __future__ import annotations

import subprocess
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "ggrt_official_tpu")


class NoCard(RuntimeError):
    """The run asks for more CUDA cards than the machine has."""


def require(chips: int):
    """torch, once there are `chips` CUDA cards; NoCard otherwise. The run
    never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"the cell asks for {chips} cards, torch sees {torch.cuda.device_count()}")
    return torch


def power_limit_w() -> float | None:
    """The first card's power limit in watts, from nvidia-smi (None where it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def describe(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit_w": power_limit_w()}


def forbidden_modules() -> list[str]:
    """Modules in this process whose top-level name is JAX's, flax's or the
    JAX package's, compared whole (`ggrt_official_torch` is not
    `ggrt_official_tpu`)."""
    return sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)
