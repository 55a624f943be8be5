"""Wall-clock and device-memory benchmarking (the JAX package's
utils/benchmarker.py; the reference's misc/benchmarker.py).

Tagged timing with a JSON dump and a per-device memory dump. Work on a CUDA
device is queued, not done, when a call returns, so on one the timer waits
for the device before it reads the clock at entry and at exit; on the CPU
it reads the clock alone and never calls into torch.cuda.
"""
from __future__ import annotations

import json
import time
from collections import defaultdict
from contextlib import contextmanager
from pathlib import Path

import torch


class Benchmarker:
    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.execution_times = defaultdict(list)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextmanager
    def time(self, tag: str, num_calls: int = 1):
        """Seconds of the block, split evenly over `num_calls` entries."""
        self._sync()
        start_time = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            end_time = time.perf_counter()
            for _ in range(num_calls):
                self.execution_times[tag].append((end_time - start_time) / num_calls)

    def dump(self, path) -> None:
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        with path.open("w") as f:
            json.dump(dict(self.execution_times), f)

    def dump_memory(self, path) -> dict:
        """torch.cuda.memory_stats of every card, under the JAX package's
        keys device_{i}, as ints; {} for a CPU benchmarker. Returns what it
        wrote."""
        path = Path(path)
        path.parent.mkdir(exist_ok=True, parents=True)
        stats = {}
        if self.device.type == "cuda":
            for i in range(torch.cuda.device_count()):
                ms = torch.cuda.memory_stats(i)
                if ms:
                    stats[f"device_{i}"] = {k: int(v) for k, v in ms.items()}
        with path.open("w") as f:
            json.dump(stats, f)
        return stats

    def summarize(self) -> None:
        for tag, times in self.execution_times.items():
            print(f"{tag}: {len(times)} calls, avg. {sum(times) / len(times):.3f} s/call")
