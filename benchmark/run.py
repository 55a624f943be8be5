"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
    python3 -m benchmark.run ...   (the same, from the root of the checkout)

The cell is an entry of `workloads` in BENCHMARK.json; its configuration,
traffic mix, loop and metrics are found by name (benchmark/spec.py). A run
makes its inputs and weights from the seed, warms up its own shapes,
measures for `--seconds`, then decides `correct` against the benchmark's
plain reference and prints one JSON object as the last line of standard
output. With `--trace 1` the window runs under torch.profiler and the line
carries the cell's per-layer metrics and a breakdown instead of its
end-to-end ones. Without a CUDA card, or without the program beside it, it
prints no result and exits non-zero.
"""
from __future__ import annotations

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Build caches live inside the checkout, at fixed paths (the program keeps
# its nvcc builds in ggrt_official_torch/_build/ itself).
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / ".cache" / "torch_extensions"))

from benchmark import chip, common, spec  # noqa: E402


# A traced run profiles the window's first items, up to this many seconds,
# and runs the rest of the window untraced: a longer trace only costs memory
# and the time to read it.
TRACE_SECONDS = 10.0


class Spans:
    """Named device spans of the timed items: CUDA events around each call
    and a `bench.<name>` range in the trace. Off in untraced runs, where a
    span costs nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.events: dict[str, list] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        with torch.profiler.record_function(f"bench.{name}"):
            start.record()
            try:
                yield
            finally:
                end.record()
        self.events.setdefault(name, []).append((start, end))

    def wrap(self, obj, attr: str, name: str) -> None:
        """Put a span around every call of obj.attr (an instance attribute
        shadows the method, so the program's own callers go through it)."""
        fn = getattr(obj, attr)

        def spanned(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)
        setattr(obj, attr, spanned)

    def ms(self) -> dict[str, list[float]]:
        return {k: [s.elapsed_time(e) for s, e in v] for k, v in self.events.items()}


def measure(loop, state, seconds: float, spans: Spans, trace: bool, device) -> dict:
    """The timed window: items one after another, each ended on the host,
    until `seconds` have passed; the last item runs to its end."""
    import torch

    on_card = device.type == "cuda"
    common.sync(device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    prof = traced = None
    if trace:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    item_ms = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function("bench.item"):
                loop.item(state, len(item_ms), spans)
        else:
            loop.item(state, len(item_ms), spans)
        t1 = time.perf_counter()
        item_ms.append((t1 - t0) * 1e3)
        if t1 - start >= seconds:
            break
        if prof is not None and t1 - start >= TRACE_SECONDS:
            prof.stop()
            traced, prof = prof, None
    window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if prof is not None:
        prof.stop()
        traced = prof
    return {"first_item_at": start, "window_s": window_s, "items": len(item_ms),
            "item_ms": item_ms, "peak_bytes": peak, "prof": traced}


def execute(ctx: dict, loop, readers: dict, seconds: float, device_info: dict, started: float) -> dict:
    """Set-up, window, reference and metrics of one run: the result line."""
    import torch

    cell, trace = ctx["cell"], ctx["trace"]
    spans = Spans(trace)
    state = loop.setup(ctx, spans)
    win = measure(loop, state, seconds, spans, trace, ctx["device"])
    record = {"window_s": win["window_s"], "items": win["items"], "item_ms": win["item_ms"],
              "peak_bytes": win["peak_bytes"], "setup_s": win["first_item_at"] - started,
              "spans": spans.ms(), "trace": None, "work": {}, "cell": cell, "device": device_info}
    if trace:
        from benchmark.trace import Trace

        record["trace"] = Trace(win.pop("prof"))
    held = loop.release(state)
    del state
    gc.collect()
    if ctx["device"].type == "cuda":
        torch.cuda.empty_cache()
    if trace:
        record["work"] = loop.work(ctx, held, record)
    checks = loop.check(ctx, held)
    failed = int(held.get("failed", 0))
    correct = failed == 0 and all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks)
    units = {m["name"]: m["unit"] for m in cell["end_to_end"] + cell["per_layer"]}
    metrics = {}
    for name, reader in readers.items():
        value = reader.read(record)
        if value is not None:
            metrics[name] = {"value": value, "unit": units[name]}
    device = {**device_info, "memory_peak_bytes": win["peak_bytes"]}
    line = {"correct": correct, "attempted": win["items"], "failed": failed, "metrics": metrics, "device": device}
    if trace:
        tr = record["trace"]
        device["busy_s"] = tr.busy_seconds()
        device["window_s"] = tr.window_s()
        line["breakdown"] = tr.breakdown()
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    for c in checks:
        at = f" at {c['at']}" if c.get("at") else ""
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r}){at}", file=sys.stderr)
    return line


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    try:
        bench = spec.load()
        cell = spec.cell(bench, args.workload)
        loop = spec.loop(cell["traffic"]["loop"])
        readers = {m["name"]: spec.metric(m["name"])
                   for m in cell["end_to_end" if not args.trace else "per_layer"]}
        torch = chip.require(cell["workload"]["chips"])
    except (spec.SpecError, chip.NoCard) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    try:
        import ggrt_official_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"benchmark: the program is not beside the benchmark: {e}", file=sys.stderr)
        return 2
    ctx = {"cell": cell, "name": args.workload, "seed": args.seed, "trace": bool(args.trace),
           "device": torch.device("cuda", 0)}
    line = execute(ctx, loop, readers, args.seconds, chip.describe(cell["workload"]["chips"]), PROCESS_START)
    bad = chip.forbidden_modules()
    if bad:
        print(f"benchmark: JAX modules in the process: {bad}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
