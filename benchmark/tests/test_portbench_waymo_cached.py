"""The cells `pretrain-waymo.frames` and `pretrain-llff.step-cached` and the
metrics that read the port's new counters and device spans: each reader on
a synthetic trace with known numbers, none where there is nothing to read
(a program without counters), the entries as BENCHMARK.json lists them, a
whole small run of each cell on the CPU, and on the card the control
failing and the program passing at each cell's own size."""
import dataclasses
import json
import math
import time
import types

import pytest
import torch

from benchmark import program_counters, program_spans, run, spec
from benchmark.trace import Trace

CELLS = ["pretrain-waymo.frames", "pretrain-llff.step-cached"]
FRAMES = ["raster_bin_ms.frames", "raster_composite_ms.frames", "raster_keys.frames", "raster_dropped_pct.frames"]
CACHED = ["cache_hit_pct.cached", "cache_encode_ms.cached"]


def reader(name):
    return spec.metric(name).read


class Ev:
    def __init__(self, name, dev, start, dur):
        self._n, self._d, self._s, self._t = name, dev, start, dur

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return False


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda self: events})()})()


def record(trace):
    return {"trace": trace, "spans": {}, "work": {}, "cell": {"workload": {"name": "x"}}}


def three_items():
    """Three items of 10000 ns; a kernel in each."""
    ev = [Ev("bench.item", "CPU", 10000 * i, 10000) for i in range(3)]
    ev += [Ev("k", "CUDA", 10000 * i + 100, 500) for i in range(3)]
    return Trace(Prof(ev))


def counts(*triples):
    return [types.SimpleNamespace(name=n, at_ns=t, value=v) for n, t, v in triples]


def spans(*triples):
    return [types.SimpleNamespace(name=n, start_ns=t, device_ms=ms) for n, t, ms in triples]


def test_frames_readers(monkeypatch):
    monkeypatch.setattr(program_counters, "program_counts", lambda: counts(
        ("raster.keys", 100, 4e6), ("raster.kept", 110, 1e6), ("raster.keys", 10100, 6e6),
        ("raster.kept", 10110, 3e6), ("raster.keys", 20100, 5e6), ("raster.kept", 20110, 2e6),
        ("raster.keys", 40000, 1e9)))
    monkeypatch.setattr(program_spans, "program_records", lambda: spans(
        ("raster.bin", 200, 3.0), ("raster.bin", 10200, 5.0), ("raster.bin", 20200, 4.0),
        ("raster.composite", 300, 1.0), ("raster.composite", 10300, 2.0), ("raster.composite", 20300, 9.0),
        ("raster.bin", 400, None)))
    rec = record(three_items())
    assert program_counters.per_item(rec, "raster.keys") == [4e6, 6e6, 5e6]
    assert reader("raster_keys.frames")(rec) == pytest.approx(5.0)
    assert reader("raster_dropped_pct.frames")(rec) == pytest.approx(100.0 * 9 / 15)
    assert reader("raster_bin_ms.frames")(rec) == pytest.approx(4.0)
    assert reader("raster_composite_ms.frames")(rec) == pytest.approx(2.0)


def test_cached_readers(monkeypatch):
    monkeypatch.setattr(program_counters, "program_counts", lambda: counts(
        ("cache.hits", 100, 0), ("cache.misses", 100, 4), ("cache.hits", 10100, 3),
        ("cache.misses", 10100, 1), ("cache.hits", 20100, 2), ("cache.misses", 20100, 2)))
    monkeypatch.setattr(program_spans, "program_records", lambda: spans(
        ("cache.encode", 150, 400.0), ("cache.encode", 10150, 100.0), ("cache.encode", 20150, 200.0)))
    rec = record(three_items())
    assert reader("cache_hit_pct.cached")(rec) == pytest.approx(100.0 * 5 / 12)
    assert reader("cache_encode_ms.cached")(rec) == pytest.approx(200.0)


@pytest.mark.parametrize("name", FRAMES + CACHED)
def test_nothing_to_read_gives_no_metric(name, monkeypatch):
    """A program without counters (no `tracing.counts`) or without the device
    spans, as the parent of these metrics is, and an untraced run: None."""
    from ggrt_official_torch.utils import tracing

    monkeypatch.delattr(tracing, "counts")
    monkeypatch.setattr(program_spans, "program_records", lambda: spans(("raster.bin", 100, None)))
    assert reader(name)(record(None)) is None
    assert reader(name)(record(three_items())) is None


def test_entries():
    bench = spec.load()
    cells = {w["name"]: w for w in bench["workloads"]}
    for name in CELLS:
        assert cells[name]["chips"] == 1
        cell = spec.cell(bench, name)
        assert callable(spec.loop(cell["traffic"]["loop"]).check)
        e2e = [m["name"] for m in cell["end_to_end"]]
        assert "setup_s" in e2e and "peak_gib" in e2e and len(e2e) == 3
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in FRAMES + CACHED:
        m = per_layer[name]
        assert m["source"] == "program_span"
        assert m["workloads"] == (["pretrain-llff.frames", "pretrain-waymo.frames"] if name in FRAMES
                                  else ["pretrain-llff.step-cached"])
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.metrics_of(bench, cell, "end_to_end")]


def test_frames_pairwise_keeps_the_frames_mix():
    frames = json.loads((spec.HERE / "traffic" / "frames.json").read_text())
    pairwise = json.loads((spec.HERE / "traffic" / "frames-pairwise.json").read_text())
    assert {k: v for k, v in pairwise.items() if k not in ("loop", "about")} == \
        {k: v for k, v in frames.items() if k not in ("loop", "about")}


def small_ctx(name):
    from ggrt_official_torch import config

    cell = spec.cell(spec.load(), name)
    model = json.loads(json.dumps(dataclasses.asdict(config.tiny_config())))
    model["encoder"]["gaussians_per_pixel"] = 1
    cell["config"] = {**cell["config"], "model": model, "image_size": [16, 24]}
    if name.endswith("frames"):
        cell["traffic"] = {**cell["traffic"], "frames_per_leg": 2, "checked_positions": 3, "warmup": 1}
    return {"cell": cell, "name": name, "seed": 2**31 + 41, "trace": False, "device": torch.device("cpu")}


@pytest.mark.parametrize("name", CELLS)
def test_whole_small_run(name):
    ctx = small_ctx(name)
    readers = {m["name"]: spec.metric(m["name"]) for m in ctx["cell"]["end_to_end"]}
    line = run.execute(ctx, spec.loop(ctx["cell"]["traffic"]["loop"]), readers, 0.5, {"platform": "cpu"},
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert all(math.isfinite(c["value"]) for c in line["checks"].values())


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def failed(checks):
    return [c["name"] for c in checks if not c["value"] <= c["limit"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_control_fails(card, name):
    ctx = {"cell": spec.cell(spec.load(), name), "name": name, "seed": 2**31 + 23, "trace": False, "device": card}
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    assert failed(loop.control(ctx, loop.inputs(ctx)))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_program_passes(card, name):
    ctx = {"cell": spec.cell(spec.load(), name), "name": name, "seed": 2**31 + 24, "trace": False, "device": card}
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    assert not failed(loop.check(ctx, loop.sound(ctx)))
