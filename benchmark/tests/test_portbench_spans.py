"""The metrics that read the program's own spans (`ggrt.*` ranges and the
port's span records): each against a synthetic trace with known numbers,
none where there is nothing to read, the ranges and records of a real CPU
profile on one clock, and on the card a traced frame whose device events do
not change with the spans on."""
import types

import numpy as np
import pytest
import torch

from benchmark import program_spans, spec
from benchmark.trace import Trace

NEW = ["prepare_ms.serve", "prepare_ms.step", "optimizer_ms.step", "sfm_loss_ms.step", "raster_idle_ms.frames"]


def reader(name):
    return spec.metric(name).read


class Ev:
    def __init__(self, name, dev, start, dur, annotation=False):
        self._n, self._d, self._s, self._t, self._a = name, dev, start, dur, annotation

    def name(self):
        return self._n

    def device_type(self):
        return f"DeviceType.{self._d}"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._t

    def is_user_annotation(self):
        return self._a


class Prof:
    def __init__(self, events):
        self.profiler = type("P", (), {"kineto_results": type("K", (), {"events": lambda self: events})()})()


def synthetic():
    """Three items of 10000 ns. prepare_batch 1000, 2000, 3000 ns; optimizer
    500, 400, 900 ns; raster 4000 ns in each, the device busy for 1000 ns of
    the first (a kernel starting before it), all of the second and none of
    the third; a device-side ggrt annotation that counts as nothing."""
    ev = [Ev("bench.item", "CPU", 10000 * i, 10000) for i in range(3)]
    ev += [Ev("ggrt.prepare_batch", "CPU", 100, 1000), Ev("ggrt.prepare_batch", "CPU", 10100, 2000),
           Ev("ggrt.prepare_batch", "CPU", 20100, 3000), Ev("ggrt.prepare_batch", "CPU", 40000, 9000)]
    ev += [Ev("ggrt.optimizer", "CPU", 9000, 500), Ev("ggrt.optimizer", "CPU", 19000, 400),
           Ev("ggrt.optimizer", "CPU", 29000, 900)]
    ev += [Ev("ggrt.raster", "CPU", 1000 + 10000 * i, 4000) for i in range(3)]
    ev += [Ev("k", "CUDA", 500, 1500), Ev("k", "CUDA", 10500, 5000),
           Ev("ggrt.raster", "CUDA", 21000, 4000, annotation=True)]
    return Trace(Prof(ev))


def record(trace):
    return {"trace": trace, "spans": {}, "work": {}, "cell": {"workload": {"name": "x"}}}


def test_host_spans_per_item():
    rec = record(synthetic())
    assert program_spans.host_ms(rec, "prepare_batch") == pytest.approx([1e-3, 2e-3, 3e-3])
    for name in ("prepare_ms.serve", "prepare_ms.step"):
        assert reader(name)(rec) == pytest.approx(2e-3)
    assert reader("optimizer_ms.step")(rec) == pytest.approx(5e-4)


def test_raster_idle_is_the_span_less_the_busy_union():
    tr = synthetic()
    rec = record(tr)
    assert program_spans.idle_ms(rec, "raster") == pytest.approx([3e-3, 0.0, 4e-3])
    assert reader("raster_idle_ms.frames")(rec) == pytest.approx(3e-3)
    item_idle = [(hi - lo) / 1e6 - b for (lo, hi), b in zip(tr.items, tr.item_busy_ms())]
    assert all(a <= b + 1e-12 for a, b in zip(program_spans.idle_ms(rec, "raster"), item_idle))


def test_sfm_loss_device_ms_grouped_by_host_start(monkeypatch):
    recs = [types.SimpleNamespace(name="sfm_loss", start_ns=t, device_ms=ms)
            for t, ms in ((500, 1.5), (10500, 2.5), (10600, 1.0), (25000, 0.5), (40000, 100.0))]
    recs += [types.SimpleNamespace(name="iponet", start_ns=400, device_ms=9.0),
             types.SimpleNamespace(name="sfm_loss", start_ns=600, device_ms=None)]
    monkeypatch.setattr(program_spans, "program_records", lambda: recs)
    rec = record(synthetic())
    assert program_spans.device_ms(rec, "sfm_loss") == pytest.approx([1.5, 3.5, 0.5])
    assert reader("sfm_loss_ms.step")(rec) == pytest.approx(1.5)


@pytest.mark.parametrize("name", NEW)
def test_nothing_to_read_gives_no_metric(name, monkeypatch):
    monkeypatch.setattr(program_spans, "program_records", lambda: [])
    assert reader(name)(record(None)) is None
    bare = Trace(Prof([Ev("bench.item", "CPU", 0, 1000), Ev("k", "CUDA", 0, 500)]))
    assert reader(name)(record(bare)) is None


def test_each_new_metric_is_listed_with_its_cells():
    bench = spec.load()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["source"] == "program_span" and m["unit"] == "ms"
        for cell in m["workloads"]:
            assert m["moves"] in [e["name"] for e in spec.metrics_of(bench, cell, "end_to_end")]


def test_cpu_profile_ranges_and_records_share_a_clock():
    """A real profile of three rasterizer calls on the CPU, each in a
    `bench.item` range: the trace's `ggrt.raster` ranges give the records'
    host times, item by item."""
    from ggrt_official_torch.ops.rasterizer import api
    from ggrt_official_torch.utils import tracing

    g = torch.Generator().manual_seed(0)
    n = 48
    means = torch.cat([torch.rand(1, n, 2, generator=g) - 0.5, torch.rand(1, n, 1, generator=g) + 2], -1)
    args = (torch.eye(4)[None], torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]]), torch.tensor([1.0]),
            torch.tensor([10.0]), (16, 128), torch.zeros(1, 3), means, torch.diag_embed(torch.full((1, n, 3), 0.01)),
            torch.rand(1, n, 3, 1, generator=g), torch.rand(1, n, generator=g))
    api.render(*args)
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with torch.profiler.record_function("bench.item"):
                api.render(*args)
    recs = [r for r in tracing.spans() if r.name == "raster"]
    tracing.clear()
    rec = record(Trace(prof))
    ranges = program_spans.host_ms(rec, "raster")
    assert len(ranges) == len(recs) == 3
    assert np.allclose(ranges, [r.host_ms for r in recs], atol=0.1)
    assert program_spans.idle_ms(rec, "raster") == pytest.approx(ranges)   # no device on the CPU


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_spans_leave_the_device_events_alone(card, monkeypatch):
    """Five traced frames of the frames cell with the spans on and five with
    them held off: the same kernels, copies and sets, item by item (the
    ranges' device-side annotations stay out of the trace's device events);
    with them on, each record starts within 100 us of its range."""
    from benchmark.loops import frames
    from benchmark.run import Spans
    from ggrt_official_torch.utils import tracing

    ctx = {"cell": spec.cell(spec.load(), "pretrain-llff.frames"), "name": "pretrain-llff.frames",
           "seed": 2**31 + 31, "trace": False, "device": card}
    st = frames.setup(ctx, Spans(False))

    def traced():
        tracing.clear()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for pos in range(5):
                with torch.profiler.record_function("bench.item"):
                    frames.frame(st, pos)
        return Trace(prof), tracing.spans()

    on, recs = traced()
    with monkeypatch.context() as m:
        m.setattr(tracing, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
        off, none = traced()
    tracing.clear()
    assert none == [] and not any(n.startswith("ggrt.") for n in off.host_name)
    assert on.launches_per_item() == off.launches_per_item()
    assert sorted(on.dev_name.tolist()) == sorted(off.dev_name.tolist())
    assert not any(n.startswith("ggrt.") for n in on.dev_name)
    starts = {}
    for name, s in zip(on.host_name, on.host_s):
        if name.startswith("ggrt."):
            starts.setdefault(name, []).append(int(s))
    got = {}
    for r in recs:
        got.setdefault(f"ggrt.{r.name}", []).append(r.start_ns)
    assert sorted(got) == sorted(starts) and "ggrt.raster.composite" in got
    for name, s in starts.items():
        assert np.abs(np.sort(s) - np.sort(got[name])).max() < 100_000, name
