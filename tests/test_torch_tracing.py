"""The port's span module (`utils/tracing.py`) on the CPU: off outside a
profiler session, nested records on the profiler's clock inside one, and the
rasterizer's spans nested at its stage boundaries."""
import numpy as np
import pytest
import torch

from ggrt_official_torch.ops.rasterizer import api
from ggrt_official_torch.training.trainer import prepare_batch
from ggrt_official_torch.utils import tracing
from ggrt_official_torch.utils.tracing import span


@pytest.fixture(autouse=True)
def fresh():
    tracing.clear()
    yield
    tracing.clear()


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@span("decorated")
def decorated(x):
    return x * 2


def test_off_records_nothing_and_opens_no_range(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("record_function called with tracing off")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    with span("a", device=True):
        with span("a.b"):
            pass
    assert decorated(3) == 6
    assert span("a") is span("a") and span("a") is not span("a", device=True)
    assert tracing.spans() == []


def test_nested_spans_carry_parent_and_root():
    with profiled():
        with span("outer") as outer:
            with span("mid") as mid:
                with span("inner") as inner:
                    pass
            with span("sibling") as sib:
                pass
        with span("second") as second:
            pass
    recs = tracing.spans()
    assert [r.name for r in recs] == ["inner", "mid", "sibling", "outer", "second"]
    assert (outer.parent, outer.root) == (None, outer.id)
    assert (mid.parent, mid.root) == (outer.id, outer.id)
    assert (inner.parent, inner.root) == (mid.id, outer.id)
    assert (sib.parent, sib.root) == (outer.id, outer.id)
    assert (second.parent, second.root) == (None, second.id)
    kids = inner.end_ns - inner.start_ns
    assert mid.children_ns == kids
    assert outer.self_ms == pytest.approx(outer.host_ms - mid.host_ms - sib.host_ms)
    assert all(r.device_ms is None for r in recs)
    assert tracing.spans() == recs   # reading does not consume


def test_host_start_on_the_profilers_clock():
    with profiled():
        with span("warm"):
            pass
    tracing.clear()
    with profiled() as prof:
        for i in range(5):
            with span(f"clock{i}"):
                torch.ones(64).sum()
    starts = {e.name(): e.start_ns() for e in prof.profiler.kineto_results.events()
              if e.name().startswith("ggrt.clock")}
    recs = tracing.spans()
    assert len(recs) == 5
    for r in recs:
        assert abs(r.start_ns - starts[f"ggrt.{r.name}"]) < 100_000


def test_decorator_keeps_the_return_value():
    with profiled():
        assert decorated(21) == 42
    assert decorated.__name__ == "decorated"
    assert [r.name for r in tracing.spans()] == ["decorated"]


def test_a_span_whose_block_raises_still_closes():
    with profiled() as prof:
        with pytest.raises(ValueError):
            with span("outer"):
                with span("fails"):
                    raise ValueError("x")
        with span("after") as after:
            pass
    recs = tracing.spans()
    assert [r.name for r in recs] == ["fails", "outer", "after"]
    assert recs[0].parent == recs[1].id and after.parent is None
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert "ggrt.fails" in names and "ggrt.outer" in names


def test_device_span_on_a_cpu_tensor_records_no_event_pair():
    x = torch.ones(8)
    with profiled():
        with span("dev", device=True):
            x.sum()
        traced = span("dev.fn", device=True)(lambda t: t * 2)
        traced(x)
    assert [(r.name, r.device_ms) for r in tracing.spans()] == [("dev", None), ("dev.fn", None)]


def test_render_spans_nest_at_the_stage_boundaries():
    """One view through `api.render` (the compositor's plain versions on the
    CPU): a `raster` span with the four stages under it, in order."""
    g = torch.Generator().manual_seed(0)
    n = 64
    means = torch.cat([torch.rand(1, n, 2, generator=g) - 0.5, torch.rand(1, n, 1, generator=g) + 2], -1)
    cov = torch.diag_embed(torch.full((1, n, 3), 0.01))
    harm = torch.rand(1, n, 3, 1, generator=g)
    opa = torch.rand(1, n, generator=g)
    intr = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]])
    args = (torch.eye(4)[None], intr, torch.tensor([1.0]), torch.tensor([10.0]), (16, 128), torch.zeros(1, 3),
            means, cov, harm, opa)
    plain = api.render(*args)
    with profiled():
        img = api.render(*args)
    assert torch.equal(img, plain)
    recs = tracing.spans()
    assert [r.name for r in recs] == ["raster.project", "raster.bin", "raster.records", "raster.composite",
                                      "raster"]
    assert all(r.parent == recs[-1].id and r.root == recs[-1].id for r in recs[:-1])


def test_prepare_batch_span():
    raw = {"rgb": np.zeros((1, 4, 4, 3), np.float32), "context": {}, "target": {}, "rgb_path": "x"}
    with profiled():
        out = prepare_batch(raw, lambda b: b, "cpu")
    assert isinstance(out["rgb"], torch.Tensor) and "rgb_path" not in out
    assert [r.name for r in tracing.spans()] == ["prepare_batch"]
