"""The Waymo-size configuration and the Gaussian-cache steps on the CPU:
`pretrain-waymo`'s file through both sides' configuration loaders, its frames
path against the benchmark's reference by the cell's own comparison at tiny
widths, grouped pair encoding equal to batched, the cached trainer against
the reference's over 3 steps with cache hits, and the rasterizer's and the
cache's counters and device spans, recorded only under a profiler session.
"""
import dataclasses
import json

import pytest
import torch

from benchmark import common, spec
from benchmark.run import Spans
from ggrt_official_torch import config
from ggrt_official_torch.models import pixelsplat
from ggrt_official_torch.ops.rasterizer import api, tiling
from ggrt_official_torch.ops.rasterizer.projection import project_gaussians
from ggrt_official_torch.utils import tracing

SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tracing.clear()
    yield
    tracing.clear()
    torch.set_num_threads(threads)


def tiny_ctx(name: str, image=(16, 24), gaussians_per_pixel=None, **traffic) -> dict:
    """A cell of BENCHMARK.json at tiny_config() widths and a small image,
    with its own limits, on the CPU."""
    cell = spec.cell(spec.load(), name)
    model = json.loads(json.dumps(dataclasses.asdict(config.tiny_config())))
    if gaussians_per_pixel:
        model["encoder"]["gaussians_per_pixel"] = gaussians_per_pixel
    cell["config"] = {**cell["config"], "model": model, "image_size": list(image)}
    cell["traffic"] = {**cell["traffic"], **traffic}
    return {"cell": cell, "name": name, "seed": SEED, "trace": False, "device": torch.device("cpu")}


def profiled():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def test_waymo_config_loads_on_both_sides():
    cell = spec.cell(spec.load(), "pretrain-waymo.frames")
    llff = spec.cell(spec.load(), "pretrain-llff.frames")
    assert cell["config"]["image_size"] == [640, 960] and cell["config"]["reduced"] == []
    assert cell["config"]["model"] == llff["config"]["model"]
    prog, ref = common.program_config(cell), common.reference_config(cell)
    assert dataclasses.asdict(prog) == dataclasses.asdict(common.program_config(llff))
    assert dataclasses.asdict(ref) == dataclasses.asdict(common.reference_config(llff))
    assert prog.encoder.d_feature == ref.encoder.d_feature == 128
    assert common.image_size(cell) == (640, 960) and common.source_views(cell) == 5


@pytest.mark.parametrize("pairs_per_call", [None, 1])
def test_waymo_frames_match_the_reference(pairs_per_call, monkeypatch):
    """The program's frames path (encode_pairs + decode_frame), its pairs in
    one call or one a call as at 640x960, against the reference's pairwise
    encode and plain compositor, under the cell's limits."""
    ctx = tiny_ctx("pretrain-waymo.frames", frames_per_leg=2, checked_positions=3, warmup=1)
    h, w = common.image_size(ctx["cell"])
    if pairs_per_call:
        monkeypatch.setattr(pixelsplat, "MAX_PIXELS_PER_CALL", pairs_per_call * 2 * h * w)
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    checks = loop.check(ctx, loop.sound(ctx))
    assert [c["name"] for c in checks] == ["gaussians_gap", "frame_levels"]
    for c in checks:
        assert c["value"] <= c["limit"], c


@pytest.mark.parametrize("deterministic", [True, False])
@pytest.mark.parametrize("pairs_per_call", [1, 2, 3])
def test_grouped_encode_equals_batched(deterministic, pairs_per_call, monkeypatch):
    from ggrt_official_torch.models.ggrt import GGRtModel

    cfg = config.tiny_config()
    model = GGRtModel(cfg, device="cpu")
    g = torch.Generator().manual_seed(0)
    v, h, w = 5, 32, 48
    ctx = {"image": torch.rand(1, v, 3, h, w, generator=g),
           "extrinsics": torch.eye(4).repeat(1, v, 1, 1),
           "intrinsics": torch.tensor([[0.8, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1.0]]).repeat(1, v, 1, 1),
           "near": torch.full((1, v), 1.0), "far": torch.full((1, v), 10.0)}
    ctx["extrinsics"][0, :, 0, 3] = torch.linspace(-0.5, 0.5, v)
    enc = cfg.encoder
    u = None if deterministic else torch.rand(v - 1, 2, h * w, enc.num_surfaces, enc.gaussians_per_pixel,
                                              generator=g)
    with torch.no_grad():
        batched = model.gaussian.encode_pairs(ctx, 0, deterministic=deterministic, uniforms=u)
        monkeypatch.setattr(pixelsplat, "MAX_PIXELS_PER_CALL", pairs_per_call * 2 * h * w)
        grouped = model.gaussian.encode_pairs(ctx, 0, deterministic=deterministic, uniforms=u)
    assert all(torch.equal(a, b) for a, b in zip(batched, grouped))


def test_cached_steps_match_the_reference_with_hits():
    """The cell's compared steps, program against reference, under its
    limits. One Gaussian a pixel: at a tiny image the decoder raises K
    toward the tile's demand, and the reference's plain compositor then
    takes nearly all the CPU time, in proportion to the Gaussians."""
    ctx = tiny_ctx("pretrain-llff.step-cached", gaussians_per_pixel=1)
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    st = loop.setup(ctx, Spans(False))
    trainer = st["trainer"]
    assert int(ctx["cell"]["traffic"]["compared_steps"]) >= 3
    assert trainer.hits > 0 and trainer.misses > 0
    checks = loop.check(ctx, loop.release(st))
    assert [c["name"] for c in checks] == ["loss_gap", "first_grad_gap", "change_gap"]
    for c in checks:
        assert c["value"] <= c["limit"], c


def small_scene(n=64):
    g = torch.Generator().manual_seed(0)
    means = torch.cat([torch.rand(1, n, 2, generator=g) - 0.5, torch.rand(1, n, 1, generator=g) + 2], -1)
    cov = torch.diag_embed(torch.full((1, n, 3), 0.01))
    intr = torch.tensor([[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]])
    return (torch.eye(4)[None], intr, torch.tensor([1.0]), torch.tensor([10.0]), (16, 128), torch.zeros(1, 3),
            means, cov, torch.rand(1, n, 3, 1, generator=g), torch.rand(1, n, generator=g))


@pytest.mark.parametrize("max_per_tile", [4, 1024])
def test_raster_counters_count_keys_and_cut_pairs(max_per_tile):
    args = small_scene()
    api.render(*args, max_per_tile=max_per_tile)
    assert tracing.counts() == [] and tracing.spans() == []
    with profiled():
        api.render(*args, max_per_tile=max_per_tile)
    counted = {c.name: c.value for c in tracing.counts()}
    ext, intr, near, far, shape, _, means, cov, harm, opa = args
    ext, cov, means, near, far = api._rescale(ext, cov, means, near, far)
    pg = project_gaussians(means[0], cov[0], harm[0], opa[0], ext[0], intr[0], near[0], far[0], shape)
    stats = tiling.binning_overflow_stats(pg, shape, max_dup=32, max_per_tile=max_per_tile)
    assert counted["raster.keys"] == int(stats["pairs_wanted"] - stats["dropped_by_max_dup"]) > 0
    dropped = counted["raster.keys"] - counted["raster.kept"]
    assert dropped == int(stats["dropped_by_max_per_tile"])
    assert (dropped > 0) == (max_per_tile == 4)
    spans = {r.name: r for r in tracing.spans()}
    assert all(spans["raster.bin"].start_ns <= c.at_ns <= spans["raster.bin"].end_ns for c in tracing.counts())
    assert {"raster.project", "raster.bin", "raster.records", "raster.composite"} <= set(spans)


def test_cache_counters_and_span_only_while_profiling():
    from ggrt_official_torch.training.trainer_cached import CachedGGRtTrainer

    ctx = tiny_ctx("pretrain-llff.step-cached", gaussians_per_pixel=1)
    loop = spec.loop(ctx["cell"]["traffic"]["loop"])
    exs = loop.inputs(ctx)["examples"]
    trainer = CachedGGRtTrainer(common.program_config(ctx["cell"]), device="cpu")
    trainer.init_full()
    trainer.train_iteration(exs[0], "nerf_only")
    assert tracing.counts() == [] and tracing.spans() == []
    hits, misses = trainer.hits, trainer.misses
    with profiled():
        trainer.train_iteration(exs[1], "nerf_only")
    counted = {c.name: c.value for c in tracing.counts() if c.name.startswith("cache.")}
    assert counted == {"cache.hits": trainer.hits - hits, "cache.misses": trainer.misses - misses}
    assert sum(counted.values()) == common.source_views(ctx["cell"]) - 1
    assert [r.name for r in tracing.spans() if r.name == "cache.encode"] == ["cache.encode"]
