"""The metric arithmetic: percentiles, windows over counts, the idle share
of a trace, the live-pair bound, the stored FLOP counts, and a run that
finds no card."""
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import common, flops, roofline, spec
from benchmark.trace import Trace

ROOT = Path(__file__).resolve().parents[2]


def reader(name):
    return spec.metric(name).read


def test_p95_over_all_frames():
    rec = {"item_ms": [float(x) for x in range(100, 0, -1)]}
    assert reader("frame_ms_p95")(rec) == 95.0
    assert reader("frame_ms_p95")({"item_ms": [3.0]}) == 3.0
    assert reader("frame_ms_p95")({"item_ms": [float(x) for x in range(1, 21)]}) == 19.0


@pytest.mark.parametrize("name", ["request_ms", "step_ms"])
def test_window_over_count(name):
    assert reader(name)({"window_s": 10.5, "items": 4}) == pytest.approx(2625.0)


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
    """Two items of 1000 ns each; kernels busy 0-300, 250-400 (overlapping),
    700-1000 and 1000-1500, so 1000-2000 has a 500 ns gap; a copy counts as
    busy but not as a launch; annotations are neither."""
    return Trace(Prof([
        Ev("bench.item", "CPU", 0, 1000), Ev("bench.item", "CPU", 1000, 1000),
        Ev("aten::mm", "CPU", 1400, 300),
        Ev("k1", "CUDA", 0, 300), Ev("k2", "CUDA", 250, 150), Ev("k1", "CUDA", 700, 300),
        Ev("Memcpy DtoH (Device -> Pinned)", "CUDA", 1000, 500),
        Ev("bench.item", "CUDA", 0, 2000, annotation=True),
    ]))


def test_idle_share_of_a_known_gap():
    tr = synthetic()
    assert tr.window_s() == pytest.approx(2e-6)
    assert tr.busy_seconds() == pytest.approx(1.2e-6)   # 0-400, 700-1500
    for name in ("idle_pct.serve", "idle_pct.frames", "idle_pct.step"):
        assert reader(name)({"trace": tr}) == pytest.approx(40.0)
    assert tr.item_busy_ms() == pytest.approx([7e-4, 5e-4])
    assert tr.launches_per_item() == [3, 0]
    bd = tr.breakdown()
    assert bd["idle_gaps"][0] == ["bench.item / aten::mm", pytest.approx(5e-7)]
    assert bd["device_ops"][0] == ["k1", pytest.approx(6e-7)]
    assert reader("launches.frames")({"trace": tr}) == 1.5


def test_no_reading_gives_no_metric():
    empty = {"trace": None, "spans": {}, "work": {}, "cell": {"workload": {"name": "x"}}}
    for name in ("idle_pct.step", "mfu.step", "composite_fwd_roofline.step", "iponet_ms.serve",
                 "frame_device_ms.frames", "launches.frames", "tile_pass_ms.finetune"):
        assert reader(name)(empty) is None


def test_live_pairs_against_chip_smoke():
    """The reference's count of live (pixel, Gaussian) pairs equals the one
    chip_smoke.py takes from the program's records, on a small scene."""
    import chip_smoke
    from ggrt_official_torch.ops.rasterizer import api, cuda_composite, projection, tiling

    g = torch.Generator().manual_seed(3)
    n, image = 400, (16, 256)
    means = torch.cat([torch.rand(1, n, 2, generator=g) * 2 - 1, torch.rand(1, n, 1, generator=g) * 3 + 2], -1)
    scale = torch.rand(1, n, 3, generator=g) * 0.05 + 0.01
    cov = torch.diag_embed(scale**2)
    harm = torch.rand(1, n, 3, 4, generator=g)
    opa = torch.rand(1, n, generator=g)
    extr = torch.eye(4)[None]
    intr = torch.tensor([[[1.0, 0, 0.5], [0, 16.0, 0.5], [0, 0, 1]]])
    near, far = torch.tensor([1.0]), torch.tensor([10.0])
    mine = roofline.render_work(extr, intr, near, far, image, means, cov, harm, opa, max_dup=32, max_per_tile=128)

    e, c, m, nr, fr = api._rescale(extr, cov, means, near, far)
    pg = projection.project_gaussians(m[0], c[0], harm[0], opa[0], e[0], intr[0], nr[0], fr[0], image)
    b = tiling.bin_gaussians(pg, image, max_dup=32, max_per_tile=128)
    rec, col, cnt = cuda_composite.build_records(pg, b)
    _, _, tst, nexec = cuda_composite.composite_records_plain(rec, col, cnt, tiling.TILE_H, tiling.TILE_W)
    theirs = chip_smoke.live_pairs(rec, {"nexec": nexec, "tst": tst}, (tiling.TILE_H, tiling.TILE_W))
    assert mine["pixels"] == 16 * 256 and theirs > 1000
    assert abs(mine["pairs"] - theirs) <= 0.002 * theirs
    ops_ms = roofline.OPS_PER_EVAL * mine["pairs"] / chip_smoke.H100_FP32_FLOPS * 1e3
    assert roofline.fwd_bound_ms(mine) == pytest.approx(max(ops_ms, chip_smoke.bound(
        roofline.OPS_PER_EVAL * mine["pairs"], 36 * mine["entries"] + 12 * mine["pixels"])[0]))


@pytest.mark.parametrize("name", ["pretrain-llff.serve", "finetune-llff.step", "pretrain-llff.train"])
def test_stored_flops_recounted(name):
    """The FLOPs that mfu.* divide by, counted again on the meta device at the
    cell's own shapes."""
    cell = spec.cell(spec.load(), name)
    assert flops.count(cell) == common.cell_data(name)["flops_per_item"]


def test_a_run_without_a_card_fails_and_prints_nothing(tmp_path):
    out = subprocess.run([sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", "pretrain-llff.serve",
                          "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=tmp_path,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()
    with pytest.raises(json.JSONDecodeError):
        json.loads(out.stdout or "x")
