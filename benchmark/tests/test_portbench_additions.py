"""A cell, a configuration, a traffic mix and a metric are added by new
files and entries alone: the harness, copied into a fresh directory, finds
them by name without an edit to any file it has."""
import json
import shutil
from pathlib import Path

import pytest

from benchmark import spec

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture()
def copy(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path


def snapshot(root: Path) -> dict:
    return {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}


def test_new_cell_is_files_and_entries(copy):
    before = snapshot(copy)
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    cfg = json.loads((copy / "benchmark/configs/pretrain-llff.json").read_text())
    cfg["image_size"] = [640, 960]
    (copy / "benchmark/configs/pretrain-waymo.json").write_text(json.dumps(cfg))
    mix = json.loads((copy / "benchmark/traffic/frames.json").read_text())
    mix["frames_per_leg"] = 60
    (copy / "benchmark/traffic/slow-orbit.json").write_text(json.dumps(mix))
    (copy / "benchmark/metrics/items_per_s.orbit.py").write_text(
        "def read(rec):\n    return rec['items'] / rec['window_s']\n")
    bench["configs"].append({"name": "pretrain-waymo", "source": "https://example.org/waymo",
                             "file": "benchmark/configs/pretrain-waymo.json", "reduced": [], "why": "bigger"})
    bench["workloads"].append({"name": "pretrain-waymo.frames", "config": "pretrain-waymo",
                               "traffic": "slow-orbit", "chips": 1, "why": "a slower orbit at 640x960"})
    bench["per_layer"].append({"name": "items_per_s.orbit", "unit": "frames/s", "better": "higher",
                               "source": "host_clock", "layer": "decoder and rasterizer",
                               "moves": "frame_ms_p95", "workloads": ["pretrain-waymo.frames"]})
    bench["end_to_end"][[m["name"] for m in bench["end_to_end"]].index("frame_ms_p95")]["workloads"].append(
        "pretrain-waymo.frames")
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell(spec.load(copy), "pretrain-waymo.frames", root=copy)
    assert cell["config"]["image_size"] == [640, 960]
    assert cell["traffic"]["frames_per_leg"] == 60
    assert [m["name"] for m in cell["per_layer"]] == ["items_per_s.orbit"]
    assert "frame_ms_p95" in [m["name"] for m in cell["end_to_end"]]
    loop = spec.load_file(copy / "benchmark/loops" / f"{cell['traffic']['loop']}.py", "loop")
    assert callable(loop.setup) and callable(loop.item) and callable(loop.check)
    metric = spec.load_file(copy / "benchmark/metrics/items_per_s.orbit.py", "metric")
    assert metric.read({"items": 50, "window_s": 10.0}) == 5.0
    after = snapshot(copy)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {copy / "BENCHMARK.json"}


@pytest.mark.parametrize("bad", ["has space", "slash/name", "comma,name", "", "-lead", "x" * 65, "µs"])
def test_bad_names_refused(copy, bad):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["workloads"][0]["name"] = bad
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError):
        spec.load(copy)


@pytest.mark.parametrize("bad", ["tokens per s", "x" * 17, "µs", "a,b", ""])
def test_bad_units_refused(copy, bad):
    bench = json.loads((copy / "BENCHMARK.json").read_text())
    bench["per_layer"][0]["unit"] = bad
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(spec.SpecError):
        spec.load(copy)


@pytest.mark.parametrize("good", ["tokens/s", "%", "launches/frame", "GiB", "ms"])
def test_good_units_pass(good):
    assert spec.check_unit(good, "m") == good


def test_harness_lists_no_cell():
    """No file of the harness names a cell, a configuration or a mix: they are
    found through BENCHMARK.json."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {w["name"] for w in bench["workloads"]} | {c["name"] for c in bench["configs"]}
    for path in (ROOT / "benchmark").glob("*.py"):
        text = path.read_text()
        assert not [n for n in names if n in text], path
