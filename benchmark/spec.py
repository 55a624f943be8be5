"""The benchmark's description: `BENCHMARK.json` at the root of the checkout,
and the files it names by name.

Nothing here lists a cell, a configuration, a traffic mix or a metric. A
cell is an entry of `workloads`; its configuration is
`benchmark/configs/<config>.json`, its traffic mix
`benchmark/traffic/<traffic>.json`, the loop that drives that mix
`benchmark/loops/<loop>.py` (the mix's "loop" key), and each metric
`benchmark/metrics/<metric>.py`. Adding any of them is adding files and
entries.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


class SpecError(ValueError):
    """BENCHMARK.json or a file it names breaks the benchmark's rules."""


def check_name(name, what: str) -> str:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 of A-Z a-z 0-9 _ . - and starts with a letter, digit or _")
    return name


def check_unit(unit, what: str) -> str:
    if not isinstance(unit, str) or not UNIT.fullmatch(unit):
        raise SpecError(f"{what} unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def load(root: Path = ROOT) -> dict:
    """BENCHMARK.json, with every name and unit checked."""
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise SpecError(f"{path} is missing")
    spec = json.loads(path.read_text())
    for c in spec["configs"]:
        check_name(c["name"], "config")
        for key in c["reduced"]:
            check_name(key, "reduced key")
    for w in spec["workloads"]:
        for key in ("name", "config", "traffic"):
            check_name(w[key], f"workload {key}")
    for kind in ("end_to_end", "per_layer"):
        for m in spec[kind]:
            check_name(m["name"], kind)
            check_unit(m["unit"], m["name"])
    return spec


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The `kind` ("end_to_end" or "per_layer") metrics that `cell` reports:
    those that list it, and those without a list."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def read_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    return json.loads(path.read_text())


def cell(spec: dict, name: str, root: Path = ROOT) -> dict:
    """Everything one run of workload `name` needs: the entry, its
    configuration file, its traffic mix, and its metrics of both kinds."""
    entries = [w for w in spec["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise SpecError(f"workload {name!r} is named {len(entries)} times in BENCHMARK.json")
    w = entries[0]
    configs = [c for c in spec["configs"] if c["name"] == w["config"]]
    if len(configs) != 1:
        raise SpecError(f"config {w['config']!r} is named {len(configs)} times in BENCHMARK.json")
    return {
        "workload": w,
        "config": read_json(root / configs[0]["file"], f"config {w['config']}"),
        "traffic": read_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json", f"traffic {w['traffic']}"),
        "end_to_end": metrics_of(spec, name, "end_to_end"),
        "per_layer": metrics_of(spec, name, "per_layer"),
    }


def load_file(path: Path, what: str):
    """Import one harness file by its path: names with dots, such as
    `iponet_ms.serve.py`, are not importable as modules."""
    if not path.is_file():
        raise SpecError(f"{what}: {path} is missing")
    mod_name = "benchmark._files." + re.sub(r"\W", "_", path.resolve().as_posix())
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def loop(name: str):
    """The loop module that drives a traffic mix's "loop"."""
    return load_file(HERE / "loops" / f"{check_name(name, 'loop')}.py", f"loop {name}")


def metric(name: str):
    """The reader of one metric: a module with `read(record) -> float | None`."""
    return load_file(HERE / "metrics" / f"{check_name(name, 'metric')}.py", f"metric {name}")
