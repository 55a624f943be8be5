"""Nothing the benchmark runs imports JAX, flax or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: `ggrt_official_torch` is not `ggrt_official_tpu`."""
import ast
from pathlib import Path

import pytest

HARNESS = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ggrt_official_tpu"}


def imported_tops(path: Path) -> set[str]:
    """Top-level names of the absolute imports in one file."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".", 1)[0])
    return tops


def sources(*parts):
    return sorted(p for p in HARNESS.joinpath(*parts).rglob("*.py") if "tests" not in p.relative_to(HARNESS).parts)


@pytest.mark.parametrize("path", sources(), ids=lambda p: str(p.relative_to(HARNESS)))
def test_no_jax_in_the_harness(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sources("reference"), ids=lambda p: str(p.relative_to(HARNESS)))
def test_reference_imports_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "ggrt_official_torch" not in tops and not tops & FORBIDDEN


def test_the_check_compares_whole_names():
    from benchmark import chip

    assert "ggrt_official_torch" not in chip.FORBIDDEN and "ggrt_official_tpu" in chip.FORBIDDEN


def test_a_run_loads_no_jax(tmp_path):
    """The modules a run imports, in a fresh process: the harness, every loop
    and metric, the reference and the program's entry points."""
    import subprocess
    import sys

    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark import spec, run, chip, flops, control\n"
        "b = spec.load()\n"
        "for w in b['workloads']:\n"
        "    c = spec.cell(b, w['name']); spec.loop(c['traffic']['loop'])\n"
        "    [spec.metric(m['name']) for m in c['end_to_end'] + c['per_layer']]\n"
        "import benchmark.loops.serve as s, benchmark.loops.frames as f, benchmark.loops.steps as t\n"
        "s.sides(True); s.sides(False); f.sides(True); f.sides(False)\n"
        "t.trainer_class({'trainer': 'finetune'}, True); t.trainer_class({'trainer': 'pretrain'}, False)\n"
        "print(chip.forbidden_modules())\n" % str(HARNESS.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
