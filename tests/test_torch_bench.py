"""The port of bench.py (ggrt_official_torch/scripts/bench.py) against the
root bench.py and the JAX rasterizer, on the CPU.

One numpy population with bench.py's distributions (1 Gaussian per pixel
of one context pair at 32x64: 2,048 Gaussians, SH degree 4) goes through
the JAX package's capacity policy, overflow statistics and render +
jax.grad ("tiled" backend, banked binning, as bench.py's gate renders its
plain side) and through the port's (the step's "cuda" backend runs its
plain versions on the CPU). The policy and the statistics are equal; the
loss agrees to rtol 1e-5 and each gradient's sum within 1e-4 of the sum of
its absolute values. The CLI runs at 32x64 / 16x32 in place of 320x448 /
640x960.
"""
import ast
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
from ggrt_official_tpu.ops.rasterizer import api as japi
from ggrt_official_tpu.ops.rasterizer import projection as jproj
from ggrt_official_tpu.ops.rasterizer import tiling as jtiling
from ggrt_official_torch.ops.rasterizer import api as tapi
from ggrt_official_torch.ops.rasterizer import projection as tproj
from ggrt_official_torch.ops.rasterizer import tiling as ttiling
from ggrt_official_torch.scripts import bench

ROOT = Path(__file__).resolve().parents[1]
H, W = 32, 64
KW = dict(max_dup=8, tile_chunk=16, binning_mode="banked")
CAMS = ("extrinsics", "intrinsics", "near", "far")
LEAVES = ("means", "covariances", "sh_coeffs", "opacities")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_population(h, w, gpp=1, pairs=1, seed=0) -> dict:
    """bench.py's distributions (bench.py:29-54), drawn with numpy; its
    cameras from its own build_inputs."""
    rs = np.random.RandomState(seed)
    g = h * w * gpp * pairs
    means = np.stack([rs.uniform(-2.0, 2.0, (1, g)), rs.uniform(-1.5, 1.5, (1, g)),
                      rs.uniform(1.2, 8.0, (1, g))], axis=-1).astype(np.float32)
    scales = rs.uniform(0.002, 0.02, (1, g, 3)).astype(np.float32)
    cov = (np.eye(3, dtype=np.float32)[None, None] * scales[..., None] ** 2).astype(np.float32)
    sh = (rs.randn(1, g, 3, 25) * 0.2).astype(np.float32)
    opa = rs.uniform(0.05, 0.9, (1, g)).astype(np.float32)
    _, _, _, _, extr, intr, near, far, bg = jbench.build_inputs(jax, jnp, 8, 8)
    cams = dict(extrinsics=extr, intrinsics=intr, near=near, far=far, background=bg)
    return dict(cams={k: np.asarray(v) for k, v in cams.items()},
                leaves=dict(means=means, covariances=cov, sh_coeffs=sh, opacities=opa))


@pytest.fixture(scope="module")
def case():
    """The population, JAX's policy at 45 dB, and JAX's step at its K."""
    pop = numpy_population(H, W)
    c, lv = pop["cams"], pop["leaves"]
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    jl = {k: jnp.asarray(v) for k, v in lv.items()}
    policy = japi.choose_max_per_tile(*(jc[k] for k in CAMS), (H, W), jc["background"], *jl.values(),
                                      target_db=45.0, max_dup=8)
    kw = dict(max_per_tile=policy["max_per_tile"], **KW)

    def loss(means, cov, sh, opa, extr):
        img = japi.render(extr, jc["intrinsics"], jc["near"], jc["far"], (H, W), jc["background"],
                          means, cov, sh, opa, backend="tiled", **kw)
        return jnp.mean(img ** 2)

    args = (*jl.values(), jc["extrinsics"])
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3, 4)))(*args)
    pg = jproj.project_gaussians(*(v[0] for v in jl.values()), *(jc[k][0] for k in CAMS), (H, W))
    overflow = {k: float(v) for k, v in jtiling.binning_overflow_stats(
        pg, (H, W), max_dup=8, max_per_tile=policy["max_per_tile"]).items()}
    return dict(pop=pop, policy=policy, kw=kw, loss=float(value), overflow=overflow,
                sums=[float(np.sum(g)) for g in grads], abs_sums=[float(np.sum(np.abs(g))) for g in grads])


def torch_population(pop):
    return ({k: torch.tensor(v) for k, v in pop["cams"].items()},
            {k: torch.tensor(v) for k, v in pop["leaves"].items()})


def test_policy_and_overflow_equal_jax(case):
    """choose_max_per_tile's dict (K, demand, k_ref, the PSNR at every
    probed K) and the overflow statistics at that K equal JAX's."""
    cams, leaves = torch_population(case["pop"])
    policy = tapi.choose_max_per_tile(*(cams[k] for k in CAMS), (H, W), cams["background"], *leaves.values(),
                                      target_db=45.0, max_dup=8)
    assert json.loads(json.dumps(policy)) == json.loads(json.dumps(case["policy"]))
    assert len(policy["psnr_at_k"]) > 1
    pg = tproj.project_gaussians(*(v[0] for v in leaves.values()), *(cams[k][0] for k in CAMS), (H, W))
    ov = ttiling.binning_overflow_stats(pg, (H, W), max_dup=8, max_per_tile=policy["max_per_tile"])
    assert {k: float(v) for k, v in ov.items()} == case["overflow"]


def test_step_matches_jax(case):
    """The port's bench step (loss and the five gradient sums) against
    JAX's render + jax.grad of the same loss."""
    cams, leaves = torch_population(case["pop"])
    out = bench.raster_step(cams, leaves, (H, W), case["kw"])().numpy()
    np.testing.assert_allclose(out[0], case["loss"], rtol=1e-5)
    for name, got, want, scale in zip(("means", "covariances", "sh", "opacities", "extrinsics"),
                                      out[1:], case["sums"], case["abs_sums"]):
        assert abs(got - want) <= 1e-4 * scale, (name, got, want, scale)
    assert all(s > 0 for s in case["abs_sums"])


def test_bench_inputs_follow_bench_py():
    """bench_inputs: bench.py's cameras and shapes (gpp 3, pairs 2), its
    ranges, and the same scene again from the same seed."""
    cams, leaves = bench.bench_inputs((8, 16), "cpu")
    jm, jc, jsh, jo, *jcams = jbench.build_inputs(jax, jnp, 8, 16)
    for k, v in zip((*CAMS, "background"), jcams):
        np.testing.assert_array_equal(cams[k].numpy(), np.asarray(v), err_msg=k)
    for k, v in zip(LEAVES, (jm, jc, jsh, jo)):
        assert tuple(leaves[k].shape) == v.shape, k
    m = leaves["means"][0]
    assert leaves["means"].shape[1] == 8 * 16 * 6
    for i, (lo, hi) in enumerate(((-2.0, 2.0), (-1.5, 1.5), (1.2, 8.0))):
        assert lo <= float(m[:, i].min()) and float(m[:, i].max()) <= hi
    assert 0.05 <= float(leaves["opacities"].min()) and float(leaves["opacities"].max()) <= 0.9
    again = bench.bench_inputs((8, 16), "cpu")[1]
    assert all(torch.equal(leaves[k], again[k]) for k in LEAVES)


def bench_py_keys() -> tuple[list, list]:
    """The keys of the line bench.py's measure() returns, and of its detail,
    read from its source."""
    fn = next(n for n in ast.parse((ROOT / "bench.py").read_text()).body
              if isinstance(n, ast.FunctionDef) and n.name == "measure")
    ret = [n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict)][-1].value
    top = [k.value for k in ret.keys]
    detail = ret.values[top.index("detail")]
    return top, [k.value for k in detail.keys]


@pytest.fixture
def small(monkeypatch):
    monkeypatch.setattr(bench, "HEADLINE", ((H, W), 1))
    monkeypatch.setattr(bench, "WAYMO", ((16, 32), 1))


def test_main_prints_one_line_with_bench_py_keys(small, capsys):
    """main(["--device", "cpu"]) at 32x64 / 16x32: one line, bench.py's
    keys, the gate's error, both scales' policies and statistics."""
    assert bench.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    top, detail = bench_py_keys()
    assert list(line) == top and list(line["detail"]) == detail
    d = line["detail"]
    assert line["metric"] == "rasterize_fwd_bwd_pixels_per_s_per_chip" and line["unit"] == "pixels/s"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / (30 * H * W))
    assert d["backend"] == "cuda" and d["device"] == "cpu" and d["resolution"] == [H, W]
    assert d["n_gaussians"] == H * W * 6 and d["pallas_vs_xla_mean_err"] < 1e-4
    assert d["cap_policy"]["target_db"] == 45.0 and 0 < d["binning_overflow"]["recall"] <= 1
    w = d["waymo_640x960"]
    assert w["resolution"] == [16, 32] and w["binning_mode"] == "banked" and w["pixels_per_s"] > 0


def test_environment_knobs(small, capsys, monkeypatch):
    """bench.py's environment: the tile shape and binning reach the step
    and the statistics; GGRT_BENCH_WAYMO=0 skips the second scale."""
    monkeypatch.setenv("GGRT_BENCH_TILE_SHAPE", "8x32")
    monkeypatch.setenv("GGRT_BENCH_BINNING", "sort")
    monkeypatch.setenv("GGRT_BENCH_WAYMO", "0")
    assert bench.main(["--device", "cpu"]) == 0
    d = json.loads(capsys.readouterr().out)["detail"]
    assert d["tile_shape"] == [8, 32] and d["waymo_640x960"] is None
    cams, leaves = bench.bench_inputs((H, W), "cpu")
    pg = tproj.project_gaussians(*(v[0] for v in leaves.values()), *(cams[k][0] for k in CAMS), (H, W))
    ov = ttiling.binning_overflow_stats(pg, (H, W), max_dup=8, max_per_tile=d["cap_policy"]["max_per_tile"],
                                        tile_h=8, tile_w=32)
    assert d["binning_overflow"] == {k: float(v) for k, v in ov.items()}


def test_profile_writes_a_trace(small, capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("GGRT_BENCH_WAYMO", "0")
    assert bench.main(["--device", "cpu", "--profile", str(tmp_path)]) == 0
    assert json.loads(capsys.readouterr().out)["value"] > 0
    trace = json.loads((tmp_path / f"raster_step_{H}x{W}.json").read_text())
    assert any("aten::" in e.get("name", "") for e in trace["traceEvents"])


def test_failure_prints_the_zero_line_and_exits_non_zero():
    """A forced failure (a malformed GGRT_BENCH_MAX_DUP) in the CLI: the one
    line carries value 0 and the error, and the exit code is 1 (bench.py
    exits 0)."""
    proc = subprocess.run([sys.executable, "-m", "ggrt_official_torch.scripts.bench", "--device", "cpu"],
                          capture_output=True, text=True, cwd=ROOT, timeout=300,
                          env={**os.environ, "GGRT_BENCH_MAX_DUP": "eight"})
    assert proc.returncode == 1
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["metric"] == "rasterize_fwd_bwd_pixels_per_s_per_chip" and line["value"] == 0.0
    assert line["vs_baseline"] == 0.0 and "eight" in line["detail"]["error"]
    assert "ValueError" in line["detail"]["traceback_tail"]


def test_no_card_is_a_failure_not_a_fallback(capsys, monkeypatch):
    """--device cuda without a card fails; nothing runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bench.main([]) == 1
    line = json.loads(capsys.readouterr().out)
    assert line["value"] == 0.0 and "no CUDA card" in line["detail"]["error"]
