"""The port's precision probe (tools/diag_exp_precision.py and the plain
versions of csrc/precision_probe.cu's kernels) against the JAX tool's
kernels on the CPU: `_kexp`, `_krecip` and `_klog`, loaded from
tools/diag_exp_precision.py by path and run through
pl.pallas_call(..., interpret=True) on the JAX tool's own inputs. Then the
probe's main on the CPU, and the wrappers' device rule.
"""
import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ggrt_official_torch.ops.cuda_kernel import CSRC, NVCC_FLAGS
from ggrt_official_torch.tools import diag_exp_precision as probe

ROOT = Path(__file__).resolve().parents[1]


def load_jax_tool():
    spec = importlib.util.spec_from_file_location("jax_diag_exp_precision", ROOT / "tools" / "diag_exp_precision.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    """The JAX tool's inputs (as its main makes them) and each Pallas
    kernel's output in interpret mode."""
    tool = load_jax_tool()
    x = jnp.linspace(-6.0, 0.0, 8 * 128 * 64).reshape(-1, 128).astype(jnp.float32)
    ins = {"exp": x, "recip": 1.0 - jnp.exp(x) + 1e-4,
           "log": jnp.linspace(1e-4, 1.0, 8 * 128).reshape(-1, 128).astype(jnp.float32)}
    kern = {"exp": tool._kexp, "recip": tool._krecip, "log": tool._klog}
    out = {}
    for name, inp in ins.items():
        f = pl.pallas_call(kern[name], out_shape=jax.ShapeDtypeStruct(inp.shape, jnp.float32), interpret=True)
        out[name] = (np.asarray(inp), np.asarray(jax.jit(f)(inp)))
    return out


def test_inputs_are_the_jax_tools(jx):
    """The probe's inputs: the JAX tool's shapes; x and log's points within
    two float32 spacings of the interval's largest magnitude (jnp.linspace
    as XLA compiles it), recip's 1 - exp(x) + 1e-4 within 2e-7."""
    ins = probe.probe_inputs("cpu")
    for name, (want, _) in jx.items():
        got = ins[name].numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        atol = {"exp": 2 * np.spacing(np.float32(6.0)), "recip": 2e-7, "log": 2 * np.spacing(np.float32(1.0))}[name]
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("name", ["exp", "recip", "log"])
def test_plain_versions_match_the_pallas_kernels(jx, name):
    """torch.exp, torch.reciprocal and torch.log against _kexp, _krecip and
    _klog in interpret mode on the same inputs: the division agrees bit for
    bit (both IEEE), exp and log within 1 ulp of each other (two libraries,
    each under 1 ulp of float64 here)."""
    x, want = jx[name]
    got = probe.KERNELS[name](torch.tensor(x)).numpy()
    if name == "recip":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_max_ulp(got, want, maxulp=1)


def test_main_on_the_cpu(capsys):
    """main(device="cpu"): one line per function with the two columns, and
    on the CPU (kernel = plain op) equal errors under CUDA's documented
    bounds (exp 2 ulp, log 1 ulp, division correctly rounded)."""
    res = probe.main(device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[0] for line in lines] == ["exp", "recip", "log"]
    assert all("kernel-vs-f64" in line and "torch-vs-f64" in line for line in lines)
    assert res["exp"]["shape"] == [512, 128] and res["log"]["shape"] == [8, 128]
    for name, bound in (("exp", 2.0), ("recip", 0.5), ("log", 1.0)):
        e = res[name]
        assert e["ulp_kernel"] == e["ulp_torch"] <= bound and e["rel_kernel"] < 1e-6, (name, e)


def test_ulps_measure():
    """ulps() counts float32 spacings at the reference: one spacing off is 1."""
    ref = np.array([1.0, 0.75, 2.0**-9, 3.5])
    y = (ref.astype(np.float32) + np.spacing(ref.astype(np.float32))).astype(np.float32)
    np.testing.assert_allclose(probe.ulps(y, ref), 1.0, rtol=1e-6)


def test_wrappers_run_plain_on_the_cpu_and_refuse_other_devices():
    """A CPU tensor takes the plain op and launches nothing; a tensor on any
    device but a card or the CPU is refused."""
    before = [k.launches for k in probe.KERNELS.values()]
    x = torch.rand(4, 8) + 0.5
    for name, k in probe.KERNELS.items():
        torch.testing.assert_close(k(x), k.plain(x), rtol=0, atol=0)
    assert [k.launches for k in probe.KERNELS.values()] == before
    with pytest.raises(RuntimeError):
        probe.probe_exp(torch.empty(4, device="meta"))


def test_probe_keeps_ieee_exp_and_division():
    """The probe's source calls no fast-math intrinsic and its flags (the
    compositors' NVCC_FLAGS) ask for no fast math, flushing or approximate
    division: the expf and 1/x it measures are those whose few ulps
    csrc/composite_cull.cuh's culling margin assumes."""
    src = (CSRC / "precision_probe.cu").read_text()
    for name in ("__expf", "__logf", "__fdividef", "__frcp_r", "__fdiv_r"):
        assert name not in src, name
    flags = " ".join(NVCC_FLAGS)
    for flag in ("use_fast_math", "prec-div=false", "ftz=true"):
        assert flag not in flags, flag


def body(src: str, opener: str) -> str:
    """The text between the braces of the first block after the regex
    `opener` (a function's signature, an `if`)."""
    start = src.index("{", re.search(opener, src).end())
    depth = 0
    for i in range(start, len(src)):
        depth += {"{": 1, "}": -1}.get(src[i], 0)
        if depth == 0:
            return src[start + 1:i]
    raise AssertionError(f"unbalanced braces after {opener}")


def test_log_waits_before_it_reads_and_returns_the_launch_error():
    """probe_log is a programmatic dependent launch, so the grid before it
    may still be writing x when it starts. In the source: the kernel's
    programmatic branch runs griddepcontrol.wait before the first access
    through x or out; launch's programmatic branch sets programmatic stream
    serialization and returns cudaLaunchKernelEx's result, and every return
    of launch is a launch's error code; probe_log and probe_empty_pdl return
    launch's result on that path, the other entry points on the <<<>>> one.
    probe_late_copy, the card test's writer, lets the next grid start
    before it writes x."""
    src = (CSRC / "precision_probe.cu").read_text()
    pdl_if = r"if\s+constexpr\s*\(\s*Pdl\s*\)"
    kernel = body(src, r"__global__\s+void\s+per_element_kernel\s*\(")
    wait = re.search(r"griddepcontrol\.wait|cudaGridDependencySynchronize", kernel)
    access = re.search(r"\b(x|out)\s*\[", kernel)
    assert wait and access and wait.start() < access.start()
    assert wait.group() in body(kernel, pdl_if)
    launch = body(src, r"\bint\s+launch\s*\(")
    pdl = body(launch, pdl_if)
    assert re.search(r"\.id\s*=\s*cudaLaunchAttributeProgrammaticStreamSerialization\s*;", pdl)
    assert re.search(r"\.programmaticStreamSerializationAllowed\s*=\s*1\s*;", pdl)
    assert re.search(r"\breturn\s*(\(int\)\s*)?cudaLaunchKernelEx\s*\(", pdl)
    returns = re.findall(r"\breturn\s*(?:\(int\)\s*)?(\w+)\s*\(", launch)
    assert returns and set(returns) <= {"cudaLaunchKernelEx", "cudaGetLastError"}, returns
    want = {"probe_exp": "false", "probe_recip": "false", "probe_log": "true", "probe_log_plain": "false",
            "probe_empty": "false", "probe_empty_pdl": "true"}
    for entry, pdl_path in want.items():
        call = re.fullmatch(r"\s*return\s+launch\s*<\s*\w+\s*,\s*(true|false)\s*>\s*\([^;]*\)\s*;\s*",
                            body(src, rf'extern\s+"C"\s+int\s+{entry}\s*\('))
        assert call and call.group(1) == pdl_path, entry
    writer = body(src, r"__global__\s+void\s+late_copy_kernel\s*\(")
    assert writer.index("griddepcontrol.launch_dependents") < re.search(r"\bx\s*\[", writer).start()
    assert probe.FLOORS == {"exp": probe.probe_floor, "recip": probe.probe_floor, "log": probe.probe_floor_pdl}
    assert (probe.probe_log.symbol, probe.probe_log_plain.symbol, probe.probe_floor_pdl.symbol) == (
        "probe_log", "probe_log_plain", "probe_empty_pdl")


def test_floor_and_probe_checks_on_the_cpu():
    """The launch floor runs its plain version on the CPU and launches
    nothing; chip_smoke's misaligned copy lies 4 bytes off 16-byte alignment
    with the same values; phase 16's checks rehearse on the CPU (the plain
    ops within CUDA's bounds, the division correctly rounded, no times)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    x = torch.rand(3, 5)
    for floor in (probe.probe_floor, probe.probe_floor_pdl):
        launches = floor.launches
        assert floor(x).shape == x.shape and floor.launches == launches
    m = cs.misaligned(x)
    assert m.data_ptr() % 16 == 4 and m.is_contiguous() and torch.equal(m, x)
    pc = cs.probe_checks("cpu", device="cpu")
    assert list(pc) == ["exp", "recip", "log"]
    assert pc["recip"]["rounded"] and pc["recip"]["vs_plain_ulp"] == 0
    for name in ("exp", "log"):
        assert pc[name]["ulp"] <= cs.PROBE_ULP[name]
    assert all(np.isnan(row["floor_ms"]) and "misaligned_equal" not in row for row in pc.values())
