"""How accurately exp, 1/x and log compute inside a hand-written kernel,
against torch's own op and against float64 (the JAX package's
tools/diag_exp_precision.py, which asked it of Mosaic against XLA).

On the card the kernels are csrc/precision_probe.cu, compiled with the
compositors' flags, so the numbers are those of the expf and logf that
csrc/composite_cull.cuh's culling margin assumes ("covers expf's and
logf's few ulps"). Each wrapper launches its kernel for a CUDA tensor and
counts the launch, runs its plain version (torch.exp, torch.reciprocal,
torch.log) for a CPU tensor, and raises on any other device. log's kernel
is a programmatic dependent launch, exp's and 1/x's a <<<>>> launch
(csrc/precision_probe.cu says why).

    python -m ggrt_official_torch.tools.diag_exp_precision            # on the card
    python -m ggrt_official_torch.tools.diag_exp_precision --device cpu

Per function it prints the largest error against float64 of the kernel
("kernel") and of torch's op on the same device ("torch"), relative and in
ulps of the float32 result.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..constants import linspace
from ..ops.cuda_kernel import LONG, PTR, CudaKernel, check_tensors


class ProbeKernel(CudaKernel):
    """One elementwise kernel of csrc/precision_probe.cu and its plain version."""

    def __init__(self, symbol: str, plain):
        super().__init__("precision_probe.cu", symbol, [PTR, PTR, LONG])
        self.plain = plain

    def launch(self, x: torch.Tensor) -> torch.Tensor:
        """x float32, contiguous, on one card -> the kernel's result."""
        check_tensors(x.device, x=(x, torch.float32))
        out = torch.empty_like(x)
        self.run(x.device, x.data_ptr(), out.data_ptr(), x.numel())
        return out

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            return self.launch(x)
        if x.device.type == "cpu":
            return self.plain(x)
        raise RuntimeError(f"no {self.symbol} for device {x.device}")


probe_exp = ProbeKernel("probe_exp", torch.exp)
probe_recip = ProbeKernel("probe_recip", torch.reciprocal)
probe_log = ProbeKernel("probe_log", torch.log)
KERNELS = {"exp": probe_exp, "recip": probe_recip, "log": probe_log}
# log's first design: the same grid on a <<<>>> launch, timed beside probe_log
# on probe_floor.
probe_log_plain = ProbeKernel("probe_log_plain", torch.log)
# The same grid with an empty body, through the same ctypes path and launch
# path (log's is a programmatic dependent launch): launched on a kernel's
# input, the launch floor under that kernel's time (the plain version
# allocates the output and computes nothing).
probe_floor = ProbeKernel("probe_empty", torch.empty_like)
probe_floor_pdl = ProbeKernel("probe_empty_pdl", torch.empty_like)
FLOORS = {"exp": probe_floor, "recip": probe_floor, "log": probe_floor_pdl}
F64 = {"exp": np.exp, "recip": lambda v: 1.0 / v, "log": np.log}


def probe_inputs(device) -> dict:
    """The JAX tool's inputs: exp on 65,536 points of [-6, 0] (alpha's
    range: the power in [log(1/255), log(0.99)]), as (512, 128); recip on
    1 - exp(x) + 1e-4 of those, exp being torch's; log on 1,024 points of
    [1e-4, 1], as (8, 128)."""
    x = linspace(-6.0, 0.0, 8 * 128 * 64, device=device).reshape(-1, 128)
    return {"exp": x, "recip": 1.0 - torch.exp(x) + 1e-4,
            "log": linspace(1e-4, 1.0, 8 * 128, device=device).reshape(-1, 128)}


def ulps(y: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|y - ref| in units of the spacing of float32 at |ref|."""
    return np.abs(y.astype(np.float64) - ref) / np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)


def errors(name: str, x: np.ndarray, got: np.ndarray, plain: np.ndarray) -> dict:
    """The kernel's and the plain op's largest error against float64."""
    want = F64[name](x.astype(np.float64))

    def rel(y):
        return float(np.max(np.abs(y - want) / np.maximum(np.abs(want), 1e-12)))

    return {"rel_kernel": rel(got), "rel_torch": rel(plain),
            "ulp_kernel": float(ulps(got, want).max()), "ulp_torch": float(ulps(plain, want).max())}


def main(device: str | None = None) -> dict:
    """Run each kernel once on its inputs (on `device`, or --device from the
    command line, default cuda) and print its errors; returns them by name."""
    if device is None:
        ap = argparse.ArgumentParser()
        ap.add_argument("--device", default="cuda")
        device = ap.parse_args().device
    out = {}
    for name, inp in probe_inputs(torch.device(device)).items():
        got = KERNELS[name](inp)
        plain = KERNELS[name].plain(inp)
        x, got, plain = (t.cpu().numpy() for t in (inp, got, plain))
        out[name] = {**errors(name, x, got, plain), "shape": list(x.shape)}
        e = out[name]
        print(f"{name:6s} kernel-vs-f64 max rel {e['rel_kernel']:.3e} ({e['ulp_kernel']:.2f} ulp)   "
              f"torch-vs-f64 max rel {e['rel_torch']:.3e} ({e['ulp_torch']:.2f} ulp)", flush=True)
    return out


if __name__ == "__main__":
    main()
