"""Build and bind the port's hand-written CUDA kernels.

Each kernel is one source under `ggrt_official_torch/csrc/` with a plain C
entry point that launches on the stream it is given and returns
`cudaGetLastError()`; sources may include the headers (`*.cuh`) beside
them. At first use nvcc compiles the source for sm_90a into a shared
library under the git-ignored `_build/`, named by the hash of the source
and the headers, and ctypes loads it. `build_all` starts one nvcc per source at once;
several kernels (C entry points) may share one source.

A `CudaKernel` counts its launches: `launches` goes up by one where the
kernel is launched and nowhere else, so a run can show that the main path
went through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

PKG_ROOT = Path(__file__).resolve().parents[1]
CSRC = PKG_ROOT / "csrc"
BUILD_DIR = PKG_ROOT / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int
LONG = ctypes.c_longlong


class CudaKernel:
    """One CUDA source and its C entry point `symbol(argtypes...) -> int`."""

    def __init__(self, source: str, symbol: str, argtypes: list):
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._fn = None

    def build(self):
        """Compile (once per source hash) and load; returns the C function."""
        if self._fn is not None:
            return self._fn
        digest = hashlib.sha256(self.source.read_bytes())
        for header in sorted(self.source.parent.glob("*.cuh")):
            digest.update(header.read_bytes())
        so = BUILD_DIR / f"{self.source.stem}_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {self.source.name} ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, so)
        fn = getattr(ctypes.CDLL(str(so)), self.symbol)
        fn.argtypes = [*self.argtypes, PTR]  # the stream comes last
        fn.restype = ctypes.c_int
        self._fn = fn
        return fn

    def run(self, device: torch.device, *args) -> None:
        """Launch on the current stream of `device` and count the launch."""
        fn = self.build()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed with CUDA error {err}")
        self.launches += 1


def build_all(kernels) -> None:
    """Build several kernels at once, one nvcc process per source; kernels
    that share a source then load its library."""
    first = {}
    for k in kernels:
        first.setdefault(k.source, k)
    with ThreadPoolExecutor(max_workers=len(first)) as pool:
        for f in [pool.submit(k.build) for k in first.values()]:
            f.result()
    for k in kernels:
        k.build()


def check_tensors(device: torch.device, **named) -> None:
    """Each value is (tensor, dtype): it must be a contiguous tensor of that
    type on `device`."""
    for name, (x, dtype) in named.items():
        if x.device != device or x.dtype != dtype or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dtype} tensor on {device}")
