"""Per-tile alpha compositing: record build, the Hopper kernel's wrapper,
its plain PyTorch version, and the image assembly.

Records are component-major (tiles, 8, K) and hold the Cholesky factor of
each Gaussian's conic with its tile-local mean folded into linear
coefficients: rows [l00, l01, cu, l11, cv, opacity, 0, 0], so that
u = l00·x + l01·y + cu and v = l11·y + cv are whitened screen offsets and
alpha = opacity·exp(-(u² + v²)/2). K is padded to a multiple of 128, the
compositor's chunk.

`composite_fwd` launches the CUDA kernel (csrc/composite_fwd.cu) for CUDA
tensors and runs `composite_records_plain` for CPU tensors; on any other
device it raises. It never falls back from the kernel to the plain version.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from .projection import ALPHA_MAX, ALPHA_MIN, T_EPS, ProjectedGaussians
from .tiling import TILE_H, TILE_W, TileBinning

CHUNK = 128                  # Gaussians per compositor chunk
MAX_TILE_PIXELS = 1024       # the kernel runs one thread per tile pixel

_PKG_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _PKG_ROOT / "csrc" / "composite_fwd.cu"
BUILD_DIR = _PKG_ROOT / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def build_records(pg: ProjectedGaussians, binning: TileBinning,
                  tile_h: int = TILE_H, tile_w: int = TILE_W):
    """Gather per-tile Gaussian lists into component-major records.

    Returns records (t, 8, K_pad), colors (t, 4, K_pad) float32 and the
    list lengths (t,) int32.
    """
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    num_tiles = nty * ntx
    ids = binning.gaussian_ids
    K0 = ids.shape[1]
    K_pad = max(CHUNK, -(-K0 // CHUNK) * CHUNK)

    comp = torch.cat(
        [pg.mean2d, pg.conic, pg.color, pg.opacity[:, None]], dim=-1
    )  # (g, 9)
    gath = comp[ids.clamp(min=0)]  # (t, K0, 9)
    if K_pad != K0:
        ids = F.pad(ids, (0, K_pad - K0), value=-1)
        gath = F.pad(gath, (0, 0, 0, K_pad - K0))
    present = (ids >= 0).to(gath.dtype)
    mean2d = gath[..., 0:2]
    conic = gath[..., 2:5]
    color = gath[..., 5:8]
    opacity = gath[..., 8] * present

    t_idx = torch.arange(num_tiles, dtype=torch.float32, device=ids.device)
    ox = (t_idx % ntx) * tile_w + (tile_w - 1) / 2.0
    oy = torch.div(t_idx, ntx, rounding_mode="floor") * tile_h + (tile_h - 1) / 2.0
    mx = mean2d[..., 0] - ox[:, None]
    my = mean2d[..., 1] - oy[:, None]

    ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
    # Cholesky of the conic [[ca, cb], [cb, cc]]; padded or culled entries
    # are clamped to keep sqrt finite — opacity 0 puts them below 1/255.
    l00 = torch.sqrt(torch.clamp(ca, min=1e-12))
    l01 = cb / l00
    l11 = torch.sqrt(torch.clamp(cc - l01 * l01, min=1e-12))
    cu = -(l00 * mx + l01 * my)
    cv = -l11 * my

    zeros = torch.zeros_like(ca)
    records = torch.stack([l00, l01, cu, l11, cv, opacity, zeros, zeros], dim=1)
    colors = torch.stack([color[..., 0], color[..., 1], color[..., 2], zeros], dim=1)
    return records.contiguous(), colors.contiguous(), binning.counts.to(torch.int32)


def _pixel_basis(tile_h: int, tile_w: int, device):
    """Tile-centred pixel coordinates (x, y), each (P,)."""
    p = torch.arange(tile_h * tile_w, device=device)
    px = (p % tile_w).to(torch.float32) - (tile_w - 1) / 2.0
    py = torch.div(p, tile_w, rounding_mode="floor").to(torch.float32) - (tile_h - 1) / 2.0
    return px, py


def composite_records_plain(records: torch.Tensor, colors: torch.Tensor,
                            counts: torch.Tensor, tile_h: int = TILE_H,
                            tile_w: int = TILE_W):
    """Plain PyTorch version of the compositor kernel, in the chunked
    cumprod formulation of the TPU kernel: within a chunk the transmittance
    after Gaussian g is T_run·Π_{j≤g}(1-α_j), and a Gaussian contributes
    iff that is ≥ 1e-4. All tiles advance together, chunk by chunk; a tile
    stops when its list is exhausted or its T is dead everywhere.

    Returns acc (t, P, 4), tfin (t, P, 1), tst (t, P, K/128) float32 and
    nexec (t,) int32, the outputs of the kernel.
    """
    t, _, K = records.shape
    nch = K // CHUNK
    P = tile_h * tile_w
    dev = records.device
    px, py = _pixel_basis(tile_h, tile_w, dev)
    px, py = px[None, :, None], py[None, :, None]

    need = torch.clamp(torch.div(counts.long() + CHUNK - 1, CHUNK, rounding_mode="floor"), max=nch)
    acc = torch.zeros(t, P, 4, dtype=torch.float32, device=dev)
    tst = torch.ones(t, P, nch, dtype=torch.float32, device=dev)
    T_run = torch.ones(t, P, 1, dtype=torch.float32, device=dev)
    nexec = torch.zeros(t, dtype=torch.int32, device=dev)
    running = torch.ones(t, dtype=torch.bool, device=dev)
    for c in range(nch):
        running = running & (c < need) & (T_run.amax(dim=(1, 2)) >= T_EPS)
        if not bool(running.any()):
            break
        B = records[:, :, c * CHUNK:(c + 1) * CHUNK]           # (t, 8, CH)
        C = colors[:, :3, c * CHUNK:(c + 1) * CHUNK]           # (t, 3, CH)
        u = px * B[:, 0:1] + py * B[:, 1:2] + B[:, 2:3]        # (t, P, CH)
        v = py * B[:, 3:4] + B[:, 4:5]
        araw = B[:, 5:6] * torch.exp(-0.5 * (u * u + v * v))
        alpha = torch.where(araw >= ALPHA_MIN, torch.clamp(araw, max=ALPHA_MAX),
                            torch.zeros_like(araw))
        om = 1.0 - alpha
        TT = T_run * torch.cumprod(om, dim=2)                  # T after each Gaussian
        contrib = TT >= T_EPS
        w = torch.where(contrib, alpha * TT / om, torch.zeros_like(TT))
        rgb = (w[:, :, None, :] * C[:, None, :, :]).sum(dim=-1)  # (t, P, 3)
        T_new = torch.where(contrib, TT, T_run).amin(dim=2, keepdim=True)

        run = running[:, None, None]
        tst[:, :, c] = torch.where(running[:, None], T_run[..., 0], tst[:, :, c])
        acc[..., :3] = torch.where(run, acc[..., :3] + rgb, acc[..., :3])
        T_run = torch.where(run, T_new, T_run)
        nexec += running.to(torch.int32)
    return acc, T_run, tst, nexec


class CompositeFwd:
    """Wrapper of the CUDA compositor kernel.

    `launches` counts kernel launches (plain-version calls on the CPU do not
    count). The shared library is built with nvcc from csrc/ into _build/
    at first use; `build()` may be called ahead to time it.
    """

    def __init__(self):
        self.launches = 0
        self.build_log = ""
        self._lib = None

    def build(self) -> ctypes.CDLL:
        if self._lib is not None:
            return self._lib
        src = SOURCE.read_bytes()
        so = BUILD_DIR / f"composite_fwd_{hashlib.sha256(src).hexdigest()[:16]}.so"
        if not so.exists():
            nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.composite_fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.composite_fwd.restype = ctypes.c_int
        self._lib = lib
        return lib

    def launch(self, records, colors, counts, tile_h, tile_w):
        """Run the kernel on CUDA tensors; returns (acc, tfin, tst, nexec)."""
        t, rows, K = records.shape
        P = tile_h * tile_w
        if rows != 8 or colors.shape != (t, 4, K) or counts.shape != (t,):
            raise ValueError(
                f"records {tuple(records.shape)}, colors {tuple(colors.shape)}, "
                f"counts {tuple(counts.shape)} do not form (t,8,K), (t,4,K), (t,)"
            )
        if K % CHUNK or K == 0:
            raise ValueError(f"K={K} must be a positive multiple of {CHUNK}")
        if not 0 < P <= MAX_TILE_PIXELS:
            raise ValueError(f"tile {tile_h}x{tile_w} has {P} pixels; the kernel takes 1..{MAX_TILE_PIXELS}")
        for name, x, dtype in (("records", records, torch.float32),
                               ("colors", colors, torch.float32),
                               ("counts", counts, torch.int32)):
            if x.device != records.device or x.dtype != dtype or not x.is_contiguous():
                raise ValueError(f"{name} must be a contiguous {dtype} tensor on {records.device}")
        lib = self.build()
        dev = records.device
        acc = torch.empty(t, P, 4, dtype=torch.float32, device=dev)
        tfin = torch.empty(t, P, 1, dtype=torch.float32, device=dev)
        tst = torch.empty(t, P, K // CHUNK, dtype=torch.float32, device=dev)
        nexec = torch.empty(t, dtype=torch.int32, device=dev)
        if t == 0:
            return acc, tfin, tst, nexec
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.composite_fwd(
                counts.data_ptr(), records.data_ptr(), colors.data_ptr(),
                acc.data_ptr(), tfin.data_ptr(), tst.data_ptr(), nexec.data_ptr(),
                t, K, tile_h, tile_w, stream,
            )
        if err != 0:
            raise RuntimeError(f"composite_fwd launch failed with CUDA error {err}")
        self.launches += 1
        return acc, tfin, tst, nexec

    def __call__(self, records, colors, counts, tile_h: int = TILE_H, tile_w: int = TILE_W):
        if records.is_cuda:
            return self.launch(records, colors, counts, tile_h, tile_w)
        if records.device.type == "cpu":
            return composite_records_plain(records, colors, counts, tile_h, tile_w)
        raise RuntimeError(f"no compositor for device {records.device}")


composite_fwd = CompositeFwd()


def composite_tiles(
    pg: ProjectedGaussians,
    binning: TileBinning,
    background: torch.Tensor,
    image_shape: tuple[int, int],
    tile_h: int = TILE_H,
    tile_w: int = TILE_W,
) -> torch.Tensor:
    """Composite every tile and assemble the (3, h, w) image."""
    h, w = image_shape
    nty, ntx = binning.num_tiles_y, binning.num_tiles_x
    records, colors, counts = build_records(pg, binning, tile_h, tile_w)
    acc, tfin, _, _ = composite_fwd(records, colors, counts, tile_h, tile_w)
    img = acc[..., :3].transpose(1, 2) + tfin.transpose(1, 2) * background[None, :, None]
    img = img.reshape(nty, ntx, 3, tile_h, tile_w).permute(2, 0, 3, 1, 4)
    img = img.reshape(3, nty * tile_h, ntx * tile_w)
    return img[:, :h, :w]
