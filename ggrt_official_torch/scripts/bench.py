"""The rasterizer's fwd+bwd headline as one JSON line (the JAX package's
bench.py, on the card).

    python -m ggrt_official_torch.scripts.bench [--device cuda] [--profile DIR]

Headline: pixels per second of one differentiable render step, forward
and backward, at LLFF's eval resolution 320x448, with bench.py's scene: 3
Gaussians per pixel for each of 2 context pairs (860,160), uniform means
in front of an identity camera, pixel-scale covariances, SH degree 4,
drawn from a torch generator at seed 0 (jax.random's bits are JAX's own,
so the scene has bench.py's distributions, not its numbers). The step is
the gradient of mean(render**2) with respect to the means, covariances,
SH, opacities and extrinsics, with backend "cuda" (the compositor and
scatter kernels), banked binning, max_dup 8, tile_chunk 16 and the K that
`choose_max_per_tile` picks at 45 dB. Before timing, the gate: a 64x128
render of the first 4096 Gaussians, "cuda" against "tiled", must agree to
a mean abs error < 1e-4 with < 0.2% of pixels off by more than 2e-3. Then
one warm-up step and 10 timed steps (host clock between synchronisations),
and the overflow statistics at the K used; the same at Waymo's 640x960
(3,686,400 Gaussians, 5 steps).

The line: {"metric": "rasterize_fwd_bwd_pixels_per_s_per_chip", "value":
pixels/s, "unit": "pixels/s", "vs_baseline": value / (30 * 320 * 448), the
30 fps forward-only real-time bar, "detail": {"resolution", "tile_shape",
"n_gaussians", "backend", "step_ms", "device", "pallas_vs_xla_mean_err"
(the gate's mean error of the cuda compositor against the tiled one),
"cap_policy", "binning_overflow", "waymo_640x960"}}. On any failure the
line carries value 0 and the error's tail, and the exit code is 1.
Nothing falls back to the CPU: --device cpu is asked for, never chosen.

Environment, as bench.py's: GGRT_BENCH_MAX_DUP (8), GGRT_BENCH_TILE_SHAPE
("HxW"; empty: 8x128), GGRT_BENCH_BINNING ("banked"), GGRT_BENCH_WAYMO
("0" skips 640x960), GGRT_BENCH_WAYMO_TILE_SHAPE and
GGRT_BENCH_WAYMO_BINNING (default: the headline's).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

METRIC = "rasterize_fwd_bwd_pixels_per_s_per_chip"
HEADLINE = ((320, 448), 10)          # (image, timed steps)
WAYMO = ((640, 960), 5)
GATE_IMAGE, GATE_GAUSSIANS = (64, 128), 4096
GATE_MEAN, GATE_OUTLIER, GATE_SHARE = 1e-4, 2e-3, 2e-3
TARGET_DB = 45.0
TILE_CHUNK = 16


def bench_inputs(image_shape, device, seed: int = 0, gpp: int = 3, pairs: int = 2):
    """bench.py's scene (bench.py:29-54): gpp Gaussians per pixel for each
    of `pairs` context pairs, drawn from a seeded generator on `device`.
    Returns (cameras, Gaussians), each a dict of batch-of-1 tensors."""
    h, w = image_shape
    g = h * w * gpp * pairs
    gen = torch.Generator(device=device).manual_seed(seed)

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo

    means = torch.stack([uniform((1, g), -2.0, 2.0), uniform((1, g), -1.5, 1.5),
                         uniform((1, g), 1.2, 8.0)], dim=-1)
    scales = uniform((1, g, 3), 0.002, 0.02)
    cov = torch.eye(3, device=device)[None, None] * scales[..., None] ** 2
    sh = torch.randn((1, g, 3, 25), generator=gen, device=device) * 0.2
    opa = uniform((1, g), 0.05, 0.9)
    cams = dict(
        extrinsics=torch.eye(4, device=device)[None],
        intrinsics=torch.tensor([[[1.2, 0.0, 0.5], [0.0, 1.2, 0.5], [0.0, 0.0, 1.0]]], device=device),
        near=torch.ones(1, device=device), far=torch.full((1,), 20.0, device=device),
        background=torch.zeros(1, 3, device=device),
    )
    return cams, {"means": means, "covariances": cov, "sh_coeffs": sh, "opacities": opa}


def _cam_args(cams):
    return cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"]


def raster_step(cams, leaves, image, kw):
    """bench.py's step: the gradients of mean(render**2) with respect to
    the means, covariances, SH, opacities and extrinsics, backend "cuda".
    Returns a callable that runs one step and returns, unread on the
    device, (6,): the loss and each gradient's sum (bench.py consumes the
    gradients into their sums the same way; a sum is finite exactly where
    its gradient is)."""
    from ..ops.rasterizer import api

    params = [x.clone().requires_grad_(True) for x in (*leaves.values(), cams["extrinsics"])]

    def step():
        m, c, sh, o, e = params
        img = api.render(e, cams["intrinsics"], cams["near"], cams["far"], image,
                         cams["background"], m, c, sh, o, backend="cuda", **kw)
        loss = (img ** 2).mean()
        grads = torch.autograd.grad(loss, params)
        return torch.stack([loss.detach(), *(g.sum() for g in grads)])

    return step


@torch.no_grad()
def gate_errors(cams, leaves, kw) -> tuple[float, float, float]:
    """bench.py's gate (bench.py:121-135): a GATE_IMAGE render of the first
    GATE_GAUSSIANS Gaussians, "cuda" against "tiled", with the step's
    options. Returns (mean abs error, share of pixels off by more than
    GATE_OUTLIER, max abs error)."""
    from ..ops.rasterizer import api

    small = [x[:, :GATE_GAUSSIANS] for x in leaves.values()]
    img_k = api.render(*_cam_args(cams), GATE_IMAGE, cams["background"], *small, backend="cuda", **kw)
    img_t = api.render(*_cam_args(cams), GATE_IMAGE, cams["background"], *small, backend="tiled", **kw)
    err = (img_k - img_t).abs()
    return float(err.mean()), float((err > GATE_OUTLIER).float().mean()), float(err.max())


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _tile_shape(text: str):
    return tuple(int(x) for x in text.split("x")) if text else None


def measure_scale(image, n_steps: int, dev, max_dup: int, tile_shape, binning: str,
                  gate: bool = False, profile_dir=None) -> dict:
    """One scale: the policy, the gate when asked, the warm-up and the
    timed steps, the overflow statistics at the K used."""
    from ..ops.rasterizer import api, projection, tiling

    cams, leaves = bench_inputs(image, dev)
    policy = api.choose_max_per_tile(*_cam_args(cams), image, cams["background"], *leaves.values(),
                                     target_db=TARGET_DB, max_dup=max_dup, tile_shape=tile_shape)
    kw = dict(max_per_tile=policy["max_per_tile"], max_dup=max_dup, tile_chunk=TILE_CHUNK,
              binning_mode=binning, tile_shape=tile_shape)
    out = {"n_gaussians": int(leaves["means"].shape[1]), "cap_policy": policy}
    if gate:
        mean, share, _ = gate_errors(cams, leaves, kw)
        if not (mean < GATE_MEAN and share < GATE_SHARE):
            raise RuntimeError(f"cuda/tiled compositor mismatch on the device: mean={mean} outlier_frac={share}")
        out["gate_mean_err"] = mean

    step = raster_step(cams, leaves, image, kw)
    sums = [step()]
    _sync(dev)
    if profile_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            step()
            _sync(dev)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, f"raster_step_{image[0]}x{image[1]}.json"))
    t0 = time.perf_counter()
    for _ in range(n_steps):
        sums.append(step())
    _sync(dev)
    out["step_s"] = (time.perf_counter() - t0) / n_steps
    if not bool(torch.isfinite(torch.stack(sums)).all()):
        raise RuntimeError(f"a non-finite gradient at {image[0]}x{image[1]}")

    with torch.no_grad():
        pg = projection.project_gaussians(*(x[0] for x in leaves.values()), *(x[0] for x in _cam_args(cams)),
                                          image)
        th, tw = tile_shape or (tiling.TILE_H, tiling.TILE_W)
        ov = tiling.binning_overflow_stats(pg, image, max_dup=max_dup, max_per_tile=policy["max_per_tile"],
                                           tile_h=th, tile_w=tw)
    out["overflow"] = {k: float(v) for k, v in ov.items()}
    return out


def measure(device: str = "cuda", profile_dir=None) -> dict:
    """Both scales on `device`; returns the line's payload."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (torch.cuda.is_available() is false)")
    env = os.environ
    max_dup = int(env.get("GGRT_BENCH_MAX_DUP", "8"))
    tile_env = env.get("GGRT_BENCH_TILE_SHAPE", "")
    tile_shape = _tile_shape(tile_env)
    binning = env.get("GGRT_BENCH_BINNING", "banked")

    (H, W), n_steps = HEADLINE
    head = measure_scale((H, W), n_steps, dev, max_dup, tile_shape, binning, gate=True, profile_dir=profile_dir)

    waymo = None
    if env.get("GGRT_BENCH_WAYMO", "1") != "0":
        (WH, WW), w_steps = WAYMO
        wtile = _tile_shape(env.get("GGRT_BENCH_WAYMO_TILE_SHAPE", tile_env))
        wbinning = env.get("GGRT_BENCH_WAYMO_BINNING", binning)
        w = measure_scale((WH, WW), w_steps, dev, max_dup, wtile, wbinning)
        waymo = {
            "resolution": [WH, WW],
            "tile_shape": list(wtile) if wtile else None,
            "n_gaussians": w["n_gaussians"],
            "step_ms": w["step_s"] * 1e3,
            "pixels_per_s": WH * WW / w["step_s"],
            "binning_mode": wbinning,
            "cap_policy": w["cap_policy"],
            "overflow": w["overflow"],
        }

    pixels_per_s = H * W / head["step_s"]
    return {
        "metric": METRIC,
        "value": pixels_per_s,
        "unit": "pixels/s",
        "vs_baseline": pixels_per_s / (30.0 * H * W),
        "detail": {
            "resolution": [H, W],
            "tile_shape": list(tile_shape) if tile_shape else None,
            "n_gaussians": head["n_gaussians"],
            "backend": "cuda",
            "step_ms": head["step_s"] * 1e3,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
            "pallas_vs_xla_mean_err": head["gate_mean_err"],
            "cap_policy": head["cap_policy"],
            "binning_overflow": head["overflow"],
            "waymo_640x960": waymo,
        },
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile", default=None, help="write a torch.profiler trace of one headline step here")
    args = p.parse_args(argv)
    try:
        payload, rc = measure(args.device, args.profile), 0
    except Exception as e:  # noqa: BLE001 — the reader always gets a line
        payload = {"metric": METRIC, "value": 0.0, "unit": "pixels/s", "vs_baseline": 0.0,
                   "detail": {"error": str(e)[-400:], "traceback_tail": traceback.format_exc(limit=3)[-400:]}}
        rc = 1
    print(json.dumps(payload), flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
