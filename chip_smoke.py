"""Drive the PyTorch port (ggrt_official_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; each one that fails stops the run with a non-zero exit:
  1. card:   name and power limit from nvidia-smi; TF32 off in cuDNN and
             cuBLAS (the reference computes in float32).
  2. build:  nvcc builds the compositor kernel from ggrt_official_torch/csrc/.
  3. kernel: the kernel against its plain PyTorch version on the records of
             a real full-width render (160 tiles of 8x128, K = 1024) and on a
             ragged case (16x16 tiles, some lists empty, some < 128).
  4. serve:  PixelSplat at pretrain_config() width with seeded random
             weights renders 3 requests (synthetic scenes at 320x448, 5
             source views -> 4 context pairs -> 1,146,880 Gaussians, 1
             target view) under torch.inference_mode(); each request must
             give finite rgb (1,1,3,320,448) and depth (1,1,320,448) and
             launch the kernel exactly twice (rgb and depth). A small
             render must agree between the card and the CPU path, which
             the CPU tests hold against the JAX package.
  5. timing: request ms (host clock around a synchronised forward), kernel
             ms (CUDA events), its bound, the plain version's ms, peak
             memory — each line with the card's name and power limit.
  6. profile: one more request under torch.profiler; the ops that take
             the most device time.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3
OPS_PER_EVAL = 21            # ~20 FLOP + 1 exp per (pixel, Gaussian) evaluation
IMAGE = (320, 448)


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", flush=True)
    sys.exit(1)


def image_errors(a, b):
    """(mean abs, share of elements off by more than 2e-3, max abs)."""
    err = (a.double() - b.double()).abs()
    return err.mean().item(), (err > 2e-3).double().mean().item(), err.max().item()


def check_images(name, a, b):
    """Mean abs < 1e-5 and under 2e-3 of elements off by more than 2e-3:
    the kernel keeps T as a running product and the plain version as
    T_run·cumprod, so a pixel may flip across the 1/255 or 1e-4 cut-offs;
    the maximum is no measure."""
    mean, share, mx = image_errors(a, b)
    print(f"  {name}: mean abs {mean:.3e}, outlier share {share:.3e}, max abs {mx:.3e}")
    if not (mean < 1e-5 and share < 2e-3):
        fail(f"{name} disagrees with the plain version")
    return mx


def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def to_device(tree, device):
    """numpy arrays and tensors of a (nested) batch dict onto `device`."""
    import numpy as np
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.tensor(tree, device=device)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def make_request(seed: int, image_shape, n_views: int, num_source_views: int, shim, device):
    from ggrt_official_torch.data import datasets

    ds = datasets.SyntheticPlanesDataset(
        datasets.SyntheticSceneSpec(n_views=n_views, image_size=image_shape, seed=seed),
        num_source_views=num_source_views,
    )
    ex = datasets.collate_batch(ds[0])
    return to_device(shim({"context": ex["context"], "target": ex["target"]}), device)


def small_config(config):
    """The widths of the CPU parity tests (__graft_entry__._tiny_cfg)."""
    return config.pretrain_config(**{
        "encoder.d_feature": 32, "encoder.num_monocular_samples": 8,
        "encoder.gaussians_per_pixel": 2, "encoder.backbone.model": "resnet18",
        "encoder.backbone.num_layers": 3, "encoder.backbone.d_out": 32,
        "encoder.gaussian_adapter.sh_degree": 1,
        "encoder.epipolar_transformer.num_samples": 4,
        "encoder.epipolar_transformer.num_octaves": 4,
        "encoder.epipolar_transformer.num_layers": 1,
        "encoder.epipolar_transformer.num_heads": 2,
        "encoder.epipolar_transformer.d_dot": 16,
        "encoder.epipolar_transformer.d_mlp": 32,
        "encoder.epipolar_transformer.self_attention.patch_size": 2,
        "encoder.epipolar_transformer.self_attention.num_octaves": 4,
        "encoder.epipolar_transformer.self_attention.num_layers": 1,
        "encoder.epipolar_transformer.self_attention.num_heads": 2,
        "encoder.epipolar_transformer.self_attention.d_token": 16,
        "encoder.epipolar_transformer.self_attention.d_dot": 16,
        "encoder.epipolar_transformer.self_attention.d_mlp": 32,
        "decoder.max_per_tile": 128,
    })


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    if not (ROOT / "ggrt_official_torch" / "csrc" / "composite_fwd.cu").exists():
        fail(f"no ggrt_official_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    from ggrt_official_torch import config
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.decoder_splatting import effective_max_per_tile
    from ggrt_official_torch.models.pixelsplat import PixelSplat
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.ops.rasterizer import projection, tiling

    dev = torch.device("cuda")

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    # TF32 keeps ~3 decimal digits; the reference computes in float32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | tf32 "
          f"cudnn {torch.backends.cudnn.allow_tf32} matmul {torch.backends.cuda.matmul.allow_tf32}",
          flush=True)

    # 2. build
    t0 = time.perf_counter()
    cc.composite_fwd.build()
    print(f"build: composite_fwd.cu in {time.perf_counter() - t0:.2f} s", flush=True)
    for line in cc.composite_fwd.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # The full-width model and the three requests.
    cfg = config.pretrain_config()
    model = PixelSplat(cfg.encoder, cfg.decoder, device=dev,
                       generator=torch.Generator().manual_seed(0)).eval()
    shim = get_data_shim(cfg.encoder)
    requests = [make_request(seed, IMAGE, 8, cfg.train.num_source_views, shim, dev)
                for seed in range(3)]

    # 3. kernel against plain version, on the first request's Gaussians
    with torch.inference_mode():
        g = model.encode_pairs(requests[0]["context"], 0, deterministic=True)
        tgt = requests[0]["target"]
        scale = 1.0 / tgt["near"][0, 0]
        extr = tgt["extrinsics"][0, 0].clone()
        extr[:3, 3] *= scale
        pg = projection.project_gaussians(
            g.means[0] * scale, g.covariances[0] * scale**2, g.harmonics[0], g.opacities[0],
            extr, tgt["intrinsics"][0, 0], tgt["near"][0, 0] * scale, tgt["far"][0, 0] * scale,
            IMAGE,
        )
        K = effective_max_per_tile(cfg.decoder, g.means.shape[1], IMAGE)
        b = tiling.bin_gaussians(pg, IMAGE, cfg.decoder.max_dup, K)
        full = cc.build_records(pg, b)
        print(f"kernel: full-width records t={full[0].shape[0]} K={full[0].shape[2]} "
              f"from {g.means.shape[1]} Gaussians; list lengths "
              f"min {int(full[2].min())} mean {full[2].float().mean().item():.1f} max {int(full[2].max())}")
        if full[0].shape[0] != 160 or full[0].shape[2] != 1024 or g.means.shape[1] != 1_146_880:
            fail("the full-width render is not 160 tiles x K=1024 of 1,146,880 Gaussians")

        b16 = tiling.bin_gaussians(pg, IMAGE, cfg.decoder.max_dup, 256, 16, 16)
        counts = b16.counts.clone()
        counts[::3] = 0
        counts[1::3] = torch.clamp(counts[1::3], max=77)
        keep = torch.arange(256, device=dev)[None] < counts[:, None]
        b16 = b16._replace(counts=counts, gaussian_ids=torch.where(keep, b16.gaussian_ids, -1))
        ragged = cc.build_records(pg, b16, 16, 16)

        max_abs_err = 0.0
        nexec_full = None
        for name, (rec, col, cnt), tile in (("full 8x128", full, (8, 128)),
                                           ("ragged 16x16", ragged, (16, 16))):
            kern = cc.composite_fwd(rec, col, cnt, *tile)
            torch.cuda.synchronize()
            plain = cc.composite_records_plain(rec, col, cnt, *tile)
            print(f" case {name}:")
            mx = max(check_images("acc", kern[0], plain[0]), check_images("tfin", kern[1], plain[1]))
            agree = int((kern[3] == plain[3]).sum())
            print(f"  nexec agrees on {agree} of {kern[3].numel()} tiles")
            if bool((kern[3] > plain[3]).any()):
                fail("the kernel ran chunks the plain version did not")
            if name.startswith("full"):
                max_abs_err, nexec_full = mx, kern[3]
    print("kernel: ok", flush=True)

    # 4. serve: reset the counts, drive the main path, read the counts.
    with torch.inference_mode():
        model(requests[0], 0, deterministic=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        cc.composite_fwd.launches = 0
        request_ms = []
        for i, batch in enumerate(requests):
            before = cc.composite_fwd.launches
            t0 = time.perf_counter()
            ret, _ = model(batch, 0, deterministic=True)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            rgb, depth = ret["rgb"], ret["depth"]
            if tuple(rgb.shape) != (1, 1, 3, *IMAGE) or tuple(depth.shape) != (1, 1, *IMAGE):
                fail(f"request {i}: rgb {tuple(rgb.shape)}, depth {tuple(depth.shape)}")
            if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
                fail(f"request {i}: non-finite output")
            if cc.composite_fwd.launches - before != 2:
                fail(f"request {i}: {cc.composite_fwd.launches - before} kernel launches, not 2")
            print(f"serve: request {i} rgb mean {rgb.mean().item():.4f} depth mean "
                  f"{depth.mean().item():.4f}, 2 kernel launches")
        main_path_launches = cc.composite_fwd.launches
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # A small render on the card against the CPU path (the one the CPU tests
    # hold against the JAX package), same weights and inputs, at the widths
    # of the CPU tests: with 10 depth octaves the epipolar positional
    # encoding multiplies float32 triangulation noise by up to 2π·512, and
    # any two devices disagree.
    small = small_config(config)
    small_gpu = PixelSplat(small.encoder, small.decoder, device=dev).eval()
    small_cpu = PixelSplat(small.encoder, small.decoder, device="cpu").eval()
    small_cpu.load_state_dict(small_gpu.state_dict())
    req = make_request(0, (32, 64), 8, 3, get_data_shim(small.encoder), "cpu")
    with torch.inference_mode():
        ret_cpu, _ = small_cpu(req, 0, deterministic=True)
        ret_gpu, _ = small_gpu(to_device(req, dev), 0, deterministic=True)
    print(" small render, card against CPU:")
    check_images("rgb", ret_gpu["rgb"].cpu(), ret_cpu["rgb"])
    check_images("depth", ret_gpu["depth"].cpu(), ret_cpu["depth"])
    print("serve: ok", flush=True)

    # 5. timing
    rec, col, cnt = full
    kernel_ms = cuda_ms(lambda: cc.composite_fwd.launch(rec, col, cnt, 8, 128), 20)
    plain_ms = cuda_ms(lambda: cc.composite_records_plain(rec, col, cnt, 8, 128), 3)
    P, nch = 8 * 128, rec.shape[2] // 128
    evals = int(nexec_full.sum()) * 128 * P
    ops_ms = evals * OPS_PER_EVAL / H100_FP32_FLOPS * 1e3
    nbytes = (rec.numel() + col.numel() + cnt.numel() + rec.shape[0] * P * (4 + 1 + nch) + rec.shape[0]) * 4
    bytes_ms = nbytes / H100_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    tag = f"[{smi}]"
    print(f"timing: request ms {', '.join(f'{x:.1f}' for x in request_ms)} {tag}")
    print(f"timing: kernel {kernel_ms:.4f} ms per launch (20 launches, CUDA events) {tag}")
    print(f"timing: kernel bound {bound_ms:.4f} ms by operations ({evals / 1e6:.1f}M evaluations "
          f"x {OPS_PER_EVAL} at 67 TFLOP/s = {ops_ms:.4f} ms; {nbytes / 1e6:.1f} MB at 3.35 TB/s "
          f"= {bytes_ms:.4f} ms) {tag}")
    print(f"timing: plain version {plain_ms:.3f} ms; library call: none {tag}")
    print(f"timing: peak memory {peak_gib:.2f} GiB over the 3 requests {tag}")

    # 6. where a request's time goes: one profiled request (not counted in
    # the main path above): the kernels with the most device time, and the
    # operators (with their input shapes) that launched the most.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode(), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                         record_shapes=True) as prof:
        model(requests[1], 0, deterministic=True)
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total_us = sum(dev_us(e) for e in on_card)
    print(f"profile: one request, {total_us / 1e3:.1f} ms of device kernel time {tag}")
    for e in sorted(on_card, key=dev_us, reverse=True)[:10]:
        print(f"  kernel {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key[:100]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::") and dev_us(e) > 0]
    for e in sorted(ops, key=dev_us, reverse=True)[:8]:
        print(f"  op     {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key} {str(e.input_shapes)[:110]}")

    kernels = [{
        "name": "composite_fwd",
        "route": "cuda",
        "source": "ggrt_official_torch/csrc/composite_fwd.cu",
        "replaces": "ggrt_official_tpu/ops/rasterizer/pallas_composite.py:112",
        "launches": main_path_launches,
        "max_abs_err": max_abs_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
