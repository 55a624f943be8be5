"""Drive the PyTorch port (ggrt_official_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; each one that fails stops the run with a non-zero exit:
  1. card:   name and power limit from nvidia-smi; TF32 off in cuDNN and
             cuBLAS (the reference computes in float32).
  2. build:  nvcc builds the three kernels from ggrt_official_torch/csrc/,
             one process each, all at once.
  3. kernels: each kernel against its plain PyTorch version. The forward
             and backward compositors on the records of a real full-width
             render (160 tiles of 8x128, K = 1024) and on a ragged case
             (16x16 tiles, some lists empty, some < 128); the segment-sum
             scatter on the record ids of a full-width train-step render
             (3,440,640 Gaussians, dead entries sent to the dump row).
  4. serve:  PixelSplat at pretrain_config() width with seeded random
             weights renders 3 requests (synthetic scenes at 320x448, 5
             source views -> 4 context pairs -> 1,146,880 Gaussians, 1
             target view) under torch.inference_mode(); each request must
             give finite rgb (1,1,3,320,448) and depth (1,1,320,448) and
             launch the forward kernel exactly twice (rgb and depth) and no
             other. A small render must agree between the card and the CPU
             path, which the CPU tests hold against the JAX package.
  5. train:  GGRtTrainer at pretrain_config() width (IPO-Net with 12 GRU
             steps + PixelSplat, use_pred_pose and use_depth_loss on) on
             synthetic scenes at 320x448 with 5 source views: one warm-up
             step, then 3 'joint' steps, one 'nerf_only' and one
             'pose_only'. Every loss must be finite, the group the machine
             leaves open must move, and each step must launch the kernels
             as the loss body says: the forward twice (rgb, depth); in
             'joint' and 'nerf_only' the rgb loss is back-propagated, so the
             backward and the scatter once; in 'pose_only' the loss is the
             SfM term alone and neither runs.
  6. timing: request and step ms (host clock around synchronised work),
             per-kernel ms (CUDA events), bound, plain-version ms and the
             library call's ms where there is one, peak memory — each line
             with the card's name and power limit.
  7. profile: one more request and one more train step under
             torch.profiler; the ops that take the most device time.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores (SXM data sheet)
H100_BYTES_PER_S = 3.35e12   # HBM3
OPS_PER_EVAL = 21            # ~20 FLOP + 1 exp per (pixel, Gaussian) evaluation
# The backward's least work per evaluation: the forward's 21, then w,
# dwdot, the suffix, d(alpha) and its chain to six record gradients, three
# colour gradients, and the nine sums over pixels (~40).
OPS_PER_EVAL_BWD = 61
IMAGE = (320, 448)
TRAIN_MACHINES = ("joint", "joint", "joint", "nerf_only", "pose_only")
# Launches each train step makes: (composite_fwd, composite_bwd, segment_sum).
STEP_LAUNCHES = {"joint": (2, 1, 1), "nerf_only": (2, 1, 1), "pose_only": (2, 0, 0)}


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


def grad_errors(a, b):
    """Errors relative to the largest plain entry: (mean, share of entries
    off by more than 1e-4, max abs)."""
    scale = b.abs().max().clamp(min=1e-30)
    err = (a.double() - b.double()).abs()
    rel = err / scale.double()
    return rel.mean().item(), (rel > 1e-4).double().mean().item(), err.max().item()


def check_grads(name, a, b):
    """Mean relative error < 1e-6 and under 1e-3 of entries off by more than
    1e-4 of the largest entry: the kernel sums over pixels in another order
    (warp shuffles, shared-memory atomics), takes each chunk's suffix as
    total minus prefix, and a (pixel, Gaussian) may fall on either side of
    the 1/255 or 1e-4 cut-offs."""
    mean, share, mx = grad_errors(a, b)
    print(f"  {name}: mean rel {mean:.3e}, outlier share {share:.3e}, max abs {mx:.3e} "
          f"(largest plain entry {b.abs().max().item():.3e})")
    if not (mean < 1e-6 and share < 1e-3):
        fail(f"{name} disagrees with the plain version")
    return mx


def counts(*kernels):
    return tuple(k.launches for k in kernels)


def reset(*kernels):
    for k in kernels:
        k.launches = 0


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
    from ggrt_official_torch.data import datasets
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.decoder_splatting import effective_max_per_tile
    from ggrt_official_torch.models.pixelsplat import PixelSplat
    from ggrt_official_torch.ops.cuda_kernel import build_all
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.ops.rasterizer import projection, tiling
    from ggrt_official_torch.ops.rasterizer import segment_sum as ss
    from ggrt_official_torch.training.trainer import GGRtTrainer

    dev = torch.device("cuda")
    fwd, bwd, seg = cc.composite_fwd, cc.composite_bwd, ss.scatter_add_rows
    kernels = (fwd, bwd, seg)

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
    tag = f"[{smi}]"

    # 2. build
    t0 = time.perf_counter()
    build_all(kernels)
    print(f"build: {', '.join(k.source.name for k in kernels)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc each, in parallel)", flush=True)
    for k in kernels:
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {k.source.name}: {line.strip()}")

    # The full-width model and the three requests.
    cfg = config.pretrain_config()
    model = PixelSplat(cfg.encoder, cfg.decoder, device=dev,
                       generator=torch.Generator().manual_seed(0)).eval()
    shim = get_data_shim(cfg.encoder)
    requests = [make_request(seed, IMAGE, 8, cfg.train.num_source_views, shim, dev)
                for seed in range(3)]

    # 3. kernels against their plain versions
    def project(g, tgt):
        scale = 1.0 / tgt["near"][0, 0]
        extr = tgt["extrinsics"][0, 0].clone()
        extr[:3, 3] *= scale
        return projection.project_gaussians(
            g.means[0] * scale, g.covariances[0] * scale**2, g.harmonics[0], g.opacities[0],
            extr, tgt["intrinsics"][0, 0], tgt["near"][0, 0] * scale, tgt["far"][0, 0] * scale,
            IMAGE,
        )

    with torch.inference_mode():
        g = model.encode_pairs(requests[0]["context"], 0, deterministic=True)
        pg = project(g, requests[0]["target"])
        K = effective_max_per_tile(cfg.decoder, g.means.shape[1], IMAGE)
        b = tiling.bin_gaussians(pg, IMAGE, cfg.decoder.max_dup, K)
        full = cc.build_records(pg, b)
        print(f"kernels: full-width records t={full[0].shape[0]} K={full[0].shape[2]} "
              f"from {g.means.shape[1]} Gaussians; list lengths "
              f"min {int(full[2].min())} mean {full[2].float().mean().item():.1f} max {int(full[2].max())}")
        if full[0].shape[0] != 160 or full[0].shape[2] != 1024 or g.means.shape[1] != 1_146_880:
            fail("the full-width render is not 160 tiles x K=1024 of 1,146,880 Gaussians")

        b16 = tiling.bin_gaussians(pg, IMAGE, cfg.decoder.max_dup, 256, 16, 16)
        cnt16 = b16.counts.clone()
        cnt16[::3] = 0
        cnt16[1::3] = torch.clamp(cnt16[1::3], max=77)
        keep = torch.arange(256, device=dev)[None] < cnt16[:, None]
        b16 = b16._replace(counts=cnt16, gaussian_ids=torch.where(keep, b16.gaussian_ids, -1))
        ragged = cc.build_records(pg, b16, 16, 16)

        gen = torch.Generator(device=dev).manual_seed(0)
        err = {}
        fwd_out = {}
        for name, (rec, col, cnt), tile in (("full 8x128", full, (8, 128)),
                                           ("ragged 16x16", ragged, (16, 16))):
            kern = fwd(rec, col, cnt, *tile)
            torch.cuda.synchronize()
            plain = cc.composite_records_plain(rec, col, cnt, *tile)
            print(f" forward, case {name}:")
            mx = max(check_images("acc", kern[0], plain[0]), check_images("tfin", kern[1], plain[1]))
            agree = int((kern[3] == plain[3]).sum())
            print(f"  nexec agrees on {agree} of {kern[3].numel()} tiles")
            if agree != kern[3].numel():
                fail("nexec differs from the plain version's")
            acc, tfin, tst, nexec = kern
            gout = torch.randn(acc.shape, generator=gen, device=dev)
            gtfin = torch.randn(tfin.shape, generator=gen, device=dev)
            dk = bwd(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
            torch.cuda.synchronize()
            dp = cc.composite_bwd_plain(rec, col, tst, nexec, tfin, gout, gtfin, *tile)
            print(f" backward, case {name}:")
            mxb = max(check_grads("drec", dk[0], dp[0]), check_grads("dcol", dk[1], dp[1]))
            if name.startswith("full"):
                err["composite_fwd"], err["composite_bwd"] = mx, mxb
                fwd_out = dict(nexec=nexec, tst=tst, tfin=tfin, gout=gout, gtfin=gtfin)

        # The train step's Gaussians: 3 per pixel, drawn with seeded uniforms.
        enc = cfg.encoder
        ctx = requests[0]["context"]
        v, h, w = ctx["image"].shape[1], *IMAGE
        uni = torch.rand(((v - 1), 2, h * w, enc.num_surfaces, enc.gaussians_per_pixel),
                         generator=gen, device=dev)
        gt = model.encode_pairs(ctx, 0, deterministic=False, uniforms=uni)
        g_train = gt.means.shape[1]
        bt = tiling.bin_gaussians(project(gt, requests[0]["target"]), IMAGE, cfg.decoder.max_dup,
                                  effective_max_per_tile(cfg.decoder, g_train, IMAGE))
        ids = torch.where(bt.gaussian_ids >= 0, bt.gaussian_ids, g_train).reshape(-1).to(torch.int32)
        vals = torch.randn(ids.shape[0], 9, generator=gen, device=dev)
        print(f" segment_sum: N={ids.shape[0]} rows, {int((ids < g_train).sum())} live, g={g_train}")
        if g_train != 3_440_640:
            fail(f"the train-step render has {g_train} Gaussians, not 3,440,640")
        out_k = seg(ids, vals, g_train)
        torch.cuda.synchronize()
        out_p = ss.scatter_add_rows_plain(ids, vals, g_train)
        mag = ss.scatter_add_rows_plain(ids, vals.abs(), g_train)
        n_max = int(torch.bincount(ids.long(), minlength=g_train + 1)[:g_train].max())
        # Float atomics in a varying order: a row of n terms agrees to
        # (n-1)·2^-24 of the sum of their magnitudes.
        e = (out_k - out_p).abs()
        bad = int((e > (n_max - 1) * 2.0**-24 * mag + 1e-30).sum())
        print(f"  out: max abs {e.max().item():.3e}, mean abs {e.mean().item():.3e}, "
              f"{bad} entries past (n-1)·2^-24·sum|v| with n <= {n_max}")
        if bad:
            fail("segment_sum disagrees with the plain version")
        err["segment_sum"] = e.max().item()
        seg_args = (ids, vals, g_train)
        del gt, bt, out_k, out_p, mag, uni
    print("kernels: ok", flush=True)

    # 4. serve: reset the counts, drive the serving path, read the counts.
    launches = {}
    with torch.inference_mode():
        model(requests[0], 0, deterministic=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(*kernels)
        request_ms = []
        for i, batch in enumerate(requests):
            before = counts(*kernels)
            t0 = time.perf_counter()
            ret, _ = model(batch, 0, deterministic=True)
            torch.cuda.synchronize()
            request_ms.append((time.perf_counter() - t0) * 1e3)
            rgb, depth = ret["rgb"], ret["depth"]
            if tuple(rgb.shape) != (1, 1, 3, *IMAGE) or tuple(depth.shape) != (1, 1, *IMAGE):
                fail(f"request {i}: rgb {tuple(rgb.shape)}, depth {tuple(depth.shape)}")
            if not (torch.isfinite(rgb).all() and torch.isfinite(depth).all()):
                fail(f"request {i}: non-finite output")
            made = tuple(a - b for a, b in zip(counts(*kernels), before))
            if made != (2, 0, 0):
                fail(f"request {i}: launches (fwd, bwd, scatter) {made}, not (2, 0, 0)")
            print(f"serve: request {i} rgb mean {rgb.mean().item():.4f} depth mean "
                  f"{depth.mean().item():.4f}, 2 kernel launches")
        launches["serve"] = counts(*kernels)
        serve_peak_gib = torch.cuda.max_memory_allocated() / 2**30

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
    del small_gpu, small_cpu

    # 5. train: reset the counts, drive the train path, read the counts.
    trainer = GGRtTrainer(config.pretrain_config(), device=dev)
    trainer.init_full()
    scenes = [datasets.collate_batch(datasets.SyntheticPlanesDataset(
        datasets.SyntheticSceneSpec(n_views=8, image_size=IMAGE, seed=seed),
        num_source_views=cfg.train.num_source_views)[0]) for seed in range(len(TRAIN_MACHINES) + 2)]
    groups = {"pose_learner": list(trainer.model.pose_learner.parameters()),
              "gaussian": list(trainer.model.gaussian.parameters())}
    open_groups = {"joint": ("pose_learner", "gaussian"), "nerf_only": ("gaussian",),
                   "pose_only": ("pose_learner",)}
    trainer.train_iteration(scenes[-1], "joint")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(*kernels)
    step_ms = []
    for i, machine in enumerate(TRAIN_MACHINES):
        snap = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
        before = counts(*kernels)
        t0 = time.perf_counter()
        aux = trainer.train_iteration(scenes[i], machine)
        torch.cuda.synchronize()
        step_ms.append((machine, (time.perf_counter() - t0) * 1e3))
        made = tuple(a - b for a, b in zip(counts(*kernels), before))
        vals4 = {k: float(aux[k]) for k in ("loss_all", "gaussian_loss", "sfm_loss", "psnr")}
        moved = {k: max(float((p.detach() - q).abs().max()) for p, q in zip(groups[k], snap[k]))
                 for k in groups}
        print(f"train: step {i} {machine}: " + ", ".join(f"{k} {x:.6f}" for k, x in vals4.items())
              + f"; launches (fwd, bwd, scatter) {made}; max |update| "
              + ", ".join(f"{k} {x:.3e}" for k, x in moved.items()), flush=True)
        if not all(math.isfinite(x) for x in vals4.values()):
            fail(f"train step {i} ({machine}): non-finite loss")
        if made != STEP_LAUNCHES[machine]:
            fail(f"train step {i} ({machine}): launches {made}, not {STEP_LAUNCHES[machine]}")
        for k in open_groups[machine]:
            if not moved[k] > 0:
                fail(f"train step {i} ({machine}): the open group {k} did not move")
        del snap
    launches["train"] = counts(*kernels)
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print("train: ok", flush=True)

    # 6. timing
    rec, col, cnt = full
    fo = fwd_out
    P, nch, t = 8 * 128, rec.shape[2] // 128, rec.shape[0]
    evals = int(fo["nexec"].sum()) * 128 * P
    rows = []

    def bound(ops, nbytes):
        ops_ms, bytes_ms = ops / H100_FP32_FLOPS * 1e3, nbytes / H100_BYTES_PER_S * 1e3
        return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms

    timing = {
        "composite_fwd": (
            lambda: fwd.launch(rec, col, cnt, 8, 128),
            lambda: cc.composite_records_plain(rec, col, cnt, 8, 128),
            None,
            bound(evals * OPS_PER_EVAL,
                  (rec.numel() + col.numel() + cnt.numel() + t * P * (4 + 1 + nch) + t) * 4),
            f"{evals / 1e6:.1f}M evaluations x {OPS_PER_EVAL}",
        ),
        "composite_bwd": (
            lambda: bwd.launch(rec, col, fo["tst"], fo["nexec"], fo["tfin"], fo["gout"], fo["gtfin"], 8, 128),
            lambda: cc.composite_bwd_plain(rec, col, fo["tst"], fo["nexec"], fo["tfin"], fo["gout"],
                                           fo["gtfin"], 8, 128),
            None,
            bound(evals * OPS_PER_EVAL_BWD,
                  (2 * (rec.numel() + col.numel()) + t + t * P * (nch + 1 + 4 + 1)) * 4),
            f"{evals / 1e6:.1f}M evaluations x {OPS_PER_EVAL_BWD}",
        ),
        "segment_sum": (
            lambda: seg.launch(*seg_args),
            lambda: ss.scatter_add_rows_plain(*seg_args),
            lambda: torch.zeros(seg_args[2] + 1, 9, device=dev).index_add_(0, seg_args[0].long(), seg_args[1]),
            bound(seg_args[1].numel(), (seg_args[0].numel() + seg_args[1].numel() + seg_args[2] * 9) * 4),
            f"{seg_args[1].numel() / 1e6:.2f}M adds",
        ),
    }
    for name, (kern_fn, plain_fn, lib_fn, (bound_ms, bound_by, ops_ms, bytes_ms), work) in timing.items():
        ms = cuda_ms(kern_fn, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        library_ms = cuda_ms(lib_fn, 20) if lib_fn else None
        rows.append((name, ms, plain_ms, library_ms, bound_ms, bound_by))
        print(f"timing: {name} {ms:.4f} ms per launch (20 launches, CUDA events); bound {bound_ms:.4f} ms "
              f"by {bound_by} ({work} at 67 TFLOP/s = {ops_ms:.4f} ms; bytes at 3.35 TB/s = "
              f"{bytes_ms:.4f} ms); plain {plain_ms:.3f} ms; library "
              f"{'none' if library_ms is None else f'{library_ms:.4f} ms (index_add_)'} {tag}")
    print(f"timing: request ms {', '.join(f'{x:.1f}' for x in request_ms)} {tag}")
    print(f"timing: step ms {', '.join(f'{m} {x:.1f}' for m, x in step_ms)} "
          f"(after one warm-up step) {tag}")
    print(f"timing: peak memory {serve_peak_gib:.2f} GiB over the 3 requests, {train_peak_gib:.2f} GiB "
          f"over the {len(TRAIN_MACHINES)} train steps {tag}")
    print(f"timing: launches (fwd, bwd, scatter): serve {launches['serve']}, train {launches['train']}")

    # 7. where the time goes: one profiled request and one profiled train
    # step (not counted in the main paths above).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def show(prof, what, wall_ms):
        dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
        on_card = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total_us = sum(dev_us(e) for e in on_card)
        print(f"profile: {what}, {total_us / 1e3:.1f} ms of device kernel time in {wall_ms:.1f} ms {tag}")
        for e in sorted(on_card, key=dev_us, reverse=True)[:10]:
            print(f"  kernel {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key[:100]}")
        ops = [e for e in prof.key_averages(group_by_input_shape=True)
               if e.device_type == DeviceType.CPU and e.key.startswith("aten::") and dev_us(e) > 0]
        for e in sorted(ops, key=dev_us, reverse=True)[:8]:
            print(f"  op     {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key} {str(e.input_shapes)[:110]}")

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode(), profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        model(requests[1], 0, deterministic=True)
        torch.cuda.synchronize()
    show(prof, "one request", (time.perf_counter() - t0) * 1e3)
    with profile(activities=activities, record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer.train_iteration(scenes[-2], "joint")
        torch.cuda.synchronize()
    show(prof, "one joint train step", (time.perf_counter() - t0) * 1e3)

    sources = {
        "composite_fwd": ("ggrt_official_torch/csrc/composite_fwd.cu",
                          "ggrt_official_tpu/ops/rasterizer/pallas_composite.py:112"),
        "composite_bwd": ("ggrt_official_torch/csrc/composite_bwd.cu",
                          "ggrt_official_tpu/ops/rasterizer/pallas_composite.py:172"),
        "segment_sum": ("ggrt_official_torch/csrc/segment_sum.cu",
                        "ggrt_official_tpu/ops/rasterizer/segment_sum.py:51"),
    }
    table = []
    for i, (name, ms, plain_ms, library_ms, bound_ms, bound_by) in enumerate(rows):
        n = launches["serve"][i] + launches["train"][i]
        table.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": n, "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    if not all(launches["train"]) or not launches["serve"][0]:
        fail(f"a kernel of a path was not launched: serve {launches['serve']}, train {launches['train']}")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
