"""Drive the PyTorch port (ggrt_official_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; each one that fails stops the run with a non-zero exit:
  1. card:   name and power limit from nvidia-smi; TF32 off in cuDNN and
             cuBLAS (the reference computes in float32).
  2. build:  nvcc builds the eight kernels from ggrt_official_torch/csrc/,
             one process for each of the six sources, all at once (the
             three probe kernels share precision_probe.cu).
  3. kernels: each kernel against its plain PyTorch version. The forward
             and backward compositors on the records of a real full-width
             render (160 tiles of 8x128, K = 1024) and on a ragged case
             (16x16 tiles, some lists empty, some < 128); the segment-sum
             scatter on the record ids of a full-width train-step render
             (3,440,640 Gaussians, dead entries sent to the dump row). The
             banked gather-and-merge is checked in phase 6, on its real
             streams.
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
             SfM term alone and neither runs. Then one more 'joint' step
             under torch's sync debug mode ("warn"): the host syncs it
             still makes, each with its file:line; none may come from the
             batch's copies to the card (training/trainer.py::_to_device).
  6. raster: the rasterizer's own entry point as bench.py drives it, at
             its two scales: 320x448 with 860,160 Gaussians and 640x960
             with 3,686,400 (3 per pixel x 2 pairs, SH degree 4, drawn from
             a seeded generator on the card to bench.py's distributions by
             scripts/bench.py, whose gate and step this phase runs too).
             At each: K from choose_max_per_tile (45 dB, max_dup 8); at
             320x448 the bench's gate (a 64x128 render of the first 4096
             Gaussians, "cuda" against "tiled", both banked); the banked
             gather-and-merge kernel's (ids, counts) against its plain
             version (gather, flat sort, front-K cut) on this scale's real
             streams, bit for bit, with the valid entries and the shared
             memory per block; the flat merge's lists against the per-slot
             sort merge's; the forward and backward compositors on
             the records of those lists and the scatter on their record ids
             against their plain versions, with phase 3's tolerances; then
             one warm-up and 10 (320x448) or 5
             (640x960) timed fwd+bwd steps of mean(render**2) with
             backend "cuda", banked binning, max_dup 8, tile_chunk 16 —
             finite gradients for means, covariances, SH, opacities and
             extrinsics, and launches (banked_gather, composite_fwd,
             composite_bwd, segment_sum) = (1, 1, 1, 1) per step; the
             overflow statistics at the K used.
  7. timing: request and step ms (host clock around synchronised work),
             per-kernel ms (CUDA events), bound, plain-version ms and the
             library call's ms where there is one, peak memory — each line
             with the card's name and power limit. The compositors are
             timed at three record sets (the full-width render's, and the
             step records of both raster scales), each with two bounds: the
             dense one counts every (pixel, Gaussian) pair of the executed
             chunks, the live one (the kernel table's) only the pairs with
             alpha >= 1/255 before the pixel's cut at T < 1e-4 in the
             chunk; and the share of (warp, Gaussian) pairs that the
             kernels' footprint test keeps. The banked kernel's bound
             counts bytes and integer operations (at the INT32 rate);
             tiling.bin_gaussians_banked's device and host ms per call at
             both raster scales. The encoder's 7x7 kernel (conv7_nhwc) at
             the shapes of a request it runs (the refinement's two, the
             feed-forward's first), beside its FFMA bound, the plain version
             (cuDNN on the channels-last input, then the epilogue) and two
             yardsticks the port never calls: cuDNN on the same
             channels-last call, and on an NCHW-contiguous input with
             cudnn.benchmark autotuned; the kernel equal to the plain
             version bit for bit, and two calls bit-equal. Its launches on
             every path that encodes (serve, train, eval, finetune, cache).
  8. profile: one more request, one more train step and one more raster
             step at each scale under torch.profiler; the kernels and ops
             that take the most device time, and the port's own kernels.
  9. eval:   the Evaluator on the train phase's model (synthetic 320x448
             test views, 5 source views): evaluate_view without refinement
             and with the flagship's refined arm (400 Adam steps per start,
             3 field-depth rounds), pose_targets at 400 steps, time_render,
             and evaluate_dataset on 2 views into a temporary directory.
             psnr, ssim and the *_unaligned errors must be finite, the
             refined 6-vectors finite, results.json strict JSON; each view
             must launch the forward kernel twice per render (the final
             one, and one per refinement round) and no other. Prints ms per
             view, refined and not, ms per Adam step, render_ms, launches
             and peak memory.
 10. loop:   train_loop on a full-width 'joint' trainer for 3 steps
             (n_tensorboard 1, n_checkpoint 2) in a temporary directory,
             then a fresh trainer resumes from `latest` to step 4. The
             saved weights must equal the trainer's bit for bit, the
             resumed run must start at step 3 and end at 4 with both
             optimizer counts 4, metrics.jsonl must hold steps 1-4, and
             each step must launch (fwd, bwd, scatter) = (2, 1, 1). Prints
             seconds per checkpoint save and the checkpoint's size.
 11. finetune: GGRtFinetuneTrainer(finetune_config()) at full width on
             a synthetic 12-view 320x448 scene with 7 source views (6 context pairs:
             5,160,960 Gaussians in the full render, 1,290,240 in each of
             the crop_size² = 4 tiles), seeded random weights: one warm-up
             step, then 3 timed 'joint' steps. loss_all and psnr must be
             finite, both parameter groups must move (the pose learner by
             the SfM loss, the Gaussian model by the injected pixel
             gradients), and each step must launch (fwd, bwd, scatter,
             gather) = (5, 4, 4, 0). Prints ms per step and of its three
             parts (CUDA events: the IPO-Net pass with its backward, the full
             render without gradients, the tiles), and the peak memory
             beside the 5-view pretrain steps'.
 12. cache:  the flagship's cache A/B: GGRtTrainer and CachedGGRtTrainer
             with the same seeded weights at pretrain_config() width,
             'nerf_only' over 6 examples of one synthetic 12-view scene
             (consecutive targets, overlapping context windows), one
             warm-up pass and one timed pass each. Every loss must be
             finite, the cached trainer must hit in the timed pass, every
             cached tensor must be on the card and detached, and each step
             of both must launch (2, 1, 1, 0). Prints ms per step off and
             on, the hits and misses of the timed pass, and the cache's
             entries and bytes.
 13. flagship: the flagship script (scripts/run_flagship.py) in-process at
             its own configuration (tiny_config(), 128x192, 4 source views)
             with cut step counts (nerf 20, pose 12 of which 4 warm, 20
             target steps per start, ceiling 8, one view per arm, cache A/B
             over 4 views, 2 scenes; the refined arms at 400 Adam steps per
             start), into a temporary directory, then the same command
             again. Every arm's psnr, ssim and *_unaligned errors must be
             finite, every pose target's R error finite, the bar computed,
             EVAL_FLAGSHIP.json strict JSON with the JAX artifact's keys
             (args.device for args.platform), the cache arm must hit, the
             second run must train no step and carry the cache A/B over, and
             (fwd, bwd, scatter) must each launch. Then, outside the
             counted runs, the compositor kernels and the scatter against
             their plain versions (phase 3's tolerances) on the records and
             record ids of the first run's first train step (32 tiles,
             so effective_max_per_tile raises the config's K of 128 to
             4096). Prints ms per step of each stage, the pose targets'
             seconds, each arm's seconds and the cache A/B's ms per step.
 14. llff:   an LLFF-format scene (20 views of a synthetic scene as PNG at
             378x504, the images_8 size of a 4032x3024 capture, with
             poses_bounds.npy) in a temporary nerf_llff_data/; train_ggrt at
             pretrain_config() width on it (5 source views resized to
             320x448, 3 steps), eval_ggrt on its checkpoint (test mode, one
             view) and finetune_ggrt from it for one step, none with
             --synthetic. Losses must be finite, each train step must
             launch (2, 1, 1, 0) and the finetune step (5, 4, 4, 0). Prints
             the host ms of LLFFTestDataset.__getitem__ (6 images read,
             blurred and resized) beside the train steps' ms.
 15. video, crop: on phase 14's folder and checkpoint, render_video at
             pretrain_config() width (the first test view's 5 context
             views encoded once, 30 frames decoded along the eased path
             between the first and last context cameras, written as PNGs):
             30 PNGs of 320x448, not constant, one forward launch a frame
             and no other; then eval_crop on one test view (320x448 in 4
             crops of 160x224): 2 forward launches a crop (rgb, depth), a
             finite stitched PSNR. Then, outside the counts: the forward
             compositor against its plain version on the first frame's
             records (phase 3's tolerances); the LPIPS network (random
             weights in the JAX package's npz format) on the card against
             the CPU on 2 pairs of 320x448 (relative error < 1e-4), and
             metrics.lpips with $GGRT_LPIPS_WEIGHTS; the g2o pose-accuracy
             protocol on the scene's poses against a noisy copy. Prints the
             encode ms and each frame's ms (CUDA events), frames/s, the
             peak memory, ms per crop view and per crop, LPIPS ms.
 16. legacy, probe: on phase 14's folder, eval_dbarf at JAX's default
             configuration (IBRNetModel with 64 coarse feature channels, 64
             inverse-uniform samples, chunks of 2048 rays, render_stride 2,
             5 source views) on 2 test views: finite PSNR and SSIM; ms per
             view (host clock), per chunk (CUDA events), peak memory. One
             2048-ray chunk of render_rays on the card against the CPU with
             the same weights and feature maps (max abs < 1e-3 in rgb, and
             in depth < 1e-3 of the far plane). DBARFModel.correct_poses
             at pretrain_config()'s IPO-Net width on the view, and a chunk
             rendered with its relative poses: finite. BARFTrainer at NeRFMLP's published widths (depth
             8, width 256, 10 and 4 bands, 64 samples, 1024 rays a step):
             20 timed steps after a warm-up, the loss must fall and both
             Adam groups move; then 50 test-time pose steps. One chunk and
             one BARF step run under torch.profiler. Then the
             precision probe (tools/diag_exp_precision.main): each of its
             three kernels launched once in the counted run, none of the
             rasterizer's four. Outside the counts each is held against its
             plain version and float64 at CUDA's documented bounds (expf 2
             ulp, logf 1 ulp, the division correctly rounded; kernel and
             torch's op at most twice that apart), on a view 4 bytes off
             16-byte alignment bit-equal to the aligned run, and timed
             beside its bound and its launch floor (an empty kernel on the
             same grid and launch path, at the same input); log (launched
             as a programmatic dependent launch) also beside its first
             design, a <<<>>> launch of the same grid that must give the
             same bits, and that one's floor.
 17. observability: at pretrain_config() width (a GGRtModel from seed 0),
             320x448, 5 source views. (a) utils.Benchmarker(device="cuda")
             times 3 requests (it synchronises at entry and exit), then
             dump and dump_memory: per-tag ms beside phase 4's, the peak
             allocated bytes. (b) utils.encoder_visualizer's
             dump_encoder_visualizations on one request with its capture
             taps on: the dumped images' names and shapes, the PNGs, the
             host ms, at least one composite_fwd launch; its rendered_rgb
             equals the same request's rgb without the taps, bit for bit;
             outside the counts, the compositors against their plain
             versions (phase 3's tolerances) on that render's records. (c)
             the Evaluator's evaluate_dataset with an out_dir on one test
             view (time_render at one iteration): pred_0000.png decodes to
             the view's prediction, clipped to [0, 1], within 1/255;
             poses_pred_vs_gt.png is
             written exactly when matplotlib is present. (d) the native
             library: g++'s version, built and loaded (no fallback), on
             phase 14's folder LLFFTestDataset.__getitem__ with
             GGRT_NATIVE_RESIZE=1 and without (host ms each, images within
             a mean of 0.03), pose_distances against numpy and a ring of 8
             blobs. (e) apply_color_map, draw_lines, hcat and add_label on
             the request's depth and image on the card against the CPU
             within 1e-6 (add_label by shape).
 18. convert, parallel, bench: (a) training/convert.py at
             pretrain_config(): a reference-shaped checkpoint
             ({'pose_learner': ..., 'gaussian': {'encoder.*': ...}}) from a
             seed-0 GGRtModel, converted into a seed-1 model and loaded:
             every tensor bit-equal, as many name-map rows as state_dict
             keys; one request through each model, rgb bit-equal, 2
             forward launches each. (b) parallel/ at world size 1 (NCCL, a
             file:// store): make_mesh() is (1, 1); make_dp_train_step on a
             GGRtTrainer at 320x448, 5 source views: a warm-up step at
             step 1 (the Gaussian gradients non-zero), 2 timed 'joint'
             steps of (2, 1, 1, 0) launches, 0 host syncs in one more; the
             warm-up step's parameters and gradients against
             train_iteration's from the same weights, example, uniforms and
             step (bit-equal, or no further from them than a second
             train_iteration run is), and two more train_iteration runs
             under torch's deterministic algorithms, each by parameter
             group, with the ops that have none and whether the step's
             kernels repeat themselves;
             render_tile_parallel("cuda") on bench.py's 320x448 scene equal
             to api.render's image, its fwd+bwd finite with (1, 1, 1, 0)
             launches; the first launch of each kernel in the converted
             model's request, the warm-up step and the render relaunched on
             its own arguments against its plain version, at phase 3's
             tolerances; dryrun_multichip(1) in a spawned rank, its three
             stages. (c) scripts/bench.py's main([]) in-process: its one
             line parses, with bench.py's metric, a positive value, the
             card's name, each scale's cap_policy equal to phase 6's (so
             its records are those phase 6 holds against the plain
             versions), every raster step (1, 1, 1, 1);
             then one 320x448 step under torch.profiler: the five host ops
             with the most self time, the launches and the host time
             between them by the host event running through each gap.
 19. sfm:    the SfM path without OpenCV, on the card: 8 PNG views at
             378x504 rendered without OpenCV (a back plane and a 4x3 grid
             of patches at other depths, an arc of cameras 0.15 rad apart,
             80-degree field of view); SIFT ms per image (CUDA events) and keypoints;
             matching and RANSAC + recoverPose ms per pair over retrieval's
             pairs, and the host syncs of an image and of a pair (sync debug
             mode); run_sfm_pipeline's seconds and edges, each edge's
             rotation and translation-direction error against the true
             relative pose; the extract_relative_poses CLI and its edges'
             errors (every rotation error of both must be <= 1 degree);
             SIFT on one view on the card
             against the CPU path (share of keypoints within 1e-2 px, the
             largest descriptor difference). Fails if OpenCV was imported.
The line before the last is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without a CUDA card, or outside a checkout
of the repository, it prints no result and exits non-zero.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_FP32_FLOPS = 67e12      # fp32 outside the tensor cores (SXM data sheet)
# INT32 adds, compares and logic: 64 INT32 lanes per SM (a quarter of an SM's
# 128 FP32 lanes counted as FMA's two operations each) x 132 SMs x 1.98 GHz.
H100_INT32_OPS = 132 * 64 * 1.98e9
H100_BYTES_PER_S = 3.35e12   # HBM3
OPS_PER_EVAL = 21            # ~20 FLOP + 1 exp per (pixel, Gaussian) evaluation
# The backward's least work per evaluation: the forward's 21, then w,
# dwdot, the suffix, d(alpha) and its chain to six record gradients, three
# colour gradients, and the nine sums over pixels (~40).
OPS_PER_EVAL_BWD = 61
IMAGE = (320, 448)
TRAIN_MACHINES = ("joint", "joint", "joint", "nerf_only", "pose_only")
# Launches each train step makes: (composite_fwd, composite_bwd, segment_sum,
# banked_gather).
STEP_LAUNCHES = {"joint": (2, 1, 1, 0), "nerf_only": (2, 1, 1, 0), "pose_only": (2, 0, 0, 0)}
# The rasterizer's entry point at bench.py's two scales: (image, timed steps).
RASTER_SCALES = (((320, 448), 10), ((640, 960), 5))
# Launches per raster fwd+bwd step, in the same order as STEP_LAUNCHES.
RASTER_STEP_LAUNCHES = (1, 1, 1, 1)
# The flagship's refined eval arm (tools/run_flagship.py:360): Adam steps per
# start and field-depth rounds.
REFINE_STEPS, REFINE_ROUNDS = 400, 3


def bound(ops, nbytes, rate=H100_FP32_FLOPS):
    """(least ms, "operations" or "bytes", ops ms, bytes ms) on the card, the
    operations at `rate` per second."""
    ops_ms, bytes_ms = ops / rate * 1e3, nbytes / H100_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms


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


def check_compositors(fwd, bwd, rec, col, cnt, tile, gen):
    """The forward and backward compositor kernels against their plain
    versions on the records (rec, col, cnt): the images and T by
    check_images, nexec equal on every tile, and the gradients of random
    cotangents by check_grads. Returns the forward's and the backward's
    largest disagreement and the forward's outputs with the cotangents."""
    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc

    mx, kern = check_fwd(fwd, rec, col, cnt, *tile)
    acc, tfin, tst, nexec = kern
    gout = torch.randn(acc.shape, generator=gen, device=acc.device)
    gtfin = torch.randn(tfin.shape, generator=gen, device=acc.device)
    mxb = check_bwd(bwd, rec, col, tst, nexec, tfin, gout, gtfin, *tile)
    return mx, mxb, dict(nexec=nexec, tst=tst, tfin=tfin, gout=gout, gtfin=gtfin)


def check_fwd(fwd, rec, col, cnt, tile_h, tile_w):
    """The forward compositor kernel against its plain version: the images
    and T by check_images, nexec equal on every tile. Returns the largest
    disagreement and the kernel's outputs."""
    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc

    kern = fwd(rec, col, cnt, tile_h, tile_w)
    torch.cuda.synchronize()
    plain = cc.composite_records_plain(rec, col, cnt, tile_h, tile_w)
    print("  forward:")
    mx = max(check_images("acc", kern[0], plain[0]), check_images("tfin", kern[1], plain[1]))
    agree = int((kern[3] == plain[3]).sum())
    print(f"  nexec agrees on {agree} of {kern[3].numel()} tiles (chunks run: min "
          f"{int(kern[3].min())}, max {int(kern[3].max())} of {rec.shape[2] // 128})")
    if agree != kern[3].numel():
        fail("nexec differs from the plain version's")
    return mx, kern


def check_bwd(bwd, *args):
    """The backward compositor kernel against its plain version on its
    arguments (records, colors, tst, nexec, tfin, gout, gtfin, tile_h,
    tile_w), by check_grads; returns the largest disagreement."""
    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc

    dk = bwd(*args)
    torch.cuda.synchronize()
    dp = cc.composite_bwd_plain(*args)
    print("  backward:")
    return max(check_grads("drec", dk[0], dp[0]), check_grads("dcol", dk[1], dp[1]))


@contextlib.contextmanager
def first_calls(kernels):
    """{kernel: a copy of the arguments of its first call} for the calls
    made inside the block, to hold those launches against the plain
    versions afterwards (and not count them)."""
    import torch

    seen, saved = {}, []
    for k in kernels:
        cls = type(k)

        def wrapped(self, *args, _call=cls.__call__):
            if self not in seen:
                seen[self] = tuple(a.detach().clone() if torch.is_tensor(a) else a for a in args)
            return _call(self, *args)

        saved.append((cls, cls.__call__))
        cls.__call__ = wrapped
    try:
        yield seen
    finally:
        for cls, call in saved:
            cls.__call__ = call


def check_calls(seen, kernels, what: str) -> tuple[dict, dict]:
    """Each captured call (first_calls) relaunched and held against the
    plain version, and launched twice more to see whether the kernel
    repeats itself bit for bit; returns ({kernel name: largest
    disagreement}, {kernel name: repeats})."""
    import torch

    fwd, bwd, seg = kernels[:3]
    err, repeats = {}, {}
    with torch.no_grad():
        for k, args in seen.items():
            name = k.source.stem
            print(f" {what}, {name} on the path's own arguments:")
            if k is fwd:
                err[name] = check_fwd(fwd, *args)[0]
            elif k is bwd:
                err[name] = check_bwd(bwd, *args)
            elif k is seg:
                err[name] = check_segment_sum(seg, *args)
            else:
                continue
            a, b = k(*args), k(*args)
            a, b = (a,) if torch.is_tensor(a) else a, (b,) if torch.is_tensor(b) else b
            repeats[name] = all(torch.equal(x, y) for x, y in zip(a, b))
            print(f"  launched twice more: bit-equal {repeats[name]}")
    return err, repeats


def check_segment_sum(seg, ids, vals, g):
    """The segment-sum kernel against its plain version on (ids, vals) into
    g rows (ids == g is the dump row); returns the largest disagreement."""
    import torch

    from ggrt_official_torch.ops.rasterizer import segment_sum as ss

    out_k = seg(ids, vals, g)
    torch.cuda.synchronize()
    out_p = ss.scatter_add_rows_plain(ids, vals, g)
    mag = ss.scatter_add_rows_plain(ids, vals.abs(), g)
    n_max = int(torch.bincount(ids.long(), minlength=g + 1)[:g].max())
    # Float atomics in a varying order: a row of n terms agrees to
    # (n-1)·2^-24 of the sum of their magnitudes.
    e = (out_k - out_p).abs()
    bad = int((e > (n_max - 1) * 2.0**-24 * mag + 1e-30).sum())
    print(f"  segment_sum: N={ids.shape[0]} rows, {int((ids < g).sum())} live, g={g}; max abs "
          f"{e.max().item():.3e}, mean abs {e.mean().item():.3e}, {bad} entries past "
          f"(n-1)·2^-24·sum|v| with n <= {n_max}")
    if bad:
        fail("segment_sum disagrees with the plain version")
    return e.max().item()


def live_pairs(rec, fo, tile) -> int:
    """(pixel, Gaussian) pairs of the executed chunks that composite: alpha
    >= 1/255 while the pixel's running T stays >= 1e-4 within the chunk,
    in the plain version's arithmetic from the forward's chunk-start T
    (fo["tst"]), chunk by chunk. The pairs past a pixel's cut in a chunk
    are evaluated by neither the kernels nor the TPU kernel: the work that
    these records need of a compositor."""
    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc

    px, py = cc._pixel_basis(*tile, rec.device)
    px, py = px[None, :, None], py[None, :, None]
    nexec, n = fo["nexec"], 0
    for c in range(rec.shape[2] // 128):
        run = nexec > c
        if not bool(run.any()):
            break
        B = rec[run][:, :, c * 128:(c + 1) * 128]
        u = px * B[:, 0:1] + py * B[:, 1:2] + B[:, 2:3]
        v = py * B[:, 3:4] + B[:, 4:5]
        araw = B[:, 5:6] * torch.exp(-0.5 * (u * u + v * v))
        take = araw >= cc.ALPHA_MIN
        alpha = torch.where(take, torch.clamp(araw, max=cc.ALPHA_MAX), torch.zeros_like(araw))
        TT = fo["tst"][run][:, :, c:c + 1] * torch.cumprod(1.0 - alpha, dim=2)
        n += int((take & (TT >= cc.T_EPS)).sum())
    return n


def kept_share(rec, nexec, tile) -> float:
    """Share of the (warp, Gaussian) pairs of the executed chunks that the
    kernels' footprint test keeps (cuda_composite.warp_keeps_plain)."""
    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc

    keep = cc.warp_keeps_plain(rec, *tile)                        # (t, W, K)
    run = torch.arange(rec.shape[2], device=rec.device)[None] < nexec[:, None].long() * 128
    return int((keep & run[:, None]).sum()) / (keep.shape[1] * int(run.sum()))


def compositor_timing(fwd, bwd, label, rec, col, cnt, fo, tag) -> dict:
    """Both compositor kernels on one record set of 8x128 tiles: ms per
    launch (CUDA events over 20 launches), the live and dense bounds, the
    kept share. Returns {kernel: {"ms": ms, "bound": bound(...), "dense":
    bound(...)}}.

    The bytes count what each kernel needs to move: of the executed chunks,
    record rows 0-5 and colour rows 0-2 read; the forward writes acc, tfin,
    every chunk's tst and nexec; the backward reads those chunks' tst, tfin,
    three gout channels and gtfin, and writes record rows 0-5 and colour rows
    0-2 of those chunks (the wrapper's zeros are not the kernel's)."""
    tile = (8, 128)
    t, _, K = rec.shape
    P, nch = tile[0] * tile[1], K // 128
    nexec = fo["nexec"]
    ran = int(nexec.sum())                                        # executed chunks
    dense = ran * 128 * P
    live = live_pairs(rec, fo, tile)
    share = kept_share(rec, nexec, tile)
    print(f"compositors at {label}: {t} tiles x K={K}, {ran} chunks run; (pixel, Gaussian) pairs "
          f"of those chunks: dense {dense}, live (alpha >= 1/255 before the pixel's cut) {live} "
          f"({live / dense!r} of dense); kept share of (warp, Gaussian) pairs {share!r} {tag}")
    staged = ran * 128 * (6 + 3)                                  # record and colour rows read
    kernels = {
        "composite_fwd": (OPS_PER_EVAL, (t + staged + t * P * (4 + 1 + nch) + t) * 4,
                          lambda: fwd.launch(rec, col, cnt, *tile)),
        "composite_bwd": (OPS_PER_EVAL_BWD, (t + staged + ran * P + t * P * (1 + 3 + 1) + staged) * 4,
                          lambda: bwd.launch(rec, col, fo["tst"], nexec, fo["tfin"], fo["gout"],
                                             fo["gtfin"], *tile)),
    }
    out = {}
    for name, (ops, nbytes, launch) in kernels.items():
        ms = cuda_ms(launch, 20)
        lb, db = bound(live * ops, nbytes), bound(dense * ops, nbytes)
        print(f"  {name} at {label}: {ms!r} ms per launch (20 launches, CUDA events); live bound "
              f"{lb[0]!r} ms by {lb[1]} ({live} pairs x {ops} at 67 TFLOP/s = {lb[2]!r} ms; "
              f"{nbytes} bytes at 3.35 TB/s = {lb[3]!r} ms); dense bound {db[0]!r} ms by {db[1]} "
              f"({dense} pairs x {ops}) {tag}")
        out[name] = {"ms": ms, "bound": lb, "dense": db}
    return out


# The encoder's 7x7 convolutions of a serve request (8 view-encodes) that
# run through the kernel: (name, B, Cin, H, W, Cout, epilogue); the
# refinement's two run once a request, the feed-forward's first once in each
# of the transformer's two layers (its second stays on cuDNN's FFT).
CONV7_SHAPES = (("refine1", 8, 128, 320, 448, 256, "GELU"), ("refine2", 8, 256, 320, 448, 128, "RESIDUAL"),
                ("ff1", 8, 128, 80, 112, 256, "GELU"))


def conv7_timing(tag: str, device="cuda", iters: int = 5) -> dict:
    """The 7x7 kernel at CONV7_SHAPES: ms per launch (CUDA events), its
    FFMA bound (2·M·N·49·Cin at 67 TFLOP/s against each input and output
    byte once), the plain version's ms, and the two yardsticks' ms (cuDNN on
    the channels-last call; cuDNN on an NCHW-contiguous input, autotuned);
    whether the kernel gives the plain version's bits (cuDNN's generic
    engine sums in the kernel's order) and two calls the same bits."""
    import torch
    import torch.nn.functional as F

    from ggrt_official_torch.ops import conv7 as c7

    out = {}
    gen = torch.Generator(device=device).manual_seed(7)
    for name, b, cin, h, w, cout, epi in CONV7_SHAPES:
        mode = getattr(c7, epi)
        x = torch.randn(b, h, w, cin, generator=gen, device=device).permute(0, 3, 1, 2)
        wt = torch.randn(cout, cin, 7, 7, generator=gen, device=device) / math.sqrt(49 * cin)
        bias = torch.randn(cout, generator=gen, device=device) * 0.1
        res = (torch.randn(b, h, w, cout, generator=gen, device=device).permute(0, 3, 1, 2)
               if mode == c7.RESIDUAL else None)
        with torch.no_grad():
            got, _ = c7.conv7_kernel.launch(x, wt, bias, mode, res)
            again, _ = c7.conv7_kernel.launch(x, wt, bias, mode, res)
            plain = c7.conv7_plain(x, wt, bias, mode, res)
            err = float((got - plain).abs().max())
            same = bool(torch.equal(got, plain))
            ms = cuda_ms(lambda: c7.conv7_kernel.launch(x, wt, bias, mode, res), iters)
            plain_ms = cuda_ms(lambda: c7.conv7_plain(x, wt, bias, mode, res), iters)
            cudnn_nhwc_ms = cuda_ms(lambda: F.conv2d(x, wt, bias, padding=3), iters)
            x_nchw = x.contiguous()
            bench = torch.backends.cudnn.benchmark
            torch.backends.cudnn.benchmark = True
            try:
                cudnn_nchw_ms = cuda_ms(lambda: F.conv2d(x_nchw, wt, bias, padding=3), iters)
            finally:
                torch.backends.cudnn.benchmark = bench
        ops = 2 * b * h * w * cout * 49 * cin
        nbytes = (x.numel() + got.numel() * (2 if res is not None else 1) + wt.numel() + cout) * 4
        bound_ms, bound_by, _, _ = bound(ops, nbytes)
        row = dict(ms=ms, plain_ms=plain_ms, library_ms=cudnn_nhwc_ms, library_nchw_ms=cudnn_nchw_ms,
                   bound_ms=bound_ms, bound_by=bound_by, tflops=ops / ms / 1e9, max_abs_err=err,
                   bit_equal_plain=same, deterministic=bool(torch.equal(got, again)))
        out[name] = row
        print(f"timing: conv7 {name} {b}x{cin}x{h}x{w} -> {cout} ({epi}): {ms!r} ms per launch "
              f"({iters} launches, CUDA events), {row['tflops']!r} TFLOP/s; bound {bound_ms!r} ms by {bound_by} "
              f"({ops / 1e12:.3f} TFLOP at 67 TFLOP/s); plain {plain_ms!r} ms; cuDNN channels-last "
              f"{cudnn_nhwc_ms!r} ms, NCHW autotuned {cudnn_nchw_ms!r} ms; max |kernel - plain| {err!r}, "
              f"bit-equal {same}; two calls bit-equal {row['deterministic']} {tag}", flush=True)
        del x, res, got, again, plain, x_nchw
        torch.cuda.empty_cache()
    return out


def counts(*kernels):
    return tuple(k.launches for k in kernels)


def reset(*kernels):
    for k in kernels:
        k.launches = 0


def cuda_ms(fn, iters: int, spin: int = 20_000_000, calls: list | None = None) -> float:
    """Device ms per call of `fn`, by CUDA events around `iters` calls. The
    calls are queued behind a spin kernel of `spin` cycles (~10 ms by
    default), so work shorter than its own launch overhead is timed on the
    card, not at the host's launch rate. That holds only if the host has
    queued every call before the spin ends; a call that waits for the card,
    or more launches than the card's queue of pending work holds (a call of
    ~135 launches fills it in under ten calls), ends the spin first, and the
    last calls then run at the host's pace. So while the spin has ended
    before the host queued the last call, the reading is taken again over
    half the calls, down to one. `calls`, if given, receives the number of
    calls of the reading and whether the spin outlasted their queuing."""
    import torch

    fn()
    torch.cuda.synchronize()
    while True:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued = not start.query()
        torch.cuda.synchronize()
        if queued or iters == 1:
            break
        iters //= 2
    if calls is not None:
        calls[:] = [iters, queued]
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


def banked_lists_work(st, K, n_valid) -> tuple[int, int, int]:
    """Least work of the banked gather-and-merge: (integer operations,
    bytes, run entries). The lists depend only on each (tile, slot)'s run
    [lo, hi): its key and payload words are read once where some run covers
    them, each run entry costs 10 operations (its position, the run and
    window-shape tests, the key) and each valid entry ceil(log2 S) compares,
    the least a merge of S sorted runs needs; the (al, lo, hi) descriptors
    are read and the (T, K) int64 ids and (T,) int32 counts written once."""
    import torch

    start, width = st.lo.long().reshape(-1), (st.hi - st.lo).long().reshape(-1)
    edges = torch.zeros(st.key_sorted.shape[0] + 1, dtype=torch.long, device=st.lo.device)
    edges.index_add_(0, start, torch.ones_like(start))
    edges.index_add_(0, start + width, -torch.ones_like(start))
    covered = int((edges.cumsum(0)[:-1] > 0).sum())
    entries = int(width.sum())
    ops = 10 * entries + math.ceil(math.log2(len(st.budgets))) * n_valid
    nbytes = 8 * covered + 12 * st.al.numel() + 8 * st.num_tiles * K + 4 * st.num_tiles
    return ops, nbytes, entries


def binning_ms(tiling, pg, image, K) -> dict:
    """tiling.bin_gaussians_banked at max_dup 8: host ms per call (the
    enqueue of 10 calls, then one wait), device ms per call by cuda_ms behind
    a ~100 ms spin (over as many of 10 calls as the host queues within it:
    a call makes ~135 launches), and the device kernel time per call summed
    by torch.profiler over 5 calls (not fooled by a wait inside the call)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn = lambda: tiling.bin_gaussians_banked(pg, image, 8, K)
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    calls = []
    dev_ms = cuda_ms(fn, 10, spin=200_000_000, calls=calls)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    kernel_us = sum(dev_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return {"host_ms": host_ms, "cuda_ms": dev_ms, "calls": calls[0], "queued": calls[1],
            "kernel_ms": kernel_us / 1e3 / 5}


def raster_phase(kernels, tag: str, device: str = "cuda") -> dict:
    """Phase 6: `api.render` at bench.py's two scales. Returns, per scale,
    what the timing phase needs: the kernel's streams, the step times, the
    launches of the timed steps and the kernel's largest disagreement."""
    import torch

    from ggrt_official_torch.ops.rasterizer import api, projection, tiling
    from ggrt_official_torch.ops.rasterizer import banked_gather as bg
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.scripts import bench

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for image, n_steps in RASTER_SCALES:
        h, w = image
        cams, leaves = bench.bench_inputs(image, dev)
        g = leaves["means"].shape[1]
        name = f"{h}x{w}"
        cam_args = lambda c: (c["extrinsics"], c["intrinsics"], c["near"], c["far"])

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        policy = api.choose_max_per_tile(*cam_args(cams), image, cams["background"],
                                         *leaves.values(), target_db=45.0, max_dup=8)
        torch.cuda.synchronize()
        print(f"raster {name}: {g} Gaussians; choose_max_per_tile {json.dumps(policy)} in "
              f"{time.perf_counter() - t0:.2f} s", flush=True)
        K = policy["max_per_tile"]
        kw = dict(max_per_tile=K, max_dup=8, tile_chunk=16, binning_mode="banked")

        with torch.no_grad():
            if image == (320, 448):
                # bench.py's own gate (bench.py:121-135): the kernel compositor
                # against the plain tiled one on a small scene, both banked.
                mean, share, mx = bench.gate_errors(cams, leaves, kw)
                print(f"  bench gate 64x128, 4096 Gaussians, cuda against tiled: mean abs "
                      f"{mean:.3e}, outlier share {share:.3e}, max abs {mx:.3e}")
                if not (mean < bench.GATE_MEAN and share < bench.GATE_SHARE):
                    fail("the bench gate: the kernel compositor disagrees with the tiled one")

            # The kernel against its plain version on this scale's streams.
            pg = projection.project_gaussians(
                *(x[0] for x in leaves.values()), *(x[0] for x in cam_args(cams)), image)
            st = tiling.banked_streams(pg, image, 8, K)
            skw = dict(budgets=st.budgets, dydx=st.dydx, qbits=st.qbits, num_tiles=st.num_tiles,
                       max_per_tile=K)
            ids_k, cnt_k = kernels[3](*st[:5], **skw)
            torch.cuda.synchronize()
            ids_p, cnt_p = bg.banked_lists_plain(*st[:5], **skw)
            same = torch.equal(ids_k, ids_p) and torch.equal(cnt_k, cnt_p)
            err = max(int((ids_k - ids_p).abs().max()), int((cnt_k - cnt_p).abs().max()))
            _, gid_cols = bg.gather_streams_plain(*st[:5], budgets=st.budgets, dydx=st.dydx,
                                                  qbits=st.qbits, num_tiles=st.num_tiles)
            n_valid = int((gid_cols != bg.INVALID_GID).sum())
            print(f"  banked_gather: {st.num_tiles} tiles x {len(st.budgets)} slots, budgets "
                  f"{list(st.budgets)}, ncol {sum(st.budgets) + 128 * len(st.budgets)}, "
                  f"{n_valid} valid entries, {int(cnt_k.sum())} listed (K {K}); shared memory "
                  f"{bg.smem_bytes(st.budgets)} bytes per block; kernel (ids, counts) "
                  f"{'equal' if same else 'DIFFER FROM'} the plain version's bit for bit")
            if not same:
                fail(f"banked_gather disagrees with its plain version at {name}")
            del gid_cols
            flat = tiling.bin_gaussians_banked(pg, image, 8, K, merge="flat")
            sort = tiling.bin_gaussians_banked(pg, image, 8, K, merge="sort")
            lists_equal = (torch.equal(flat.gaussian_ids, sort.gaussian_ids)
                           and torch.equal(flat.counts, sort.counts))
            print(f"  lists, flat merge (kernel) against sort merge (per-slot): "
                  f"{'equal' if lists_equal else 'DIFFERENT'}; counts min {int(flat.counts.min())} "
                  f"max {int(flat.counts.max())}")
            if not lists_equal:
                fail(f"banked flat lists differ from the sort merge's at {name}")
            # The compositors and the scatter on this scale's own records and
            # record ids, those the step below gives them.
            rec, col, cnt = cc.build_records(pg, flat)
            print(f"  compositors on the step's records ({rec.shape[0]} tiles x K={rec.shape[2]}):")
            mx, mxb, fo = check_compositors(kernels[0], kernels[1], rec, col, cnt, (8, 128), gen)
            ids = torch.where(flat.gaussian_ids >= 0, flat.gaussian_ids, g).reshape(-1).to(torch.int32)
            vals = torch.randn(ids.shape[0], 9, generator=gen, device=dev)
            mxs = check_segment_sum(kernels[2], ids, vals, g)
            stats = tiling.binning_overflow_stats(pg, image, max_dup=8, max_per_tile=K)
            del flat, sort, ids_k, ids_p, ids, vals

        step = bench.raster_step(cams, leaves, image, kw)
        sums = [step()]  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(*kernels)
        made, each_ms = [], []
        for _ in range(n_steps):
            before = counts(*kernels)
            t0 = time.perf_counter()
            sums.append(step())
            torch.cuda.synchronize()
            each_ms.append((time.perf_counter() - t0) * 1e3)
            made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
        step_ms = sum(each_ms) / n_steps
        launches = counts(*kernels)
        peak = torch.cuda.max_memory_allocated() / 2**30
        if not bool(torch.isfinite(torch.stack(sums)).all()):
            fail(f"raster {name}: a non-finite gradient")
        if any(m != RASTER_STEP_LAUNCHES for m in made):
            fail(f"raster {name}: launches per step (fwd, bwd, scatter, gather) {made}, "
                 f"not {RASTER_STEP_LAUNCHES}")
        print(f"  steps: {n_steps} fwd+bwd after one warm-up, {step_ms:.3f} ms per step (min "
              f"{min(each_ms):.3f}, max {max(each_ms):.3f}), {h * w / step_ms * 1e3:.1f} pixels/s, "
              f"peak {peak:.2f} GiB; gradients finite; launches (fwd, bwd, scatter, gather) "
              f"{RASTER_STEP_LAUNCHES} per step {tag}")
        print(f"  overflow at K={K}: " + ", ".join(f"{k} {float(v):.6g}" for k, v in stats.items()),
              flush=True)
        out[name] = dict(streams=st, K=K, policy=policy, n_valid=n_valid, pg=pg, step_ms=step_ms, each_ms=each_ms,
                         launches=launches, step=step, records=(rec, col, cnt), fwd_out=fo,
                         err={"banked_gather": err, "composite_fwd": mx, "composite_bwd": mxb,
                              "segment_sum": mxs})
    return out


def show_profile(prof, what: str, wall_ms: float, tag: str) -> float:
    """The device kernel time of a torch.profiler run against its wall
    time, the kernels and ops that take the most, and the port's own.
    Returns the device kernel time in ms. User annotations (the
    optimizer's step range) are ranges over kernels, not kernels: left
    out of the sum."""
    from torch.autograd import DeviceType

    dev_us = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    total_us = sum(dev_us(e) for e in on_card)
    print(f"profile: {what}, {total_us / 1e3:.1f} ms of device kernel time in {wall_ms:.1f} ms {tag}")
    top = sorted(on_card, key=dev_us, reverse=True)
    own = ("composite_", "banked_lists", "segment_sum")
    for e in top[:10] + [e for e in top[10:] if any(k in e.key for k in own)]:
        print(f"  kernel {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key[:100]}")
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type == DeviceType.CPU and e.key.startswith("aten::") and dev_us(e) > 0]
    for e in sorted(ops, key=dev_us, reverse=True)[:8]:
        print(f"  op     {dev_us(e) / 1e3:9.2f} ms {e.count:5d}x  {e.key} {str(e.input_shapes)[:110]}")
    return total_us / 1e3


def scene_views(image, seeds, mode: str, num_source_views: int = 5) -> list:
    """Collated views of synthetic 8-view scenes at `image`, one per seed."""
    from ggrt_official_torch.data import datasets

    return [datasets.collate_batch(datasets.SyntheticPlanesDataset(
        datasets.SyntheticSceneSpec(n_views=8, image_size=image, seed=seed), mode=mode,
        num_source_views=num_source_views)[0]) for seed in seeds]


def eval_phase(cfg, model, kernels, tag: str, device="cuda", image=IMAGE,
               refine_steps: int = REFINE_STEPS) -> dict:
    """Phase 9: the Evaluator at full width. Returns the times, the
    launches of each call, the peak memory and the dataset summary; the
    caller checks the launches."""
    import tempfile

    import torch

    from ggrt_official_torch.data import datasets
    from ggrt_official_torch.evaluation.harness import Evaluator

    ev = Evaluator(cfg, model, refine_depth_rounds=REFINE_ROUNDS, device=device)
    views = scene_views(image, (10, 11), "test")
    ev.evaluate_view(views[0])  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    made, ms = {}, {}

    def run(name, fn):
        before = counts(*kernels)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[name] = (time.perf_counter() - t0) * 1e3
        made[name] = tuple(a - b for a, b in zip(counts(*kernels), before))
        return out

    plain = run("view", lambda: ev.evaluate_view(views[1]))
    refined = run("refined view", lambda: ev.evaluate_view(views[1], refine_steps=refine_steps))
    targets = run("pose_targets", lambda: ev.pose_targets(views[1], steps=refine_steps))
    render_ms = run("time_render", lambda: ev.time_render(views[1], iters=3))
    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=8, image_size=image, seed=12),
                                         mode="test", num_source_views=5)
    with tempfile.TemporaryDirectory() as tmp:
        summary = run("evaluate_dataset", lambda: ev.evaluate_dataset(ds, out_dir=tmp, limit=2))

        def refuse(name):
            fail(f"results.json holds the non-strict constant {name}")

        with open(Path(tmp) / "results.json") as f:
            results = json.loads(f.read(), parse_constant=refuse)
    peak = torch.cuda.max_memory_allocated() / 2**30
    # Where a refinement step's time goes: pose_targets under the profiler
    # at 0 and at 20 steps per start; the difference over 40 is the device
    # time of one Adam step (pose_targets renders nothing, so it launches
    # no kernel).
    dev = {}
    for steps in (0, 20):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            ev.pose_targets(views[1], steps=steps)
            torch.cuda.synchronize()
        dev[steps] = show_profile(prof, f"pose_targets at {steps} steps per start ({2 * steps} Adam steps, "
                                  f"the IPO-Net pass, 2 losses)", (time.perf_counter() - t0) * 1e3, tag)
    step_dev_ms = (dev[20] - dev[0]) / 40
    for name, out in (("view", plain), ("refined view", refined)):
        bad = [k for k in ("psnr", "ssim", *(k for k in out if k.endswith("_unaligned")))
               if not math.isfinite(out[k])]
        print(f"eval: {name}: psnr {out['psnr']!r}, ssim {out['ssim']!r}, R_error_mean_unaligned "
              f"{out['R_error_mean_unaligned']!r} deg, t_error_mean_unaligned {out['t_error_mean_unaligned']!r}, "
              f"alignment_valid {out['alignment_valid']!r}")
        if bad:
            fail(f"eval {name}: non-finite {bad}")
    if not (targets.shape == (5, 6) and bool(torch.isfinite(torch.as_tensor(targets)).all())):
        fail(f"pose_targets: {targets!r}")
    if not (results["summary"]["n_views"] == 2 and len(results["per_view"]) == 2
            and results["summary"]["lpips"] is None and "lpips_status" in results["summary"]):
        fail(f"results.json summary: {results['summary']}")
    adam_steps = 2 * refine_steps
    print(f"eval: ms per view {ms['view']!r} without refinement, {ms['refined view']!r} with "
          f"{REFINE_ROUNDS} rounds x 2 starts x {refine_steps} Adam steps; pose_targets "
          f"({adam_steps} Adam steps and the IPO-Net pass) {ms['pose_targets']!r} ms, "
          f"{ms['pose_targets'] / adam_steps!r} ms per Adam step, of it {step_dev_ms!r} ms of device "
          f"kernel time (profiler); time_render {render_ms!r} ms per "
          f"render (3 iterations); evaluate_dataset on 2 views {ms['evaluate_dataset']!r} ms, its "
          f"render_ms {summary['render_ms']!r}; peak {peak:.2f} GiB {tag}")
    print(f"eval: launches (fwd, bwd, scatter, gather): " + ", ".join(f"{k} {v}" for k, v in made.items()))
    return dict(ms=ms, made=made, peak=peak, render_ms=render_ms, summary=summary)


def loop_phase(kernels, tag: str, device="cuda", cfg=None, image=IMAGE) -> dict:
    """Phase 10: train_loop at full width, a checkpoint, a resume. Returns
    the launches per step, the save time and size; the caller checks the
    launches."""
    import tempfile

    import torch

    from ggrt_official_torch import config
    from ggrt_official_torch.training.checkpoint import STATE_FILE, CheckPointManager
    from ggrt_official_torch.training.loop import checkpoint_state, train_loop
    from ggrt_official_torch.training.trainer import GGRtTrainer

    cfg = cfg or config.pretrain_config()
    cfg.train.n_tensorboard, cfg.train.n_checkpoint = 1, 2
    # train_loop draws the next batch after each step, the last one too.
    views = scene_views(image, range(20, 25), "train")

    def batches(start):
        yield from views[start:]

    trainer = GGRtTrainer(cfg, device=device)
    trainer.init_full()
    with tempfile.TemporaryDirectory() as tmp:
        before = counts(*kernels)
        t0 = time.perf_counter()
        train_loop(trainer, batches(0), tmp, n_iters=3)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        first = tuple(a - b for a, b in zip(counts(*kernels), before))
        payload = CheckPointManager(str(Path(tmp) / "checkpoints")).load()
        saved = {k: v.to(trainer.device) for k, v in payload["state"]["model"].items()}
        live = trainer.model.state_dict()
        same = saved.keys() == live.keys() and all(torch.equal(saved[k], live[k]) for k in live)
        print(f"loop: 3 'joint' steps in {first_s!r} s with 2 checkpoint saves; latest at step "
              f"{payload['step']}, weights {'equal' if same else 'DIFFER FROM'} the trainer's bit for bit")
        if payload["step"] != 3 or not same:
            fail("loop: the checkpoint at `latest` is not the trainer's state at step 3")
        t0 = time.perf_counter()
        CheckPointManager(str(Path(tmp) / "timed")).save(3, checkpoint_state(trainer))
        save_s = time.perf_counter() - t0
        size_mb = (Path(tmp) / "timed" / "ckpt_00000003" / STATE_FILE).stat().st_size / 1e6
        del trainer, saved, live, payload

        resumed = GGRtTrainer(cfg, device=device)
        resumed.init_full()
        before = counts(*kernels)
        train_loop(resumed, batches(3), tmp, n_iters=4)
        torch.cuda.synchronize()
        second = tuple(a - b for a, b in zip(counts(*kernels), before))
        log = (Path(tmp) / "log.txt").read_text()
        steps = [json.loads(line)["step"] for line in (Path(tmp) / "metrics.jsonl").read_text().splitlines()]
        st = resumed.state
        print(f"loop: resumed ({'resumed from step 3' in log}) to step {st.step}, optimizer counts "
              f"gaussian {st.gaussian_opt.count} pose {st.pose_opt.count}; metrics.jsonl steps {steps}")
        if not ("resumed from step 3" in log and st.step == 4 and st.gaussian_opt.count == 4
                and st.pose_opt.count == 4 and steps == [1, 2, 3, 4]):
            fail("loop: the resumed run did not continue from step 3 to 4")
    print(f"loop: checkpoint save {save_s!r} s, {size_mb!r} MB (weights, two Adam states, generator) {tag}")
    return dict(made=(first, second), save_s=save_s, size_mb=size_mb)


def finetune_phase(kernels, tag: str, device="cuda", cfg=None, image=IMAGE, steps: int = 3) -> dict:
    """Phase 11: GGRtFinetuneTrainer at full width, 7 source views (6
    context pairs), crop_size 2, seeded random weights, on consecutive
    examples of one synthetic 12-view scene: one warm-up step, then `steps`
    timed 'joint' steps. Returns the launches of each timed
    step, the ms per step and of its three parts (CUDA events around
    pose_pass, pixel_grads and tile_pass), the largest update of each
    parameter group per step, the losses and the peak memory; the caller
    checks them."""
    import torch

    from ggrt_official_torch import config
    from ggrt_official_torch.training.trainer import GGRtFinetuneTrainer

    cfg = cfg or config.finetune_config()
    trainer = GGRtFinetuneTrainer(cfg, device=device)
    trainer.init_full()
    views = scene_sequence(image, steps + 1, cfg.train.num_source_views, seed=40)
    parts = {"pose_pass": [], "pixel_grads": [], "tile_pass": []}

    def timed(name):
        fn = getattr(trainer, name)

        def run(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            parts[name].append((start, end))
            return out
        return run

    for name in parts:
        setattr(trainer, name, timed(name))
    groups = {"pose_learner": list(trainer.model.pose_learner.parameters()),
              "gaussian": list(trainer.model.gaussian.parameters())}
    trainer.train_iteration(views[-1], "joint")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for v in parts.values():
        v.clear()
    made, step_ms, moved, losses = [], [], [], []
    for i in range(steps):
        snap = {k: [p.detach().clone() for p in ps] for k, ps in groups.items()}
        before = counts(*kernels)
        t0 = time.perf_counter()
        aux = trainer.train_iteration(views[i], "joint")
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
        moved.append({k: max(float((p.detach() - q).abs().max()) for p, q in zip(groups[k], snap[k]))
                      for k in groups})
        losses.append({k: float(aux[k]) for k in ("loss_all", "psnr")})
        del snap
    peak = torch.cuda.max_memory_allocated() / 2**30
    part_ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in parts.items()}
    ctx = trainer.prepare_batch(views[0])["context"]
    # What each tile spends in the backbone: its forward and backward on
    # the step's context pairs (the shared-backbone follow-up would save
    # all but one of these per step).
    from ggrt_official_torch.models.pixelsplat import make_pair_batch

    pairs_ctx = make_pair_batch(ctx)

    def backbone():
        trainer.model.gaussian.encoder(pairs_ctx, 0, just_return_features=True).sum().backward()

    backbone()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        backbone()
    end.record()
    torch.cuda.synchronize()
    backbone_ms = start.elapsed_time(end) / 3
    trainer.state.zero_grad()
    b, v, _, h, w = ctx["image"].shape
    enc = cfg.encoder
    per_pixel = enc.num_surfaces * enc.gaussians_per_pixel
    c = cfg.train.crop_size
    g_full, g_tile = b * (v - 1) * 2 * h * w * per_pixel, b * (v - 1) * 2 * (h // c) * (w // c) * per_pixel
    for i in range(steps):
        print(f"finetune: step {i}: loss_all {losses[i]['loss_all']!r}, psnr {losses[i]['psnr']!r}; "
              f"launches (fwd, bwd, scatter, gather) {made[i]}; max |update| "
              + ", ".join(f"{k} {x:.3e}" for k, x in moved[i].items()) + f"; {step_ms[i]!r} ms (IPO-Net "
              f"pass {part_ms['pose_pass'][i]!r}, full render {part_ms['pixel_grads'][i]!r}, "
              f"{c * c} tiles {part_ms['tile_pass'][i]!r} ms, CUDA events)", flush=True)
    print(f"finetune: the backbone's forward and backward on the step's {b * (v - 1)} pairs "
          f"{backbone_ms!r} ms (CUDA events, 3 runs), run once per tile", flush=True)
    del trainer, groups
    return dict(made=made, step_ms=step_ms, part_ms=part_ms, moved=moved, losses=losses, peak=peak,
                pairs=b * (v - 1), g_full=g_full, g_tile=g_tile, backbone_ms=backbone_ms)


def scene_sequence(image, n: int, num_source_views: int, seed: int) -> list:
    """n examples of one synthetic 12-view scene in train mode (9 train
    views, so up to 8 source views): consecutive targets, whose context
    windows overlap."""
    from ggrt_official_torch.data import datasets

    ds = datasets.SyntheticPlanesDataset(
        datasets.SyntheticSceneSpec(n_views=12, image_size=image, seed=seed), mode="train",
        num_source_views=num_source_views)
    return [datasets.collate_batch(ds[i]) for i in range(n)]


def cache_phase(kernels, tag: str, device="cuda", cfg=None, image=IMAGE) -> dict:
    """Phase 12: the flagship's cache A/B (tools/run_flagship.py:458-500) on
    the card: GGRtTrainer and CachedGGRtTrainer with the same seeded
    weights, 'nerf_only' over a sequence of 6 examples of one scene (5
    source views), one
    warm-up pass and one timed pass each. Returns per trainer the ms per
    step, the launches of each timed step and the losses, and the cached
    trainer's hits and misses over the timed pass and its cache; the caller
    checks them."""
    import torch

    from ggrt_official_torch import config
    from ggrt_official_torch.training.trainer import GGRtTrainer
    from ggrt_official_torch.training.trainer_cached import CachedGGRtTrainer

    cfg = cfg or config.pretrain_config()
    # Every step of a pass leaves at least one pair to encode.
    seq = scene_sequence(image, 6, 5, seed=30)
    out = {}
    for name, cls in (("off", GGRtTrainer), ("on", CachedGGRtTrainer)):
        trainer = cls(cfg, device=device)
        trainer.init_full()
        for ex in seq:  # warm-up pass
            trainer.train_iteration(ex, "nerf_only")
        torch.cuda.synchronize()
        hits0, misses0 = getattr(trainer, "hits", 0), getattr(trainer, "misses", 0)
        made, losses = [], []
        t0 = time.perf_counter()
        for ex in seq:
            before = counts(*kernels)
            aux = trainer.train_iteration(ex, "nerf_only")
            made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
            losses.append(aux["loss_all"])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / len(seq)
        losses = [float(x) for x in losses]
        out[name] = dict(ms=ms, made=made, losses=losses)
        if name == "on":
            cache = trainer.cache
            out[name].update(hits=trainer.hits - hits0, misses=trainer.misses - misses0,
                             entries=len(cache), nbytes=cache.nbytes(),
                             detached=all(x.is_cuda and not x.requires_grad
                                          for g in cache.store.values() for x in g))
        print(f"cache {name}: {ms!r} ms per 'nerf_only' step over {len(seq)} steps after a warm-up pass; "
              f"losses {', '.join(f'{x:.6f}' for x in losses)}; launches per step {made}"
              + (f"; hits {out[name]['hits']}, misses {out[name]['misses']} over the timed pass; cache "
                 f"{out[name]['entries']} entries, {out[name]['nbytes']} bytes" if name == "on" else "")
              + f" {tag}", flush=True)
        del trainer
        torch.cuda.empty_cache()
    return out


def step_syncs(fn):
    """The host syncs of one call of `fn` (a train step), counted by
    file:line of the Python frame that made each (torch's sync debug mode,
    "warn")."""
    import collections
    import warnings

    import torch

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return collections.Counter(
        f"{Path(w.filename).relative_to(ROOT) if Path(w.filename).is_relative_to(ROOT) else w.filename}:{w.lineno}"
        for w in caught if "called a synchronizing CUDA operation" in str(w.message))


def to_device_lines() -> set:
    """"file:line" of every line of training/trainer.py::_to_device, as
    step_syncs names them."""
    import inspect

    from ggrt_official_torch.training import trainer

    lines, first = inspect.getsourcelines(trainer._to_device)
    path = Path(trainer.__file__).resolve().relative_to(ROOT)
    return {f"{path}:{n}" for n in range(first, first + len(lines))}


FLAGSHIP_ARGS = ["--nerf", "20", "--pose", "12", "--pose_warm", "4", "--selfdistill_steps", "20",
                 "--ceiling", "8", "--eval_limit", "1", "--cache_ab", "4", "--scenes", "2"]


def flagship_keys_differ(result: dict) -> set:
    """The key paths in which a port artifact differs from the JAX
    artifact EVAL_FLAGSHIP_r05.json (run_flagship.schema_differences)."""
    from ggrt_official_torch.scripts.run_flagship import schema_differences

    return schema_differences(result, json.loads((ROOT / "EVAL_FLAGSHIP_r05.json").read_text()))


def flagship_phase(kernels, tag: str, device="cuda", argv=FLAGSHIP_ARGS, refine_steps: int = REFINE_STEPS) -> dict:
    """Phase 13: the flagship script in-process at its own configuration
    (tiny_config(), 128x192, 4 source views) with cut step counts, into a
    temporary directory, then the same command again, which must resume
    every stage. Returns both runs' results and timings, the first run's
    launches and the artifact's strictness and key differences; the
    caller checks them. The records, colours, list lengths and record ids
    of the first train step's render are kept (copies, made without a
    launch) for the caller to hold the kernels against their plain
    versions at this configuration's shapes."""
    import tempfile

    import torch

    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.scripts import run_flagship

    captured = {}
    build = cc.build_records

    def capture(pg, binning, tile_h=cc.TILE_H, tile_w=cc.TILE_W):
        out = build(pg, binning, tile_h, tile_w)
        if not captured and out[0].requires_grad:
            captured.update(records=tuple(x.detach().clone() for x in out), tile=(tile_h, tile_w),
                            ids=binning.gaussian_ids.detach().clone(), g=pg.mean2d.shape[0])
        return out

    with tempfile.TemporaryDirectory() as tmp:
        args = run_flagship.build_parser().parse_args([*argv, "--out", tmp, "--device", str(device)])
        before = counts(*kernels)
        t0 = time.perf_counter()
        cc.build_records = capture
        try:
            result, timings = run_flagship.run(args, refine_steps)
        finally:
            cc.build_records = build
        first_s = time.perf_counter() - t0
        made = tuple(a - b for a, b in zip(counts(*kernels), before))

        def refuse(name):
            raise ValueError(f"non-strict constant {name}")

        try:
            artifact = json.loads((Path(tmp) / "EVAL_FLAGSHIP.json").read_text(), parse_constant=refuse)
            strict = True
        except ValueError:
            artifact, strict = {}, False
        t0 = time.perf_counter()
        again, again_timings = run_flagship.run(args, refine_steps)
        second_s = time.perf_counter() - t0
    return dict(result=result, timings=timings, made=made, strict=strict, differ=flagship_keys_differ(artifact),
                again=again, again_timings=again_timings, first_s=first_s, second_s=second_s,
                captured=captured)


def write_llff_scene(root: Path, scene: str, n_views: int = 20, image=(378, 504), seed: int = 50) -> None:
    """An LLFF-format scene <root>/nerf_llff_data/<scene>/: a synthetic
    scene's views as PNG in images_8/ (the size of a 4032x3024 capture at
    factor 8) and poses_bounds.npy in LLFF's convention. load_llff_data
    negates the pose's y and z columns and divides the focal length by the
    factor; this writes the inverse, so the loaded cameras are the scene's
    up to the world scale and recentering load_llff_data applies (a
    similarity, which leaves the scene's geometry as it was)."""
    import numpy as np
    from PIL import Image

    from ggrt_official_torch.data import datasets

    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=n_views, image_size=image,
                                                                     seed=seed))
    img_dir = root / "nerf_llff_data" / scene / "images_8"
    img_dir.mkdir(parents=True)
    rows = []
    h, w = image
    for i, (rgb, c2w) in enumerate(zip(ds.images, ds.poses)):
        Image.fromarray((np.clip(rgb, 0, 1) * 255 + 0.5).astype(np.uint8)).save(img_dir / f"{i:03d}.png")
        pose = c2w[:3, :4].astype(np.float64).copy()
        pose[:, 1:3] *= -1
        hwf = np.array([h, w, float(ds.K[0, 0]) * 8])[:, None]
        rows.append(np.concatenate([np.concatenate([pose, hwf], 1).ravel(), ds.depth_range]))
    np.save(root / "nerf_llff_data" / scene / "poses_bounds.npy", np.stack(rows))


def llff_phase(kernels, tag: str, root: Path, device="cuda", tiny: bool = False, image=(378, 504)) -> dict:
    """Phase 14: the three CLIs on an LLFF-format folder, no --synthetic:
    the scene "synth" is written into <root>/nerf_llff_data/; train_ggrt at
    pretrain_config() width (5 source views, resized to 320x448) for 3
    steps into <root>/tr, eval_ggrt on its checkpoint (test mode, one view)
    and finetune_ggrt from it for one step. Each trainer's steps are
    counted and timed where they are taken; LLFFTestDataset.__getitem__
    (the reads and the resize of 6 images) is timed on the host. Returns
    the launches, losses and ms of each step, the eval summary and the
    getitem ms; the caller checks them. The scene and the train run's
    checkpoint stay in `root` for phase 15."""
    import torch

    from ggrt_official_torch.data.datasets import LLFFTestDataset
    from ggrt_official_torch.scripts import eval_ggrt, finetune_ggrt, train_ggrt
    from ggrt_official_torch.training import trainer as trainer_mod

    steps = {"train": [], "finetune": []}

    def counted(cls, name):
        inner = cls.train_iteration

        def run(self, batch, *a, **kw):
            before = counts(*kernels)
            t0 = time.perf_counter()
            aux = inner(self, batch, *a, **kw)
            if torch.device(device).type == "cuda":
                torch.cuda.synchronize()
            steps[name].append(dict(ms=(time.perf_counter() - t0) * 1e3, loss=float(aux["loss_all"]),
                                    made=tuple(a - b for a, b in zip(counts(*kernels), before))))
            return aux
        return inner, run

    tiny_flag = ["--tiny"] if tiny else []
    t0 = time.perf_counter()
    write_llff_scene(root, "synth", image=image)
    write_s = time.perf_counter() - t0
    ds = LLFFTestDataset(str(root), "train", scenes=("synth",), num_source_views=5)
    ds[0]
    t0 = time.perf_counter()
    n_get = 5
    for i in range(n_get):
        ex = ds[i]
    getitem_ms = (time.perf_counter() - t0) / n_get * 1e3
    shapes = (ex["rgb"].shape, ex["src_rgbs"].shape)

    saved = {}
    for cls, name in ((trainer_mod.GGRtTrainer, "train"), (trainer_mod.GGRtFinetuneTrainer, "finetune")):
        saved[cls], wrapped = counted(cls, name)
        cls.train_iteration = wrapped
    try:
        common = ["--rootdir", str(root), "--device", str(device)]
        before = counts(*kernels)
        train_ggrt.main([*common, "--scenes", "synth", "--n_iters", "3", "--out", str(root / "tr"), *tiny_flag])
        ckpt = str(root / "tr" / "checkpoints" / "latest")
        t0 = time.perf_counter()
        summary = eval_ggrt.main([*common, "--scenes", "synth", "--ckpt", ckpt, "--limit", "1",
                                  "--out", str(root / "ev"), *tiny_flag])
        eval_s = time.perf_counter() - t0
        eval_made = tuple(a - b for a, b in zip(counts(*kernels), before))
        finetune_ggrt.main([*common, "--scene", "synth", "--ckpt", ckpt, "--n_iters", "4",
                            "--out", str(root / "ft"), *tiny_flag])
    finally:
        for cls, fn in saved.items():
            cls.train_iteration = fn
    # The train steps' launches come before the eval's in `eval_made`.
    train_made = tuple(sum(s["made"][i] for s in steps["train"]) for i in range(len(kernels)))
    eval_made = tuple(a - b for a, b in zip(eval_made, train_made))
    for name, xs in steps.items():
        for i, st in enumerate(xs):
            print(f"llff: {name} step {i}: loss_all {st['loss']!r}; launches (fwd, bwd, scatter, gather) "
                  f"{st['made']}; {st['ms']!r} ms", flush=True)
    print(f"llff: eval on one test view {eval_s!r} s (the view and time_render's 21 renders): psnr "
          f"{summary['psnr']!r}, ssim {summary['ssim']!r}, R_error_mean_unaligned "
          f"{summary['R_error_mean_unaligned']!r}; launches {eval_made}", flush=True)
    print(f"llff: LLFFTestDataset.__getitem__ {getitem_ms!r} ms on the host (6 PNGs of {image[0]}x{image[1]} "
          f"read, blurred and resized to 320x448; {n_get} calls), example shapes {shapes}; scene written in "
          f"{write_s:.1f} s {tag}", flush=True)
    return dict(steps=steps, summary=summary, eval_made=eval_made, getitem_ms=getitem_ms, shapes=shapes)



def write_g2o_vertices(path: Path, c2w) -> None:
    """A g2o file of VERTEX_SE3:QUAT lines (id, tx ty tz, qx qy qz qw) of the
    world-to-camera poses of `c2w` (n, 4, 4), the quaternions from the
    port's lie_group.R_to_quat (w first)."""
    import torch

    from ggrt_official_torch.geometry.lie_group import R_to_quat

    w2c = torch.linalg.inv(torch.as_tensor(c2w, dtype=torch.float64))
    q = R_to_quat(w2c[:, :3, :3])
    path.write_text("".join(
        f"VERTEX_SE3:QUAT {i} {t[0]!r} {t[1]!r} {t[2]!r} {qi[1]!r} {qi[2]!r} {qi[3]!r} {qi[0]!r}\n"
        for i, (t, qi) in enumerate(zip(w2c[:, :3, 3].tolist(), q.tolist()))))


def profile_frame(kept: dict, tag: str) -> None:
    """One more video frame of render_video's model and batch (the context
    encoded again, the frame at the first context camera) under
    torch.profiler, after a warm-up frame: where a frame's device time goes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ggrt_official_torch.models.decoder_splatting import DecoderSplatting
    from ggrt_official_torch.scripts.render_video import decode_frame

    ctx, hw = kept["batch"]["context"], tuple(kept["batch"]["target"]["image"].shape[-2:])
    decoder = DecoderSplatting(kept["cfg"].decoder)
    with torch.inference_mode():
        g = kept["model"].gaussian.encode_pairs(ctx, 0, deterministic=True)
        frame = lambda: decode_frame(decoder, g, ctx["extrinsics"][0, 0], ctx["intrinsics"][0, 0],
                                     ctx["near"][:, :1], ctx["far"][:, :1], hw)
        frame()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
            t0 = time.perf_counter()
            frame()
            torch.cuda.synchronize()
    show_profile(prof, "one video frame (decode only)", (time.perf_counter() - t0) * 1e3, tag)


def video_phase(kernels, tag: str, root: Path, device="cuda", n_frames: int = 30) -> dict:
    """Phase 15: on phase 14's LLFF folder and checkpoint, render_video
    (pretrain_config() width, the first test view's 5 context views, n_frames
    frames as PNGs), then eval_crop (one test view of 320x448 in 160x224
    crops), each counted and timed where it runs; then, outside the counts,
    the LPIPS network on the card against the CPU and metrics.lpips with
    $GGRT_LPIPS_WEIGHTS, and the g2o pose-accuracy protocol on the scene's
    poses. The first frame's records (cuda_composite.build_records, kept as
    copies made without a launch) are returned for the caller to hold the
    forward kernel against its plain version. The caller checks the rest."""
    import os

    import numpy as np
    import torch
    from PIL import Image

    from ggrt_official_torch.data.llff import load_llff_data
    from ggrt_official_torch.evaluation import crop_eval, lpips, metrics, pose_accuracy
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.scripts import eval_crop, render_video

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    common = ["--rootdir", str(root), "--device", str(device), "--ckpt", str(root / "tr" / "checkpoints" / "latest")]
    crop = (160, 224)
    out = {}

    # render_video: launches and the host wall of render_frames (encode, the
    # frames, the one copy back), the frame times by CUDA events.
    captured, kept, build, render_frames = {}, {}, cc.build_records, render_video.render_frames

    def capture(pg, binning, tile_h=cc.TILE_H, tile_w=cc.TILE_W):
        rec = build(pg, binning, tile_h, tile_w)
        if not captured:
            captured.update(records=tuple(x.clone() for x in rec), tile=(tile_h, tile_w))
        return rec

    def timed_frames(model, cfg, batch, *a, **kw):
        sync()
        t0 = time.perf_counter()
        frames = render_frames(model, cfg, batch, *a, **kw)
        out["frames_wall_ms"] = (time.perf_counter() - t0) * 1e3
        kept.update(model=model, cfg=cfg, batch=batch)
        return frames

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = counts(*kernels)
    cc.build_records, render_video.render_frames = capture, timed_frames
    try:
        res = render_video.main([*common, "--scene", "synth", "--n_frames", str(n_frames),
                                 "--out", str(root / "video.mp4")])
    finally:
        cc.build_records, render_video.render_frames = build, render_frames
    out["video_made"] = tuple(a - b for a, b in zip(counts(*kernels), before))
    out["video_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else float("nan")
    out["encode_ms"], out["frame_ms"] = res["encode_ms"], res["frame_ms"]
    pngs = sorted(res["folder"].glob("*.png"))
    imgs = [np.asarray(Image.open(p)) for p in pngs]
    out["pngs"] = [p.name for p in pngs]
    out["png_ok"] = all(im.shape == (320, 448, 3) and im.dtype == np.uint8 and im.std() > 0 for im in imgs)
    out["frames_differ"] = len(imgs) > 1 and not np.array_equal(imgs[0], imgs[-1])
    out["captured"] = captured
    later = sorted(res["frame_ms"][1:])
    print(f"video: {n_frames} frames at 320x448 from 4 context pairs; encode {res['encode_ms']!r} ms (CUDA "
          f"events); ms per frame after the first: median {later[len(later) // 2]!r}, min {later[0]!r}, max "
          f"{later[-1]!r} (first {res['frame_ms'][0]!r}); {1e3 / later[len(later) // 2]!r} frames/s decode-only; "
          f"render_frames wall {out['frames_wall_ms']!r} ms ({n_frames * 1e3 / out['frames_wall_ms']!r} frames/s "
          f"with the encode and the copy back); launches {out['video_made']}; peak {out['video_peak_gib']:.2f} "
          f"GiB {tag}", flush=True)
    if dev.type == "cuda":
        profile_frame(kept, tag)
    kept.clear()

    # eval_crop: each view timed on the host clock (its crops end in a copy
    # to the host), launches counted.
    view_ms, eval_crop_view = [], crop_eval.eval_crop_view

    def timed_view(*a, **kw):
        sync()
        t0 = time.perf_counter()
        r = eval_crop_view(*a, **kw)
        view_ms.append((time.perf_counter() - t0) * 1e3)
        return r

    before = counts(*kernels)
    crop_eval.eval_crop_view = timed_view
    try:
        summary = eval_crop.main([*common, "--scenes", "synth", "--limit", "1", "--crop-h", str(crop[0]),
                                  "--crop-w", str(crop[1]), "--out", str(root / "ec")])
    finally:
        crop_eval.eval_crop_view = eval_crop_view
    out["crop_made"] = tuple(a - b for a, b in zip(counts(*kernels), before))
    out["n_crops"] = len(crop_eval.crop_centers(320, 448, *crop))
    out["crop_summary"], out["view_ms"] = summary, view_ms
    out["stitched_shape"] = np.load(root / "ec" / "stitched_000.npy").shape
    print(f"crop: {summary['n_views']} view of 320x448 in {out['n_crops']} crops of {crop[0]}x{crop[1]}: "
          f"{view_ms[0]!r} ms per view, {view_ms[0] / out['n_crops']!r} ms per crop (host clock, the copy "
          f"back included); stitched PSNR {summary['psnr_mean']!r}; launches {out['crop_made']} {tag}",
          flush=True)

    # LPIPS: random weights in JAX's npz format; the card against the CPU.
    gen = torch.Generator().manual_seed(15)
    net = lpips.LPIPS()
    with torch.no_grad():
        for i in range(5):
            getattr(net, f"lin{i}").model[1].weight.uniform_(-0.05, 0.1, generator=gen)
    sd = {k: v.numpy() for k, v in net.state_dict().items()}
    npz = root / "lpips_alex.npz"
    lpips.save_weights(str(npz), sd, sd)
    cpu_net = lpips.load_npz(lpips.LPIPS(), str(npz)).eval()
    card_net = lpips.load_npz(lpips.LPIPS(), str(npz)).to(dev).eval()
    a, b = (torch.rand(2, 3, 320, 448, generator=gen) * 2 - 1 for _ in range(2))
    with torch.no_grad():
        want = cpu_net(a, b)
        ad, bd = a.to(dev), b.to(dev)
        got = card_net(ad, bd).cpu()
        out["lpips_ms"] = cuda_ms(lambda: card_net(ad, bd), 10) if dev.type == "cuda" else float("nan")
    out["lpips_err"] = float((got - want).abs().max())
    out["lpips_rel"] = float(((got - want).abs() / want.abs()).max())
    old = os.environ.get("GGRT_LPIPS_WEIGHTS")
    os.environ["GGRT_LPIPS_WEIGHTS"] = str(npz)
    try:
        out["lpips_metric"] = metrics.lpips(((ad[0] + 1) / 2), ((bd[0] + 1) / 2))
    finally:
        if old is None:
            del os.environ["GGRT_LPIPS_WEIGHTS"]
        else:
            os.environ["GGRT_LPIPS_WEIGHTS"] = old
    print(f"lpips: card against CPU on 2 pairs of 320x448: {got.tolist()} against {want.tolist()}, max abs "
          f"{out['lpips_err']!r}, max rel {out['lpips_rel']!r}; {out['lpips_ms']!r} ms per call of 2 pairs "
          f"(CUDA events); metrics.lpips with GGRT_LPIPS_WEIGHTS {out['lpips_metric']!r} {tag}", flush=True)

    # Pose accuracy on the scene's poses (the host), one file with noise.
    _, poses, _, _, _, _ = load_llff_data(str(root / "nerf_llff_data" / "synth"), factor=8)
    c2w = np.tile(np.eye(4), (poses.shape[0], 1, 1))
    c2w[:, :3, :4] = poses[:, :3, :4]
    rng = np.random.RandomState(15)
    noisy = c2w.copy()
    noisy[:, :3, 3] += 0.01 * rng.normal(size=(len(c2w), 3))
    write_g2o_vertices(root / "gt.g2o", c2w)
    write_g2o_vertices(root / "pred.g2o", noisy)
    out["pose_accuracy"] = pose_accuracy.evaluate_g2o_pose_accuracy(str(root / "pred.g2o"), str(root / "gt.g2o"))
    print(f"pose accuracy (g2o, {len(c2w)} poses, centres moved by 0.01 s.d.): {json.dumps(out['pose_accuracy'])}",
          flush=True)
    return out

def profile_ms(fn, what: str, tag: str) -> float:
    """One call of `fn` under torch.profiler after a warm-up call, shown by
    show_profile; returns its device kernel time in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], record_shapes=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return show_profile(prof, what, wall_ms, tag)


def barf_batch(n: int, seed: int):
    """Camera-local rays and the colour where each hits the z = 2.5 plane
    (the JAX package's BARF test scene), on the CPU: the field must place
    the plane, so the camera pose is identifiable."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    d = torch.randn(n, 3, generator=gen) * torch.tensor([0.3, 0.3, 0.0]) + torch.tensor([0.0, 0.0, 1.0])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    hit = 2.5 / d[:, 2:3] * d
    rgb = 0.5 + 0.4 * torch.stack([torch.sin(2 * hit[:, 0]), torch.sin(2 * hit[:, 1]),
                                   torch.cos(1.5 * hit[:, 0] + 1.5 * hit[:, 1])], -1)
    return {"rays_o": torch.zeros(n, 3), "rays_d": d, "rgb": rgb.clamp(0, 1), "cam_idx": torch.tensor(1),
            "base_c2w": torch.eye(4)}


def legacy_phase(tag: str, root: Path, device="cuda", tiny: bool = False) -> dict:
    """Phase 16's model paths: eval_dbarf on phase 14's LLFF folder (2 test
    views), each view timed on the host clock and each render_rays chunk
    by CUDA events; one chunk of render_rays on the card against the CPU
    with the same weights and features; DBARFModel.correct_poses and a chunk
    rendered with its relative poses; BARFTrainer steps and test-time pose
    steps. `tiny` cuts every width for a rehearsal on the CPU. On the card
    one chunk and one BARF step are profiled too (neither launches a kernel
    of the port). Returns what the caller checks."""
    import copy

    import torch

    from ggrt_official_torch import config
    from ggrt_official_torch.geometry.se3 import se3_exp
    from ggrt_official_torch.models.dbarf import DBARFModel
    from ggrt_official_torch.rendering import volume
    from ggrt_official_torch.rendering.rays import get_rays_single_image
    from ggrt_official_torch.scripts import eval_dbarf
    from ggrt_official_torch.training.barf_trainer import BARFTrainConfig, BARFTrainer

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    out = {}

    # eval_dbarf: JAX's default configuration (or a cut one for a rehearsal).
    view_ms, chunk_events, kept = [], [], {}
    render_view, render_rays, build_model = eval_dbarf.render_view, volume.render_rays, eval_dbarf.build_model

    def timed_view(model, ex, *a, **kw):
        sync()
        t0 = time.perf_counter()
        pred, gt = render_view(model, ex, *a, **kw)
        sync()
        view_ms.append((time.perf_counter() - t0) * 1e3)
        kept.setdefault("ex", ex)
        return pred, gt

    def timed_chunk(*a, **kw):
        if not on_card:
            return render_rays(*a, **kw)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ret = render_rays(*a, **kw)
        end.record()
        chunk_events.append((start, end))
        return ret

    def keep_model(*a, **kw):
        kept["model"] = build_model(*a, **kw)
        return kept["model"]

    cut = ["--n_samples", "8", "--render_stride", "8"] if tiny else []
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    eval_dbarf.render_view, volume.render_rays, eval_dbarf.build_model = timed_view, timed_chunk, keep_model
    try:
        t0 = time.perf_counter()
        res = eval_dbarf.main(["--rootdir", str(root), "--scenes", "synth", "--limit", "2", "--device", str(device),
                               "--out", str(root / "ed"), *cut])
        out["eval_s"] = time.perf_counter() - t0
    finally:
        eval_dbarf.render_view, volume.render_rays, eval_dbarf.build_model = render_view, render_rays, build_model
    out["eval"], out["view_ms"] = res, view_ms
    out["chunk_ms"] = [s.elapsed_time(e) for s, e in chunk_events]
    out["eval_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if on_card else float("nan")
    n_samples = 8 if tiny else 64
    per_view = len(out["chunk_ms"]) // max(len(view_ms), 1)
    chunk_line = (f"ms per chunk of 2048 rays (CUDA events) median {sorted(out['chunk_ms'])[len(out['chunk_ms']) // 2]!r},"
                  f" min {min(out['chunk_ms'])!r}, max {max(out['chunk_ms'])!r} ({per_view} a view)"
                  if out["chunk_ms"] else "no chunk times (CPU)")
    print(f"legacy: eval_dbarf on {len(view_ms)} LLFF test views of 320x448 (render_stride 2, {n_samples} samples, "
          f"5 source views): ms per view (host clock) {', '.join(repr(x) for x in view_ms)}; {chunk_line}; peak "
          f"{out['eval_peak_gib']:.2f} GiB; per view {json.dumps(res['per_view'])} {tag}", flush=True)

    # One chunk of render_rays on the card against the CPU: the same
    # weights, the same (card-made) feature maps, the same rays.
    model, ex = kept["model"], kept["ex"]
    cpu_model = copy.deepcopy(model).cpu()

    def first_chunk(dev_, m, feats, rel_poses=None):
        cam = torch.tensor(ex["camera"][0], device=dev_)
        h, w = int(ex["camera"][0][0]), int(ex["camera"][0][1])
        ro, rd = get_rays_single_image(h, w, cam[2:18].reshape(4, 4)[None], cam[18:34].reshape(4, 4)[None], 2)
        batch = {"ray_o": ro[:2048], "ray_d": rd[:2048], "camera": cam,
                 "depth_range": torch.tensor(ex["depth_range"][0], device=dev_),
                 "src_rgbs": torch.tensor(ex["src_rgbs"][0], device=dev_),
                 "src_cameras": torch.tensor(ex["src_cameras"][0], device=dev_)}
        return volume.render_rays(batch, m.coarse, (feats, None), n_samples, det=True, inv_uniform=True,
                                  rel_poses=rel_poses)["outputs_coarse"]

    with torch.inference_mode():
        feats = model.extract_features(torch.tensor(ex["src_rgbs"][0], device=dev))[0]
        got = first_chunk(dev, model, feats)
        t0 = time.perf_counter()
        want = first_chunk(torch.device("cpu"), cpu_model, feats.cpu())
        out["cpu_chunk_s"] = time.perf_counter() - t0
    out["chunk_err"] = {k: float((got[k].cpu() - want[k]).abs().max()) for k in ("rgb", "depth")}
    out["far"] = float(ex["depth_range"][0][1])
    out["chunk_rgb_share"] = float(((got["rgb"].cpu() - want["rgb"]).abs() > 1e-3).double().mean())
    print(f"legacy: one chunk of 2048 rays, card against CPU (same weights and features): max abs rgb "
          f"{out['chunk_err']['rgb']!r}, depth {out['chunk_err']['depth']!r} (depth range "
          f"{ex['depth_range'][0].tolist()}); share of rays with an rgb error > 1e-3: {out['chunk_rgb_share']!r}; "
          f"the CPU took {out['cpu_chunk_s']:.1f} s", flush=True)
    del cpu_model
    if on_card:  # where a chunk's device time goes, after a warm-up chunk
        with torch.inference_mode():
            profile_ms(lambda: first_chunk(dev, model, feats), "one eval_dbarf chunk of 2048 rays", tag)

    # DBARFModel.correct_poses at pretrain_config()'s IPO-Net width, then a
    # chunk rendered with its relative poses.
    cfg = config.tiny_config() if tiny else config.pretrain_config()
    dbarf = DBARFModel(cfg, device=dev).eval()
    with torch.inference_mode():
        tgt = torch.tensor(ex["rgb"][0], device=dev).permute(2, 0, 1)[None]
        refs = torch.tensor(ex["src_rgbs"][0], device=dev).permute(0, 3, 1, 2)
        K = torch.tensor(ex["camera"][0][2:18], device=dev).reshape(4, 4)[:3, :3][None]
        ref_K = torch.tensor(ex["src_cameras"][0][:, 2:18], device=dev).reshape(-1, 4, 4)[:, :3, :3]
        near, far = (float(x) for x in ex["depth_range"][0])
        dbarf.correct_poses(tgt, refs, K, ref_K, min_depth=near, max_depth=far)  # warm-up
        sync()
        t0 = time.perf_counter()
        poses = dbarf.correct_poses(tgt, refs, K, ref_K, min_depth=near, max_depth=far)
        sync()
        out["pose_ms"] = (time.perf_counter() - t0) * 1e3
        rel = poses.rel_poses[0, :, -1]
        feats = dbarf.extract_features(torch.tensor(ex["src_rgbs"][0], device=dev))[0]
        posed = first_chunk(dev, dbarf, feats, rel_poses=rel)
    out["rel_poses"] = rel.cpu()
    out["posed_finite"] = bool(torch.isfinite(posed["rgb"]).all() and torch.isfinite(posed["depth"]).all()
                               and torch.isfinite(rel).all())
    print(f"legacy: DBARFModel.correct_poses ({cfg.iponet.iters} GRU steps, {refs.shape[0]} reference views at "
          f"{tgt.shape[-2]}x{tgt.shape[-1]}) {out['pose_ms']!r} ms (host clock, after a warm-up call); relative poses "
          f"|max| {float(rel.abs().max())!r}; a chunk with them finite: {out['posed_finite']} {tag}", flush=True)
    del dbarf, model, feats

    # BARF at NeRFMLP's published widths (cut for a rehearsal).
    widths = (dict(depth=4, width=32, num_freqs_xyz=4, n_samples=8) if tiny
              else dict(depth=8, width=256, num_freqs_xyz=10, n_samples=64))
    n_rays, n_steps, n_pose = (64, 4, 5) if tiny else (1024, 20, 50)
    tr = BARFTrainer(BARFTrainConfig(num_cameras=2, **widths), device=dev)
    tr.init()
    batch = {k: v.to(dev) for k, v in barf_batch(n_rays, 16).items()}
    field0 = [p.detach().clone() for p in tr.model.nerf.parameters()]
    pose0 = tr.model.pose_refine.detach().clone()
    tr.train_step(batch, 0, n_steps)  # warm-up, not timed
    losses, step_ms = [], []
    for s in range(n_steps):
        sync()
        t0 = time.perf_counter()
        losses.append(tr.train_step(batch, s, n_steps))
        sync()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if on_card:
        profile_ms(lambda: tr.train_step(batch, n_steps - 1, n_steps), "one BARF step", tag)
    out["barf_losses"] = torch.stack(losses).tolist()
    out["barf_moved"] = {
        "field": max(float((p.detach() - q).abs().max()) for p, q in zip(tr.model.nerf.parameters(), field0)),
        "pose_refine": float((tr.model.pose_refine.detach() - pose0).abs().max())}
    out["barf_ms"] = step_ms
    test = {k: v.to(dev) for k, v in barf_batch(n_rays, 17).items()}
    bad = se3_exp(torch.tensor([0.04, -0.03, 0.03, 0.0, 0.0, 0.0], device=dev))
    sync()
    t0 = time.perf_counter()
    c2w, pose_losses = tr.optimize_test_pose(test["rays_o"], test["rays_d"], test["rgb"], bad, n_steps=n_pose)
    out["pose_step_ms"] = (time.perf_counter() - t0) * 1e3 / n_pose
    out["pose_losses"], out["pose_c2w_finite"] = pose_losses, bool(torch.isfinite(c2w).all())
    print(f"legacy: BARF (depth {widths['depth']}, width {widths['width']}, {widths['num_freqs_xyz']} and 4 bands, "
          f"{widths['n_samples']} samples, {n_rays} rays a step): ms per step (host clock, synchronised) "
          f"median {sorted(step_ms)[len(step_ms) // 2]!r}, min {min(step_ms)!r}, max {max(step_ms)!r}; loss "
          f"{out['barf_losses'][0]!r} -> {out['barf_losses'][-1]!r}; max |update| field "
          f"{out['barf_moved']['field']!r}, pose_refine {out['barf_moved']['pose_refine']!r}; test-time pose "
          f"{n_pose} steps at {out['pose_step_ms']!r} ms a step (host clock, one copy of the losses at the end), "
          f"loss {pose_losses[0]!r} -> {pose_losses[-1]!r} {tag}", flush=True)
    return out


# CUDA's documented float32 accuracy (the CUDA C++ Programming Guide's
# table of single-precision functions): expf 2 ulp, logf 1 ulp, and x/y
# correctly rounded with the default -prec-div=true.
PROBE_ULP = {"exp": 2.0, "log": 1.0}


def misaligned(x):
    """A contiguous copy of x whose data lies 4 bytes off 16-byte alignment."""
    import torch

    return torch.empty(x.numel() + 1, device=x.device, dtype=x.dtype)[1:].view_as(x).copy_(x)


def probe_checks(tag: str, device="cuda") -> dict:
    """Phase 16's probe kernels outside the counted run: each against its
    plain version and float64 on the probe's inputs, in ulps of the float32
    result, and its time beside the plain op's, torch's op's and its bound."""
    import numpy as np
    import torch

    from ggrt_official_torch.tools import diag_exp_precision as probe

    out = {}
    ins = probe.probe_inputs(torch.device(device))
    for name, k in probe.KERNELS.items():
        x = ins[name]
        got, plain = k(x), k.plain(x)
        xs, g, p = (a.cpu().numpy() for a in (x, got, plain))
        want = probe.F64[name](xs.astype(np.float64))
        row = {"max_abs_err": float(np.abs(g - p).max()), "ulp": float(probe.ulps(g, want).max()),
               "plain_ulp": float(probe.ulps(p, want).max()), "vs_plain_ulp": float(probe.ulps(g, p.astype(np.float64)).max())}
        if name == "recip":
            row["rounded"] = bool(np.array_equal(g, want.astype(np.float32)))
        nbytes = 8 * x.numel()
        row["bound"] = bound(x.numel(), nbytes)
        if torch.device(device).type == "cuda":
            # The kernel takes any contiguous float32 pointer: a view 4 bytes
            # off 16-byte alignment gives the same bits.
            row["misaligned_equal"] = bool(torch.equal(k.launch(misaligned(x)), got))
            row["ms"] = cuda_ms(lambda: k.launch(x), 20)
            row["plain_ms"] = cuda_ms(lambda: k.plain(x), 20)
            row["library_ms"] = cuda_ms(lambda: {"exp": torch.exp, "recip": torch.reciprocal, "log": torch.log}[name](x), 20)
            # The launch floor: an empty kernel on the same grid and launch
            # path, through the same ctypes path and wrapper, timed as the
            # kernel is.
            row["floor_ms"] = cuda_ms(lambda: probe.FLOORS[name].launch(x), 20)
            if name == "log":
                # log's first design (a <<<>>> launch of the same grid; the
                # same bits) and its floor, timed beside the kept
                # programmatic launch.
                row["first_equal"] = bool(torch.equal(probe.probe_log_plain.launch(x), got))
                row["first_ms"] = cuda_ms(lambda: probe.probe_log_plain.launch(x), 20)
                row["first_floor_ms"] = cuda_ms(lambda: probe.probe_floor.launch(x), 20)
        else:
            row["ms"] = row["plain_ms"] = row["library_ms"] = row["floor_ms"] = float("nan")
        out[name] = row
        print(f"probe: {name} on {tuple(x.shape)}: kernel {row['ulp']!r} ulp, torch {row['plain_ulp']!r} ulp of float64 "
              f"(bound {PROBE_ULP.get(name, 'correctly rounded')}); kernel against torch max abs "
              f"{row['max_abs_err']!r} ({row['vs_plain_ulp']!r} ulp); {row['ms']!r} ms per launch (20 launches, CUDA events), launch "
              f"floor (an empty kernel on the same grid and launch path) {row['floor_ms']!r}, plain "
              f"{row['plain_ms']!r}, torch's op {row['library_ms']!r}, bound {row['bound'][0]!r} ms by {row['bound'][1]} ({nbytes} bytes at 3.35 TB/s)"
              + (f"; first design (<<<>>> launch, bit-equal {row['first_equal']}) {row['first_ms']!r} on a floor of {row['first_floor_ms']!r}"
                 if "first_ms" in row else "") + f" {tag}", flush=True)
    return out


def observability_phase(kernels, tag: str, root: Path, device="cuda", cfg=None, image=IMAGE) -> dict:
    """Phase 17's paths at `cfg` (pretrain_config() by default) width: the
    Benchmarker around 3 requests, the encoder dump of one request (its
    launches counted; the records of its rgb render kept, copies made
    without a launch, for the caller's compositor check), the Evaluator's
    image writes on one test view, the native library on the LLFF folder
    phase 14 wrote under `root`, and the device visualizations. Returns
    what the caller checks and prints; raises nothing of its own."""
    import os
    import tempfile

    import numpy as np
    import torch
    from PIL import Image

    from ggrt_official_torch import config, native
    from ggrt_official_torch.data import datasets
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.evaluation.harness import Evaluator
    from ggrt_official_torch.models.ggrt import GGRtModel
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.utils import Benchmarker
    from ggrt_official_torch.utils.encoder_visualizer import dump_encoder_visualizations
    from ggrt_official_torch.visualization import add_label, apply_color_map, draw_lines, hcat

    dev = torch.device(device)
    cfg = cfg or config.pretrain_config()
    out = {}
    model = GGRtModel(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    shim = get_data_shim(cfg.encoder)
    requests = [make_request(seed, image, 8, cfg.train.num_source_views, shim, dev) for seed in range(3)]
    tmp = tempfile.TemporaryDirectory()
    work = Path(tmp.name)

    # (a) the Benchmarker around 3 requests.
    with torch.inference_mode():
        model.gaussian(requests[0], 0, deterministic=True)  # warm-up
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        bm = Benchmarker(device=dev)
        before = counts(*kernels)
        for batch in requests:
            with bm.time("request"):
                ret, _ = model.gaussian(batch, 0, deterministic=True)
        out["bench_made"] = tuple(a - b for a, b in zip(counts(*kernels), before))
    bm.dump(work / "times.json")
    out["times"] = json.loads((work / "times.json").read_text())
    out["memory"] = bm.dump_memory(work / "memory.json")
    out["memory_json"] = json.loads((work / "memory.json").read_text())
    depth, rgb_img = ret["depth"][0, 0], ret["rgb"][0, 0]

    # (b) the encoder dump, counted; the rgb render's records kept.
    captured = {}
    build = cc.build_records

    def capture(pg, binning, tile_h=cc.TILE_H, tile_w=cc.TILE_W):
        recs = build(pg, binning, tile_h, tile_w)
        if not captured:
            captured.update(records=tuple(x.detach().clone() for x in recs), tile=(tile_h, tile_w))
        return recs

    with torch.inference_mode():
        plain, _ = model.gaussian(requests[0], 0, deterministic=True)
        plain_rgb = plain["rgb"].cpu().numpy()
    before = counts(*kernels)
    cc.build_records = capture
    try:
        t0 = time.perf_counter()
        dumps = dump_encoder_visualizations(model, requests[0], 0, image, out_dir=str(work / "dump"))
        out["dump_ms"] = (time.perf_counter() - t0) * 1e3
    finally:
        cc.build_records = build
    out["dump_made"] = tuple(a - b for a, b in zip(counts(*kernels), before))
    out["dump_shapes"] = {k: tuple(v.shape) for k, v in dumps.items()}
    out["dump_pngs"] = sorted(os.listdir(work / "dump"))
    out["dump_finite"] = all(np.isfinite(v).all() for v in dumps.values())
    out["dump_rgb_equal"] = bool(np.array_equal(dumps["rendered_rgb"], plain_rgb))
    out["captured"] = captured
    del dumps, plain

    # (c) the evaluator's two images.
    ev = Evaluator(cfg, model, device=dev)
    inner_time_render, inner_view = ev.time_render, ev.evaluate_view
    ev.time_render = lambda b, iters=20: inner_time_render(b, iters=1)
    views = []
    ev.evaluate_view = lambda *a, **k: views.append(inner_view(*a, **k)) or views[-1]
    ds = datasets.SyntheticPlanesDataset(datasets.SyntheticSceneSpec(n_views=8, image_size=image, seed=7),
                                         mode="test", num_source_views=cfg.train.num_source_views)
    t0 = time.perf_counter()
    out["eval_summary"] = ev.evaluate_dataset(ds, out_dir=str(work / "eval"), limit=1)
    out["eval_s"] = time.perf_counter() - t0
    png = work / "eval" / "pred_0000.png"
    # The PNG holds the prediction clipped to [0, 1], as in the JAX package.
    out["pred_png_err"] = (np.abs(np.asarray(Image.open(png), np.float64) / 255.0
                                  - np.clip(views[0]["pred"].transpose(1, 2, 0), 0, 1)).max()
                           if png.exists() else None)
    out["poses_png"] = (work / "eval" / "poses_pred_vs_gt.png").exists()
    try:
        import matplotlib
        out["matplotlib"] = matplotlib.__version__
    except ImportError:
        out["matplotlib"] = "absent"

    # (d) the native library on phase 14's LLFF folder.
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True)
    out["gxx"] = gxx.stdout.splitlines()[0] if gxx.returncode == 0 and gxx.stdout else None
    t0 = time.perf_counter()
    out["native"] = native.available()
    out["native_build_s"] = time.perf_counter() - t0
    out["native_log"] = native.build_log
    lds = datasets.LLFFTestDataset(str(root), "train", scenes=("synth",), num_source_views=cfg.train.num_source_views)
    examples, getitem_ms = {}, {}
    for mode in ("numpy", "native"):
        os.environ.pop("GGRT_NATIVE_RESIZE", None)
        if mode == "native":
            os.environ["GGRT_NATIVE_RESIZE"] = "1"
        try:
            lds[0]
            t0 = time.perf_counter()
            examples[mode] = [lds[i] for i in range(5)]
            getitem_ms[mode] = (time.perf_counter() - t0) / 5 * 1e3
        finally:
            os.environ.pop("GGRT_NATIVE_RESIZE", None)
    out["getitem_ms"] = getitem_ms
    out["resize_mean_abs"] = max(float(np.abs(a[k] - b[k]).mean()) for a, b in zip(examples["numpy"], examples["native"])
                                 for k in ("rgb", "src_rgbs"))
    out["resize_shapes"] = (examples["native"][0]["rgb"].shape, examples["native"][0]["src_rgbs"].shape)
    poses = np.stack(lds.train_poses[0]).astype(np.float32)
    out["pose_distances_err"] = float(np.abs(native.pose_distances(poses, poses[3])
                                             - np.linalg.norm(poses[:, :3, 3] - poses[3, :3, 3], axis=-1)).max())
    ring = native.PrefetchRing(capacity=8)
    blobs = [bytes([i]) * (1000 + i) for i in range(8)]
    pushed = [ring.push(b) for b in blobs] + [ring.push(b"ninth")]
    out["ring_ok"] = pushed == [True] * 8 + [False] and [ring.pop() for _ in range(9)] == blobs + [None]

    # (e) device visualization on the request's depth and image.
    dn = (depth - depth.min()) / (depth.max() - depth.min())
    gen = torch.Generator().manual_seed(17)
    start = torch.rand(8, 2, generator=gen) * torch.tensor([image[1], image[0]])
    end = torch.rand(8, 2, generator=gen) * torch.tensor([image[1], image[0]])
    calls = {"apply_color_map": lambda d, i: apply_color_map(d, "turbo"),
             "draw_lines": lambda d, i: draw_lines(i, start, end, (1.0, 0.2, 0.1), 2.0),
             "hcat": lambda d, i: hcat(i, d[None].expand(3, -1, -1)),
             "add_label": lambda d, i: add_label(i, "request 0")}
    vis = {}
    for name, fn in calls.items():
        got, want = fn(dn, rgb_img), fn(dn.cpu(), rgb_img.cpu())
        vis[name] = dict(device=got.device.type, shape=tuple(got.shape), finite=bool(torch.isfinite(got).all()),
                         err=None if name == "add_label" else float((got.cpu() - want).abs().max()),
                         same_shape=tuple(want.shape) == tuple(got.shape))
    out["vis"] = vis
    tmp.cleanup()
    return out


def convert_phase(kernels, tag: str, device="cuda", cfg=None, image=IMAGE) -> dict:
    """Phase 18(a): a reference-shaped checkpoint ({'pose_learner': ...,
    'gaussian': {'encoder.*': ...}}) from a seed-0 GGRtModel's state_dict,
    converted into a seed-1 model and loaded; then one request through
    each model, the counts read around each, and the converted model's
    forward launch held against the plain version on its own records."""
    import torch

    from ggrt_official_torch import config, weights
    from ggrt_official_torch.data.shims import get_data_shim
    from ggrt_official_torch.models.ggrt import GGRtModel
    from ggrt_official_torch.training import convert

    cfg = cfg or config.pretrain_config()
    dev = torch.device(device)
    src = GGRtModel(cfg, device=dev, generator=torch.Generator().manual_seed(0)).eval()
    sd = src.state_dict()
    ckpt = {part: {k.removeprefix(part + "."): v for k, v in sd.items() if k.startswith(part + ".")}
            for part in ("pose_learner", "gaussian")}
    dst = GGRtModel(cfg, device=dev, generator=torch.Generator().manual_seed(1)).eval()
    differ_before = sum(not torch.equal(v, sd[k]) for k, v in dst.state_dict().items())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dst.load_state_dict(convert.convert_reference_checkpoint(ckpt, dst, encoder_cfg=cfg.encoder))
    torch.cuda.synchronize()
    convert_ms = (time.perf_counter() - t0) * 1e3
    differ = [k for k, v in dst.state_dict().items() if not torch.equal(v, sd[k])]
    rows = len(weights.depth_pose_net_name_map(8)) + len(weights.encoder_name_map(cfg.encoder))
    req = make_request(0, image, 8, cfg.train.num_source_views, get_data_shim(cfg.encoder), dev)
    made, rgb = [], []
    with torch.inference_mode():
        for m in (src, dst):
            with first_calls(kernels) as seen:
                before = counts(*kernels)
                ret, _ = m.gaussian(req, 0, deterministic=True)
                torch.cuda.synchronize()
                made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
            rgb.append(ret["rgb"])
    print(f"convert: {len(sd)} state_dict keys, {rows} name-map rows; {differ_before} tensors differ "
          f"between the seed-0 and seed-1 models, {len(differ)} after the conversion; convert + load "
          f"{convert_ms:.1f} ms; requests through both models: rgb {tuple(rgb[0].shape)} "
          f"{'bit-equal' if torch.equal(rgb[0], rgb[1]) else 'DIFFERENT'}, launches {made} {tag}", flush=True)
    err, _ = check_calls(seen, kernels, "convert")
    return dict(keys=len(sd), rows=rows, differ_before=differ_before, differ=differ, made=made,
                rgb_equal=bool(torch.equal(rgb[0], rgb[1])), finite=bool(torch.isfinite(rgb[0]).all()), err=err)


def parallel_phase(kernels, tag: str, device="cuda", cfg=None, image=IMAGE, n_steps: int = 2) -> dict:
    """Phase 18(b): the parallel paths at world size 1 (NCCL on the card,
    gloo on the CPU; a file:// store). make_mesh(); make_dp_train_step on a
    GGRtTrainer's model: a warm-up step at step 1 (where the joint loss
    weighs the Gaussian term), `n_steps` timed 'joint' steps with their
    launches, one more under the sync debug mode; the warm-up step against
    GGRtTrainer.train_iteration from the same weights, example, uniforms
    and step, run twice (the card's own run-to-run difference), and twice
    more under torch's deterministic algorithms, each by parameter group;
    render_tile_parallel("cuda") on bench.py's scene against api.render,
    forward and backward; the first launch of each kernel in the warm-up
    step and in the render held against its plain version on its own
    arguments; then dryrun_multichip(1) in a spawned rank."""
    import datetime
    import tempfile

    import torch
    import torch.distributed as dist

    from ggrt_official_torch import config
    from ggrt_official_torch.ops.rasterizer import api
    from ggrt_official_torch.parallel import dryrun, make_mesh
    from ggrt_official_torch.parallel.sharded_step import local_example, make_dp_train_step, replicate
    from ggrt_official_torch.parallel.tile_parallel import render_tile_parallel
    from ggrt_official_torch.scripts import bench
    from ggrt_official_torch.training.state import TrainState
    from ggrt_official_torch.training.trainer import GGRtTrainer, make_pretrain_loss_fn

    cfg = cfg or config.pretrain_config()
    dev = torch.device(device)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0, timeout=datetime.timedelta(seconds=60))
        try:
            mesh = make_mesh(device_type=dev.type)
            out["mesh"] = tuple(mesh.shape)
            trainer = GGRtTrainer(cfg, device=dev)
            trainer.init_full()
            model = trainer.model
            snapshot = {k: v.clone() for k, v in model.state_dict().items()}
            views = scene_views(image, range(2 + n_steps), "train", cfg.train.num_source_views)
            batches = [local_example([trainer.prepare_batch(v)], mesh) for v in views]
            uniforms = [trainer.draw_uniforms(b) for b in batches]
            replicate(model, mesh)
            step = make_dp_train_step(cfg, mesh, make_pretrain_loss_fn(model, cfg))

            def taken():
                """(parameters, the step's averaged and clipped gradients)."""
                return ({k: p.detach().clone() for k, p in model.named_parameters()},
                        {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})

            # The warm-up, compared below. At step 0 the joint loss gives the
            # Gaussian term no weight and every Gaussian gradient is zero.
            trainer.state.step = 1
            with first_calls(kernels) as seen:
                aux = step(trainer.state, model, batches[0], uniforms[0])
                torch.cuda.synchronize()
            dp_params, dp_grads = taken()
            out["err"], out["repeats"] = check_calls(seen, kernels, "parallel: dp step")
            del seen
            out["warm_loss"] = float(aux["loss_all"])
            made, step_ms, losses = [], [], []
            for i in range(1, 1 + n_steps):
                before = counts(*kernels)
                t0 = time.perf_counter()
                aux = step(trainer.state, model, batches[i], uniforms[i])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
                made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
                losses.append(float(aux["loss_all"]))
            out.update(made=made, step_ms=step_ms, losses=losses)
            out["syncs"] = step_syncs(lambda: step(trainer.state, model, batches[-1], uniforms[-1]))

            def single():
                model.load_state_dict(snapshot)
                trainer.state = TrainState(cfg, model)
                trainer.state.step = 1
                trainer.train_iteration(views[0], "joint", uniforms=uniforms[0])
                torch.cuda.synchronize()
                return taken()

            ref, again = single(), single()
            # torch's deterministic algorithms (cuDNN's among them); the ops
            # that have none warn, and are listed.
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    det, det_again = single(), single()
            finally:
                torch.use_deterministic_algorithms(False)
            out["nondeterministic_ops"] = sorted({str(w.message).split(" does not have")[0] for w in caught
                                                  if "deterministic" in str(w.message)})

            def compare(a, b):
                """{part: (bit-equal, max abs difference, relative L2
                difference)} over all tensors and per parameter group."""
                res = {}
                for part in ("all", "pose_learner", "gaussian"):
                    ks = [k for k in b if part == "all" or k.startswith(part + ".")]
                    diff = max(float((a[k] - b[k]).abs().max()) for k in ks)
                    num = math.sqrt(sum(float(((a[k] - b[k]).double() ** 2).sum()) for k in ks))
                    den = math.sqrt(sum(float((b[k].double() ** 2).sum()) for k in ks))
                    res[part] = (all(torch.equal(a[k], b[k]) for k in ks), diff, num / max(den, 1e-30))
                return res

            out["gauss_grad_max"] = max(float(g.abs().max()) for k, g in dp_grads.items() if k.startswith("gaussian."))
            pairs = (("dp step against train_iteration", dp_params, dp_grads, ref),
                     ("train_iteration run twice", *again, ref),
                     ("train_iteration twice, deterministic algorithms", *det_again, det))
            for what in ("params", "grads"):
                i = 0 if what == "params" else 1
                out[what] = tuple(compare(p if i == 0 else g, r[i]) for _, p, g, r in pairs)
            print(f"parallel: mesh {out['mesh']}; dp step at world size 1: warm-up loss (step 1) "
                  f"{out['warm_loss']:.6f}, largest Gaussian gradient {out['gauss_grad_max']:.3e}, steps "
                  f"{', '.join(f'{x:.1f}' for x in step_ms)} ms, losses {losses}, launches {made}, host "
                  f"syncs {sum(out['syncs'].values())} {tag}", flush=True)
            for j, (name, *_) in enumerate(pairs):
                print(f"  {name} (bit-equal, max abs, rel L2): " + "; ".join(
                    f"{what} {part} {out[what][j][part]}" for what in ("params", "grads")
                    for part in ("pose_learner", "gaussian")), flush=True)
            print(f"  ops without a deterministic implementation: {out['nondeterministic_ops']}; the step's "
                  f"kernels repeat themselves bit for bit: {out['repeats']}", flush=True)
            del trainer, model, snapshot, batches, uniforms, dp_params, dp_grads, ref, again, det, det_again, step
            torch.cuda.empty_cache()

            cams, leaves = bench.bench_inputs(image, dev)
            kw = dict(max_dup=8, max_per_tile=1024)
            params = [x[0].clone().requires_grad_(True) for x in leaves.values()]
            cam = [cams[k][0] for k in ("extrinsics", "intrinsics", "near", "far")]
            with first_calls(kernels) as seen:
                before = counts(*kernels)
                t0 = time.perf_counter()
                img = render_tile_parallel(mesh, *params, *cam, image, cams["background"][0], backend="cuda",
                                           **kw)
                grads = torch.autograd.grad((img ** 2).mean(), params)
                torch.cuda.synchronize()
                out["tp_ms"] = (time.perf_counter() - t0) * 1e3
                out["tp_made"] = tuple(a - b for a, b in zip(counts(*kernels), before))
            with torch.no_grad():
                ref_img = api.render(cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"], image,
                                     cams["background"], *leaves.values(), backend="cuda", **kw)[0]
            out["tp_equal"] = bool(torch.equal(img.detach(), ref_img))
            out["tp_err"] = float((img.detach() - ref_img).abs().max())
            out["tp_grads_finite"] = all(bool(torch.isfinite(g).all()) for g in grads)
            print(f"parallel: render_tile_parallel(cuda) at {image[0]}x{image[1]}, "
                  f"{leaves['means'].shape[1]} Gaussians, tp 1: against api.render "
                  f"{'bit-equal' if out['tp_equal'] else 'DIFFERENT'} (max abs {out['tp_err']!r}); fwd+bwd "
                  f"{out['tp_ms']:.1f} ms, gradients finite {out['tp_grads_finite']}, launches {out['tp_made']} {tag}",
                  flush=True)
            del params, grads, img, ref_img, leaves
            for name, e in check_calls(seen, kernels, "parallel: tile-parallel render")[0].items():
                out["err"][name] = max(out["err"].get(name, 0.0), e)
            del seen
        finally:
            dist.destroy_process_group()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun.dryrun_multichip(1, device=dev.type)
    out["dryrun_s"] = time.perf_counter() - t0
    print(f"parallel: dryrun_multichip(1) in a spawned rank, {out['dryrun_s']:.1f} s: "
          + "; ".join(f"{m} [t+{s:.1f}s]" for m, s in out["dryrun"]["stages"]), flush=True)
    return out


def host_trace(prof, wall_ms: float, tag: str) -> dict:
    """Where a step's host time goes, from a torch.profiler run with CPU
    (and CUDA) activities: the five host ops with the largest self time,
    and the host time between consecutive kernel launches, summed by the
    innermost host event (an op, or the autograd engine's evaluation of a
    backward function) that runs through each gap."""
    import collections

    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CPU]
    top = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                 key=lambda e: e.self_cpu_time_total, reverse=True)[:5]
    launches = sorted((e for e in events if "LaunchKernel" in e.name), key=lambda e: e.time_range.start)
    ops = [e for e in events if "LaunchKernel" not in e.name]
    by_op = collections.Counter()
    gaps = []
    for a, b in zip(launches, launches[1:]):
        gap = b.time_range.start - a.time_range.end
        mid = (a.time_range.end + b.time_range.start) / 2
        inside = [e for e in ops if e.time_range.start <= mid <= e.time_range.end]
        name = (min(inside, key=lambda e: e.time_range.elapsed_us()).name if inside
                else "no op: Python between the forward's ops")
        by_op[name] += gap
        gaps.append(gap)
    span = (launches[-1].time_range.end - launches[0].time_range.start) / 1e3 if launches else 0.0
    in_launch = sum(e.time_range.elapsed_us() for e in launches) / 1e3
    between = sum(gaps) / 1e3
    print(f"  host trace, one step under the profiler: {wall_ms:.1f} ms wall, {len(launches)} kernel launches "
          f"over {span:.1f} ms, {in_launch:.1f} ms inside the launch calls, {between:.1f} ms on the host "
          f"between launches {tag}")
    for e in top:
        print(f"  host op {e.self_cpu_time_total / 1e3:9.2f} ms self {e.count:5d}x  {e.key[:100]}")
    for name, us in by_op.most_common(8):
        print(f"  between launches {us / 1e3:9.2f} ms inside {name[:100]}")
    return {"wall_ms": wall_ms, "launches": len(launches), "span_ms": span, "in_launch_ms": in_launch,
            "between_ms": between, "top": [(e.key, e.self_cpu_time_total / 1e3) for e in top],
            "between_by_op": [(k, v / 1e3) for k, v in by_op.most_common(8)]}


def bench_phase(kernels, tag: str, device="cuda") -> dict:
    """Phase 18(c): scripts.bench.main([]) in-process, its line captured and
    the launches of each of its raster steps counted (its raster_step
    wrapped); then one 320x448 step under torch.profiler (host_trace)."""
    import contextlib
    import io

    import torch
    from torch.profiler import ProfilerActivity, profile

    from ggrt_official_torch.scripts import bench

    made = []
    raster_step = bench.raster_step

    def counted(*args, **kwargs):
        step = raster_step(*args, **kwargs)

        def run():
            before = counts(*kernels)
            ok = step()
            made.append(tuple(a - b for a, b in zip(counts(*kernels), before)))
            return ok

        return run

    buf = io.StringIO()
    bench.raster_step = counted
    try:
        reset(*kernels)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = bench.main(["--device", device])
        seconds = time.perf_counter() - t0
        launches = counts(*kernels)
    finally:
        bench.raster_step = raster_step
    lines = buf.getvalue().splitlines()
    payload = json.loads(lines[-1])
    out = dict(rc=rc, lines=lines, payload=payload, made=made, launches=launches, s=seconds)
    if rc != 0:
        return out

    dev = torch.device(device)
    cams, leaves = bench.bench_inputs(IMAGE, dev)
    kw = dict(max_per_tile=payload["detail"]["cap_policy"]["max_per_tile"], max_dup=8, tile_chunk=16,
              binning_mode="banked")
    step = raster_step(cams, leaves, IMAGE, kw)
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    out["trace"] = host_trace(prof, wall_ms, tag)
    return out


# Phase 19's scene: a back plane and a 4x3 grid of patches at depths
# between it and the cameras, each with its own texture, seen from an arc of
# cameras looking at the origin, 0.15 rad apart, with an 80-degree field of
# view (f = 0.6 w). RANSAC's poses here come from the best of a few
# five-point samples (OpenCV's adaptive count at 80-95% inliers), so the
# samples must span depths: with a back plane and a few small patches most
# samples are nearly planar and an edge often lands past a degree; a
# narrower field, a longer arc or repeated textures (SIFT matches a rotated
# copy) do worse.
SFM_PLANES = ((0.0, 0.0, 0.0, 1.8, 1.35),) + tuple(
    (-0.15 - 1.05 * ((7 * k) % 12) / 11, -1.2 + 0.8 * (k % 4), -0.8 + 0.8 * (k // 4), 0.3, 0.28) for k in range(12))
SFM_STEP, SFM_FOCAL = 0.15, 0.6
SFM_VIEWS, SFM_IMAGE = 8, (378, 504)
SFM_MAX_ROT_DEG = 1.0


def render_plane_views(out_dir: Path, device="cuda"):
    """Phase 19's views as PNGs, without OpenCV: each plane point (u, v) maps
    to a pixel by K [r1 r2 (t + z r3)], and each pixel samples its plane's
    texture bilinearly (grid_sample) where the plane covers it, in the order
    of SFM_PLANES (the patches lie in front of the back plane and do not
    overlap each other). Textures: smooth noise at three scales (SIFT needs
    blob-scale structure). Returns (K, c2w (n, 4, 4))."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from ggrt_official_torch.sfm.sift import gaussian_blur

    g = torch.Generator().manual_seed(0)

    def texture(th, tw):
        tex = torch.zeros(3, th, tw, device=device)
        for sigma, amp in ((1.5, 0.5), (4, 0.7), (10, 1.0)):
            layer = torch.stack([gaussian_blur(c, sigma) for c in torch.rand(3, th, tw, generator=g).to(device)])
            tex += amp * (layer - layer.min()) / (layer.max() - layer.min() + 1e-6)
        return (tex - tex.min()) / (tex.max() - tex.min() + 1e-6)

    planes = [(*p, texture(480, 640) if k == 0 else texture(200, 260)) for k, p in enumerate(SFM_PLANES)]
    h, w = SFM_IMAGE
    f = SFM_FOCAL * w
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1.0]])
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                            torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1).reshape(-1, 3)
    out_dir.mkdir(parents=True, exist_ok=True)
    poses = []
    for i in range(SFM_VIEWS):
        a = (i - (SFM_VIEWS - 1) / 2) * SFM_STEP
        c2w = np.eye(4)
        c2w[:3, :3] = [[math.cos(a), 0, -math.sin(a)], [0, 1, 0], [math.sin(a), 0, math.cos(a)]]
        c2w[:3, 3] = [2.5 * math.sin(a), 0.06 * i - 0.2, -2.5 * math.cos(a)]
        poses.append(c2w)
        w2c = np.linalg.inv(c2w)
        img = torch.zeros(3, h * w, dtype=torch.float32, device=device)
        for z0, cx, cy, hx, hy, tex in planes:
            H = K @ np.concatenate([w2c[:3, 0:1], w2c[:3, 1:2], w2c[:3, 3:4] + z0 * w2c[:3, 2:3]], 1)
            uv = pix @ torch.tensor(np.linalg.inv(H).T, device=device)
            u, v = (uv[:, 0] / uv[:, 2] - cx) / hx, (uv[:, 1] / uv[:, 2] - cy) / hy
            inside = (u.abs() <= 1) & (v.abs() <= 1)
            grid = torch.stack([u, v], -1).float().view(1, 1, -1, 2)
            img = torch.where(inside, F.grid_sample(tex[None], grid, align_corners=True)[0, :, 0], img)
        png = (img.view(3, h, w).permute(1, 2, 0).clamp(0, 1) * 255).round().byte().cpu().numpy()
        Image.fromarray(png).save(out_dir / f"{i:03d}.png")
    return K, np.stack(poses)


def relative_pose_errors(R, t, c2w, i: int, j: int) -> tuple[float, float]:
    """(rotation error, translation-direction error) in degrees of an edge
    (x_j = R x_i + t) against the true poses."""
    import numpy as np

    w2c_i, w2c_j = np.linalg.inv(c2w[i]), np.linalg.inv(c2w[j])
    R_true = w2c_j[:3, :3] @ w2c_i[:3, :3].T
    t_true = w2c_j[:3, 3] - R_true @ w2c_i[:3, 3]
    cos_r = (np.trace(np.asarray(R) @ R_true.T) - 1) / 2
    cos_t = np.dot(t, t_true) / (np.linalg.norm(t) * np.linalg.norm(t_true))
    return (math.degrees(math.acos(float(np.clip(cos_r, -1, 1)))),
            math.degrees(math.acos(float(np.clip(cos_t, -1, 1)))))


def event_ms(fn, device) -> tuple[float, object]:
    """(ms, fn's result): CUDA events around one call on the card (the call
    ends in a host read, so the events close behind it), else the host clock."""
    import torch

    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return (time.perf_counter() - t0) * 1e3, out
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end), out


def sfm_phase(tag: str, root: Path, device="cuda") -> dict:
    """Phase 19: the SfM path without OpenCV on `device`. Renders the views,
    times SIFT per image and matching and RANSAC + recoverPose per pair
    (retrieval's pairs, 4 per view), counts their host syncs, runs
    run_sfm_pipeline and the extract_relative_poses CLI, and holds one
    view's SIFT on the card against the CPU path's."""
    import numpy as np
    import torch

    from ggrt_official_torch.data.image_io import read_gray
    from ggrt_official_torch.evaluation.pose_accuracy import read_g2o_file
    from ggrt_official_torch.scripts import extract_relative_poses
    from ggrt_official_torch.sfm import sift, two_view
    from ggrt_official_torch.sfm.pipeline import run_sfm_pipeline
    from ggrt_official_torch.sfm.retrieval import pairs_from_retrieval

    dev = torch.device(device)
    out = {}
    views = root / "sfm_views"
    K, c2w = render_plane_views(views, device=dev)
    files = sorted(p.name for p in views.iterdir())
    grays = [read_gray(str(views / f)) for f in files]

    # (a) SIFT per image (one warm-up image first), and its host syncs.
    sift.detect_and_compute(grays[0], 4096, device=dev)
    feats, out["sift_ms"], out["keypoints"] = [], [], []
    for gray in grays:
        ms, (kp, desc) = event_ms(lambda: sift.detect_and_compute(gray, 4096, device=dev), dev)
        feats.append((kp.pt, desc))
        out["sift_ms"].append(ms)
        out["keypoints"].append(len(desc))
    syncs = step_syncs(lambda: sift.detect_and_compute(grays[1], 4096, device=dev)) \
        if dev.type == "cuda" else {}
    out["sift_syncs"] = sum(syncs.values())
    clock = "CUDA events" if dev.type == "cuda" else "host clock"
    print(f"sfm: SIFT ms per image {', '.join(f'{x:.2f}' for x in out['sift_ms'])} ({clock}, after one "
          f"warm-up); keypoints {out['keypoints']}; host syncs of one image {out['sift_syncs']} "
          f"{dict(syncs)} {tag}", flush=True)

    # (b) matching and RANSAC + recoverPose per pair, then one pass of every
    # pair under the sync debug mode.
    pairs = pairs_from_retrieval(str(views), files, num_matches=4)
    gen = torch.Generator(device=dev).manual_seed(0)
    out["match_ms"], out["geom_ms"] = [], []

    def pair_pass(timed: bool):
        kept = 0
        for i, j in pairs:
            ms_m, m = event_ms(lambda: two_view.match_pair(feats[i], feats[j]), dev)
            if m is None:
                continue
            ms_g, tv = event_ms(lambda: two_view.two_view_geometry(m[0], m[1], K, 30, gen), dev)
            kept += tv is not None
            if timed:
                out["match_ms"].append(ms_m)
                out["geom_ms"].append(ms_g)
        return kept

    warm = two_view.match_pair(feats[pairs[0][0]], feats[pairs[0][1]])
    two_view.two_view_geometry(warm[0], warm[1], K, 30, torch.Generator(device=dev).manual_seed(1))
    pair_pass(True)
    syncs = step_syncs(lambda: pair_pass(False)) if dev.type == "cuda" else {}
    out["pair_syncs"] = sum(syncs.values()) / max(len(pairs), 1)
    print(f"sfm: {len(pairs)} pairs; matching ms per pair {', '.join(f'{x:.2f}' for x in out['match_ms'])}; "
          f"RANSAC + recoverPose ms per pair {', '.join(f'{x:.2f}' for x in out['geom_ms'])}; host syncs per "
          f"pair {out['pair_syncs']!r} ({dict(syncs)}) {tag}", flush=True)

    # One image's SIFT and one pair's geometry under torch.profiler: device
    # time against wall time, the launches, and each stage's host and device
    # time (the spans in sift.py and essential.py, `ggrt.*` ranges here).
    if dev.type == "cuda":
        from torch.profiler import ProfilerActivity, profile

        for what, fn in (("one SIFT image", lambda: sift.detect_and_compute(grays[1], 4096, device=dev)),
                         ("one pair's RANSAC + recoverPose", lambda: two_view.two_view_geometry(warm[0], warm[1], K, 30, gen))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            show_profile(prof, what, wall, tag)
            avg = prof.key_averages()
            launches = sum(e.count for e in avg if "LaunchKernel" in e.key)
            stages = [e for e in avg if e.key.startswith(("ggrt.sift.", "ggrt.ransac.", "ggrt.recover_pose"))]
            print(f"  {launches} kernel launches; stages (host ms, device ms): " + ", ".join(
                f"{e.key} ({e.cpu_time_total / 1e3:.2f}, {getattr(e, 'device_time_total', 0) / 1e3:.2f})"
                for e in stages), flush=True)

    # (c) the pipeline, and each edge against the true relative pose.
    t0 = time.perf_counter()
    res = run_sfm_pipeline(str(views), str(root / "sfm_out"), K, num_matches=4, min_inliers=30, device=dev)
    out["pipeline_s"] = time.perf_counter() - t0
    out["edges"] = [(g.i, g.j, g.num_inliers, *relative_pose_errors(g.R, g.t, c2w, g.i, g.j))
                    for g in res["geometries"]]
    out["poses_written"] = (root / "sfm_out" / "poses_bounds.npy").exists()
    print(f"sfm: run_sfm_pipeline {out['pipeline_s']:.2f} s, {len(out['edges'])} edges, poses_bounds.npy "
          f"{out['poses_written']}; (i, j, inliers, rotation error deg, translation direction error deg): "
          f"{[(i, j, n, round(r, 4), round(tt, 4)) for i, j, n, r, tt in out['edges']]} {tag}", flush=True)

    # (d) the CLI on the same views.
    t0 = time.perf_counter()
    _, edges = extract_relative_poses.main(["--image_dir", str(views), "--out", str(root / "sfm.g2o"),
                                            "--fx", str(K[0, 0]), "--device", str(dev)])
    out["cli_s"] = time.perf_counter() - t0
    out["cli_edges"] = [(i, j, n, *relative_pose_errors(R, t, c2w, i, j)) for i, j, R, t, n in edges]
    out["cli_g2o_edges"] = len(read_g2o_file(str(root / "sfm.g2o"))[1])
    worst = max((e[3] for e in out["cli_edges"]), default=float("nan"))
    print(f"sfm: extract_relative_poses {out['cli_s']:.2f} s, {len(edges)} edges ({out['cli_g2o_edges']} in the "
          f"g2o), worst rotation error {worst!r} deg {tag}", flush=True)

    # (e) SIFT on view 0, the card against the CPU path.
    kd, dd = sift.detect_and_compute(grays[0], 4096, device=dev)
    kc, dc = sift.detect_and_compute(grays[0], 4096, device="cpu")
    pd, pc_ = kd.pt.cpu().double(), kc.pt.double()
    dist = torch.cdist(pd, pc_) + 1e3 * ((kd.angle.cpu()[:, None] - kc.angle[None]).abs() > 1e-2)
    near, idx = dist.min(1) if len(pc_) else (torch.full((len(pd),), math.inf), torch.zeros(len(pd), dtype=torch.long))
    agree = near < 1e-2
    out["sift_agree"] = float(agree.double().mean()) if len(pd) else 0.0
    out["sift_counts"] = (len(pd), len(pc_))
    out["desc_max_diff"] = float((dd.cpu()[agree] - dc[idx[agree]]).abs().max()) if agree.any() else float("nan")
    print(f"sfm: SIFT on view 0, card against CPU: {out['sift_counts'][0]} and {out['sift_counts'][1]} keypoints, "
          f"share of the card's within 1e-2 px (same angle within 1e-2 deg) of the CPU's {out['sift_agree']!r}, "
          f"largest descriptor difference {out['desc_max_diff']!r} (of 0-255) {tag}", flush=True)
    out["cv2_loaded"] = "cv2" in sys.modules
    return out


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
    from ggrt_official_torch.ops import conv7 as c7
    from ggrt_official_torch.ops.cuda_kernel import build_all
    from ggrt_official_torch.ops.rasterizer import banked_gather as bg
    from ggrt_official_torch.ops.rasterizer import cuda_composite as cc
    from ggrt_official_torch.ops.rasterizer import projection, tiling
    from ggrt_official_torch.ops.rasterizer import segment_sum as ss
    from ggrt_official_torch.scripts import bench
    from ggrt_official_torch.training.trainer import GGRtTrainer

    from ggrt_official_torch.tools import diag_exp_precision as probe

    dev = torch.device("cuda")
    fwd, bwd, seg, gat = cc.composite_fwd, cc.composite_bwd, ss.scatter_add_rows, bg.banked_lists
    kernels = (fwd, bwd, seg, gat)
    probes = tuple(probe.KERNELS.values())

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
    build_all((*kernels, *probes, c7.conv7_kernel))
    built = list(dict.fromkeys(k.source.name for k in (*kernels, *probes, c7.conv7_kernel)))
    print(f"build: {', '.join(built)} in {time.perf_counter() - t0:.2f} s "
          f"(one nvcc each, in parallel)", flush=True)
    for k in (*kernels, probes[0], c7.conv7_kernel):
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
            print(f" compositors, case {name}:")
            mx, mxb, outs = check_compositors(fwd, bwd, rec, col, cnt, tile, gen)
            if name.startswith("full"):
                err["composite_fwd"], err["composite_bwd"] = mx, mxb
                fwd_out = outs

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
        if g_train != 3_440_640:
            fail(f"the train-step render has {g_train} Gaussians, not 3,440,640")
        print(" train-step scatter:")
        err["segment_sum"] = check_segment_sum(seg, ids, vals, g_train)
        seg_args = (ids, vals, g_train)
        del gt, bt, uni
    print("kernels: ok", flush=True)

    # 4. serve: reset the counts, drive the serving path, read the counts.
    launches = {}
    with torch.inference_mode():
        model(requests[0], 0, deterministic=True)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset(*kernels, c7.conv7_kernel)
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
            if made != (2, 0, 0, 0):
                fail(f"request {i}: launches (fwd, bwd, scatter, gather) {made}, not (2, 0, 0, 0)")
            print(f"serve: request {i} rgb mean {rgb.mean().item():.4f} depth mean "
                  f"{depth.mean().item():.4f}, 2 kernel launches")
        launches["serve"] = counts(*kernels)
        conv7_paths = {"serve": c7.conv7_kernel.launches}
        serve_peak_gib = torch.cuda.max_memory_allocated() / 2**30

    # A small render on the card against the CPU path (the one the CPU tests
    # hold against the JAX package), same weights and inputs, at the widths
    # of the CPU tests: with 10 depth octaves the epipolar positional
    # encoding multiplies float32 triangulation noise by up to 2π·512, and
    # any two devices disagree.
    small = config.tiny_config()
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
    scenes = scene_views(IMAGE, range(len(TRAIN_MACHINES) + 2), "train", cfg.train.num_source_views)
    groups = {"pose_learner": list(trainer.model.pose_learner.parameters()),
              "gaussian": list(trainer.model.gaussian.parameters())}
    open_groups = {"joint": ("pose_learner", "gaussian"), "nerf_only": ("gaussian",),
                   "pose_only": ("pose_learner",)}
    trainer.train_iteration(scenes[-1], "joint")  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset(*kernels, c7.conv7_kernel)
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
              + f"; launches (fwd, bwd, scatter, gather) {made}; max |update| "
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
    conv7_paths["train"] = c7.conv7_kernel.launches
    train_peak_gib = torch.cuda.max_memory_allocated() / 2**30
    # The host syncs left in one 'joint' step, each with the line it comes
    # from (not counted in the launches above).
    syncs = step_syncs(lambda: trainer.train_iteration(scenes[-2], "joint"))
    print(f"train: {sum(syncs.values())} host syncs in one 'joint' step: "
          + ", ".join(f"{where} x{n}" for where, n in syncs.most_common()), flush=True)
    copies = [where for where in syncs if where in to_device_lines()]
    if copies:
        fail(f"train: the batch's copies to the card wait for it: {copies}")
    print("train: ok", flush=True)

    # 6. raster: the rasterizer's own entry point at bench.py's two scales.
    t0 = time.perf_counter()
    raster = raster_phase(kernels, tag)
    launches["raster"] = tuple(sum(x) for x in zip(*(r["launches"] for r in raster.values())))
    raster_ref = {name: (r["policy"], r["step_ms"]) for name, r in raster.items()}
    for r in raster.values():
        for name, e in r["err"].items():
            err[name] = max(err.get(name, 0.0), e)
    print(f"raster: ok in {time.perf_counter() - t0:.1f} s", flush=True)

    # 7. timing. The compositors at their three record sets; the kernel
    # table takes the full-width render's.
    rows = []
    comp_sets = [("serve 8x128", full, fwd_out)] + [
        (f"raster {name}", r["records"], r["fwd_out"]) for name, r in raster.items()]
    comp = {label: compositor_timing(fwd, bwd, label, *recs, fo, tag) for label, recs, fo in comp_sets}
    rec, col, cnt = full
    fo = fwd_out
    plain = {
        "composite_fwd": lambda: cc.composite_records_plain(rec, col, cnt, 8, 128),
        "composite_bwd": lambda: cc.composite_bwd_plain(rec, col, fo["tst"], fo["nexec"], fo["tfin"],
                                                        fo["gout"], fo["gtfin"], 8, 128),
    }
    for name, plain_fn in plain.items():
        c = comp["serve 8x128"][name]
        ms, (bound_ms, bound_by, _, _) = c["ms"], c["bound"]
        plain_ms = cuda_ms(plain_fn, 3)
        rows.append((name, ms, plain_ms, None, bound_ms, bound_by))
        print(f"timing: {name} {ms!r} ms per launch at serve 8x128; live bound "
              f"{bound_ms!r} ms by {bound_by}, dense bound {c['dense'][0]!r} ms; plain {plain_ms!r} ms; "
              f"library none {tag}")
    timing = {
        "segment_sum": (
            lambda: seg.launch(*seg_args),
            lambda: ss.scatter_add_rows_plain(*seg_args),
            lambda: torch.zeros(seg_args[2] + 1, 9, device=dev).index_add_(0, seg_args[0].long(), seg_args[1]),
            bound(seg_args[1].numel(), (seg_args[0].numel() + seg_args[1].numel() + seg_args[2] * 9) * 4),
            f"{seg_args[1].numel() / 1e6:.2f}M adds at 67 TFLOP/s (fp32)",
        ),
    }
    for name, r in raster.items():
        st, K = r["streams"], r["K"]
        skw = dict(budgets=st.budgets, dydx=st.dydx, qbits=st.qbits, num_tiles=st.num_tiles,
                   max_per_tile=K)
        ops, nbytes, entries = banked_lists_work(st, K, r["n_valid"])
        timing[f"banked_gather {name}"] = (
            lambda st=st, skw=skw: gat.launch(*st[:5], **skw),
            lambda st=st, skw=skw: bg.banked_lists_plain(*st[:5], **skw),
            None,
            bound(ops, nbytes, H100_INT32_OPS),
            f"{entries} run entries x 10 + {r['n_valid']} valid entries x "
            f"{math.ceil(math.log2(len(st.budgets)))} merge compares, integer operations at "
            f"{H100_INT32_OPS / 1e12:.2f} TOP/s (INT32)",
        )
    for name, (kern_fn, plain_fn, lib_fn, (bound_ms, bound_by, ops_ms, bytes_ms), work) in timing.items():
        ms = cuda_ms(kern_fn, 20)
        plain_ms = cuda_ms(plain_fn, 3)
        library_ms = cuda_ms(lib_fn, 20) if lib_fn else None
        rows.append((name, ms, plain_ms, library_ms, bound_ms, bound_by))
        print(f"timing: {name} {ms!r} ms per launch (20 launches, CUDA events); bound {bound_ms!r} ms "
              f"by {bound_by} ({work} = {ops_ms:.4f} ms; bytes at 3.35 TB/s = "
              f"{bytes_ms:.4f} ms); plain {plain_ms!r} ms; library "
              f"{'none' if library_ms is None else f'{library_ms!r} ms (index_add_)'} {tag}")
    for name, r in raster.items():
        b = binning_ms(tiling, r["pg"], tuple(int(x) for x in name.split("x")), r["K"])
        print(f"timing: tiling.bin_gaussians_banked at {name} (K {r['K']}): device "
              f"{b['cuda_ms']!r} ms per call (cuda_ms, {b['calls']} calls behind a ~100 ms spin, "
              f"{'all' if b['queued'] else 'NOT all'} queued within it), device "
              f"kernel time {b['kernel_ms']!r} ms per call (profiler, 5 calls), host "
              f"{b['host_ms']!r} ms per call (enqueue, 10 calls) {tag}")
    conv7 = conv7_timing(tag)
    print(f"timing: conv7 launches over the 3 requests {conv7_paths['serve']} (2 + 1 a transformer layer, one "
          f"encoder call a request) {tag}")
    print(f"timing: request ms {', '.join(f'{x:.1f}' for x in request_ms)} {tag}")
    print(f"timing: step ms {', '.join(f'{m} {x:.1f}' for m, x in step_ms)} "
          f"(after one warm-up step) {tag}")
    print(f"timing: peak memory {serve_peak_gib:.2f} GiB over the 3 requests, {train_peak_gib:.2f} GiB "
          f"over the {len(TRAIN_MACHINES)} train steps {tag}")
    for name, r in raster.items():
        h, w = (int(x) for x in name.split("x"))
        print(f"timing: raster {name} fwd+bwd step {r['step_ms']!r} ms (each: "
              f"{', '.join(repr(x) for x in r['each_ms'])}), {h * w / r['step_ms'] * 1e3!r} "
              f"pixels/s {tag}")
    print(f"timing: launches (fwd, bwd, scatter, gather): serve {launches['serve']}, train "
          f"{launches['train']}, raster {launches['raster']}")

    # 8. where the time goes: one profiled request and one profiled train

    # step (not counted in the main paths above).
    from torch.profiler import ProfilerActivity, profile

    def show(prof, what, wall_ms):
        show_profile(prof, what, wall_ms, tag)

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
    for name, r in raster.items():
        with profile(activities=activities, record_shapes=True) as prof:
            t0 = time.perf_counter()
            r["step"]()
            torch.cuda.synchronize()
        show(prof, f"one raster fwd+bwd step at {name}", (time.perf_counter() - t0) * 1e3)
    del raster, comp_sets, comp, fo, fwd_out, full, rec, col, cnt, seg_args, plain, timing
    torch.cuda.empty_cache()

    # 9. eval: reset the counts, drive the eval path, read the counts.
    t0 = time.perf_counter()
    reset(*kernels, c7.conv7_kernel)
    ev = eval_phase(cfg, trainer.model, kernels, tag)
    launches["eval"] = counts(*kernels)
    conv7_paths["eval"] = c7.conv7_kernel.launches
    want = {"view": (2, 0, 0, 0), "refined view": (2 + 2 * REFINE_ROUNDS, 0, 0, 0), "pose_targets": (0, 0, 0, 0)}
    for name, w in want.items():
        if ev["made"][name] != w:
            fail(f"eval {name}: launches (fwd, bwd, scatter, gather) {ev['made'][name]}, not {w}")
    print(f"eval: ok in {time.perf_counter() - t0:.1f} s; composite_fwd launches 2 per view and 2 per "
          f"refinement round {tag}", flush=True)
    del trainer, groups, scenes
    torch.cuda.empty_cache()

    # 10. loop: reset the counts, drive the loop path, read the counts.
    t0 = time.perf_counter()
    reset(*kernels)
    lp = loop_phase(kernels, tag)
    launches["loop"] = counts(*kernels)
    if lp["made"] != ((6, 3, 3, 0), (2, 1, 1, 0)):
        fail(f"loop: launches (fwd, bwd, scatter, gather) {lp['made']}, not (6, 3, 3, 0) then (2, 1, 1, 0)")
    print(f"loop: ok in {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"timing: launches (fwd, bwd, scatter, gather): eval {launches['eval']}, loop {launches['loop']}")
    torch.cuda.empty_cache()

    # The earlier phases' models and tensors go, so that each later peak is
    # the phase's own.
    del model, requests, g, pg, b, b16, ragged, keep, cnt16
    torch.cuda.empty_cache()

    # 11. finetune: reset the counts, drive the finetune path, read the counts.
    t0 = time.perf_counter()
    reset(*kernels, c7.conv7_kernel)
    ft = finetune_phase(kernels, tag)
    launches["finetune"] = counts(*kernels)
    conv7_paths["finetune"] = c7.conv7_kernel.launches
    c = config.finetune_config().train.crop_size
    want = (1 + c * c, c * c, c * c, 0)
    if (ft["pairs"], ft["g_full"], ft["g_tile"]) != (6, 5_160_960, 1_290_240):
        fail(f"finetune: {ft['pairs']} pairs, {ft['g_full']} and {ft['g_tile']} Gaussians, not 6, "
             f"5,160,960 and 1,290,240")
    if any(m != want for m in ft["made"]):
        fail(f"finetune: launches (fwd, bwd, scatter, gather) per step {ft['made']}, not {want}")
    if not all(math.isfinite(x) for lo in ft["losses"] for x in lo.values()):
        fail(f"finetune: non-finite loss_all or psnr {ft['losses']}")
    if not all(m[k] > 0 for m in ft["moved"] for k in m):
        fail(f"finetune: a parameter group did not move {ft['moved']}")
    mean = lambda xs: sum(xs) / len(xs)
    print(f"finetune: ok in {time.perf_counter() - t0:.1f} s; {ft['pairs']} context pairs, "
          f"{ft['g_full']} Gaussians in the full render, {ft['g_tile']} in each tile; ms per step "
          f"{mean(ft['step_ms'])!r} (IPO-Net pass {mean(ft['part_ms']['pose_pass'])!r}, full render "
          f"{mean(ft['part_ms']['pixel_grads'])!r}, tiles {mean(ft['part_ms']['tile_pass'])!r}); peak "
          f"{ft['peak']:.2f} GiB against {train_peak_gib:.2f} GiB for the 5-view pretrain steps {tag}",
          flush=True)
    torch.cuda.empty_cache()

    # 12. cache A/B: reset the counts, drive both trainers, read the counts.
    t0 = time.perf_counter()
    reset(*kernels, c7.conv7_kernel)
    ab = cache_phase(kernels, tag)
    launches["cache"] = counts(*kernels)
    conv7_paths["cache"] = c7.conv7_kernel.launches
    for name in ("off", "on"):
        if any(m != (2, 1, 1, 0) for m in ab[name]["made"]):
            fail(f"cache {name}: launches per step {ab[name]['made']}, not (2, 1, 1, 0)")
        if not all(math.isfinite(x) for x in ab[name]["losses"]):
            fail(f"cache {name}: a non-finite loss {ab[name]['losses']}")
    if not ab["on"]["hits"] > 0:
        fail("cache on: no hit in the timed pass")
    if not ab["on"]["detached"]:
        fail("cache on: a cached tensor is off the card or requires grad")
    print(f"cache: ok in {time.perf_counter() - t0:.1f} s; ms per step off {ab['off']['ms']!r}, on "
          f"{ab['on']['ms']!r} ({ab['on']['ms'] / ab['off']['ms']!r} of off); hits {ab['on']['hits']}, "
          f"misses {ab['on']['misses']} {tag}", flush=True)
    print(f"timing: launches (fwd, bwd, scatter, gather): finetune {launches['finetune']}, cache "
          f"{launches['cache']}")
    torch.cuda.empty_cache()

    # 13. flagship: reset the counts, drive the flagship twice, read the counts.
    t0 = time.perf_counter()
    reset(*kernels)
    fl = flagship_phase(kernels, tag)
    launches["flagship"] = counts(*kernels)
    result, timings = fl["result"], fl["timings"]
    arms = [k for k in result if k.startswith("heldout_")]
    for name in arms:
        arm = result[name]
        bad = [k for k in ("psnr", "ssim", *(k for k in arm if k.endswith("_unaligned")))
               if not (isinstance(arm.get(k), float) and math.isfinite(arm[k]))]
        if "error" in arm or bad:
            fail(f"flagship arm {name}: {arm.get('error', f'non-finite {bad}')}")
    errs = result["pose_target_stats"]["per_view_R_err"]
    if not (len(errs) == 18 and all(math.isfinite(x) for x in errs)):
        fail(f"flagship: pose targets' R errors {errs}")
    if "error" in result["bar"]:
        fail(f"flagship: {result['bar']['error']}")
    if not fl["strict"] or fl["differ"]:
        fail(f"flagship: EVAL_FLAGSHIP.json strict {fl['strict']}, keys differing from the JAX artifact's "
             f"{sorted(fl['differ'])}")
    if not result["cache_ab"]["on"]["hits"] > 0:
        fail(f"flagship: the cache arm did not hit {result['cache_ab']}")
    resumed = {**fl["again_timings"]["stages"], "stage_ceiling": fl["again_timings"]["ceiling"]}
    if any(st["steps"] for st in resumed.values()) or not fl["again"]["cache_ab"].get("carried_from_previous_run"):
        fail(f"flagship: the second run trained {resumed} or did not carry the cache A/B over")
    if not all(fl["made"][:3]):
        fail(f"flagship: launches (fwd, bwd, scatter, gather) {fl['made']}")
    stage_ms = {k: (v["s"] * 1e3 / v["steps"] if v["steps"] else None)
                for k, v in {**timings["stages"], "stage_ceiling": timings["ceiling"]}.items()}
    print(f"flagship: ms per step (host clock, the stage's checkpoint saves included) "
          + ", ".join(f"{k} {v!r}" for k, v in stage_ms.items())
          + f"; pose targets {timings['pose_targets_s']!r} s for 18 views x 2 starts x 20 steps; arms (s) "
          + ", ".join(f"{k} {v!r}" for k, v in timings["arms_s"].items())
          + f"; cache A/B ms per step off {result['cache_ab']['off']['step_ms']!r}, on "
          f"{result['cache_ab']['on']['step_ms']!r} (hits {result['cache_ab']['on']['hits']}, misses "
          f"{result['cache_ab']['on']['misses']}); bar {json.dumps(result['bar'])}; first run "
          f"{fl['first_s']:.1f} s, resumed run {fl['second_s']:.1f} s {tag}", flush=True)
    # The kernels against their plain versions on a flagship train step's
    # own records and record ids, after the counts are read.
    cap = fl["captured"]
    if not cap:
        fail("flagship: no train step's render was captured")
    rec, col, cnt = cap["records"]
    print(f" flagship train-step records (tiny_config(), 128x192): t={rec.shape[0]} K={rec.shape[2]} from "
          f"{cap['g']} Gaussians; list lengths min {int(cnt.min())} max {int(cnt.max())}")
    gen = torch.Generator(device=dev).manual_seed(13)
    mx, mxb, _ = check_compositors(fwd, bwd, rec, col, cnt, cap["tile"], gen)
    ids = torch.where(cap["ids"] >= 0, cap["ids"], cap["g"]).reshape(-1).to(torch.int32)
    mxs = check_segment_sum(seg, ids, torch.randn(ids.shape[0], 9, generator=gen, device=dev), cap["g"])
    for name, e in (("composite_fwd", mx), ("composite_bwd", mxb), ("segment_sum", mxs)):
        err[name] = max(err[name], e)
    del cap, rec, col, cnt, ids
    print(f"flagship: ok in {time.perf_counter() - t0:.1f} s; launches (fwd, bwd, scatter, gather) "
          f"{launches['flagship']}", flush=True)
    torch.cuda.empty_cache()

    # 14. llff: reset the counts, drive the three CLIs on an LLFF folder, read the counts.
    # The folder and the train run's checkpoint serve phase 15 too.
    import tempfile

    scene_tmp = tempfile.TemporaryDirectory()
    scene_root = Path(scene_tmp.name)
    t0 = time.perf_counter()
    reset(*kernels)
    ll = llff_phase(kernels, tag, scene_root)
    launches["llff"] = counts(*kernels)
    for name, want in (("train", (2, 1, 1, 0)), ("finetune", (5, 4, 4, 0))):
        xs = ll["steps"][name]
        if len(xs) != {"train": 3, "finetune": 1}[name] or any(x["made"] != want for x in xs):
            fail(f"llff {name}: steps {xs}, each must launch {want}")
        if not all(math.isfinite(x["loss"]) for x in xs):
            fail(f"llff {name}: a non-finite loss {xs}")
    if not all(math.isfinite(ll["summary"][k]) for k in ("psnr", "ssim", "R_error_mean_unaligned")):
        fail(f"llff eval: {ll['summary']}")
    step_ms = [x["ms"] for x in ll["steps"]["train"]]
    print(f"llff: ok in {time.perf_counter() - t0:.1f} s; LLFFTestDataset.__getitem__ {ll['getitem_ms']!r} ms "
          f"on the host beside train steps of {', '.join(repr(x) for x in step_ms)} ms; launches "
          f"{launches['llff']} {tag}", flush=True)
    torch.cuda.empty_cache()

    # 15. video and crop eval: reset the counts before each path, read them after.
    t0 = time.perf_counter()
    reset(*kernels)
    vp = video_phase(kernels, tag, scene_root)
    launches["video"] = vp["video_made"]
    launches["crop"] = vp["crop_made"]
    if vp["pngs"] != [f"{i:04d}.png" for i in range(30)] or not vp["png_ok"] or not vp["frames_differ"]:
        fail(f"video: frames {vp['pngs']}, each 320x448x3 uint8 and not constant: {vp['png_ok']}, "
             f"first and last differ: {vp['frames_differ']}")
    if vp["video_made"] != (30, 0, 0, 0):
        fail(f"video: launches (fwd, bwd, scatter, gather) {vp['video_made']}, not one forward a frame (30, 0, 0, 0)")
    if not all(math.isfinite(x) and x > 0 for x in [vp["encode_ms"], *vp["frame_ms"]]):
        fail(f"video: encode {vp['encode_ms']} ms, frames {vp['frame_ms']} ms")
    if vp["crop_made"] != (2 * vp["n_crops"], 0, 0, 0):
        fail(f"crop: launches {vp['crop_made']}, not 2 forwards (rgb, depth) for each of {vp['n_crops']} crops")
    if vp["n_crops"] != 4 or vp["stitched_shape"] != (320, 448, 3) or not math.isfinite(vp["crop_summary"]["psnr_mean"]):
        fail(f"crop: {vp['n_crops']} crops, stitched {vp['stitched_shape']}, summary {vp['crop_summary']}")
    if not (vp["lpips_rel"] < 1e-4 and isinstance(vp["lpips_metric"], float) and math.isfinite(vp["lpips_metric"])):
        fail(f"lpips: card against CPU max rel {vp['lpips_rel']} (must be < 1e-4), metric {vp['lpips_metric']}")
    if not all(math.isfinite(v) for v in vp["pose_accuracy"].values()):
        fail(f"pose accuracy: {vp['pose_accuracy']}")
    # The forward kernel against its plain version on a video frame's own
    # records, after the counts are read.
    cap = vp["captured"]
    if not cap:
        fail("video: no frame's render was captured")
    rec, col, cnt = cap["records"]
    print(f" video frame records (pretrain_config(), 320x448): t={rec.shape[0]} K={rec.shape[2]}; list "
          f"lengths min {int(cnt.min())} max {int(cnt.max())}")
    mx, _, _ = check_compositors(fwd, bwd, rec, col, cnt, cap["tile"], torch.Generator(device=dev).manual_seed(15))
    err["composite_fwd"] = max(err["composite_fwd"], mx)
    del cap, rec, col, cnt, vp["captured"]
    print(f"video, crop: ok in {time.perf_counter() - t0:.1f} s; launches video {launches['video']}, crop "
          f"{launches['crop']} {tag}", flush=True)
    torch.cuda.empty_cache()

    # 16. legacy and probe: reset the counts, drive eval_dbarf, the DBARF and
    # BARF paths and the precision probe, read the counts.
    t0 = time.perf_counter()
    reset(*kernels, *probes)
    lg = legacy_phase(tag, scene_root)
    probe.main(device="cuda")
    launches["legacy"] = counts(*kernels)
    probe_launches = counts(*probes)
    print(f"legacy: launches (fwd, bwd, scatter, gather) {launches['legacy']} (the volume-rendering path does "
          f"not rasterize); probe (exp, recip, log) {probe_launches}", flush=True)
    if launches["legacy"] != (0, 0, 0, 0) or probe_launches != (1, 1, 1):
        fail(f"legacy: launches {launches['legacy']} and probe {probe_launches}, not (0, 0, 0, 0) and (1, 1, 1)")
    rows_ev = lg["eval"]["per_view"]
    if len(rows_ev) != 2 or not all(math.isfinite(r[k]) for r in rows_ev for k in ("psnr", "ssim")):
        fail(f"legacy: eval_dbarf per view {rows_ev}")
    if not lg["chunk_ms"] or len(lg["view_ms"]) != 2:
        fail(f"legacy: {len(lg['view_ms'])} views timed, {len(lg['chunk_ms'])} chunks")
    # rgb in [0, 1]; depth up to the far plane, so its error is relative to it.
    if not (lg["chunk_err"]["rgb"] < 1e-3 and lg["chunk_err"]["depth"] < 1e-3 * lg["far"]):
        fail(f"legacy: a chunk on the card against the CPU, max abs {lg['chunk_err']} (must be < 1e-3 in rgb "
             f"and < 1e-3 of the far plane {lg['far']} in depth)")
    if not lg["posed_finite"]:
        fail("legacy: the DBARF relative poses or the chunk rendered with them are not finite")
    bl = lg["barf_losses"]
    if not (all(math.isfinite(x) for x in bl) and bl[-1] < bl[0]):
        fail(f"legacy: BARF losses {bl} (finite, the last below the first)")
    if not all(v > 0 for v in lg["barf_moved"].values()):
        fail(f"legacy: a BARF Adam group did not move {lg['barf_moved']}")
    if not (all(math.isfinite(x) for x in lg["pose_losses"]) and lg["pose_c2w_finite"]):
        fail(f"legacy: test-time pose losses {lg['pose_losses']}")
    # The probe's kernels against their plain versions and float64, outside
    # the counted run. The kernel and torch's op each keep CUDA's bound, so
    # they differ by at most its double (exp 4, log 2 ulp; the division 0).
    pc = probe_checks(tag)
    for name, row in pc.items():
        if not row.get("misaligned_equal", True):
            fail(f"probe: {name} on a misaligned view differs from the aligned run: {row}")
        if not row.get("first_equal", True):
            fail(f"probe: log's first design (<<<>>> launch) differs from probe_log: {row}")
        if name == "recip":
            if not (row["rounded"] and row["vs_plain_ulp"] == 0):
                fail(f"probe: 1/x is not correctly rounded or differs from torch's: {row}")
        elif not (row["ulp"] <= PROBE_ULP[name] and row["vs_plain_ulp"] <= 2 * PROBE_ULP[name]):
            fail(f"probe: {name} off CUDA's bound of {PROBE_ULP[name]} ulp: {row}")
    print(f"legacy, probe: ok in {time.perf_counter() - t0:.1f} s {tag}", flush=True)
    torch.cuda.empty_cache()

    # 17. observability: reset the counts before the Benchmarker's requests
    # and before the encoder dump, read them after each.
    t0 = time.perf_counter()
    reset(*kernels)
    ob = observability_phase(kernels, tag, scene_root)
    scene_tmp.cleanup()
    launches["bench"], launches["dump"] = ob["bench_made"], ob["dump_made"]
    req = ob["times"].get("request", [])
    peak = ob["memory"].get("device_0", {}).get("allocated_bytes.all.peak")
    print(f"observability: Benchmarker request ms {', '.join(repr(x * 1e3) for x in req)} (phase 4: "
          f"{', '.join(f'{x:.1f}' for x in request_ms)}); dump_memory peak allocated {peak} bytes over "
          f"{len(ob['memory'])} card(s); launches {ob['bench_made']} {tag}", flush=True)
    if len(req) != 3 or not all(math.isfinite(x) and x > 0 for x in req) or ob["bench_made"] != (6, 0, 0, 0):
        fail(f"observability: Benchmarker times {req}, launches {ob['bench_made']} (3 requests of 2 forwards)")
    if not (peak and peak > 0 and ob["memory_json"] == ob["memory"]):
        fail("observability: dump_memory wrote no peak for device_0")
    print("observability: dump " + ", ".join(f"{k} {v}" for k, v in ob["dump_shapes"].items())
          + f"; PNGs {ob['dump_pngs']}; {ob['dump_ms']!r} ms on the host; launches (fwd, bwd, scatter, gather) "
          f"{ob['dump_made']}; rendered_rgb equals the plain request's: {ob['dump_rgb_equal']} {tag}", flush=True)
    if ob["dump_made"][0] < 1 or not ob["dump_rgb_equal"] or not ob["dump_finite"]:
        fail(f"observability: dump launches {ob['dump_made']}, rgb equal {ob['dump_rgb_equal']}, finite "
             f"{ob['dump_finite']}")
    if not (any(k.startswith("attention_") for k in ob["dump_shapes"]) and "depth_pdf_v0" in ob["dump_shapes"]
            and ob["dump_pngs"] == sorted(f"{k}.png" for k in ob["dump_shapes"])):
        fail(f"observability: dump images {sorted(ob['dump_shapes'])}, PNGs {ob['dump_pngs']}")
    cap = ob.pop("captured")
    if not cap:
        fail("observability: the dump's render was not captured")
    rec, col, cnt = cap["records"]
    print(f" dump render records (pretrain_config(), 320x448): t={rec.shape[0]} K={rec.shape[2]}; list "
          f"lengths min {int(cnt.min())} max {int(cnt.max())}")
    mx, mxb, _ = check_compositors(fwd, bwd, rec, col, cnt, cap["tile"], torch.Generator(device=dev).manual_seed(17))
    err["composite_fwd"], err["composite_bwd"] = max(err["composite_fwd"], mx), max(err["composite_bwd"], mxb)
    del cap, rec, col, cnt
    print(f"observability: evaluate_dataset with out_dir {ob['eval_s']!r} s; pred_0000.png max abs "
          f"{ob['pred_png_err']!r} from the clipped prediction; poses_pred_vs_gt.png written {ob['poses_png']}; "
          f"matplotlib {ob['matplotlib']}", flush=True)
    if ob["pred_png_err"] is None or ob["pred_png_err"] > 1 / 255 + 1e-7:
        fail(f"observability: pred_0000.png off the prediction by {ob['pred_png_err']}")
    if ob["poses_png"] != (ob["matplotlib"] != "absent"):
        fail(f"observability: poses_pred_vs_gt.png written {ob['poses_png']} with matplotlib {ob['matplotlib']}")
    print(f"observability: {ob['gxx']}; native library {'built and loaded' if ob['native'] else 'NOT built'} in "
          f"{ob['native_build_s']:.2f} s; LLFFTestDataset.__getitem__ {ob['getitem_ms']['numpy']!r} ms numpy, "
          f"{ob['getitem_ms']['native']!r} ms GGRT_NATIVE_RESIZE=1 (host; examples {ob['resize_shapes']}); "
          f"images differ by a mean of at most {ob['resize_mean_abs']!r}; pose_distances max abs "
          f"{ob['pose_distances_err']!r}; ring of 8 blobs {ob['ring_ok']} {tag}", flush=True)
    if not ob["gxx"] or not ob["native"]:
        fail(f"observability: the native library did not build or load: {ob['gxx']}\n{ob['native_log']}")
    if not (ob["resize_mean_abs"] < 0.03 and ob["pose_distances_err"] < 1e-5 and ob["ring_ok"]):
        fail(f"observability: native resize mean {ob['resize_mean_abs']} (< 0.03), pose_distances "
             f"{ob['pose_distances_err']}, ring {ob['ring_ok']}")
    print("observability: on the card " + ", ".join(f"{k} {v}" for k, v in ob["vis"].items()), flush=True)
    for name, v in ob["vis"].items():
        if not (v["device"] == "cuda" and v["finite"] and v["same_shape"] and (v["err"] is None or v["err"] <= 1e-6)):
            fail(f"observability: {name} on the card {v}")
    print(f"observability: ok in {time.perf_counter() - t0:.1f} s; launches bench {launches['bench']}, dump "
          f"{launches['dump']} {tag}", flush=True)
    torch.cuda.empty_cache()

    # 18. convert, parallel, bench: reset the counts before each path, read them after.
    t0 = time.perf_counter()
    cv = convert_phase(kernels, tag)
    launches["convert"] = tuple(sum(x) for x in zip(*cv["made"]))
    if cv["differ"] or not cv["differ_before"] or cv["rows"] != cv["keys"]:
        fail(f"convert: {len(cv['differ'])} tensors differ after the conversion ({cv['differ'][:5]}), "
             f"{cv['differ_before']} before it; {cv['rows']} rows for {cv['keys']} keys")
    if not (cv["rgb_equal"] and cv["finite"]) or cv["made"] != [(2, 0, 0, 0)] * 2 or "composite_fwd" not in cv["err"]:
        fail(f"convert: the two models' requests: rgb equal {cv['rgb_equal']}, finite {cv['finite']}, "
             f"launches {cv['made']} (2 forwards each)")
    torch.cuda.empty_cache()
    reset(*kernels)
    pp = parallel_phase(kernels, tag)
    launches["dp"] = tuple(sum(x) for x in zip(*pp["made"]))
    launches["tp"] = pp["tp_made"]
    if pp["mesh"] != (1, 1):
        fail(f"parallel: make_mesh() at world size 1 gave {pp['mesh']}")
    if any(m != STEP_LAUNCHES["joint"] for m in pp["made"]) or not all(math.isfinite(x) for x in pp["losses"]):
        fail(f"parallel: dp steps launched {pp['made']} (each {STEP_LAUNCHES['joint']}), losses {pp['losses']}")
    if sum(pp["syncs"].values()):
        fail(f"parallel: a dp step makes host syncs: {dict(pp['syncs'])}")
    # The dp step at world size 1 is train_iteration's step: bit-equal where
    # the card repeats itself, else no further from it than a second
    # train_iteration run is (atomic float sums order themselves anew).
    for what in ("params", "grads"):
        (eq, _, rel), (eq_again, _, rel_again) = pp[what][0]["all"], pp[what][1]["all"]
        if not (eq or (not eq_again and rel <= 4 * rel_again)):
            fail(f"parallel: the dp step's {what} against train_iteration's {pp[what][0]}, a second "
                 f"train_iteration against the first {pp[what][1]}")
    if not pp["gauss_grad_max"] > 0:
        fail("parallel: the compared dp step gave the Gaussians no gradient")
    if sorted(pp["err"]) != sorted(k.source.stem for k in kernels[:3]):
        fail(f"parallel: the dp step and the render launched no {sorted(pp['err'])} to check")
    if not (pp["tp_err"] <= 1e-6 and pp["tp_grads_finite"]) or pp["tp_made"] != (1, 1, 1, 0):
        fail(f"parallel: render_tile_parallel against api.render max abs {pp['tp_err']}, gradients finite "
             f"{pp['tp_grads_finite']}, launches {pp['tp_made']} (not (1, 1, 1, 0))")
    if len(pp["dryrun"]["stages"]) != 3 or not math.isfinite(pp["dryrun"]["loss"]):
        fail(f"parallel: dryrun_multichip(1) {pp['dryrun']}")
    for name, e in (*cv["err"].items(), *pp["err"].items()):
        err[name] = max(err.get(name, 0.0), e)
    torch.cuda.empty_cache()
    bp = bench_phase(kernels, tag)
    launches["bench_line"] = bp["launches"]
    print("bench: " + "\n       ".join(bp["lines"]), flush=True)
    if bp["rc"] != 0:
        fail(f"bench: scripts.bench.main exited {bp['rc']}")
    line, detail = bp["payload"], bp["payload"]["detail"]
    wdet = detail["waymo_640x960"]
    if line["metric"] != bench.METRIC or not line["value"] > 0 or detail["device"] != torch.cuda.get_device_name(0):
        fail(f"bench: metric {line['metric']}, value {line['value']}, device {detail['device']}")
    for name, policy in (("320x448", detail["cap_policy"]), ("640x960", wdet["cap_policy"])):
        if policy != json.loads(json.dumps(raster_ref[name][0])):
            fail(f"bench: cap_policy at {name} {policy}, phase 6's {raster_ref[name][0]}")
    if not bp["made"] or any(m != RASTER_STEP_LAUNCHES for m in bp["made"]):
        fail(f"bench: launches per raster step {bp['made']}, each {RASTER_STEP_LAUNCHES}")
    print(f"bench: {len(bp['made'])} raster steps (2 warm-ups), each {RASTER_STEP_LAUNCHES}; 320x448 step "
          f"{detail['step_ms']!r} ms, {line['value']!r} pixels/s (phase 6: {raster_ref['320x448'][1]!r} ms); "
          f"640x960 step {wdet['step_ms']!r} ms, {wdet['pixels_per_s']!r} pixels/s (phase 6: "
          f"{raster_ref['640x960'][1]!r} ms); main() {bp['s']:.1f} s {tag}", flush=True)
    print(f"convert, parallel, bench: ok in {time.perf_counter() - t0:.1f} s; launches convert {launches['convert']}, "
          f"dp {launches['dp']}, tp {launches['tp']}, bench {launches['bench_line']} {tag}", flush=True)

    # 19. sfm: SIFT, matching, RANSAC and recoverPose on the card, no OpenCV.
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        sf = sfm_phase(tag, Path(tmp))
    if sf["cv2_loaded"]:
        fail("sfm: OpenCV (cv2) was imported")
    if not sf["edges"]:
        fail("sfm: run_sfm_pipeline found no edge")
    bad = [e for e in sf["edges"] if not e[3] <= SFM_MAX_ROT_DEG]
    if bad:
        fail(f"sfm: edges with a rotation error above {SFM_MAX_ROT_DEG} deg (i, j, inliers, deg, deg): {bad}")
    bad = [e for e in sf["cli_edges"] if not e[3] <= SFM_MAX_ROT_DEG]
    if bad:
        fail(f"sfm: the CLI's edges with a rotation error above {SFM_MAX_ROT_DEG} deg (i, j, inliers, deg, deg): "
             f"{bad}")
    if not sf["poses_written"] or not sf["cli_edges"] or sf["cli_g2o_edges"] != len(sf["cli_edges"]):
        fail(f"sfm: poses_bounds.npy written {sf['poses_written']}; the CLI's edges {len(sf['cli_edges'])}, "
             f"{sf['cli_g2o_edges']} in its g2o")
    print(f"sfm: ok in {time.perf_counter() - t0:.1f} s; {len(sf['edges'])} edges, worst rotation error "
          f"{max(e[3] for e in sf['edges'])!r} deg {tag}", flush=True)

    sources = {
        "composite_fwd": ("ggrt_official_torch/csrc/composite_fwd.cu",
                          "ggrt_official_tpu/ops/rasterizer/pallas_composite.py:112"),
        "composite_bwd": ("ggrt_official_torch/csrc/composite_bwd.cu",
                          "ggrt_official_tpu/ops/rasterizer/pallas_composite.py:172"),
        "segment_sum": ("ggrt_official_torch/csrc/segment_sum.cu",
                        "ggrt_official_tpu/ops/rasterizer/segment_sum.py:51"),
        "banked_gather": ("ggrt_official_torch/csrc/banked_gather.cu",
                          "ggrt_official_tpu/ops/rasterizer/banked_gather.py:52"),
    }
    table = []
    # One row per kernel; the banked gather's at bench.py's headline scale.
    for row in rows:
        name, ms, plain_ms, library_ms, bound_ms, bound_by = row
        if name == "banked_gather 640x960":
            continue
        name = name.split()[0]
        i = [k.source.stem for k in kernels].index(name)
        n = sum(launches[path][i] for path in launches)
        table.append({
            "name": name, "route": "cuda", "source": sources[name][0], "replaces": sources[name][1],
            "launches": n, "max_abs_err": err[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms,
        })
    # The probe's rows: launches from phase 16's counted run.
    for (name, row), n, line in zip(pc.items(), probe_launches, (13, 17, 21)):
        table.append({
            "name": f"probe_{name}", "route": "cuda", "source": "ggrt_official_torch/csrc/precision_probe.cu",
            "replaces": f"tools/diag_exp_precision.py:{line}", "launches": n, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "plain_ms": row["plain_ms"], "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "floor_ms": row["floor_ms"],
        })
    c = conv7["refine1"]
    table.append({
        "name": "conv7_nhwc", "route": "cuda", "source": "ggrt_official_torch/csrc/conv7_nhwc.cu",
        "replaces": "none (XLA's convolutions)", "launches": conv7_paths["serve"], "max_abs_err": c["max_abs_err"],
        "ms": c["ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
        "library_ms": c["library_ms"], "library_nchw_ms": c["library_nchw_ms"],
        "by_shape": {k: {f: v[f] for f in ("ms", "bound_ms", "plain_ms", "library_ms", "library_nchw_ms")}
                     for k, v in conv7.items()},
    })
    # cuDNN's generic engine, the plain version's at these shapes, sums in
    # the kernel's order: any difference is a fault.
    if not all(v["deterministic"] and v["bit_equal_plain"] for v in conv7.values()):
        fail(f"conv7: two calls differ or the kernel is off the plain version's bits: {conv7}")
    if conv7_paths["serve"] != 3 * (2 + cfg.encoder.epipolar_transformer.num_layers):
        fail(f"conv7: {conv7_paths['serve']} launches over the 3 requests")
    # Every path that encodes runs its 7x7 convolutions through the kernel.
    print(f"timing: conv7 launches by path {conv7_paths} {tag}")
    if not all(conv7_paths.values()):
        fail(f"conv7: a path that encodes did not launch the kernel: {conv7_paths}")
    if not (launches["serve"][0] and all(launches["train"][:3]) and all(launches["raster"])
            and launches["eval"][0] and all(launches["loop"][:3]) and all(launches["finetune"][:3])
            and all(launches["cache"][:3]) and all(launches["flagship"][:3])
            and all(launches["llff"][:3]) and launches["video"][0] and launches["crop"][0]
            and all(probe_launches) and launches["bench"][0] and launches["dump"][0]
            and launches["convert"][0] and all(launches["dp"][:3]) and all(launches["tp"][:3])
            and all(launches["bench_line"])):
        fail(f"a kernel of a path was not launched: {launches}, probe {probe_launches}")
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
