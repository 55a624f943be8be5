"""Flagship proof run (the JAX package's tools/run_flagship.py): a staged
synthetic pretrain, self-supervised pose targets, self-distillation, six
held-out eval arms, the acceptance bar, the overfit ceiling and the
Gaussian-cache A/B, on one device.

  stage 1  nerf_only        - the Gaussian model on the dataset's poses.
  stage 2a pose_only warm   - depth distillation only (sfm_weight 0, a
                              weak identity anchor): IPO-Net's depth head
                              learns from the frozen teacher render.
  targets  per training view, the evaluator's dual-start warp refinement
           (Adam on the raw 6-vector poses) with the teacher render's
           inverse depth; no ground-truth poses.
  stage 2b pose_only selfdistill - IPO-Net regresses the targets
           (iteration-weighted MSE) with the depth distillation.

Eval: held-out views of training scene 0 and the held-out scene 17, each
with the predicted poses, the predicted poses refined at test time (400
Adam steps per start), and the dataset's poses, beside each scene's
identity-pose baseline. The bar: the predicted arm's PSNR within 2 dB of
the dataset-pose arm and its unaligned R error under half the identity
baseline's (`refined_pass` for the refined arm).

Every stage resumes from its own checkpoints under --out, so running the
same command again skips the finished stages. The result goes to
<out>/EVAL_FLAGSHIP.json (non-finite floats as null), and to --artifact
where one is given; its keys are the JAX package's, with `args.device` in
place of `args.platform`.

Usage:
  python -m ggrt_official_torch.scripts.run_flagship [--nerf 1600] [--pose 900] [--out out/flagship]
  python -m ggrt_official_torch.scripts.run_flagship --device cpu --image 32 48 --scenes 1 ...
"""
from __future__ import annotations

import argparse
import copy
import dataclasses
import itertools
import json
import time
from pathlib import Path

import numpy as np
import torch

from ..config import GGRtConfig, tiny_config
from ..data.datasets import SyntheticPlanesDataset, collate_batch, flagship_scene_spec
from ..evaluation.harness import Evaluator, _no_nan as sanitize
from ..geometry.alignment import evaluate_camera_alignment
from ..geometry.se3 import relative_to_source_c2w
from ..training.loop import checkpoint_state, restore_state, train_loop
from ..training.trainer import GGRtTrainer
from ..training.trainer_cached import CachedGGRtTrainer

# The arguments whose defaults make a run the default flagship.
DEFAULT_KEYS = ("nerf", "pose", "pose_warm", "scenes", "distill", "image", "eval_limit", "lrate_pose",
                "pred_pose", "render_grad", "sfm_weight", "pose_anchor", "selfdistill",
                "selfdistill_steps", "selfdistill_rounds", "ceiling", "device")
ARM_REFINE_STEPS = 400


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nerf", type=int, default=1600)
    ap.add_argument("--pose", type=int, default=900,
                    help="total pose_only steps (warm distill + selfdistill)")
    ap.add_argument("--pose_warm", type=int, default=300,
                    help="distill-only steps before pose-target generation")
    ap.add_argument("--scenes", type=int, default=4)
    ap.add_argument("--distill", type=float, default=1.0)
    ap.add_argument("--lrate_pose", type=float, default=2e-4)
    ap.add_argument("--pred_pose", type=int, default=0)
    ap.add_argument("--render_grad", type=int, default=0)
    ap.add_argument("--sfm_weight", type=float, default=0.0)
    ap.add_argument("--pose_anchor", type=float, default=0.01)
    ap.add_argument("--selfdistill", type=float, default=10.0)
    ap.add_argument("--selfdistill_steps", type=int, default=400,
                    help="warp-descent steps per training view when generating pose targets")
    ap.add_argument("--selfdistill_rounds", type=int, default=1,
                    help="rounds of target generation and selfdistill training; the pose budget "
                         "after warm-up is split across rounds")
    ap.add_argument("--image", type=int, nargs=2, default=(128, 192))
    ap.add_argument("--ceiling", type=int, default=1500,
                    help="overfit-ceiling arm: train a fresh Gaussian model this many steps on "
                         "scene 0 only and report its dataset-pose held-out-view PSNR (0 = skip)")
    ap.add_argument("--out", default="out/flagship_r05")
    ap.add_argument("--eval_limit", type=int, default=None)
    ap.add_argument("--cache_ab", type=int, default=25,
                    help="steps for the Gaussian-cache on/off timing (0 = skip)")
    ap.add_argument("--artifact", default=None, help="also write the result here")
    ap.add_argument("--device", default="cuda")
    return ap


def flagship_config(args) -> GGRtConfig:
    """tiny_config() with the flagship's training settings."""
    cfg = tiny_config()
    tc = cfg.train
    tc.use_pred_pose = bool(args.pred_pose)
    tc.pose_render_grad = bool(args.render_grad)
    tc.sfm_valid_mask = True
    tc.sfm_oob_weight = 0.1
    tc.sfm_weight = args.sfm_weight
    tc.pose_anchor_weight = args.pose_anchor
    tc.pose_selfdistill_weight = args.selfdistill
    tc.pose_depth_distill = args.distill
    tc.lrate_pose = args.lrate_pose
    tc.n_tensorboard = 100
    tc.n_checkpoint = 1000
    tc.n_iters = args.nerf + args.pose
    return cfg


def scene_spec(args, seed: int):
    return flagship_scene_spec(seed=seed, image_size=tuple(args.image))


def train_datasets(args) -> list:
    return [SyntheticPlanesDataset(scene_spec(args, s), num_source_views=4) for s in range(args.scenes)]


def batches(train_ds: list, targets: dict):
    """Scenes in turn, then views; a view's pose target ((nv, 6), keyed
    (scene, view)) rides along once generated."""
    for i in itertools.count():
        si = i % len(train_ds)
        vi = (i // len(train_ds)) % len(train_ds[si])
        b = collate_batch(train_ds[si][vi])
        t = targets.get((si, vi))
        if t is not None:
            b["pose_target"] = t[None]
        yield b


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_stage(trainer, data, out_dir: str, n_iters: int, machine: str) -> dict:
    """train_loop for one stage with resume; returns the steps it took (a
    finished stage takes none) and its seconds."""
    pulled = 0

    def counted():
        nonlocal pulled
        for b in data:
            pulled += 1
            yield b

    t0 = time.perf_counter()
    train_loop(trainer, counted(), out_dir, n_iters=n_iters, machine_schedule=lambda s: machine, resume=True)
    _sync(trainer.device)
    # train_loop draws one batch before its first step and one after each.
    return {"steps": pulled - 1, "s": time.perf_counter() - t0}


def _target_pose(b: dict) -> np.ndarray:
    cam = b["camera"][-16:] if b["camera"].ndim == 1 else b["camera"][0, -16:]
    return np.asarray(cam).reshape(4, 4)


def _alignment(pred: np.ndarray, gt: np.ndarray) -> dict:
    return {k: float(v) for k, v in evaluate_camera_alignment(
        torch.tensor(pred, dtype=torch.float32), torch.tensor(gt, dtype=torch.float32)).items()}


def generate_targets(evaluator: Evaluator, train_ds: list, targets: dict, stats: dict, steps: int) -> None:
    """Pose targets for every training view: the evaluator's dual-start
    refinement with the teacher render's inverse depth (1, 1, h, w),
    `steps` Adam steps per start. Fills `targets` and adds this round to
    `stats` (per-view R error of the targets against the dataset's poses,
    a diagnostic that never trains)."""
    tg0 = time.perf_counter()
    errs = []
    for si, d in enumerate(train_ds):
        for vi in range(len(d)):
            braw = collate_batch(d[vi])
            batch = evaluator._prepare_batch(braw)
            ret, _ = evaluator._render(batch)
            inv = None
            if ret["depth"] is not None:
                lo, hi = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
                inv = (1.0 / torch.clamp(ret["depth"][0, 0], lo, hi))[None, None]
            vec = evaluator.pose_targets(braw, steps=steps, inv_depth=inv)
            targets[(si, vi)] = vec
            gt = np.asarray(braw["context"]["extrinsics"][0])
            tp = torch.as_tensor(_target_pose(braw), dtype=torch.float32)
            pred = relative_to_source_c2w(tp.expand(gt.shape[0], 4, 4), torch.as_tensor(vec))
            errs.append(round(_alignment(pred.numpy(), gt)["R_error_mean"], 3))
    stats["per_view_R_err"] = errs
    stats["seconds"] += round(time.perf_counter() - tg0, 1)
    stats["R_err_mean"] = round(float(np.mean(errs)), 4)
    stats["rounds"].append(stats["R_err_mean"])
    print("pose_targets", json.dumps({k: v for k, v in stats.items() if k != "per_view_R_err"}), flush=True)


def train_stages(args, trainer, evaluator: Evaluator, train_ds: list, targets: dict,
                 stats: dict) -> dict:
    """Stage 1, stage 2a, then each round's targets and selfdistill stage.
    Returns each stage's steps and seconds."""
    timings = {"stage_nerf": run_stage(trainer, batches(train_ds, targets), f"{args.out}/stage_nerf",
                                       args.nerf, "nerf_only")}
    pose_warm = min(args.pose_warm, args.pose)
    if pose_warm > 0:
        timings["stage_distill"] = run_stage(trainer, batches(train_ds, targets),
                                             f"{args.out}/stage_distill", pose_warm, "pose_only")
    if args.pose > pose_warm:
        rounds = max(args.selfdistill_rounds, 1)
        budget = args.pose - pose_warm
        per_round = budget // rounds
        for r in range(rounds):
            if args.selfdistill > 0:
                generate_targets(evaluator, train_ds, targets, stats, args.selfdistill_steps)
            n_r = per_round if r < rounds - 1 else budget - per_round * (rounds - 1)
            name = f"stage_selfdistill{r if r else ''}"
            timings[name] = run_stage(trainer, batches(train_ds, targets), f"{args.out}/{name}", n_r,
                                      "pose_only")
    return timings


def identity_baseline(ds) -> dict:
    """Unaligned R/t errors of the target pose broadcast as every source
    pose: the bar any trained pose branch must beat."""
    rs, ts = [], []
    for i in range(len(ds)):
        b = collate_batch(ds[i])
        gt = np.asarray(b["context"]["extrinsics"][0])
        err = _alignment(np.broadcast_to(_target_pose(b), gt.shape), gt)
        rs.append(err["R_error_mean"])
        ts.append(err["t_error_mean"])
    return {"R_error_mean_unaligned": round(float(np.mean(rs)), 4),
            "t_error_mean_unaligned": round(float(np.mean(ts)), 4)}


def arm_specs(args, refine_steps: int = ARM_REFINE_STEPS) -> dict:
    """name -> (scene spec, use_pred_pose, refine_steps)."""
    return {
        "heldout_views_pred_pose": (scene_spec(args, 0), True, 0),
        "heldout_views_pred_refined": (scene_spec(args, 0), True, refine_steps),
        "heldout_views_gt_pose": (scene_spec(args, 0), False, 0),
        "heldout_scene_pred_pose": (scene_spec(args, 17), True, 0),
        "heldout_scene_pred_refined": (scene_spec(args, 17), True, refine_steps),
        "heldout_scene_gt_pose": (scene_spec(args, 17), False, 0),
    }


def key_paths(obj, prefix: str = "") -> set:
    """Every key path of a nested dict, as "/key/key"."""
    out = set()
    if isinstance(obj, dict):
        for k, v in obj.items():
            out |= {f"{prefix}/{k}"} | key_paths(v, f"{prefix}/{k}")
    return out


def schema_differences(result: dict, reference: dict) -> set:
    """The key paths in which `result` differs from `reference`, an
    artifact of tools/run_flagship.py: `args.device` stands for
    `args.platform`, and only a resumed run carries the cache A/B over."""
    want = {"/args/device" if k == "/args/platform" else k for k in key_paths(reference)}
    return (want ^ key_paths(result)) - {"/cache_ab/carried_from_previous_run"}


def dump(path, payload) -> None:
    with open(path, "w") as f:
        json.dump(sanitize(payload), f, indent=2)


def run_arms(args, evaluator: Evaluator, result: dict, out_path, refine_steps: int = ARM_REFINE_STEPS) -> dict:
    """Each arm's summary (or its error) and each scene's identity baseline
    into `result`, dumped after every arm. Returns each arm's seconds."""
    baselines, seconds = {}, {}
    for name, (sp, pred, refine) in arm_specs(args, refine_steps).items():
        t0 = time.perf_counter()
        ds = SyntheticPlanesDataset(sp, mode="test", num_source_views=4)
        key = "scene17" if sp.seed == 17 else "scene0"
        if key not in baselines:
            baselines[key] = identity_baseline(ds)
        result[f"identity_pose_baseline_{key}"] = baselines[key]
        try:
            summary = evaluator.evaluate_dataset(ds, out_dir=f"{args.out}/eval_{name}", limit=args.eval_limit,
                                                 use_pred_pose=pred, refine_steps=refine)
            summary = {k: (round(float(v), 4) if isinstance(v, float) else v) for k, v in summary.items()
                       if isinstance(v, (int, float)) or k.startswith("lpips")}
            if not pred:
                # The renderer never sees these poses in a dataset-pose arm.
                summary["pose_metrics_refer_to"] = "iponet prediction (unused for rendering in this arm)"
            result[name] = summary
        except Exception as e:  # noqa: BLE001 — keep the other arms' results
            result[name] = {"error": str(e)[-300:]}
        seconds[name] = time.perf_counter() - t0
        print(name, json.dumps(sanitize(result[name])), flush=True)
        dump(out_path, result)
    return seconds


def bar(result: dict) -> dict:
    """The acceptance bar from the arms, or why it cannot be computed."""
    try:
        pv = result["heldout_views_pred_pose"]
        gv = result["heldout_views_gt_pose"]
        ident = result["identity_pose_baseline_scene0"]["R_error_mean_unaligned"]
        refined = result.get("heldout_views_pred_refined", {})
        gap = gv["psnr"] - pv["psnr"]
        ratio = pv["R_error_mean_unaligned"] / max(ident, 1e-9)
        return {
            "psnr_gap_db": round(gap, 3),
            "psnr_ok": bool(gap <= 2.0),
            "r_err_ratio_vs_identity": round(ratio, 3),
            "r_ok": bool(ratio < 0.5),
            "refined_r_err_ratio": round(refined.get("R_error_mean_unaligned", float("nan")) / max(ident, 1e-9), 3),
            "pass": bool(gap <= 2.0 and ratio < 0.5),
            "refined_pass": bool(gap <= 2.0 and refined.get("R_error_mean_unaligned", float("inf")) < 0.5 * ident),
        }
    except (KeyError, TypeError) as e:
        return {"error": f"bar not computable: {e}"}


def ceiling(args, cfg: GGRtConfig, train_ds: list, result: dict) -> dict:
    """A fresh Gaussian model trained `args.ceiling` steps on scene 0 only,
    evaluated with the dataset's poses on its held-out views. Returns the
    stage's steps and seconds and the eval's seconds."""
    ceil_trainer = GGRtTrainer(cfg, device=args.device)

    def ceil_batches():
        for i in itertools.count():
            yield collate_batch(train_ds[0][i % len(train_ds[0])])

    timing = run_stage(ceil_trainer, ceil_batches(), f"{args.out}/stage_ceiling", args.ceiling, "nerf_only")
    t0 = time.perf_counter()
    ceil_eval = Evaluator(cfg, ceil_trainer.model, device=args.device)
    try:
        summary = ceil_eval.evaluate_dataset(
            SyntheticPlanesDataset(scene_spec(args, 0), mode="test", num_source_views=4),
            out_dir=f"{args.out}/eval_ceiling", limit=args.eval_limit, use_pred_pose=False, refine_steps=0)
        result["overfit_ceiling_scene0"] = {
            "steps": args.ceiling,
            "psnr": round(float(summary["psnr"]), 4),
            "ssim": round(float(summary["ssim"]), 4),
            "gt_arm_gap_db": round(float(summary["psnr"])
                                   - result["heldout_views_gt_pose"].get("psnr", float("nan")), 3),
        }
    except Exception as e:  # noqa: BLE001
        result["overfit_ceiling_scene0"] = {"error": str(e)[-300:]}
    print("overfit_ceiling_scene0", json.dumps(sanitize(result["overfit_ceiling_scene0"])), flush=True)
    return {**timing, "eval_s": time.perf_counter() - t0}


def cache_ab(args, cfg: GGRtConfig, trainer, train_ds: list) -> dict:
    """Steady-state ms per 'nerf_only' step without and with the Gaussian
    cache over the first `args.cache_ab` views of scene 0, each trainer
    starting from a copy of `trainer`'s state (weights, both Adam states,
    step, generator): one warm-up pass, then a timed pass."""
    seq = [collate_batch(train_ds[0][i % len(train_ds[0])]) for i in range(args.cache_ab)]
    start = copy.deepcopy(checkpoint_state(trainer))

    def timed_steps(tr):
        tr.init_full()
        restore_state(tr, copy.deepcopy(start))
        for b in seq:
            tr.train_iteration(b, machine="nerf_only")
        if hasattr(tr, "hits"):
            tr.hits = tr.misses = 0
        _sync(args.device)
        t0 = time.perf_counter()
        for b in seq:
            tr.train_iteration(b, machine="nerf_only")
        _sync(args.device)
        dt = (time.perf_counter() - t0) / len(seq) * 1e3
        extra = {"hits": tr.hits, "misses": tr.misses} if hasattr(tr, "hits") else {}
        return {"step_ms": round(dt, 2), **extra}

    return {"off": timed_steps(GGRtTrainer(cfg, device=args.device)),
            "on": timed_steps(CachedGGRtTrainer(cfg, device=args.device))}


def run(args, refine_steps: int = ARM_REFINE_STEPS):
    """The flagship with parsed `args`, the refined arms at `refine_steps`
    Adam steps per start; returns (result, timings): the artifact's dict
    and the seconds of each stage, the pose targets, each arm, the ceiling
    and the cache A/B, which the artifact does not hold."""
    ap = build_parser()
    defaults = all(getattr(args, k) == ap.get_default(k) for k in DEFAULT_KEYS)
    cfg = flagship_config(args)
    train_ds = train_datasets(args)
    targets: dict = {}
    stats = {"per_view_R_err": [], "seconds": 0.0, "rounds": []}

    trainer = GGRtTrainer(cfg, device=args.device)
    trainer.init_full()
    # The evaluator shares the trainer's live model: tools/run_flagship.py hands
    # it the trainer's params wherever it reads them.
    evaluator = Evaluator(cfg, trainer.model, device=args.device)
    t0 = time.perf_counter()
    timings = {"stages": train_stages(args, trainer, evaluator, train_ds, targets, stats)}
    train_s = time.perf_counter() - t0
    pose_warm = min(args.pose_warm, args.pose)
    result = {
        "train_steps": args.nerf + args.pose,
        "train_s": round(train_s, 1),
        "recipe": f"nerf_only {args.nerf} -> pose_only distill {pose_warm} "
                  f"-> pose targets (warp descent {args.selfdistill_steps} "
                  f"steps, teacher depth) -> selfdistill "
                  f"{args.pose - pose_warm} on {args.scenes} scenes",
        "args": vars(args),
        "scene_spec": dataclasses.asdict(scene_spec(args, 0)),
        "is_default_flagship": defaults,
        "pose_target_stats": stats,
    }
    timings["pose_targets_s"] = stats["seconds"]

    out_path = Path(args.out) / "EVAL_FLAGSHIP.json"
    # The previous run's result in this --out, read before this run's first
    # dump overwrites it: a resumed run carries its cache A/B over.
    prev_run = {}
    if out_path.exists():
        try:
            with open(out_path) as f:
                prev_run = json.load(f)
        except (OSError, ValueError):
            prev_run = {}
    out_path.parent.mkdir(parents=True, exist_ok=True)

    timings["arms_s"] = run_arms(args, evaluator, result, out_path, refine_steps)
    result["bar"] = bar(result)
    print("bar", json.dumps(result["bar"]), flush=True)
    # The bar is on record before the long ceiling and cache stages.
    dump(out_path, result)
    if args.artifact:
        dump(args.artifact, result)

    if args.ceiling > 0:
        timings["ceiling"] = ceiling(args, cfg, train_ds, result)

    prev_cache_ab = None
    if args.cache_ab > 0 and prev_run.get("args", {}).get("cache_ab") == args.cache_ab:
        prev_cache_ab = prev_run.get("cache_ab")
    if prev_cache_ab is not None and "error" not in prev_cache_ab:
        result["cache_ab"] = dict(prev_cache_ab, carried_from_previous_run=True)
        print("cache_ab (carried over)", json.dumps(result["cache_ab"]), flush=True)
    elif args.cache_ab > 0:
        t0 = time.perf_counter()
        result["cache_ab"] = cache_ab(args, cfg, trainer, train_ds)
        timings["cache_ab_s"] = time.perf_counter() - t0
        print("cache_ab", json.dumps(result["cache_ab"]), flush=True)

    dump(out_path, result)
    if args.artifact:
        dump(args.artifact, result)
        print(f"artifact written: {args.artifact}", flush=True)
    print("timings", json.dumps(timings), flush=True)
    print(json.dumps(sanitize(result), indent=2))
    return result, timings


def main(argv=None):
    return run(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
