"""GGRt evaluation CLI (the reference's eval/eval_ggrt.py; the JAX
package's scripts/eval_ggrt.py): per-view pose correction, Gaussian
rendering, PSNR/SSIM and pose R/t errors, written to <out>/results.json.

Usage:
  python -m ggrt_official_torch.scripts.eval_ggrt --synthetic --ckpt out/smoke/checkpoints/latest
  python -m ggrt_official_torch.scripts.eval_ggrt --synthetic --tiny --limit 1 --device cpu

Only the procedural scenes (--synthetic) are ported; the LLFF readers are
ROADMAP Queue 6.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..config import pretrain_config, tiny_config
from ..data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec
from ..evaluation.harness import Evaluator
from ..training.checkpoint import CheckPointManager
from ..training.loop import restore_state
from ..training.trainer import GGRtTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scenes", nargs="*", default=["fern"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="out/eval")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--synthetic_seed", type=int, default=0,
                    help="procedural scene seed (pick one outside the training mix for a "
                         "held-out-scene eval)")
    ap.add_argument("--gt_pose", action="store_true",
                    help="render with dataset extrinsics instead of IPO-Net poses (isolates "
                         "G-3DGS quality from pose quality)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_config() if args.tiny else pretrain_config()
    cfg.train.rootdir = args.rootdir
    if not args.synthetic:
        raise NotImplementedError("only --synthetic scenes are ported; the LLFF readers are ROADMAP Queue 6")
    ds = SyntheticPlanesDataset(
        SyntheticSceneSpec(n_views=12, image_size=(64, 96), seed=args.synthetic_seed),
        mode="test", num_source_views=4,
    )

    trainer = GGRtTrainer(cfg, device=args.device)
    trainer.init_full()
    if args.ckpt:
        payload = CheckPointManager(str(Path(args.ckpt).parent)).load(args.ckpt)
        if payload is not None:
            restore_state(trainer, payload["state"], model_only=True)
            print(f"loaded checkpoint at step {payload['step']}")

    evaluator = Evaluator(cfg, trainer.model, device=args.device)
    summary = evaluator.evaluate_dataset(ds, out_dir=args.out, limit=args.limit,
                                         use_pred_pose=not args.gt_pose)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
