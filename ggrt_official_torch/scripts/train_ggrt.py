"""Generalizable GGRt pretraining CLI (the reference's
train_ggrt_stable.py; the JAX package's scripts/train_ggrt.py).

Usage:
  python -m ggrt_official_torch.scripts.train_ggrt --synthetic --n_iters 50 --out out/smoke
  python -m ggrt_official_torch.scripts.train_ggrt --synthetic --tiny --n_iters 2 --device cpu

Only the procedural scenes (--synthetic) are ported; the LLFF readers are
ROADMAP Queue 6.
"""
from __future__ import annotations

import argparse
import itertools

from ..config import apply_overrides, pretrain_config, tiny_config
from ..data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ..training.loop import train_loop
from ..training.trainer import GGRtTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scenes", nargs="*", default=[])
    ap.add_argument("--n_iters", type=int, default=None)
    ap.add_argument("--out", default="out/pretrain")
    ap.add_argument("--num_source_views", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true", help="procedural scene (smoke test)")
    ap.add_argument("--synthetic_scenes", type=int, default=1,
                    help="number of procedural scenes (different seeds) to mix")
    ap.add_argument("--tiny", action="store_true", help="tiny model config (smoke test)")
    ap.add_argument("--machine", default=None,
                    help="state machine: joint | nerf_only | pose_only (joint's exp-decay "
                         "crushes the gaussian loss early: stage nerf_only -> pose_only for short runs)")
    ap.add_argument("--override", nargs="*", default=[], help="cfg overrides key=value")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = tiny_config() if args.tiny else pretrain_config()
    if args.n_iters:
        cfg.train.n_iters = args.n_iters
    if args.num_source_views:
        cfg.train.num_source_views = args.num_source_views
    if args.rootdir:
        cfg.train.rootdir = args.rootdir
    if args.machine:
        cfg.train.machine = args.machine
    apply_overrides(cfg, dict(kv.split("=", 1) for kv in args.override))

    if not args.synthetic:
        raise NotImplementedError("only --synthetic scenes are ported; the LLFF readers are ROADMAP Queue 6")
    scenes = [
        SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96), seed=s),
                               num_source_views=min(cfg.train.num_source_views, 4))
        for s in range(args.synthetic_scenes)
    ]

    def batches():
        for i in itertools.count():
            d = scenes[i % len(scenes)]
            yield collate_batch(d[(i // len(scenes)) % len(d)])

    train_loop(GGRtTrainer(cfg, device=args.device), batches(), args.out)


if __name__ == "__main__":
    main()
