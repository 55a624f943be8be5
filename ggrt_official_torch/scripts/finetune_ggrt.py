"""Per-scene finetune with deferred back-propagation CLI (the reference's
finetune_ggrt_stable.py; the JAX package's scripts/finetune_ggrt.py).

Usage:
  python -m ggrt_official_torch.scripts.finetune_ggrt --synthetic --ckpt out/pretrain/checkpoints/latest
  python -m ggrt_official_torch.scripts.finetune_ggrt --synthetic --tiny --n_iters 2 --device cpu

`--ckpt` resumes from a checkpoint of train_ggrt (weights, optimizers and
step, as the JAX package's loop does). Only the procedural scenes
(--synthetic) are ported; the LLFF readers are ROADMAP Queue 6.
"""
from __future__ import annotations

import argparse
import itertools

from ..config import finetune_config, tiny_config
from ..data.datasets import SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ..training.loop import train_loop
from ..training.trainer import GGRtFinetuneTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scene", default="room")
    ap.add_argument("--n_iters", type=int, default=None)
    ap.add_argument("--out", default="out/finetune")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny model widths (smoke test)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = finetune_config()
    if args.tiny:
        tiny = tiny_config()
        tiny.train = cfg.train
        cfg = tiny
    if args.n_iters:
        cfg.train.n_iters = args.n_iters
    cfg.train.ckpt_path = args.ckpt
    cfg.train.rootdir = args.rootdir

    if not args.synthetic:
        raise NotImplementedError("only --synthetic scenes are ported; the LLFF readers are ROADMAP Queue 6")
    ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)), num_source_views=4)

    def batches():
        for i in itertools.count():
            yield collate_batch(ds[i % len(ds)])

    train_loop(GGRtFinetuneTrainer(cfg, device=args.device), batches(), args.out)


if __name__ == "__main__":
    main()
