"""Crop-tiled evaluation of large images (the reference's eval_crop.py,
concat.py and compare.py; the JAX package's scripts/eval_crop.py).

Every test view is rendered crop by crop through principal-point-shifted
intrinsics (evaluation/crop_eval.py), the crops are stitched, and the
stitched view's PSNR against GT is reported per view and as a mean, in
<out>/results.json, with each stitched view as <out>/stitched_NNN.npy.

Usage:
  python -m ggrt_official_torch.scripts.eval_crop --rootdir data/ibrnet/train --scenes fern \
      --ckpt out/pretrain/checkpoints/latest
  python -m ggrt_official_torch.scripts.eval_crop --synthetic --tiny --limit 1 --device cpu

A crop's height and width must be multiples of the epipolar transformer's
downscale times its self-attention patch size (16 at pretrain_config()
widths, 8 at --tiny's); a crop that is not is refused, not padded.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np

from ..config import pretrain_config, tiny_config
from ..data.datasets import LLFFTestDataset, SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ..evaluation import crop_eval
from ..evaluation.harness import Evaluator
from ..training.checkpoint import CheckPointManager
from ..training.loop import restore_state
from ..training.trainer import GGRtTrainer


def check_crop(cfg, crop_h: int, crop_w: int) -> None:
    """Raise unless the encoder can take a crop of crop_h x crop_w."""
    et = cfg.encoder.epipolar_transformer
    unit = (et.downscale or 1) * et.self_attention.patch_size
    if crop_h % unit or crop_w % unit:
        raise ValueError(f"crop {crop_h}x{crop_w}: height and width must be multiples of {unit} "
                         f"(the epipolar transformer's downscale x its patch size)")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scenes", nargs="*", default=["fern"])
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="out/eval_crop")
    ap.add_argument("--crop-h", type=int, default=160)
    ap.add_argument("--crop-w", type=int, default=224)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.tiny:
        cfg = tiny_config()
        args.crop_h, args.crop_w = 16, 32
    else:
        cfg = pretrain_config()
    cfg.train.rootdir = args.rootdir
    check_crop(cfg, args.crop_h, args.crop_w)

    if args.synthetic:
        ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)),
                                    mode="test", num_source_views=4)
    else:
        ds = LLFFTestDataset(cfg.train.rootdir, "test", scenes=tuple(args.scenes),
                             num_source_views=cfg.train.num_source_views, llffhold=cfg.train.llffhold)

    trainer = GGRtTrainer(cfg, device=args.device)
    trainer.init_full()
    if args.ckpt:
        payload = CheckPointManager(str(Path(args.ckpt).parent)).load(args.ckpt)
        if payload is not None:
            restore_state(trainer, payload["state"])

    evaluator = Evaluator(cfg, trainer.model, device=args.device)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    def render_fn(cropped_batch):
        ret, _ = evaluator._render(cropped_batch)
        return ret["rgb"][0, 0]

    results = []
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    for i in range(n):
        batch = evaluator._prepare_batch(collate_batch(ds[i]))
        stitched, psnr = crop_eval.eval_crop_view(render_fn, batch, args.crop_h, args.crop_w)
        results.append({"view": i, "psnr_stitched": psnr})
        np.save(out_dir / f"stitched_{i:03d}.npy", stitched)
        print(f"view {i}: stitched PSNR {psnr:.2f}")

    summary = {
        "n_views": len(results),
        "psnr_mean": float(np.mean([r["psnr_stitched"] for r in results])),
        "crop": [args.crop_h, args.crop_w],
        "views": results,
    }
    (out_dir / "results.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps({k: v for k, v in summary.items() if k != "views"}))
    return summary


if __name__ == "__main__":
    main()
