"""DBARF / IBRNet-path evaluation (the JAX package's scripts/eval_dbarf.py;
the reference's eval/eval_dbarf.py): volume rendering of each test view
with the coarse IBRNet at inverse-depth-uniform, deterministic samples,
PSNR and SSIM per view, written to <out>/results.json as {"summary",
"per_view"}.

Usage:
  python -m ggrt_official_torch.scripts.eval_dbarf --rootdir data/ibrnet/train --scenes fern
  python -m ggrt_official_torch.scripts.eval_dbarf --synthetic --limit 1 --device cpu

As in the JAX script the model carries seeded random weights (there is no
checkpoint argument). `render_view` renders one collated example and is
what chip_smoke.py and the tests call.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from ..config import pretrain_config
from ..data.datasets import LLFFTestDataset, SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ..evaluation import metrics
from ..models.dbarf import IBRNetModel
from ..rendering import rays as rays_mod
from ..rendering import volume


def build_model(cfg, n_samples: int, device) -> IBRNetModel:
    """The JAX script's model: coarse only, 64 feature channels, seed 0."""
    return IBRNetModel(cfg, coarse_feat_dim=64, coarse_only=True, n_samples=n_samples, device=device,
                       generator=torch.Generator().manual_seed(0)).eval()


def render_view(model: IBRNetModel, ex: dict, n_samples: int, chunk_size: int, render_stride: int, device):
    """One collated example -> (pred, gt), each (3, h', w') on `device` at
    every render_stride-th pixel. The image size comes from the host's copy
    of the camera."""
    dev = torch.device(device)
    h, w = int(ex["camera"][0][0]), int(ex["camera"][0][1])
    src_rgbs = torch.tensor(ex["src_rgbs"][0], device=dev)
    camera = torch.tensor(ex["camera"][0], device=dev)
    feats = model.extract_features(src_rgbs)
    ray_o, ray_d = rays_mod.get_rays_single_image(h, w, camera[2:18].reshape(4, 4)[None],
                                                  camera[18:34].reshape(4, 4)[None], render_stride=render_stride)
    ray_batch = {
        "ray_o": ray_o, "ray_d": ray_d,
        "depth_range": torch.tensor(ex["depth_range"][0], device=dev),
        "camera": camera,
        "src_rgbs": src_rgbs,
        "src_cameras": torch.tensor(ex["src_cameras"][0], device=dev),
    }
    rgb, _ = volume.render_image(ray_batch, model.coarse, (feats[0], None), n_samples, chunk_size=chunk_size,
                                 det=True, inv_uniform=True)
    hs, ws = len(range(0, h, render_stride)), len(range(0, w, render_stride))
    pred = rgb.reshape(hs, ws, 3).permute(2, 0, 1)
    gt = torch.tensor(ex["rgb"][0][::render_stride, ::render_stride], device=dev).permute(2, 0, 1)
    return pred, gt


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scenes", nargs="*", default=["fern"])
    ap.add_argument("--out", default="out/eval_dbarf")
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--n_samples", type=int, default=64)
    ap.add_argument("--chunk_size", type=int, default=2048)
    ap.add_argument("--render_stride", type=int, default=2)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = pretrain_config()
    if args.synthetic:
        ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)),
                                    mode="test", num_source_views=4)
    else:
        ds = LLFFTestDataset(args.rootdir, "test", scenes=tuple(args.scenes),
                             num_source_views=cfg.train.num_source_views)

    model = build_model(cfg, args.n_samples, args.device)
    rows = []
    n = len(ds) if args.limit is None else min(args.limit, len(ds))
    with torch.inference_mode():
        for i in range(n):
            pred, gt = render_view(model, collate_batch(ds[i]), args.n_samples, args.chunk_size,
                                   args.render_stride, args.device)
            rows.append({"psnr": float(metrics.psnr(pred, gt)), "ssim": float(metrics.ssim(pred, gt))})
            print(f"view {i}: psnr={rows[-1]['psnr']:.2f}", flush=True)

    summary = {k: float(np.mean([r[k] for r in rows])) for k in rows[0]}
    Path(args.out).mkdir(parents=True, exist_ok=True)
    with open(Path(args.out) / "results.json", "w") as f:
        json.dump({"summary": summary, "per_view": rows}, f, indent=2)
    print(json.dumps(summary, indent=2))
    return {"summary": summary, "per_view": rows}


if __name__ == "__main__":
    main()
