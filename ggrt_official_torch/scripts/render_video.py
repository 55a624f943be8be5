"""Novel-view video rendering (the reference's eval/render_llff_video.py;
the JAX package's scripts/render_video.py): encode the context views once,
then decode each frame of a camera trajectory through the context window.

Usage:
  python -m ggrt_official_torch.scripts.render_video --rootdir data/ibrnet/train --scene fern \
      --ckpt out/pretrain/checkpoints/latest
  python -m ggrt_official_torch.scripts.render_video --synthetic --n_frames 4 --device cpu

The frames are written as numbered PNGs (0000.png, ...) into the directory
that --out names with its suffix dropped (out/video for the default
out/video.mp4): no MP4 encoder is needed. Without --synthetic the context
is the first test view's of the LLFF-format scene
<rootdir>/nerf_llff_data/<scene>.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..config import GGRtConfig, pretrain_config
from ..data.datasets import LLFFTestDataset, SyntheticPlanesDataset, SyntheticSceneSpec, collate_batch
from ..models.decoder_splatting import DecoderSplatting
from ..models.gaussian_adapter import Gaussians
from ..training.checkpoint import CheckPointManager
from ..training.loop import restore_state
from ..training.trainer import GGRtTrainer
from ..utils.trajectories import cosine_ease, interpolate_extrinsics, interpolate_intrinsics


def decode_frame(decoder, gaussians: Gaussians, extrinsics: torch.Tensor, intrinsics: torch.Tensor,
                 near: torch.Tensor, far: torch.Tensor, image_shape: tuple[int, int]) -> torch.Tensor:
    """One frame (h, w, 3) uint8 on the Gaussians' device: the decoder's
    colour render at one camera (extrinsics (4, 4), intrinsics (3, 3)),
    clipped to [0, 1] and scaled by 255 with truncation, as the JAX script's
    astype(np.uint8)."""
    out = decoder(gaussians, extrinsics[None, None], intrinsics[None, None], near, far, image_shape)
    return (out.color[0, 0].permute(1, 2, 0).clamp(0, 1) * 255).to(torch.uint8)


def _clock(device: torch.device):
    """A mark on the device's clock: a recorded CUDA event on the card (read
    after the one sync at the end), the host clock on the CPU."""
    if device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter()


def _ms(a, b) -> float:
    return a.elapsed_time(b) if isinstance(a, torch.cuda.Event) else (b - a) * 1e3


@torch.inference_mode()
def render_frames(model, cfg: GGRtConfig, batch: dict, n_frames: int, times: Optional[dict] = None) -> np.ndarray:
    """Encode the prepared batch's context once with `model.gaussian` and
    decode `n_frames` frames with cfg.decoder's splatting decoder along the
    cosine-eased geodesic from the first to the last context camera
    (extrinsics and intrinsics interpolated). Returns (n_frames, h,
    w, 3) uint8. The frames are queued on the device and copied back once,
    so the host waits for the device once for all of them.

    `times`, if given, receives "encode_ms" and "frame_ms" (a list): CUDA
    events on the card, the host clock on the CPU."""
    ctx = batch["context"]
    device = ctx["image"].device
    marks = [_clock(device)]
    gaussians = model.gaussian.encode_pairs(ctx, 0, deterministic=True)
    marks.append(_clock(device))
    t = cosine_ease(n_frames, device=device)
    extr = interpolate_extrinsics(ctx["extrinsics"][0, 0], ctx["extrinsics"][0, -1], t)
    intr = interpolate_intrinsics(ctx["intrinsics"][0, 0], ctx["intrinsics"][0, -1], t)
    h, w = batch["target"]["image"].shape[-2:]
    decoder = DecoderSplatting(cfg.decoder)
    frames = []
    for i in range(n_frames):
        frames.append(decode_frame(decoder, gaussians, extr[i], intr[i],
                                   ctx["near"][:, :1], ctx["far"][:, :1], (h, w)))
        marks.append(_clock(device))
        print(f"frame {i + 1}/{n_frames} queued")
    out = torch.stack(frames).cpu().numpy()
    if times is not None:
        times["encode_ms"] = _ms(marks[0], marks[1])
        times["frame_ms"] = [_ms(a, b) for a, b in zip(marks[1:-1], marks[2:])]
    return out


def write_frames(frames: np.ndarray, out: str) -> Path:
    """The uint8 frames as <out without its suffix>/0000.png, ..."""
    from PIL import Image

    folder = Path(out).with_suffix("")
    folder.mkdir(parents=True, exist_ok=True)
    for i, frame in enumerate(frames):
        Image.fromarray(frame).save(folder / f"{i:04d}.png")
    return folder


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rootdir", default="data/ibrnet/train")
    ap.add_argument("--scene", default="fern")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--out", default="out/video.mp4")
    ap.add_argument("--n_frames", type=int, default=60)
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = pretrain_config()
    if args.synthetic:
        ds = SyntheticPlanesDataset(SyntheticSceneSpec(n_views=12, image_size=(64, 96)), num_source_views=4)
    else:
        ds = LLFFTestDataset(args.rootdir, "test", scenes=(args.scene,),
                             num_source_views=cfg.train.num_source_views)

    trainer = GGRtTrainer(cfg, device=args.device)
    trainer.init_full()
    if args.ckpt:
        payload = CheckPointManager(str(Path(args.ckpt).parent)).load(args.ckpt)
        if payload:
            restore_state(trainer, payload["state"])

    batch = trainer.prepare_batch(collate_batch(ds[0]))
    times = {}
    frames = render_frames(trainer.model, cfg, batch, args.n_frames, times)
    folder = write_frames(frames, args.out)
    print(f"wrote {len(frames)} frames to {folder}")
    return {"frames": frames, "folder": folder, **times}


if __name__ == "__main__":
    main()
