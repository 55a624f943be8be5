"""Real-time frames of one encoded scene, closed loop, one viewer.

Set-up encodes one scene's context with `PixelSplat.encode_pairs`. The
window renders an orbit through the context cameras, there and back, frame
after frame, with the splatting decoder as `scripts/render_video.py`'s
`decode_frame` calls it: each frame's camera goes from the host to the card
and its uint8 pixels come back before the next camera is sent. The encoder
and IPO-Net are not on this path.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import common, traffic, weights


def _so3_log(R: np.ndarray) -> np.ndarray:
    cos = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(cos)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (0.5 if theta < 1e-8 else theta / (2.0 * np.sin(theta)))


def _so3_exp(w: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if theta < 1e-8:
        return np.eye(3) + K
    return np.eye(3) + np.sin(theta) / theta * K + (1 - np.cos(theta)) / theta**2 * K @ K


def orbit(extrinsics: np.ndarray, intrinsics: np.ndarray, frames_per_leg: int) -> tuple[np.ndarray, np.ndarray]:
    """Cameras along the context cameras and back: between neighbours the
    geodesic (slerp of the rotation, lerp of the centre and intrinsics)
    under the cosine ease of the port's `utils/trajectories.py`. Returns
    float32 (n, 4, 4) c2w and (n, 3, 3) normalised intrinsics."""
    t = np.linspace(0.0, 1.0, frames_per_leg, endpoint=False)
    t = (np.cos(np.pi * (t + 1)) + 1) / 2
    path = list(range(len(extrinsics))) + list(range(len(extrinsics) - 2, 0, -1))
    E, K = [], []
    for a, b in zip(path, path[1:] + path[:1]):
        e0, e1 = extrinsics[a].astype(np.float64), extrinsics[b].astype(np.float64)
        w = _so3_log(e0[:3, :3].T @ e1[:3, :3])
        for s in t:
            m = np.eye(4)
            m[:3, :3] = e0[:3, :3] @ _so3_exp(w * s)
            m[:3, 3] = e0[:3, 3] * (1 - s) + e1[:3, 3] * s
            E.append(m)
            K.append(intrinsics[a] * (1 - s) + intrinsics[b] * s)
    return np.stack(E).astype(np.float32), np.stack(K).astype(np.float32)


def sides(program: bool):
    if program:
        from ggrt_official_torch.data.shims import get_data_shim
        from ggrt_official_torch.models.decoder_splatting import DecoderSplatting
        from ggrt_official_torch.models.ggrt import GGRtModel
        from ggrt_official_torch.scripts.render_video import decode_frame
        from ggrt_official_torch.training.trainer import prepare_batch
    else:
        from benchmark.reference.ggrt.data.shims import get_data_shim
        from benchmark.reference.ggrt.models.decoder_splatting import DecoderSplatting
        from benchmark.reference.ggrt.models.ggrt import GGRtModel
        from benchmark.reference.ggrt.training.trainer import prepare_batch
        decode_frame = reference_frame
    return GGRtModel, prepare_batch, get_data_shim, DecoderSplatting, decode_frame


def reference_frame(decoder, gaussians, extrinsics, intrinsics, near, far, image_shape):
    """The frame as `decode_frame` defines it: the colour render clipped to
    [0, 1], times 255, truncated to uint8."""
    out = decoder(gaussians, extrinsics[None, None], intrinsics[None, None], near, far, image_shape)
    return (out.color[0, 0].permute(1, 2, 0).clamp(0, 1) * 255).to(torch.uint8)


def scene(ctx: dict) -> dict:
    cell = ctx["cell"]
    return traffic.scenes({**cell["traffic"], "scenes": 1}, common.image_size(cell), ctx["seed"],
                          common.source_views(cell), ctx["device"])[0].example(0)


@torch.inference_mode()
def encode(program: bool, ctx: dict):
    """(model, decoder, frame function, Gaussians, batch) of one side."""
    GGRtModel, prepare_batch, get_data_shim, DecoderSplatting, decode_frame = sides(program)
    cfg = common.program_config(ctx["cell"]) if program else common.reference_config(ctx["cell"])
    model = GGRtModel(cfg, device=ctx["device"])
    weights.load_params(model, weights.make_params(weights.param_shapes(model), common.seeded(ctx["seed"], 2),
                                                   ctx["device"]))
    batch = prepare_batch(scene(ctx), get_data_shim(cfg.encoder), ctx["device"])
    gaussians = model.gaussian.encode_pairs(batch["context"], 0, deterministic=True)
    return model, DecoderSplatting(cfg.decoder), decode_frame, gaussians, batch


def cameras(ctx: dict, batch: dict) -> tuple[np.ndarray, np.ndarray]:
    c = batch["context"]
    return orbit(c["extrinsics"][0].cpu().numpy(), c["intrinsics"][0].cpu().numpy(),
                 int(ctx["cell"]["traffic"]["frames_per_leg"]))


def checked_positions(ctx: dict, rendered) -> list[int]:
    """The orbit positions the reference checks: a sample, drawn from the
    seed, of those the window rendered."""
    rendered = sorted(rendered)
    k = min(int(ctx["cell"]["traffic"]["checked_positions"]), len(rendered))
    rng = np.random.default_rng(common.seeded(ctx["seed"], 3))
    return sorted(rendered[j] for j in rng.choice(len(rendered), size=k, replace=False))


@torch.inference_mode()
def frame(st: dict, pos: int) -> np.ndarray:
    dev = st["device"]
    e = torch.from_numpy(st["E"][pos]).to(dev)
    k = torch.from_numpy(st["K"][pos]).to(dev)
    c = st["batch"]["context"]
    img = st["frame"](st["decoder"], st["gaussians"], e, k, c["near"][:, :1], c["far"][:, :1], st["shape"])
    return img.cpu().numpy()


def setup(ctx: dict, spans) -> dict:
    common.note("building the program's model, encoding the scene")
    model, decoder, decode_frame, gaussians, batch = encode(True, ctx)
    common.note("warming up")
    E, K = cameras(ctx, batch)
    st = {"model": model, "decoder": decoder, "frame": decode_frame, "gaussians": gaussians, "batch": batch,
          "E": E, "K": K, "shape": tuple(batch["target"]["image"].shape[-2:]), "device": ctx["device"],
          "kept": {}, "failed": 0}
    for pos in range(int(ctx["cell"]["traffic"].get("warmup", 3))):
        frame(st, pos)
    common.note("set-up done")
    return st


def item(st: dict, i: int, spans) -> None:
    pos = i % len(st["E"])
    st["kept"][pos] = frame(st, pos)


def release(st: dict) -> dict:
    del st["model"]
    kept = st["kept"]
    failed = 0 if kept else 1
    return {"kept": kept, "gaussians": st["gaussians"], "failed": failed}


def work(ctx: dict, held: dict, record: dict) -> dict:
    return {}


def compare(ctx: dict, gaussians, kept: dict, ref) -> list[dict]:
    _, decoder, decode_frame, ref_g, batch = ref
    g_gap = max(float((a - b).abs().max() / b.abs().max().clamp_min(1e-30)) for a, b in zip(gaussians, ref_g))
    E, K = cameras(ctx, batch)
    st = {"E": E, "K": K, "batch": batch, "frame": decode_frame, "decoder": decoder, "gaussians": ref_g,
          "shape": tuple(batch["target"]["image"].shape[-2:]), "device": ctx["device"]}
    levels = 0
    for pos in checked_positions(ctx, kept):
        want = frame(st, pos).astype(np.int16)
        levels = max(levels, int(np.abs(kept[pos].astype(np.int16) - want).max()))
    return [{"name": "gaussians_gap", "value": g_gap, "limit": common.limit(ctx, "gaussians_gap")},
            {"name": "frame_levels", "value": float(levels), "limit": common.limit(ctx, "frame_levels")}]


def reference(ctx: dict, tf32: bool):
    common.set_tf32(tf32)
    try:
        return encode(False, ctx)
    finally:
        common.set_tf32(False)


def check(ctx: dict, held: dict) -> list[dict]:
    return compare(ctx, held["gaussians"], held["kept"], reference(ctx, tf32=False))


def inputs(ctx: dict) -> dict:
    return {}


def sound(ctx: dict) -> dict:
    """The program's Gaussians and one frame at each checked position,
    without a window."""
    from benchmark.run import Spans

    st = setup(ctx, Spans(False))
    for pos in checked_positions(ctx, range(len(st["E"]))):
        item(st, pos, None)
    return release(st)


def control(ctx: dict, held: dict) -> list[dict]:
    """The control: the TF32 reference's Gaussians and frames in the
    program's place."""
    _, decoder, decode_frame, gaussians, batch = reference(ctx, tf32=True)
    E, K = cameras(ctx, batch)
    st = {"E": E, "K": K, "batch": batch, "frame": decode_frame, "decoder": decoder, "gaussians": gaussians,
          "shape": tuple(batch["target"]["image"].shape[-2:]), "device": ctx["device"]}
    common.set_tf32(True)
    try:
        kept = {pos: frame(st, pos) for pos in checked_positions(ctx, range(len(E)))}
    finally:
        common.set_tf32(False)
    return compare(ctx, gaussians, kept, reference(ctx, tf32=False))
