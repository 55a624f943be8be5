"""Encoder visualization dumps (the JAX package's utils/encoder_visualizer.py;
the reference's encoder_visualizer_epipolar.py): epipolar attention
entropy, depth-PDF summaries, depth maps and Gaussian statistics, as
host-side numpy images in place of wandb panels.

The JAX package reads its two flax `sow` taps; here `capture_intermediates`
switches on the same two taps, which the modules hold (`Attention.capture`,
`DepthPredictorMonocular.capture`) and which cost nothing while off.
"""
from __future__ import annotations

import os
import re
from contextlib import contextmanager

import numpy as np
import torch

from ..models.depth_predictor import DepthPredictorMonocular
from ..models.transformer import Attention
from .visualization import colorize_depth


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def visualize_depth_maps(gaussians_means: np.ndarray, extrinsics: np.ndarray,
                         image_shape: tuple[int, int], gaussians_per_pixel: int) -> np.ndarray:
    """Per-pixel mean Gaussian depth as a colorized image.

    gaussians_means: (v*h*w*spp, 3) in encoder emission order; extrinsics
    (v, 4, 4). Returns (v, h, w, 3) color maps.
    """
    h, w = image_shape
    v = extrinsics.shape[0]
    means = gaussians_means.reshape(v, h, w, gaussians_per_pixel, 3)
    out = []
    for i in range(v):
        w2c = np.linalg.inv(extrinsics[i])
        pts = means[i].reshape(-1, 3) @ w2c[:3, :3].T + w2c[:3, 3]
        depth = pts[:, 2].reshape(h, w, gaussians_per_pixel).mean(-1)
        out.append(colorize_depth(depth))
    return np.stack(out)


def overlay_epipolar_samples(
    image: np.ndarray,            # (3, h, w) the view samples are drawn FROM
    xy_samples: np.ndarray,       # (r_sel, s, 2) normalized xy of samples
    color=(1.0, 0.2, 0.2),
) -> np.ndarray:
    """Scatter epipolar sample points onto an image (returns (3, h, w))."""
    out = np.array(image, copy=True)
    _, h, w = out.shape
    xs = np.clip((xy_samples[..., 0] * w).astype(int), 0, w - 1)
    ys = np.clip((xy_samples[..., 1] * h).astype(int), 0, h - 1)
    for c in range(3):
        out[c, ys.reshape(-1), xs.reshape(-1)] = color[c]
    return out


def gaussian_statistics(gaussians) -> dict:
    """Summary stats of an encoder output (means/scales/opacities)."""
    means = _host(gaussians.means)
    opac = _host(gaussians.opacities)
    scales = _host(gaussians.scales)
    return {
        "n_gaussians": int(means.reshape(-1, 3).shape[0]),
        "mean_opacity": float(opac.mean()),
        "p95_opacity": float(np.percentile(opac, 95)),
        "mean_scale": float(scales.mean()),
        "max_scale": float(scales.max()),
        "means_bbox_min": means.reshape(-1, 3).min(0).tolist(),
        "means_bbox_max": means.reshape(-1, 3).max(0).tolist(),
    }


def visualize_attention(attn: np.ndarray, image_shape: tuple[int, int]) -> np.ndarray:
    """Per-head epipolar attention entropy maps (ref :130-203 simplified).

    attn: (r, heads, s) softmax weights per downscaled pixel token.
    Returns (heads, h, w, 3) colorized entropy (low entropy = peaky match).
    """
    h, w = image_shape
    r, heads, s = attn.shape
    assert r == h * w, (r, h, w)
    p = np.clip(attn, 1e-9, 1.0)
    entropy = -(p * np.log(p)).sum(-1) / np.log(s)    # (r, heads)
    return np.stack(
        [colorize_depth(entropy[:, i].reshape(h, w), cmap_name="viridis")
         for i in range(heads)]
    )


def visualize_overlaps(valid: np.ndarray, image_shape: tuple[int, int]) -> np.ndarray:
    """Fraction of other views whose epipolar segment overlaps each pixel
    (ref :231-269). valid: (v, ov, r) bool. Returns (v, h, w, 3)."""
    h, w = image_shape
    frac = np.asarray(valid, np.float32).mean(1)      # (v, r)
    return np.stack(
        [colorize_depth(f.reshape(h, w), cmap_name="magma") for f in frac]
    )


def visualize_probabilities(pdf: np.ndarray, image_shape: tuple[int, int]) -> np.ndarray:
    """Depth-bucket PDF summaries (ref :302-374): expectation and peakiness
    maps. pdf: (r, s). Returns (2, h, w, 3)."""
    h, w = image_shape
    r, s = pdf.shape
    buckets = (np.arange(s) + 0.5) / s
    expectation = (pdf * buckets).sum(-1) / np.clip(pdf.sum(-1), 1e-9, None)
    peak = pdf.max(-1)
    return np.stack([
        colorize_depth(expectation.reshape(h, w), cmap_name="turbo"),
        colorize_depth(peak.reshape(h, w), cmap_name="viridis"),
    ])


def visualize_epipolar_color_samples(
    image_from: np.ndarray,       # (3, h, w) view the colors are sampled FROM
    image_onto: np.ndarray,       # (3, h, w) view whose rays were projected
    xy_samples: np.ndarray,       # (r_sel, s, 2) normalized xy in image_from
) -> np.ndarray:
    """Reference :466-530 equivalent: bilinear-free nearest color pulled
    along each epipolar segment, scattered back onto the target view's
    pixel rows — a quick visual check that the epipolar geometry actually
    lands on corresponding texture. Returns (3, h, w)."""
    out = np.array(image_onto, copy=True) * 0.25
    _, h, w = image_from.shape
    xs = np.clip((xy_samples[..., 0] * w).astype(int), 0, w - 1)
    ys = np.clip((xy_samples[..., 1] * h).astype(int), 0, h - 1)
    sampled = image_from[:, ys, xs]                       # (3, r_sel, s)
    mean_color = sampled.mean(-1)                         # (3, r_sel)
    r_sel = xy_samples.shape[0]
    rows = (np.arange(r_sel) * (h * w // max(r_sel, 1))) % (h * w)
    out[:, rows // w, rows % w] = mean_color
    return out


def _flax_path(name: str) -> tuple[str, ...]:
    """A module's place in the JAX package's intermediates tree, from its
    torch name: a transformer layer's attention (layers.{i}.0.fn) is flax's
    attn_{i} and its feed-forward (layers.{i}.1.fn) ff_{i}."""
    name = re.sub(r"layers\.(\d+)\.0\.fn", r"attn_\1", name)
    name = re.sub(r"layers\.(\d+)\.1\.fn", r"ff_\1", name)
    return tuple(name.split("."))


@contextmanager
def capture_intermediates(module: torch.nn.Module):
    """While open, every Attention and DepthPredictorMonocular inside
    `module` appends its detached softmax weights or depth PDF to a list.
    Yields {"attn": [...], "depth_pdf": [...]}, each in the order of JAX's
    flattened intermediates: by the modules' places in flax's tree (its
    dict keys sorted), then in call order."""
    taps = [(m, []) for m in module.modules() if isinstance(m, (Attention, DepthPredictorMonocular))]
    names = {id(m): _flax_path(n) for n, m in module.named_modules()}
    for m, seen in taps:
        m.capture = seen
    out = {"attn": [], "depth_pdf": []}
    try:
        yield out
    finally:
        for m, _ in taps:
            m.capture = None
        for m, seen in sorted(taps, key=lambda tap: names[id(tap[0])]):
            out["attn" if isinstance(m, Attention) else "depth_pdf"].extend(seen)


def dump_encoder_visualizations(model, batch, step, image_shape, out_dir=None, deterministic=True,
                                generator=None):
    """The composite dump (the reference's EncoderVisualizerEpipolar.
    visualize, encoder_visualizer_epipolar.py:36-128): runs the Gaussian
    model of `model` (a GGRtModel; its `gaussian` forward) on a prepared
    batch with the taps on, copies what they captured and the render to the
    host in one copy, and returns the JAX package's dict of numpy images
    (`encoder_dumps`); with `out_dir`, also writes them as PNGs. Without
    `deterministic` the depth buckets are sampled with draws from
    `generator`."""
    gaussian = model.gaussian
    uniforms = None
    if not deterministic:
        if generator is None:
            raise ValueError("stochastic depth sampling needs a generator")
        b, v, _, h, w = batch["context"]["image"].shape
        enc = gaussian.encoder.cfg
        shape = (b * (v - 1), 2, h * w, enc.num_surfaces, enc.gaussians_per_pixel)
        uniforms = torch.rand(shape, generator=generator, device=generator.device)
        uniforms = uniforms.to(batch["context"]["image"].device)
    with torch.no_grad(), capture_intermediates(gaussian) as taps:
        ret, _ = gaussian(batch, step, deterministic=deterministic, uniforms=uniforms)
    tensors = [*taps["attn"], *taps["depth_pdf"], ret["rgb"]]
    flat = torch.cat([x.reshape(-1).float() for x in tensors]).cpu().numpy()
    host, at = [], 0
    for x in tensors:
        host.append(flat[at:at + x.numel()].reshape(x.shape))
        at += x.numel()
    n_attn = len(taps["attn"])
    dumps = encoder_dumps(host[:n_attn], host[n_attn:-1], host[-1], image_shape)
    if out_dir is not None:
        write_pngs(dumps, out_dir)
    return dumps


def encoder_dumps(attns, pdfs, rgb, image_shape) -> dict:
    """The dump's images from the captured taps on the host, as the JAX
    package's dump makes them: attention entropy per cross-attention
    layer and view (the taps whose token count fits no downscale of the
    image, the image self-attention's, are skipped but keep their layer
    number), depth-PDF expectation and peakiness per view, and the render."""
    dumps: dict[str, np.ndarray] = {}
    h, w = image_shape
    for li, a in enumerate(attns):
        # (tokens, heads, q=1, s) -> (r, heads, s) at the transformer's
        # downscaled resolution; infer the downscale from the token count.
        a = a.reshape(a.shape[0], a.shape[1], -1)
        r = a.shape[0]
        for ds in (4, 2, 8, 1):
            hh, ww = h // ds, w // ds
            if hh * ww and r % (hh * ww) == 0:
                views = r // (hh * ww)
                per = a.reshape(views, hh * ww, a.shape[1], a.shape[2])
                for vi in range(views):
                    dumps[f"attention_l{li}_v{vi}"] = visualize_attention(per[vi], (hh, ww))
                break
    for p in pdfs:
        # (b, v, r, srf, s) -> per-view expectation/peakiness maps.
        for vi in range(p.shape[1]):
            dumps[f"depth_pdf_v{vi}"] = visualize_probabilities(p[0, vi, :, 0, :], (h, w))
    dumps["rendered_rgb"] = rgb
    return dumps


def write_pngs(dumps: dict, out_dir) -> None:
    """Each image as <name>.png: leading panel axes collapse to the first
    panel, CHW becomes HWC, values are clipped to [0, 1] and scaled by 255
    (truncated); arrays that are no RGB image are skipped."""
    from PIL import Image

    os.makedirs(out_dir, exist_ok=True)
    for name, img in dumps.items():
        arr = np.asarray(img)
        while arr.ndim > 3:
            arr = arr[0]
        if arr.ndim == 3 and arr.shape[0] == 3 and arr.shape[-1] != 3:
            arr = arr.transpose(1, 2, 0)
        if arr.ndim == 3 and arr.shape[-1] == 3:
            Image.fromarray((np.clip(arr, 0.0, 1.0) * 255).astype(np.uint8)).save(
                os.path.join(out_dir, f"{name}.png"))


def visualize_gaussians(gaussians, image_shape: tuple[int, int], v: int,
                        gaussians_per_pixel: int) -> np.ndarray:
    """Opacity / scale maps per view (ref :270-301). Returns (v, 2, h, w, 3)."""
    h, w = image_shape
    opac = _host(gaussians.opacities).reshape(v, h, w, -1).mean(-1)
    scales = _host(gaussians.scales).reshape(v, h, w, -1, 3).mean((-1, -2))
    out = []
    for i in range(v):
        out.append(np.stack([
            colorize_depth(opac[i], cmap_name="viridis"),
            colorize_depth(scales[i], cmap_name="magma"),
        ]))
    return np.stack(out)
