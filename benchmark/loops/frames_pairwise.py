"""Real-time frames as `frames.py` runs them, with the reference's context
encoded one adjacent pair at a time, as the reference GGRt loops over its
pairs (pixelsplat.py:262-270).

At 640x960 the reference's batched encode of 4 pairs does not fit on an
80 GB card (its first attention asks for 18.75 GiB on top of 57 GiB); one
pair a call fits beside the program's held Gaussians. The encoder never
mixes pairs, so the Gaussians are those of the batched encode, in the same
order. The program encodes as it always does (`PixelSplat.encode_pairs`),
which at 640x960 is one pair a call too, and gives the reference's bits.

A program that encodes every pair in one call whatever the image size
(one without `pixelsplat.MAX_PIXELS_PER_CALL`) is refused at set-up: its
Gaussians are summed in another order, and the depth's argmax then moves
some of them (0.019-0.032 of the scene's scale over three seeds, up to 29
levels in a frame), which this comparison cannot tell from a fault.

Everything else is `frames.py`'s: this module loads a private copy of it
and replaces that copy's `encode`.
"""
from __future__ import annotations

import torch

from benchmark import common, spec, weights
from benchmark.reference.ggrt.models.gaussian_adapter import Gaussians

frames = spec.loop("frames")
_encode = frames.encode


@torch.inference_mode()
def encode(program: bool, ctx: dict):
    """(model, decoder, frame function, Gaussians, batch) of one side; the
    reference's Gaussians pair by pair."""
    if program:
        return _encode(True, ctx)
    GGRtModel, prepare_batch, get_data_shim, DecoderSplatting, decode_frame = frames.sides(False)
    cfg = common.reference_config(ctx["cell"])
    model = GGRtModel(cfg, device=ctx["device"])
    weights.load_params(model, weights.make_params(weights.param_shapes(model), common.seeded(ctx["seed"], 2),
                                                   ctx["device"]))
    batch = prepare_batch(frames.scene(ctx), get_data_shim(cfg.encoder), ctx["device"])
    c = batch["context"]
    parts = [model.gaussian.encode_pairs({k: x[:, i:i + 2] for k, x in c.items() if isinstance(x, torch.Tensor)},
                                         0, deterministic=True)
             for i in range(c["image"].shape[1] - 1)]
    gaussians = Gaussians(*(torch.cat(ts, dim=1) for ts in zip(*parts)))
    return model, DecoderSplatting(cfg.decoder), decode_frame, gaussians, batch


def setup(ctx: dict, spans) -> dict:
    from ggrt_official_torch.models import pixelsplat

    if not hasattr(pixelsplat, "MAX_PIXELS_PER_CALL"):
        raise RuntimeError("the program encodes every context pair in one call; this cell compares "
                           "Gaussians encoded one pair a call")
    return frames.setup(ctx, spans)


frames.encode = encode
item, release, work = frames.item, frames.release, frames.work
check, inputs, sound, control = frames.check, frames.inputs, frames.sound, frames.control
