"""FLOPs of one timed item, counted once over the benchmark's reference on
the meta device (shapes only: nothing is computed) with
`torch.utils.flop_counter.FlopCounterMode`, and stored in
`benchmark/cells/<cell>.json` as `flops_per_item`.

What is counted is the networks' work: matrix products, convolutions and
attention, forward and, for a train step, backward. The rasterizer's
projection, binning and compositing are not in the count (its plain
compositor's products are under 0.1% of a request's). The finetune step is
counted as one forward and backward of the whole-image loss: the deferred
back-propagation's extra encoder pass per crop tile is not work the step
needs, so that removing it shows as a higher `mfu.step`.

    python3 -m benchmark.flops --workload <cell> [--write]
"""
from __future__ import annotations

import argparse
import json

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, spec, traffic


def example(cell: dict) -> dict:
    """A request or train example of the cell's traffic, at its shapes."""
    mix = cell["traffic"]
    s = traffic.PlanesScene(traffic.SceneSpec.of(mix.get("scene", {}), n_views=mix["views_per_scene"],
                                                 image_size=tuple(common.image_size(cell)), seed=0),
                            mode=mix["split"], num_source_views=common.source_views(cell))
    return s.example(0)


def count(cell: dict) -> int | None:
    """FLOPs per item of the cell's loop; None for a loop without a count."""
    from benchmark.reference.ggrt.data.shims import get_data_shim
    from benchmark.reference.ggrt.models.ggrt import GGRtModel
    from benchmark.reference.ggrt.training.trainer import prepare_batch

    loop = cell["traffic"]["loop"]
    if loop not in ("serve", "steps"):
        return None
    cfg = common.reference_config(cell)
    model = GGRtModel(cfg, device="meta")
    batch = prepare_batch(example(cell), get_data_shim(cfg.encoder), "meta")
    train = loop == "steps"
    mode = FlopCounterMode(display=False)
    with mode, torch.set_grad_enabled(train):
        _, _, sfm, _ = model.iponet(batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
                                    batch["depth_range"][0, 0], batch["depth_range"][0, 1],
                                    compute_sfm_loss=train)
        if train:
            sfm["loss"].backward()
        ctx = batch["context"]
        b, v, _, h, w = ctx["image"].shape
        enc = cfg.encoder
        uniforms = torch.empty((b * (v - 1), 2, h * w, enc.num_surfaces, enc.gaussians_per_pixel), device="meta")
        g = model.gaussian.encode_pairs(ctx, 0, deterministic=not train, uniforms=uniforms if train else None)
        if train:
            sum(t.sum() for t in g[:4]).backward()
    return int(mode.get_total_flops())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--write", action="store_true", help="store the count in benchmark/cells/<cell>.json")
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load(), args.workload)
    n = count(cell)
    print(json.dumps({"workload": args.workload, "flops_per_item": n}))
    if args.write:
        path = common.HERE / "cells" / f"{args.workload}.json"
        data = json.loads(path.read_text())
        data["flops_per_item"] = n
        path.write_text(json.dumps(data, indent=1) + "\n")


if __name__ == "__main__":
    main()
