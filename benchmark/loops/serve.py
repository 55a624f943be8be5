"""Pose-free requests, closed loop, one client.

A request is one example of a scene: its source views and target camera as
numpy arrays on the host. It goes through IPO-Net (the source poses), the
poses placed from the target camera (`relative_to_source_c2w`), then the
Gaussian model (encode and render), as the evaluator's unrefined view runs
it without its metrics, and ends with the rgb and depth on the host. The
mix names the pool of scenes made in set-up and how many finished requests
the reference checks.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark import common, traffic, weights


def sides(program: bool):
    """(GGRtModel, prepare_batch, get_data_shim, relative_to_source_c2w) of
    the program or of the reference."""
    if program:
        from ggrt_official_torch.data.shims import get_data_shim
        from ggrt_official_torch.geometry.se3 import relative_to_source_c2w
        from ggrt_official_torch.models.ggrt import GGRtModel
        from ggrt_official_torch.training.trainer import prepare_batch
    else:
        from benchmark.reference.ggrt.data.shims import get_data_shim
        from benchmark.reference.ggrt.geometry.se3 import relative_to_source_c2w
        from benchmark.reference.ggrt.models.ggrt import GGRtModel
        from benchmark.reference.ggrt.training.trainer import prepare_batch
    return GGRtModel, prepare_batch, get_data_shim, relative_to_source_c2w


@torch.no_grad()
def request(model, prepare_batch, shim, relative_to_source_c2w, raw: dict, device) -> dict:
    """One request, from host arrays to host arrays: rgb (3, h, w), depth
    (h, w) and the relative poses of every GRU step (nv, n_preds, 6)."""
    batch = prepare_batch(raw, shim, device)
    _, rel_poses, _, _ = model.iponet(
        batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
        batch["depth_range"][0, 0], batch["depth_range"][0, 1], compute_sfm_loss=False)
    nv = batch["src_cameras"].shape[1]
    target_pose = batch["camera"][0, -16:].reshape(4, 4).expand(nv, 4, 4)
    c2w = relative_to_source_c2w(target_pose, rel_poses[:, -1, :])
    batch = {**batch, "context": {**batch["context"], "extrinsics": c2w[None]}}
    ret, _ = model.gaussian(batch, 0, deterministic=True)
    return {"rgb": ret["rgb"][0, 0].cpu().numpy(), "depth": ret["depth"][0, 0].cpu().numpy(),
            "poses": rel_poses.cpu().numpy()}


def requests(ctx: dict) -> tuple[list[dict], list[int]]:
    """The pool's requests (one per scene) and the order they are sent in:
    the pool in a seeded order, again and again."""
    cell = ctx["cell"]
    pool = [s.example(0) for s in traffic.scenes(cell["traffic"], common.image_size(cell), ctx["seed"],
                                                 common.source_views(cell), ctx["device"])]
    order = np.random.default_rng(common.seeded(ctx["seed"], 1)).permutation(len(pool)).tolist()
    return pool, order


def make_params(model, ctx):
    return weights.make_params(weights.param_shapes(model), common.seeded(ctx["seed"], 2), ctx["device"])


def setup(ctx: dict, spans) -> dict:
    GGRtModel, prepare_batch, get_data_shim, rel = sides(program=True)
    cfg = common.program_config(ctx["cell"])
    common.note("building the program's model")
    model = GGRtModel(cfg, device=ctx["device"])
    weights.load_params(model, make_params(model, ctx))
    common.note("making the requests")
    pool, order = requests(ctx)
    common.note("warming up")
    st = {"model": model, "prepare": prepare_batch, "shim": get_data_shim(cfg.encoder), "rel": rel,
          "pool": pool, "order": order, "outputs": [], "device": ctx["device"]}
    for k in range(int(ctx["cell"]["traffic"].get("warmup", 2))):
        request(model, prepare_batch, st["shim"], rel, pool[order[k % len(pool)]], ctx["device"])
    if spans.on:
        spans.wrap(model, "iponet", "iponet")
        spans.wrap(model.gaussian, "encode_pairs", "encoder")
    common.sync(ctx["device"])
    common.note("set-up done")
    return st


def item(st: dict, i: int, spans) -> None:
    st["outputs"].append(request(st["model"], st["prepare"], st["shim"], st["rel"],
                                 st["pool"][st["order"][i % len(st["order"])]], st["device"]))


def release(st: dict) -> dict:
    outs = st.pop("outputs")
    failed = sum(not all(np.isfinite(v).all() for v in o.values()) for o in outs)
    return {"outputs": outs, "pool": st["pool"], "order": st["order"], "failed": failed}


def work(ctx: dict, held: dict, record: dict) -> dict:
    return {}


def checked(ctx: dict, held: dict) -> list[int]:
    """The finished requests the reference checks, drawn from the seed."""
    n = len(held["outputs"])
    k = min(int(ctx["cell"]["traffic"]["checked_requests"]), n)
    return sorted(np.random.default_rng(common.seeded(ctx["seed"], 3)).choice(n, size=k, replace=False).tolist())


def reference_outputs(ctx: dict, held: dict, idx: list[int], tf32: bool) -> list[dict]:
    """The reference's answers to requests `idx`, in float32 or, as the
    control, with TF32."""
    GGRtModel, prepare_batch, get_data_shim, rel = sides(program=False)
    cfg = common.reference_config(ctx["cell"])
    common.set_tf32(tf32)
    try:
        model = GGRtModel(cfg, device=ctx["device"])
        weights.load_params(model, make_params(model, ctx))
        shim = get_data_shim(cfg.encoder)
        order = held["order"]
        return [request(model, prepare_batch, shim, rel, held["pool"][order[i % len(order)]], ctx["device"])
                for i in idx]
    finally:
        common.set_tf32(False)


def compare(ctx: dict, answers: list[dict], refs: list[dict]) -> list[dict]:
    gaps = {"poses": 0.0, "rgb": 0.0, "depth": 0.0}
    for a, r in zip(answers, refs):
        for key in gaps:
            gaps[key] = max(gaps[key], common.max_gap(a[key], r[key]))
    return [{"name": f"{key}_gap", "value": v, "limit": common.limit(ctx, f"{key}_gap")} for key, v in gaps.items()]


def check(ctx: dict, held: dict) -> list[dict]:
    idx = checked(ctx, held)
    return compare(ctx, [held["outputs"][i] for i in idx], reference_outputs(ctx, held, idx, tf32=False))


def inputs(ctx: dict, n: int = 10) -> dict:
    """What the control needs in place of a run's `held`: the pool, the order
    and `n` finished requests to draw the checked ones from."""
    pool, order = requests(ctx)
    return {"pool": pool, "order": order, "outputs": [None] * n}


def sound(ctx: dict) -> dict:
    """The program's answers to the requests a run of 10 would check,
    without a window."""
    from benchmark.run import Spans

    st = setup(ctx, Spans(False))
    held = inputs(ctx)
    for i in checked(ctx, held):
        item(st, i, None)
        held["outputs"][i] = st["outputs"].pop()
    return held


def control(ctx: dict, held: dict) -> list[dict]:
    """The control: the reference with TF32 in the program's place."""
    idx = checked(ctx, held)
    return compare(ctx, reference_outputs(ctx, held, idx, tf32=True), reference_outputs(ctx, held, idx, tf32=False))
