"""Optimizer steps, one after another: the generalizable train step
(`GGRtTrainer.train_iteration`) or the per-scene finetune step with
deferred back-propagation (`GGRtFinetuneTrainer.train_iteration`), as the
mix's "trainer" says ("pretrain" or "finetune").

Set-up builds one trainer, loads the seeded weights, resumes it at the
mix's `start_step` (fresh optimizer state), and drives it through the
mix's `compared_steps` first steps on distinct examples, with the
depth-sampling draws made from the seed; those steps also warm up every
shape. The window goes on with the same trainer and the following
examples. After the window the reference follows the first steps from the
same weights, examples and draws, and the losses, each leaf's first
gradient as Adam got it, and each leaf's change over those steps are
compared.
"""
from __future__ import annotations

import torch

from benchmark import common, roofline, traffic, weights


def trainer_class(mix: dict, program: bool):
    if program:
        from ggrt_official_torch.training import trainer as mod
    else:
        from benchmark.reference.ggrt.training import trainer as mod
    return {"pretrain": mod.GGRtTrainer, "finetune": mod.GGRtFinetuneTrainer}[mix["trainer"]]


def examples(ctx: dict) -> list[dict]:
    cell = ctx["cell"]
    mix = cell["traffic"]
    out = []
    for s in traffic.scenes(mix, common.image_size(cell), ctx["seed"], common.source_views(cell), ctx["device"]):
        out += [s.example(j) for j in range(int(mix.get("examples_per_scene", len(s))))]
    return out


def draws(ctx: dict, step: int, example: dict):
    """The step's depth-sampling draws, from (seed, step): the whole render's
    (pairs, 2, h·w, surfaces, gaussians per pixel) and, for the finetune,
    each crop tile's."""
    cfg = ctx["cell"]["config"]["model"]
    enc = cfg["encoder"]
    v = example["context"]["image"].shape[1]
    h, w = common.image_size(ctx["cell"])
    gen = torch.Generator(device=ctx["device"]).manual_seed(common.seeded(ctx["seed"], 10, step))

    def rand(pixels):
        shape = (v - 1, 2, pixels, enc["num_surfaces"], enc["gaussians_per_pixel"])
        return torch.rand(shape, generator=gen, device=ctx["device"])

    full = rand(h * w)
    if ctx["cell"]["traffic"]["trainer"] != "finetune":
        return full
    c = cfg["train"]["crop_size"]
    return full, [rand((h // c) * (w // c)) for _ in range(c * c)]


def resume(trainer, ctx: dict) -> None:
    """Place a fresh trainer at the mix's `start_step`, as the program's
    `training/loop.py::restore_state` resumes a run without its optimizer
    state (the configurations' `no_load_opt`): the step counter and both
    schedules' counts, so the joint loss's weights and the learning rates
    are those of that step, past the warm-up."""
    step = int(ctx["cell"]["traffic"].get("start_step", 0))
    trainer.state.step = step
    trainer.state.gaussian_opt.count = step
    trainer.state.pose_opt.count = step


def initial_params(model, ctx):
    return weights.make_params(weights.param_shapes(model), common.seeded(ctx["seed"], 2), ctx["device"])


def first_steps(trainer, ctx: dict, exs: list[dict]) -> dict:
    """Drive a built trainer through the compared steps; returns the
    readings the comparison takes."""
    n = int(ctx["cell"]["traffic"]["compared_steps"])
    machine = ctx["cell"]["traffic"]["machine"]
    losses, first = [], {}
    for i in range(n):
        aux = trainer.train_iteration(exs[i % len(exs)], machine, uniforms=draws(ctx, i, exs[i % len(exs)]))
        losses.append(float(aux["loss_all"]))
        if i == 0:
            st = trainer.state
            first = common.leaf_norms(common.adam_first_grads(trainer.model, [st.gaussian_opt.opt, st.pose_opt.opt]))
    p0 = initial_params(trainer.model, ctx)
    change = common.leaf_norms({k: p.detach() - p0[k] for k, p in trainer.model.named_parameters()})
    return {"losses": losses, "first": first, "change": change}


class Capture:
    """Stands in front of the program's decoder; while `on`, keeps each
    render's Gaussians and cameras (detached copies) for the rooflines."""

    def __init__(self, decoder):
        self.decoder = decoder
        self.on = False
        self.renders = []

    def __call__(self, gaussians, extrinsics, intrinsics, near, far, image_shape, depth_mode=None):
        if self.on:
            grad = torch.is_grad_enabled() and gaussians.means.requires_grad
            self.renders.append({
                "gaussians": [t.detach().clone() for t in gaussians[:4]],
                "cameras": [t.detach().clone() for t in (extrinsics, intrinsics, near, far)],
                "image_shape": tuple(image_shape), "depth": depth_mode is not None, "grad": grad})
        return self.decoder(gaussians, extrinsics, intrinsics, near, far, image_shape, depth_mode=depth_mode)


def setup(ctx: dict, spans) -> dict:
    mix = ctx["cell"]["traffic"]
    common.note("building the program's trainer")
    trainer = trainer_class(mix, program=True)(common.program_config(ctx["cell"]), device=ctx["device"])
    trainer.init_full()
    weights.load_params(trainer.model, initial_params(trainer.model, ctx))
    resume(trainer, ctx)
    common.note("making the examples")
    exs = examples(ctx)
    common.note("the compared first steps")
    readings = first_steps(trainer, ctx, exs)
    common.sync(ctx["device"])
    common.note("set-up done")
    st = {"trainer": trainer, "examples": exs, "readings": readings, "ctx": ctx, "failed": 0,
          "capture": None, "losses": []}
    if spans.on:
        if mix["trainer"] == "finetune":
            spans.wrap(trainer, "pose_pass", "pose_pass")
            spans.wrap(trainer, "tile_pass", "tile_pass")
        st["capture"] = Capture(trainer.model.gaussian.decoder)
        trainer.model.gaussian.decoder = st["capture"]
    return st


def item(st: dict, i: int, spans) -> None:
    ctx = st["ctx"]
    step = int(ctx["cell"]["traffic"]["compared_steps"]) + i
    ex = st["examples"][step % len(st["examples"])]
    cap = st["capture"]
    if cap is not None:
        cap.on = i == 0
    aux = st["trainer"].train_iteration(ex, ctx["cell"]["traffic"]["machine"], uniforms=draws(ctx, step, ex))
    st["losses"].append(aux["loss_all"])
    common.sync(ctx["device"])


def release(st: dict) -> dict:
    losses = torch.stack(st["losses"]).float().cpu() if st["losses"] else torch.zeros(0)
    cap = st["capture"]
    held = {"readings": st["readings"], "examples": st["examples"],
            "failed": int((~torch.isfinite(losses)).sum()),
            "renders": cap.renders if cap is not None else []}
    st.clear()
    return held


def work(ctx: dict, held: dict, record: dict) -> dict:
    """The compositor's least time and its kernels' time in the window's
    first step (whose renders were captured)."""
    from benchmark.reference.ggrt.models.decoder_splatting import effective_max_per_tile

    if not held["renders"] or record["trace"] is None:
        return {}
    cfg = common.reference_config(ctx["cell"]).decoder
    fwd = bwd = 0.0
    for r in held["renders"]:
        means, cov, harm, opa = r["gaussians"]
        extr, intr, near, far = r["cameras"]
        b, v = extr.shape[:2]
        flat = lambda t: t.reshape(b * v, *t.shape[2:])  # noqa: E731
        rep = lambda t: t.repeat_interleave(v, dim=0)  # noqa: E731
        w = roofline.render_work(flat(extr), flat(intr), flat(near), flat(far), r["image_shape"],
                                 rep(means), rep(cov), rep(harm), rep(opa), max_dup=cfg.max_dup,
                                 max_per_tile=effective_max_per_tile(cfg, means.shape[1], r["image_shape"]))
        fwd += roofline.fwd_bound_ms(w) * (2 if r["depth"] else 1)
        if r["grad"]:
            bwd += roofline.bwd_bound_ms(w)
    held["renders"].clear()
    lo, hi = record["trace"].items[0]
    out = {}
    for kernel, bound in (("composite_fwd", fwd), ("composite_bwd", bwd)):
        ms, launches = record["trace"].kernel_ms(lo, hi, f"{kernel}_kernel")
        if launches and bound > 0:
            out[kernel] = {"bound_ms": bound, "kernel_ms": ms, "launches": launches}
    return out


def reference_readings(ctx: dict, held: dict, tf32: bool) -> dict:
    common.set_tf32(tf32)
    try:
        trainer = trainer_class(ctx["cell"]["traffic"], program=False)(common.reference_config(ctx["cell"]),
                                                                        device=ctx["device"])
        trainer.init_full()
        weights.load_params(trainer.model, initial_params(trainer.model, ctx))
        resume(trainer, ctx)
        return first_steps(trainer, ctx, held["examples"])
    finally:
        common.set_tf32(False)


def compare(ctx: dict, got: dict, ref: dict) -> list[dict]:
    """The first step's loss; the worst leaf's first gradient; the worst
    leaf's change over the compared steps, leaving out the leaves whose
    reference gradient is under a thousandth of the median leaf's (they move
    by round-off alone). The later steps' losses and the median leaf's
    change go to standard error beside them."""
    if len(got["losses"]) != len(ref["losses"]):
        return [{"name": n, "value": float("inf"), "limit": common.limit(ctx, n)}
                for n in ("loss_gap", "first_grad_gap", "change_gap")]
    losses = [abs(a - b) / max(abs(b), 1e-30) for a, b in zip(got["losses"], ref["losses"])]
    first, first_at = common.worst_leaf(got["first"], ref["first"])
    med = sorted(ref["first"].values())[len(ref["first"]) // 2]
    moving = {k for k, g in ref["first"].items() if g >= 1e-3 * med}
    change, change_at = common.worst_leaf(got["change"], ref["change"], keep=moving)
    gaps = sorted(abs(got["change"][k] - ref["change"][k]) / max(ref["change"][k], 1e-30) for k in moving)
    return [{"name": "loss_gap", "value": losses[0], "limit": common.limit(ctx, "loss_gap"),
             "at": f"step 1; every step {losses}"},
            {"name": "first_grad_gap", "value": first, "limit": common.limit(ctx, "first_grad_gap"),
             "at": first_at},
            {"name": "change_gap", "value": change, "limit": common.limit(ctx, "change_gap"),
             "at": f"{change_at}; median leaf {gaps[len(gaps) // 2] if gaps else 0.0}; "
                   f"{len(moving)} of {len(ref['first'])} leaves"}]


def check(ctx: dict, held: dict) -> list[dict]:
    return compare(ctx, held["readings"], reference_readings(ctx, held, tf32=False))


def inputs(ctx: dict) -> dict:
    return {"examples": examples(ctx)}


def sound(ctx: dict) -> dict:
    """The program's readings without a window: its set-up alone."""
    from benchmark.run import Spans

    return release(setup(ctx, Spans(False)))


def control(ctx: dict, held: dict) -> list[dict]:
    return compare(ctx, reference_readings(ctx, held, tf32=True), reference_readings(ctx, held, tf32=False))
