"""The port's flagship script (ggrt_official_torch/scripts/run_flagship.py)
on the CPU: its arguments against tools/run_flagship.py's; its batch order,
stage split, bar and overfit ceiling against the same pieces of
tools/run_flagship.py's main (taken from its source with ast and run on
the same inputs, with stand-ins for the trainers and the evaluator); the
identity baseline and the pose targets' diagnostic against the JAX
package's geometry; and one whole tiny run (16x24, one scene, a step or two
per stage, 2 refinement steps per start in the refined arms) whose
EVAL_FLAGSHIP.json must have the JAX artifact's keys, then a resume that
skips every finished stage.

The whole run renders at 16x24, not larger: the plain compositor that the
CPU runs composites every pixel against every Gaussian of a tile (K grows
to the tile's demand on images of few tiles), so its cost grows with the
square of the pixel count.
"""
import ast
import copy
import itertools
import json
import math
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ggrt_official_torch.data.datasets import SyntheticPlanesDataset, collate_batch
from ggrt_official_torch.evaluation.harness import Evaluator
from ggrt_official_torch.scripts import run_flagship as rf
from ggrt_official_torch.training.trainer import GGRtTrainer
from ggrt_official_tpu.geometry.alignment import evaluate_camera_alignment as j_align
from ggrt_official_tpu.geometry.se3 import relative_to_source_c2w as j_rel
from tests.test_torch_train import import_beside_placeholders  # noqa: F401  (torch.optim's first import)

ROOT = Path(__file__).resolve().parents[1]
TINY = ["--device", "cpu", "--image", "16", "24", "--scenes", "1", "--nerf", "1", "--pose", "2",
        "--pose_warm", "1", "--selfdistill_steps", "2", "--ceiling", "1", "--eval_limit", "1",
        "--cache_ab", "1"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


JAX_SCRIPT = ROOT / "tools" / "run_flagship.py"


def jax_main() -> ast.FunctionDef:
    """tools/run_flagship.py's main, parsed."""
    tree = ast.parse(JAX_SCRIPT.read_text())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def run_jax(nodes, ns: dict) -> dict:
    """Statements of tools/run_flagship.py's main run with `ns` as their
    globals (main's locals that they read); returns `ns`."""
    exec(compile(ast.Module(body=list(nodes), type_ignores=[]), str(JAX_SCRIPT), "exec"), ns)
    return ns


def silent(*args, **kwargs):
    pass


def jax_arguments() -> dict:
    """option -> default of tools/run_flagship.py's parser, read from its
    source (the parser is built inside its main)."""
    tree = ast.parse((ROOT / "tools" / "run_flagship.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: k.value for k in node.keywords}
            out[node.args[0].value] = ast.literal_eval(kw["default"]) if "default" in kw else None
    return out


def test_arguments_and_defaults_match_jax():
    want = jax_arguments()
    assert want.pop("--platform") == ""
    ap = rf.build_parser()
    got = {a.option_strings[0]: a.default for a in ap._actions if a.option_strings[0] != "-h"}
    assert got.pop("--device") == "cuda"
    assert got == want
    defaults = ap.parse_args([])
    assert rf.DEFAULT_KEYS == (*[k for k in ("nerf", "pose", "pose_warm", "scenes", "distill", "image",
                                             "eval_limit", "lrate_pose", "pred_pose", "render_grad",
                                             "sfm_weight", "pose_anchor", "selfdistill", "selfdistill_steps",
                                             "selfdistill_rounds", "ceiling")], "device")
    assert all(hasattr(defaults, k) for k in rf.DEFAULT_KEYS)


def test_flagship_config():
    args = rf.build_parser().parse_args(["--pred_pose", "1", "--selfdistill", "3"])
    cfg = rf.flagship_config(args)
    tc = cfg.train
    assert (tc.use_pred_pose, tc.pose_render_grad, tc.sfm_valid_mask, tc.sfm_oob_weight) == (True, False, True, 0.1)
    assert (tc.sfm_weight, tc.pose_anchor_weight, tc.pose_selfdistill_weight, tc.pose_depth_distill) == (0.0, 0.01, 3.0, 1.0)
    assert (tc.lrate_pose, tc.n_tensorboard, tc.n_checkpoint, tc.n_iters) == (2e-4, 100, 1000, 2500)
    assert cfg.encoder.backbone.model == "resnet18" and cfg.decoder.backend == "cuda"


def test_batches_cycle_scenes_then_views_and_carry_targets():
    args = rf.build_parser().parse_args(["--image", "16", "24", "--scenes", "2"])
    ds = rf.train_datasets(args)
    targets = {(1, 0): np.full((4, 6), 0.5, np.float32)}
    it = rf.batches(ds, targets)
    got = [next(it) for _ in range(5)]
    want = [(0, 0), (1, 0), (0, 1), (1, 1), (0, 2)]
    for b, (si, vi) in zip(got, want):
        np.testing.assert_array_equal(b["rgb"], collate_batch(ds[si][vi])["rgb"])
        assert ("pose_target" in b) == ((si, vi) in targets)
    np.testing.assert_array_equal(got[1]["pose_target"], targets[(1, 0)][None])


def test_identity_baseline_matches_jax():
    args = rf.build_parser().parse_args(["--image", "16", "24"])
    ds = SyntheticPlanesDataset(rf.scene_spec(args, 17), mode="test", num_source_views=4)
    rs, ts = [], []
    for i in range(len(ds)):
        b = collate_batch(ds[i])
        gt = jnp.asarray(b["context"]["extrinsics"][0])
        err = j_align(jnp.broadcast_to(jnp.asarray(b["camera"][0, -16:].reshape(4, 4)), gt.shape), gt)
        rs.append(float(err["R_error_mean"]))
        ts.append(float(err["t_error_mean"]))
    got = rf.identity_baseline(ds)
    assert got == {"R_error_mean_unaligned": pytest.approx(round(float(np.mean(rs)), 4), abs=1e-4),
                   "t_error_mean_unaligned": pytest.approx(round(float(np.mean(ts)), 4), abs=1e-4)}
    assert got["R_error_mean_unaligned"] > 1.0


def test_bar():
    arm = lambda psnr, r: {"psnr": psnr, "R_error_mean_unaligned": r}  # noqa: E731
    result = {"heldout_views_pred_pose": arm(20.0, 2.0), "heldout_views_gt_pose": arm(21.5, 9.0),
              "heldout_views_pred_refined": arm(20.5, 5.0),
              "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}}
    assert rf.bar(result) == {"psnr_gap_db": 1.5, "psnr_ok": True, "r_err_ratio_vs_identity": 0.25,
                              "r_ok": True, "refined_r_err_ratio": 0.625, "pass": True, "refined_pass": False}
    result["heldout_views_gt_pose"]["psnr"] = 23.0
    assert not rf.bar(result)["pass"] and not rf.bar(result)["psnr_ok"]
    del result["heldout_views_pred_refined"]
    assert math.isnan(rf.bar(result)["refined_r_err_ratio"])
    assert "error" in rf.bar({"heldout_views_pred_pose": {"error": "x"}})


def fake_scenes(n_scenes: int, n_views: int) -> list:
    return [[(si, vi) for vi in range(n_views)] for si in range(n_scenes)]


def fake_collate(example) -> dict:
    return {"id": example}


@pytest.mark.parametrize("n_scenes,n_views", [(1, 5), (2, 3), (3, 4)])
def test_batches_follow_jax(n_scenes, n_views, monkeypatch):
    """The port's batch stream against tools/run_flagship.py's `batches`
    closure on the same scenes and targets: the same (scene, view) order
    and the same pose targets attached."""
    train_ds = fake_scenes(n_scenes, n_views)
    targets = {(n_scenes - 1, 1): np.full((4, 6), 0.5, np.float32), (0, n_views - 1): np.ones((4, 6), np.float32)}
    fn = next(n for n in jax_main().body if isinstance(n, ast.FunctionDef) and n.name == "batches")
    ns = run_jax([fn], {"itertools": itertools, "collate_batch": fake_collate, "train_ds": train_ds,
                        "targets": targets})
    monkeypatch.setattr(rf, "collate_batch", fake_collate)
    n = 3 * n_scenes * n_views
    want = list(itertools.islice(ns["batches"](), n))
    got = list(itertools.islice(rf.batches(train_ds, targets), n))
    assert [b["id"] for b in got] == [b["id"] for b in want]
    for b, w in zip(got, want):
        assert b.keys() == w.keys()
        if "pose_target" in w:
            np.testing.assert_array_equal(b["pose_target"], w["pose_target"])


def jax_bar(result: dict) -> dict:
    """tools/run_flagship.py's bar: the try statement of its main that
    sets result["bar"], run on a copy of `result`."""
    node = next(n for n in jax_main().body if isinstance(n, ast.Try) and "result['bar'] = {" in ast.unparse(n))
    return run_jax([node], {"result": copy.deepcopy(result), "json": json, "print": silent})["result"]["bar"]


def arm(psnr, r):
    return {"psnr": psnr, "R_error_mean_unaligned": r}


BAR_CASES = {
    "pass": {"heldout_views_pred_pose": arm(20.0, 2.0), "heldout_views_gt_pose": arm(21.5, 9.0),
             "heldout_views_pred_refined": arm(20.5, 5.0),
             "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
    "psnr_gap": {"heldout_views_pred_pose": arm(20.0, 2.0), "heldout_views_gt_pose": arm(23.0, 9.0),
                 "heldout_views_pred_refined": arm(20.5, 3.0),
                 "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
    "at_the_limits": {"heldout_views_pred_pose": arm(20.0, 4.0), "heldout_views_gt_pose": arm(22.0, 9.0),
                      "heldout_views_pred_refined": arm(20.5, 4.0),
                      "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
    "no_refined_arm": {"heldout_views_pred_pose": arm(20.0, 4.0), "heldout_views_gt_pose": arm(21.0, 9.0),
                       "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
    "refined_arm_failed": {"heldout_views_pred_pose": arm(20.0, 4.5), "heldout_views_gt_pose": arm(20.0, 9.0),
                           "heldout_views_pred_refined": {"error": "x"},
                           "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 9.0}},
    "zero_identity": {"heldout_views_pred_pose": arm(20.0, 1e-12), "heldout_views_gt_pose": arm(21.0, 9.0),
                      "heldout_views_pred_refined": arm(20.5, 0.0),
                      "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 0.0}},
    "pred_arm_failed": {"heldout_views_pred_pose": {"error": "x"}, "heldout_views_gt_pose": arm(21.0, 9.0),
                        "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
    "no_identity": {"heldout_views_pred_pose": arm(20.0, 2.0), "heldout_views_gt_pose": arm(21.0, 9.0)},
    "psnr_null": {"heldout_views_pred_pose": arm(None, 2.0), "heldout_views_gt_pose": arm(21.0, 9.0),
                  "identity_pose_baseline_scene0": {"R_error_mean_unaligned": 8.0}},
}


@pytest.mark.parametrize("case", list(BAR_CASES))
def test_bar_matches_jax(case):
    """The port's bar against tools/run_flagship.py's on the same arms
    (NaN compared as NaN, through json)."""
    result = BAR_CASES[case]
    assert json.dumps(rf.bar(copy.deepcopy(result))) == json.dumps(jax_bar(result))


STAGE_ARGS = {
    "default": [],
    "warm_past_pose": ["--pose", "5", "--pose_warm", "10"],
    "no_warm": ["--pose_warm", "0"],
    "no_selfdistill": ["--selfdistill", "0"],
    "three_rounds": ["--pose", "900", "--pose_warm", "300", "--selfdistill_rounds", "3"],
    "uneven_rounds": ["--pose", "10", "--pose_warm", "3", "--selfdistill_rounds", "4"],
}


@pytest.mark.parametrize("case", list(STAGE_ARGS))
def test_stage_split_matches_jax(case, monkeypatch):
    """The port's train_stages against tools/run_flagship.py's stage
    statements (from the first train_loop call to train_s): the same
    stages in the same order, each with its directory, steps and machine,
    and the pose targets regenerated at the same points."""
    args = rf.build_parser().parse_args([*STAGE_ARGS[case], "--out", "run"])
    body = jax_main().body
    first = next(i for i, n in enumerate(body) if isinstance(n, ast.Expr) and "train_loop(" in ast.unparse(n))
    last = next(i for i, n in enumerate(body) if isinstance(n, ast.Assign) and ast.unparse(n.targets[0]) == "train_s")
    stages = [n for n in body[first:last] if not isinstance(n, ast.FunctionDef)]
    want = []
    params = SimpleNamespace(params=None)
    run_jax(stages, {
        "args": args, "cfg": None, "trainer": SimpleNamespace(state=params), "batches": lambda: None,
        "Evaluator": lambda *a: params,
        "train_loop": lambda tr, data, out, n_iters, machine_schedule, resume: want.append(
            (out, n_iters, machine_schedule(0))),
        "generate_targets": lambda: want.append("targets"),
    })
    got = []
    monkeypatch.setattr(rf, "run_stage", lambda tr, data, out, n_iters, machine: got.append((out, n_iters, machine))
                        or {"steps": n_iters, "s": 0.0})
    monkeypatch.setattr(rf, "generate_targets", lambda *a: got.append("targets"))
    rf.train_stages(args, None, None, fake_scenes(1, 2), {}, {})
    assert got == want


class FakeTrainer:
    def __init__(self, cfg, device=None):
        self.state = SimpleNamespace(params=None)
        self.model = None


def fake_evaluator(summary):
    class FakeEvaluator:
        def __init__(self, *args, **kwargs):
            pass

        def evaluate_dataset(self, *args, **kwargs):
            if summary is None:
                raise RuntimeError("the eval failed")
            return dict(summary)
    return FakeEvaluator


@pytest.mark.parametrize("case", ["gap", "gt_arm_failed", "eval_failed"])
def test_ceiling_matches_jax(case, monkeypatch):
    """The port's ceiling against tools/run_flagship.py's ceiling block on
    the same arms: scene 0's views in the same order, the same steps and
    directory, and the same overfit_ceiling_scene0 (psnr, ssim, the gap to
    the dataset-pose arm, or the error)."""
    args = rf.build_parser().parse_args(["--ceiling", "7", "--out", "run"])
    summary = None if case == "eval_failed" else {"psnr": 24.123456, "ssim": 0.81234567}
    gt = {"error": "x"} if case == "gt_arm_failed" else arm(21.5, 9.0)
    train_ds = fake_scenes(2, 3)
    node = next(n for n in jax_main().body if isinstance(n, ast.If) and ast.unparse(n.test) == "args.ceiling > 0")

    def loop(tr, data, out, n_iters, machine_schedule, resume):
        want.append((out, n_iters, machine_schedule(0), [b["id"] for b in itertools.islice(data, 8)]))

    want, got = [], []
    jax_result = {"heldout_views_gt_pose": dict(gt)}
    run_jax([node], {
        "args": args, "cfg": None, "GGRtTrainer": FakeTrainer, "Evaluator": fake_evaluator(summary),
        "itertools": itertools, "collate_batch": fake_collate, "train_ds": train_ds, "train_loop": loop,
        "SyntheticPlanesDataset": lambda *a, **k: None, "spec": lambda seed: None, "result": jax_result,
        "json": json, "sanitize": rf.sanitize, "print": silent,
    })
    monkeypatch.setattr(rf, "GGRtTrainer", FakeTrainer)
    monkeypatch.setattr(rf, "Evaluator", fake_evaluator(summary))
    monkeypatch.setattr(rf, "SyntheticPlanesDataset", lambda *a, **k: None)
    monkeypatch.setattr(rf, "collate_batch", fake_collate)
    monkeypatch.setattr(rf, "run_stage", lambda tr, data, out, n_iters, machine: got.append(
        (out, n_iters, machine, [b["id"] for b in itertools.islice(data, 8)])) or {"steps": n_iters, "s": 0.0})
    result = {"heldout_views_gt_pose": dict(gt)}
    rf.ceiling(args, None, train_ds, result)
    assert got == want
    assert json.dumps(result) == json.dumps(jax_result)


def test_generate_targets_matches_jax_geometry():
    """Targets for one view of one scene; the diagnostic R error equals the
    JAX package's relative_to_source_c2w + evaluate_camera_alignment on
    the same targets."""
    args = rf.build_parser().parse_args(TINY)
    cfg = rf.flagship_config(args)
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    ev = Evaluator(cfg, trainer.model, device="cpu")
    view = rf.train_datasets(args)[0][3]
    targets, stats = {}, {"per_view_R_err": [], "seconds": 0.0, "rounds": []}
    rf.generate_targets(ev, [[view]], targets, stats, steps=2)
    vec = targets[(0, 0)]
    assert vec.shape == (4, 6) and np.isfinite(vec).all()
    b = collate_batch(view)
    gt = jnp.asarray(b["context"]["extrinsics"][0])
    pred = j_rel(jnp.broadcast_to(jnp.asarray(b["camera"][0, -16:].reshape(4, 4)), gt.shape), jnp.asarray(vec))
    want = round(float(j_align(pred, gt)["R_error_mean"]), 3)
    assert stats["per_view_R_err"] == [pytest.approx(want, abs=2e-3)]
    assert stats["rounds"] == [stats["R_err_mean"]] and len(stats["rounds"]) == 1


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """One whole run at TINY's sizes, the refined arms at 2 Adam steps per
    start and time_render at one iteration."""
    out = tmp_path_factory.mktemp("flagship")
    args = rf.build_parser().parse_args([*TINY, "--out", str(out)])
    with pytest.MonkeyPatch.context() as mp:
        inner = Evaluator.time_render
        mp.setattr(Evaluator, "time_render", lambda self, batch, iters=20: inner(self, batch, iters=1))
        result, timings = rf.run(args, refine_steps=2)
    return args, result, timings


def test_tiny_run_has_the_jax_artifact_keys(tiny_run):
    args, result, timings = tiny_run

    def refuse(name):
        raise ValueError(name)

    written = json.loads((Path(args.out) / "EVAL_FLAGSHIP.json").read_text(), parse_constant=refuse)
    reference = json.loads((ROOT / "EVAL_FLAGSHIP_r05.json").read_text())
    assert rf.schema_differences(written, reference) == set()
    assert "/cache_ab/carried_from_previous_run" not in rf.key_paths(written)  # only a resumed run carries it
    assert written["args"]["device"] == "cpu" and written["is_default_flagship"] is False
    for name in [k for k in written if k.startswith("heldout_")]:
        assert all(math.isfinite(written[name][k]) for k in ("psnr", "ssim", "R_error_mean_unaligned",
                                                              "t_error_mean_unaligned")), name
    assert len(written["pose_target_stats"]["per_view_R_err"]) == len(rf.train_datasets(args)[0])
    assert written["cache_ab"]["on"]["hits"] > 0 and "error" not in written["bar"]
    assert [timings["stages"][k]["steps"] for k in ("stage_nerf", "stage_distill", "stage_selfdistill")] == [1, 1, 1]
    assert timings["ceiling"]["steps"] == 1 and set(timings["arms_s"]) == set(rf.arm_specs(args))


def test_resume_skips_every_finished_stage(tiny_run):
    args, _, _ = tiny_run
    cfg = rf.flagship_config(args)
    trainer = GGRtTrainer(cfg, device="cpu")
    trainer.init_full()
    ev = Evaluator(cfg, trainer.model, device="cpu")
    stats = {"per_view_R_err": [], "seconds": 0.0, "rounds": []}
    ds = rf.train_datasets(args)
    stages = rf.train_stages(args, trainer, ev, [[ds[0][0]]], {}, stats)
    assert {k: v["steps"] for k, v in stages.items()} == {"stage_nerf": 0, "stage_distill": 0, "stage_selfdistill": 0}
    assert trainer.state.step == args.nerf + args.pose
    ceil = GGRtTrainer(cfg, device="cpu")
    assert rf.run_stage(ceil, iter([collate_batch(ds[0][0])] * 2), f"{args.out}/stage_ceiling",
                        args.ceiling, "nerf_only")["steps"] == 0
