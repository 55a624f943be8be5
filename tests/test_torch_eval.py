"""The port's eval slice against the JAX package, on the CPU: the SSIM
metric, the SE(3) maps and their gradients, the Umeyama alignment, the
pose-error protocol with its gate, the LPIPS stub, and the Evaluator
(IPO-Net pose pass, test-time refinement, render, metrics, results.json).

Inputs are made with numpy from a seed and given to both sides; the
Evaluator's weights are made by the JAX package and reach the port through
`weights.ggrt_params_from_jax`. Each test states its tolerance.
"""
import copy
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.evaluation import metrics as jmetrics
from ggrt_official_tpu.evaluation.harness import Evaluator as JEvaluator
from ggrt_official_tpu.geometry import alignment as jalign
from ggrt_official_tpu.geometry import se3 as jse3
from ggrt_official_tpu.losses.photometric import photometric_decay_loss as jphoto
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.ops import ssim as jssim
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.evaluation import harness as tharness
from ggrt_official_torch.evaluation import metrics as tmetrics
from ggrt_official_torch.geometry import alignment as talign
from ggrt_official_torch.geometry import se3 as tse3
from ggrt_official_torch.models import ggrt as tggrt
from ggrt_official_torch.ops import ssim as tssim
from tests.test_torch_models import port_cfg
from tests.test_torch_rasterizer import image_close
from tests.test_torch_train import import_beside_placeholders  # noqa: F401  (torch.optim's first import)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for this file's torch work: at these sizes a
    pool gains nothing, and the suite runs several test processes on a few
    cores, where every process's pool spinning on all of them slows each
    step many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual, np.float64), np.asarray(expected, np.float64), **tol)


# --- SSIM metric ---------------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 3, 32, 48), (2, 3, 11, 13)])
def test_ssim_metric(shape):
    """atol 1e-6: the same 11x11 window (made in float64, then cast), the
    same zero padding and constants."""
    rng = np.random.RandomState(0)
    x = rng.uniform(size=shape).astype(np.float32)
    y = np.clip(x + 0.1 * rng.normal(size=shape), 0, 1).astype(np.float32)
    close(tssim._gaussian_window(11, 1.5), jssim._gaussian_window(11, 1.5), rtol=0, atol=0)
    close(tssim.ssim_metric(t(x), t(y)), jax.jit(jssim.ssim_metric)(x, y), rtol=0, atol=1e-6)
    close(tmetrics.ssim(t(x[0]), t(y[0])), jmetrics.ssim(x[0], y[0]), rtol=0, atol=1e-6)
    close(tmetrics.psnr(t(x), t(y)), jmetrics.psnr(x, y), rtol=1e-6)
    close(tmetrics.psnr(t(x), t(x)), jmetrics.psnr(x, x), rtol=0)  # mse floored at 1e-10


# --- SE(3) ---------------------------------------------------------------------

# theta = 0, a small theta inside the Taylor branches (theta² < 1e-8) and a
# generic theta.
THETAS = {"zero": 0.0, "small": 5e-5, "generic": 0.9}
SE3_FNS = ["skew", "_taylor_A", "_taylor_B", "_taylor_C", "_taylor_A_sq", "_taylor_B_sq", "_taylor_C_sq",
           "axis_angle_to_R", "so3_exp", "so3_log", "se3_exp", "se3_log", "compose", "rotation_distance"]


def se3_inputs(regime):
    """(fn name -> inputs) for one theta: axis-angle vectors of that norm,
    the matrices they make, and random cotangents for the gradients."""
    rng = np.random.RandomState(11)
    theta = THETAS[regime]
    axes = rng.normal(size=(3, 3))
    w = (axes / np.linalg.norm(axes, axis=-1, keepdims=True) * theta).astype(np.float32)
    u = rng.normal(size=(3, 3)).astype(np.float32)
    wu = np.concatenate([w, u], axis=-1)
    R = np.asarray(jse3.so3_exp(w))
    T = np.asarray(jse3.se3_exp(wu))
    T2 = np.asarray(jse3.se3_exp(np.concatenate([w[::-1], u], axis=-1)))
    x = np.full((3,), theta, np.float32)
    ins = {"skew": (w,), "axis_angle_to_R": (w,), "so3_exp": (w,), "so3_log": (R,), "se3_exp": (wu,),
           "se3_log": (T,), "compose": (T, T2), "rotation_distance": (R, np.asarray(jse3.so3_exp(w[::-1])))}
    ins.update({f"_taylor_{k}": (x,) for k in "ABC"})
    ins.update({f"_taylor_{k}_sq": (x * x,) for k in "ABC"})
    return ins


@pytest.fixture(scope="module")
def se3_jax():
    """Values and gradients (of sum(f(x)·cot) w.r.t. the first argument)
    of every SE(3) function in every regime, from one jitted JAX call."""
    cases = {(fn, r): se3_inputs(r)[fn] for fn in SE3_FNS for r in THETAS}
    rng = np.random.RandomState(12)
    cots = {k: rng.normal(size=np.shape(getattr(jse3, k[0])(*v))).astype(np.float32) for k, v in cases.items()}

    @jax.jit
    def run(cases, cots):
        out = {}
        for (fn, r), args in cases.items():
            f = getattr(jse3, fn)
            val = f(*args)
            grad = jax.grad(lambda a0: jnp.sum(f(a0, *args[1:]) * cots[(fn, r)]))(args[0])
            out[(fn, r)] = (val, grad)
        return out

    res = run(cases, cots)
    return {k: (np.asarray(v), np.asarray(g), cases[k], cots[k]) for k, (v, g) in res.items()}


@pytest.mark.parametrize("regime", list(THETAS))
@pytest.mark.parametrize("fn", SE3_FNS)
def test_se3(se3_jax, fn, regime):
    """Values and torch.autograd gradients against jax.grad: rtol 1e-5,
    atol 1e-6 (1e-6 of the largest entry for gradients). The Taylor-safe
    functions give finite gradients at θ = 0. se3_log at the identity does
    not, in either package: its θ = sqrt(Σw²) has an infinite derivative at
    w = 0, and JAX's gradient is NaN in the whole rotation block; the
    port's is NaN there too but for the diagonal, which torch's clamp
    backward fills with zeros. Its translation column agrees."""
    val_j, grad_j, args, cot = se3_jax[(fn, regime)]
    a0 = t(args[0]).requires_grad_(True)
    val_t = getattr(tse3, fn)(a0, *(t(a) for a in args[1:]))
    close(val_t.detach(), val_j, rtol=1e-5, atol=1e-6)
    (val_t * t(cot)).sum().backward()
    grad_t = a0.grad.numpy()
    finite = np.isfinite(grad_j)
    scale = max(np.abs(grad_j[finite]).max(), 1.0)
    close(grad_t[finite], grad_j[finite], rtol=1e-5, atol=1e-6 * scale)
    if (fn, regime) == ("se3_log", "zero"):
        assert not finite[..., :3, :3].any() and finite[..., :3, 3].all()
        off = ~np.eye(3, dtype=bool)
        assert np.isnan(grad_t[..., :3, :3][..., off]).all()
        assert (grad_t[..., :3, :3][..., ~off] == 0).all()
    else:
        assert finite.all()


# --- alignment ------------------------------------------------------------------

def random_rotation(rng):
    return np.asarray(jse3.so3_exp(rng.normal(size=3).astype(np.float32)))


@pytest.mark.parametrize("case", ["known_sim3", "reflection"])
def test_align_umeyama(case):
    """A known sim3 is recovered (atol 1e-5); where the best orthogonal fit
    is a reflection the sign fix keeps det R = +1. Both against JAX, atol
    1e-5."""
    rng = np.random.RandomState(13)
    data = rng.normal(size=(7, 3)).astype(np.float32)
    if case == "known_sim3":
        s0, R0, t0 = 1.7, random_rotation(rng), rng.normal(size=3).astype(np.float32)
        model = (s0 * data @ R0.T + t0).astype(np.float32)
    else:
        model = (data * np.array([1.0, 1.0, -1.0], np.float32)).astype(np.float32)
    s_j, R_j, t_j = jalign.align_umeyama(model, data)
    s_t, R_t, t_t = talign.align_umeyama(t(model), t(data))
    for a, b in ((s_t, s_j), (R_t, R_j), (t_t, t_j)):
        close(a, b, rtol=0, atol=1e-5)
    close(torch.linalg.det(R_t), 1.0, rtol=0, atol=1e-5)
    if case == "known_sim3":
        close(s_t, s0, rtol=1e-5)
        close(R_t, R0, rtol=0, atol=1e-5)
        close(t_t, t0, rtol=0, atol=1e-5)


def camera_ring(n, rng, radius=1.0, noise_deg=0.0):
    """n c2w matrices on a ring around the origin, each with a small random
    rotation of noise_deg degrees."""
    out = np.zeros((n, 4, 4), np.float32)
    for i in range(n):
        a = 2 * np.pi * i / n
        w = rng.normal(size=3) * np.deg2rad(noise_deg)
        out[i] = np.eye(4)
        out[i, :3, :3] = np.asarray(jse3.so3_exp(np.asarray(w, np.float32)))
        out[i, :3, 3] = radius * np.array([np.cos(a), np.sin(a), 0.3 * i / n])
    return out


@pytest.mark.parametrize("n", [4, 5])
def test_camera_alignment_median(n):
    """jnp.median averages the two middle values of an even count,
    torch.median returns the lower one: the port's medians equal JAX's at
    an even and an odd count (rtol 1e-6)."""
    rng = np.random.RandomState(14)
    gt = camera_ring(n, rng)
    pred = camera_ring(n, rng, noise_deg=3.0)
    pred[:, :3, 3] += 0.05 * rng.normal(size=(n, 3)).astype(np.float32)
    out_j = jalign.evaluate_camera_alignment(pred, gt)
    out_t = talign.evaluate_camera_alignment(t(pred), t(gt))
    for k in out_j:
        close(out_t[k], out_j[k], rtol=1e-5, err_msg=k)
    t_err = np.sort(np.linalg.norm(pred[:, :3, 3] - gt[:, :3, 3], axis=-1))
    if n % 2 == 0:
        assert float(torch.median(t(t_err))) != pytest.approx(float(out_t["t_error_med"]))
        close(out_t["t_error_med"], (t_err[n // 2 - 1] + t_err[n // 2]) / 2, rtol=1e-6)


def gate_case(branch):
    rng = np.random.RandomState(15)
    n = 2 if branch == "two_views" else 5
    gt = camera_ring(n, rng)
    pred = camera_ring(n, rng, noise_deg=2.0)
    pred[:, :3, 3] += 0.02 * rng.normal(size=(n, 3)).astype(np.float32)
    if branch == "coincident_gt":
        gt[:, :3, 3] = gt[0, :3, 3]
    elif branch == "ratio_outside":
        c = pred[:, :3, 3]
        pred[:, :3, 3] = c.mean(0) + 0.1 * (c - c.mean(0))
    elif branch == "aligned_worse":
        # Centres turned by 90 degrees about the vertical through their
        # centroid, rotations left as GT's: the fit turns every rotation by
        # 90 degrees, which the unaligned comparison does not.
        c = gt[:, :3, 3]
        Rz = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], np.float32)
        pred = gt.copy()
        pred[:, :3, 3] = (c - c.mean(0)) @ Rz.T + c.mean(0)
    return pred, gt


@pytest.mark.parametrize("branch", ["valid", "two_views", "coincident_gt", "ratio_outside", "aligned_worse"])
def test_pose_error_gate(branch):
    """Each branch of the conditioning gate: the same `alignment_valid`, NaN
    in the same gated keys, the *_unaligned values always reported; values
    rtol 1e-4, atol 1e-3 (degrees or units: arccos near 1 keeps about
    three digits of float32)."""
    pred, gt = gate_case(branch)
    out_j = {k: float(v) for k, v in jax.jit(jmetrics.evaluate_pose_errors)(pred, gt).items()}
    out_t = {k: float(v) for k, v in tmetrics.evaluate_pose_errors(t(pred), t(gt)).items()}
    assert set(out_t) == set(out_j)
    assert out_t["alignment_valid"] == out_j["alignment_valid"] == (1.0 if branch == "valid" else 0.0)
    for k, v in out_j.items():
        assert math.isnan(out_t[k]) == math.isnan(v), k
        if not math.isnan(v):
            close(out_t[k], v, rtol=1e-4, atol=1e-3, err_msg=k)
    assert all(math.isfinite(out_t[k]) for k in out_t if k.endswith("_unaligned"))


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "image_size": (320, 448), "n_views": 8}])
def test_flagship_scene_spec(kw):
    """The flagship's scene, field for field the JAX package's."""
    assert dataclasses.asdict(tds.flagship_scene_spec(**kw)) == dataclasses.asdict(jds.flagship_scene_spec(**kw))


def test_lpips_is_refused_with_weights(tmp_path, monkeypatch):
    """No LPIPS number without the network's weights: None by default, as
    JAX's metric; weights named by GGRT_LPIPS_WEIGHTS are used, not ignored,
    so a file that is no weights file is refused with an error, and a valid
    one (JAX's save_weights format) gives a float."""
    from ggrt_official_tpu.evaluation import lpips_jax
    from tests.test_torch_lpips import torch_state_dicts

    monkeypatch.delenv("GGRT_LPIPS_WEIGHTS", raising=False)
    assert tmetrics.lpips(np.zeros((3, 64, 64)), np.zeros((3, 64, 64))) is None
    f = tmp_path / "lpips.npz"
    f.write_bytes(b"")
    monkeypatch.setenv("GGRT_LPIPS_WEIGHTS", str(f))
    with pytest.raises((OSError, ValueError, EOFError)):
        tmetrics.lpips(np.zeros((3, 64, 64)), np.zeros((3, 64, 64)))
    lpips_jax.save_weights(str(f), *torch_state_dicts(3))
    x = np.random.RandomState(0).uniform(size=(3, 64, 64)).astype(np.float32)
    assert isinstance(tmetrics.lpips(x, 1.0 - x), float)


# --- the Evaluator -----------------------------------------------------------------

def dataset_example(pkg):
    return pkg.collate_batch(pkg.SyntheticPlanesDataset(
        pkg.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)[0])


def offset_gt_rel_poses(ex, offset=0.02):
    """(nv, 1, 6) relative poses that put each source camera at its dataset
    pose moved by `offset` in every 6-vector entry: the euler angles of
    R_rel = R_refᵀ R_t (R = Rx Ry Rz) and t_rel = R_refᵀ (t_t - t_ref)."""
    tgt = ex["camera"][0, -16:].reshape(4, 4).astype(np.float64)
    out = []
    for src in ex["src_cameras"][0, :, -16:].reshape(-1, 4, 4).astype(np.float64):
        R = src[:3, :3].T @ tgt[:3, :3]
        eul = [math.atan2(-R[1, 2], R[2, 2]), math.asin(R[0, 2]), math.atan2(-R[0, 1], R[0, 0])]
        out.append(np.concatenate([src[:3, :3].T @ (tgt[:3, 3] - src[:3, 3]), eul]) + offset)
    return np.asarray(out, np.float32)[:, None, :]


@pytest.fixture(scope="module")
def eval_case():
    """The JAX Evaluator at __graft_entry__._dryrun_cfg() widths, backend
    "pallas" in interpret mode, on a 32x64 scene with 3 source views; the
    port's Evaluator with the same weights on the CPU. JAX runs, each once:
    evaluate_view without refinement (IPO-Net's poses) and with one round of
    3 Adam steps per start for each refine_depth_source, and pose_targets.
    Every JAX `_refine` call's inputs and output are kept.

    The refined runs take their starting poses from offset_gt_rel_poses on
    both sides, in place of IPO-Net's: untrained IPO-Net poses put every
    source camera next to the target, where the triangulation behind the
    field's depth is ill-posed (ROADMAP Queue 3).

    One round: the warp loss is piecewise smooth (its gradient jumps where a
    bilinear sample crosses a pixel; test_refinement_step_matches_jax shows
    it on JAX's side), so Adam trajectories part at float rounding, in JAX
    against itself as in the port against JAX, and each round starts where
    the last ended.
    test_refinement_rounds covers the rounds."""
    cfg = graft._dryrun_cfg()
    cfg.decoder.backend = "pallas"
    init_cfg = copy.deepcopy(cfg)
    init_cfg.decoder.backend = "tiled"
    model = JModel(init_cfg)
    ex = dataset_example(jds)
    jb = JTrainer(init_cfg).prepare_batch(ex)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pose = jax.jit(lambda b: model.init(
        {"params": k1}, b["rgb"], b["src_rgbs"], b["camera"], b["src_cameras"],
        b["depth_range"][0, 0], b["depth_range"][0, 1], compute_sfm_loss=False, method="iponet"))(jb)
    gauss = jax.jit(lambda b: model.init({"params": k1, "sample": k2}, b, 0, deterministic=True,
                                         method="gaussian_forward"))(jb)
    params = {"params": {"pose_learner": pose["params"]["pose_learner"],
                         "gaussian": gauss["params"]["gaussian"]}}
    rel = offset_gt_rel_poses(ex)

    jev = JEvaluator(cfg, params)
    ipo_pose, refine = jev._pose, jev._refine
    calls = []

    def recording_refine(*args, **kw):
        out = refine(*args, **kw)
        calls.append(([np.asarray(a) for a in args], np.asarray(out)))
        return out

    jev._refine = recording_refine
    runs = {}
    jev.refine_depth_rounds = 1
    with pltpu.force_tpu_interpret_mode():
        runs["plain"] = jev.evaluate_view(ex, use_pred_pose=False)
        jev._pose = lambda *a: (ipo_pose(*a)[0], jnp.asarray(rel))
        for src in ("iponet", "field"):
            jev.refine_depth_source = src
            calls.clear()
            runs[src] = dict(jev.evaluate_view(ex, refine_steps=3), calls=list(calls))
        runs["targets"] = jev.pose_targets(ex, steps=3)

    pcfg = port_cfg(cfg)
    tm = tggrt.GGRtModel(pcfg, device="cpu")
    tm.load_state_dict(weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg))
    jev._pose, jev._refine = ipo_pose, refine
    return dict(cfg=pcfg, model=tm, ex=dataset_example(tds), rel=rel, runs=runs, jev=jev)


def port_evaluator(case, refine_depth_source="field", override=True, rounds=1):
    """The port's Evaluator on the CPU; with `override` its pose pass
    returns the case's starting poses (as the JAX runs' did), and every
    `_refine` call's inputs and output are kept in `.calls`."""
    ev = tharness.Evaluator(case["cfg"], case["model"], refine_depth_source=refine_depth_source,
                            refine_depth_rounds=rounds, device="cpu")
    ev.calls = []
    pose, refine = ev._pose, ev._refine
    if override:
        ev._pose = lambda b: (pose(b)[0], t(case["rel"]))

    def recording_refine(*args, **kw):
        out = refine(*args, **kw)
        ev.calls.append(([a.numpy().copy() for a in args], out.numpy().copy()))
        return out

    ev._refine = recording_refine
    return ev


def check_metrics(out_t, out_j, image_atol):
    """psnr, ssim and pred_var to `image_atol` ({key: atol}); pose errors
    rtol 1e-4, atol 1e-2 (degrees or units: rotation_distance is an arccos
    near 1); the same gated keys."""
    for k, atol in image_atol.items():
        close(out_t[k], out_j[k], rtol=0, atol=atol, err_msg=k)
    for k, v in out_j.items():
        if k.startswith(("R_", "t_", "alignment")):
            assert math.isnan(out_t[k]) == math.isnan(v), k
            if not math.isnan(v):
                close(out_t[k], v, rtol=1e-4, atol=1e-2, err_msg=k)


def test_evaluate_view_matches_jax(eval_case):
    """No refinement, IPO-Net's own poses (its pose pass with
    compute_sfm_loss off) and the dataset's context cameras for the render:
    psnr atol 2e-3 dB, ssim atol 1e-4, pred_var atol 1e-5 (measured: 1.3e-5,
    1.4e-5, 2.4e-8); the same keys; the
    aligned errors gated
    alike; the rendered image and depth by the compositor rule of
    test_torch_rasterizer.image_close (the two compositors sum in another
    order, so a pixel may flip across a cut-off)."""
    out_j = eval_case["runs"]["plain"]
    out_t = port_evaluator(eval_case, override=False).evaluate_view(eval_case["ex"], use_pred_pose=False)
    assert set(out_t) == set(out_j)
    check_metrics(out_t, out_j, {"psnr": 2e-3, "ssim": 1e-4, "pred_var": 1e-5})
    image_close(out_t["pred"], out_j["pred"], "rgb")
    image_close(out_t["depth"], out_j["depth"], "depth")
    close(out_t["gt"], out_j["gt"], rtol=1e-6, atol=0)


def refine_grad(args, vec):
    """JAX's refinement loss and its gradient at `vec`, on a recorded
    `_refine` call's inputs."""
    _, inv, tgt, refs, K, refK = args

    def loss(v):
        return jphoto(tgt, refs, inv[None], K, refK, v[None, :, None, :], valid_mask=True, oob_weight=0.1)["loss"]

    value, grad = jax.jit(jax.value_and_grad(loss))(jnp.asarray(vec))
    return float(value), np.asarray(grad)


def photometric_loss(inv, tgt, refs, K, refK):
    """The refinement's warp loss as a function of the (nv, 6) poses."""
    from ggrt_official_torch.losses.photometric import photometric_decay_loss

    return lambda v: photometric_decay_loss(tgt, refs, inv[None], K, refK, v[None, :, None, :],
                                            valid_mask=True, oob_weight=0.1)["loss"]


@pytest.mark.parametrize("src", ["iponet", "field"])
def test_refinement_step_matches_jax(eval_case, src):
    """On the first round's inputs as JAX made them: the warp loss rtol 1e-5
    at both starts; its gradient at the prediction start to 1e-3 of its
    largest entry. The loss is piecewise smooth: its gradient jumps wherever
    a bilinear sample crosses a pixel, and JAX's own gradient moves by more
    than 1e-3 of its largest entry when the poses move by 1e-6 (checked
    here), so a gradient is not held tighter than that. Every entry is above
    1e-4, four orders above Adam's eps, so that the first normalised step,
    lr·g/(|g| + eps) ≈ lr·sign(g), is held to its sign: one port Adam step
    equals it, atol 1e-6. The zeros start samples whole pixels (the
    identity warp), where the gradient is one-sided: its loss alone is
    compared."""
    args, _ = eval_case["runs"][src]["calls"][0]
    loss_fn = photometric_loss(*(t(a) for a in args[1:]))
    for start in (args[0], np.zeros_like(args[0])):
        with torch.no_grad():
            close(loss_fn(t(start)), refine_grad(args, start)[0], rtol=1e-5)
    v = t(args[0]).requires_grad_(True)
    loss_fn(v).backward()
    _, grad_j = refine_grad(args, args[0])
    rng = np.random.RandomState(16)
    jumps = [np.abs(refine_grad(args, args[0] + 1e-6 * rng.normal(size=args[0].shape).astype(np.float32))[1]
                    - grad_j).max() for _ in range(4)]
    assert max(jumps) > 1e-3 * np.abs(grad_j).max(), jumps
    assert np.abs(grad_j).min() > 1e-4, np.abs(grad_j).min()
    close(v.grad, grad_j, rtol=0, atol=1e-3 * np.abs(grad_j).max())
    close(tharness.adam_descent(loss_fn, t(args[0]), 1, 1e-2),
          args[0] - 1e-2 * grad_j / (np.abs(grad_j) + 1e-8), rtol=0, atol=1e-6)


@pytest.mark.parametrize("src", ["iponet", "field"])
def test_evaluate_view_refined_matches_jax(eval_case, src):
    """One round of 3 Adam steps per start from offset dataset poses, for
    each refine_depth_source: the round's inverse depth (IPO-Net's, or
    rendered from the field at the starting poses) by the compositor rule
    and the refined 6-vectors atol 1e-4. The view is then rendered and
    scored at the refined poses, and the render moves with them, so it is
    scored again at the poses JAX's refinement reached: the rendered image
    to a mean abs error under 5e-5 with under 2e-3 of its elements off by
    more than 2e-3 (the compositor rule, with the mean of the float32
    triangulation noise of the encoder at these context poses, ROADMAP
    Queue 3: 1.1e-5 and 2.7e-5 here, against 1e-5 at the dataset's), psnr
    atol 2e-3 dB, ssim atol 5e-4, pred_var atol 1e-5 and the pose errors as
    check_metrics says."""
    ev = port_evaluator(eval_case, refine_depth_source=src)
    out_t = ev.evaluate_view(eval_case["ex"], refine_steps=3)
    out_j = eval_case["runs"][src]
    assert len(ev.calls) == len(out_j["calls"]) == 1
    (args_t, vec_t), (args_j, vec_j) = ev.calls[0], out_j["calls"][0]
    # Every gradient entry at the prediction start far above Adam's eps:
    # the first normalised step is ±lr, so a sign flip shows at 2·lr.
    assert np.abs(refine_grad(args_j, args_j[0])[1]).min() > 1e-4
    image_close(args_t[1], args_j[1], "inverse depth")
    close(vec_t, vec_j, rtol=0, atol=1e-4)
    assert set(out_t) == set(out_j) - {"calls"} and math.isfinite(out_t["psnr"])
    ev._refine = lambda *a, **k: t(vec_j)
    at_jax = ev.evaluate_view(eval_case["ex"], refine_steps=3)
    err = np.abs(at_jax["pred"].astype(np.float64) - out_j["pred"])
    assert err.mean() < 5e-5 and (err > 2e-3).mean() < 2e-3, (err.mean(), (err > 2e-3).mean())
    check_metrics(at_jax, out_j, {"psnr": 2e-3, "ssim": 5e-4, "pred_var": 1e-5})


def test_refinement_rounds(eval_case):
    """refine_depth_rounds: each round renders the field's depth at the
    poses the last round ended at (so the depth changes) and refines from
    them; the view is rendered and scored at the last round's poses."""
    ev = port_evaluator(eval_case, rounds=3)
    renders = []
    render = ev._render
    ev._render = lambda b: renders.append(b["context"]["extrinsics"].clone()) or render(b)
    out = ev.evaluate_view(eval_case["ex"], refine_steps=2)
    assert len(ev.calls) == 3 and len(renders) == 4
    close(ev.calls[0][0][0], eval_case["rel"][:, -1], rtol=0, atol=0)
    for (args, _), (_, prev) in zip(ev.calls[1:], ev.calls):
        close(args[0], prev, rtol=0, atol=0)
    assert not np.array_equal(ev.calls[0][0][1], ev.calls[1][0][1])
    batch = ev._prepare_batch(eval_case["ex"])
    target = batch["camera"][0, -16:].reshape(4, 4).expand(3, 4, 4)
    for c2w, (args, _) in zip(renders, ev.calls):
        close(c2w[0], tse3.relative_to_source_c2w(target, t(args[0])), rtol=0, atol=0)
    close(renders[-1][0], tse3.relative_to_source_c2w(target, t(ev.calls[-1][1])), rtol=0, atol=0)
    assert math.isfinite(out["psnr"])


def test_pose_targets_match_jax(eval_case):
    """pose_targets (3 steps per start, IPO-Net's depth): atol 1e-4."""
    close(port_evaluator(eval_case).pose_targets(eval_case["ex"], steps=3), eval_case["runs"]["targets"],
          rtol=0, atol=1e-4)


def test_pose_pass_skips_sfm_loss(eval_case, monkeypatch):
    """The Evaluator's pose pass runs IPO-Net with compute_sfm_loss off: no
    photometric loss is computed, and IPO-Net's outputs are those of the
    train step's pass (which computes it)."""
    calls = []
    loss = tggrt.photometric_decay_loss
    monkeypatch.setattr(tggrt, "photometric_decay_loss", lambda *a, **k: calls.append(1) or loss(*a, **k))
    ev = port_evaluator(eval_case, override=False)
    batch = ev._prepare_batch(eval_case["ex"])
    inv, rel = ev._pose(batch)
    assert not calls
    args = (batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
            batch["depth_range"][0, 0], batch["depth_range"][0, 1])
    with torch.no_grad():
        inv_all, rel_all, sfm, _ = eval_case["model"].iponet(*args)
        assert eval_case["model"].iponet(*args, compute_sfm_loss=False)[2] is None
    assert calls and torch.isfinite(sfm["loss"])
    assert torch.equal(inv, inv_all[-1]) and torch.equal(rel, rel_all)


def test_evaluate_dataset_results_json(eval_case, tmp_path, monkeypatch):
    """results.json: strict JSON (non-finite floats written as null), the
    summary's means over the finite per-view values, lpips null with its
    status, n_views, render_ms."""
    monkeypatch.setattr(tharness.Evaluator, "time_render", lambda self, b, iters=20: 1.0)
    ds = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), mode="test",
                                    num_source_views=3)
    ev = port_evaluator(eval_case, override=False)
    summary = ev.evaluate_dataset(ds, out_dir=str(tmp_path), limit=2)

    def refuse(name):
        raise ValueError(f"non-strict JSON constant {name}")

    res = json.loads((tmp_path / "results.json").read_text(), parse_constant=refuse)
    assert res["summary"]["lpips"] is None and res["summary"]["lpips_status"].startswith("unavailable")
    assert res["summary"]["n_views"] == 2 and len(res["per_view"]) == 2
    assert res["summary"]["render_ms"] == 1.0
    for k, v in res["summary"].items():
        if k in res["per_view"][0] and not isinstance(v, bool):
            vals = [r[k] for r in res["per_view"] if r[k] is not None]
            assert (v is None) == (not vals), k
            if vals:
                close(v, np.mean(vals), rtol=1e-12, err_msg=k)
    assert math.isnan(summary["R_error_mean"]) and res["summary"]["R_error_mean"] is None
    assert summary["rendered_empty"] is False


def test_evaluate_dataset_writes_images(eval_case, tmp_path, monkeypatch):
    """With `out_dir`, both Evaluators write pred_0000.png and
    poses_pred_vs_gt.png beside results.json (the first test view, the
    dataset's cameras for the render). Decoded, each side's prediction is
    its own render as 8-bit (clip, ×255, truncated), bit for bit; the two
    renders differ by the encoder's float32 triangulation noise
    (test_torch_slice.py::test_gaussians_match), here a mean of less than
    0.1 level. The camera plot, drawn by the same matplotlib from poses
    that agree to float rounding, equals JAX's on at least 99% of its
    pixels."""
    for cls in (tharness.Evaluator, JEvaluator):
        monkeypatch.setattr(cls, "time_render", lambda self, b, iters=20: 1.0)
    kw = dict(n_views=8, image_size=(32, 64))
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    views = {}
    jev = eval_case["jev"]
    ev = port_evaluator(eval_case, override=False)
    for name, evaluator in (("jax", jev), ("port", ev)):
        inner = evaluator.evaluate_view
        monkeypatch.setattr(evaluator, "evaluate_view",
                            lambda *a, inner=inner, name=name, **k: views.setdefault(name, inner(*a, **k)))
    with pltpu.force_tpu_interpret_mode():
        jev.evaluate_dataset(jds.SyntheticPlanesDataset(jds.SyntheticSceneSpec(**kw), mode="test", num_source_views=3),
                             out_dir=str(jdir), limit=1, use_pred_pose=False)
    ev.evaluate_dataset(tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(**kw), mode="test", num_source_views=3),
                        out_dir=str(tdir), limit=1, use_pred_pose=False)
    decoded = {}
    for name, d in (("jax", jdir), ("port", tdir)):
        for f in ("pred_0000.png", "poses_pred_vs_gt.png", "results.json"):
            assert (d / f).exists(), (name, f)
        decoded[name] = np.asarray(Image.open(d / "pred_0000.png"))
        own = (np.clip(np.asarray(views[name]["pred"]).transpose(1, 2, 0), 0, 1) * 255).astype(np.uint8)
        np.testing.assert_array_equal(decoded[name], own, err_msg=name)
    assert decoded["port"].shape == (32, 64, 3)
    assert np.abs(decoded["port"].astype(int) - decoded["jax"]).mean() < 0.1
    got, want = (np.asarray(Image.open(d / "poses_pred_vs_gt.png")) for d in (tdir, jdir))
    assert got.shape == want.shape and got.ndim == 3
    assert (got == want).all(-1).mean() >= 0.99


def test_evaluator_reports_lpips_with_weights(eval_case, tmp_path, monkeypatch):
    """With GGRT_LPIPS_WEIGHTS set, each view's row has lpips (the port's
    network on the rendered and GT images' device), the value metrics.lpips
    gives for the same images as arrays (rtol 1e-6), and the summary its
    mean with no lpips_status, as JAX's harness.py:246-248, 291-297."""
    from ggrt_official_tpu.evaluation import lpips_jax
    from tests.test_torch_lpips import torch_state_dicts

    path = tmp_path / "lpips.npz"
    lpips_jax.save_weights(str(path), *torch_state_dicts(4))
    monkeypatch.setenv("GGRT_LPIPS_WEIGHTS", str(path))
    monkeypatch.setattr(tharness.Evaluator, "time_render", lambda self, b, iters=20: 1.0)
    ev = port_evaluator(eval_case, override=False)
    row = ev.evaluate_view(eval_case["ex"], use_pred_pose=False)
    assert isinstance(row["lpips"], float) and row["lpips"] > 0
    close(row["lpips"], tmetrics.lpips(row["pred"], row["gt"]), rtol=1e-6)
    ds = tds.SyntheticPlanesDataset(tds.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), mode="test",
                                    num_source_views=3)
    summary = ev.evaluate_dataset(ds, limit=1, use_pred_pose=False)
    assert isinstance(summary["lpips"], float) and "lpips_status" not in summary
