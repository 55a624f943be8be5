"""The port's train slice against the JAX package, on the CPU: geometry,
SSIM, the IPO-Net encoder, heads and network (forward and gradients), the
photometric loss, the optimizer update with its state-machine gating, and
one whole `train_iteration`.

Inputs are made with numpy from a seed and given to both sides; parameters
are made by the JAX package and reach the port through
`ggrt_official_torch.weights`. Unless a test says otherwise the tolerance
is rtol 1e-4, atol 1e-5 in float32: the same operations summed in another
order. Gradients are held to 1e-4 of each tensor's largest entry.
"""
import copy
import importlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import __graft_entry__ as graft
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.geometry import camera as jcam
from ggrt_official_tpu.geometry import depth as jdepth
from ggrt_official_tpu.geometry import se3 as jse3
from ggrt_official_tpu.losses import photometric as jphoto
from ggrt_official_tpu.models import backbone as jbb
from ggrt_official_tpu.models import depth_predictor as jdp
from ggrt_official_tpu.models import heads as jheads
from ggrt_official_tpu.models import iponet as jipo
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.ops import ssim as jssim
from ggrt_official_tpu.training import state as jstate
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_torch import weights
from ggrt_official_torch.data import datasets as tds
from ggrt_official_torch.geometry import camera as tcam
from ggrt_official_torch.geometry import depth as tdepth
from ggrt_official_torch.geometry import se3 as tse3
from ggrt_official_torch.losses import photometric as tphoto
from ggrt_official_torch.models import backbone as tbb
from ggrt_official_torch.models import heads as theads
from ggrt_official_torch.models import iponet as tipo
from ggrt_official_torch.ops import ssim as tssim
from ggrt_official_torch.training import state as tstate
from ggrt_official_torch.training.trainer import GGRtTrainer as TTrainer
from tests.test_torch_models import port_cfg

TOL = dict(rtol=1e-4, atol=1e-5)


def import_beside_placeholders(*names):
    """Import modules that torch loads lazily with the placeholder modules of
    tests/reference_stubs.py set aside. A placeholder answers every
    attribute, `__file__` included, with a namespace, and `inspect.getmodule`
    fails on it; torch calls that when it first imports `torch._dynamo`
    (from `torch.optim`) or `torch.distributed.tensor` (from
    `torch.testing`)."""
    aside = {k: m for k, m in sys.modules.copy().items()
             if not isinstance(getattr(m, "__file__", None), (str, type(None)))}
    for k in aside:
        del sys.modules[k]
    try:
        for name in names:
            importlib.import_module(name)
    finally:
        sys.modules.update(aside)


import_beside_placeholders("torch._dynamo", *(("torch.distributed.tensor",) if torch.distributed.is_available() else ()))


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected), **(tol or TOL))


def close_to_scale(actual, expected, rtol=1e-4, name=""):
    """|actual - expected| <= rtol·max|expected| everywhere."""
    expected = np.asarray(expected, np.float64)
    np.testing.assert_allclose(np.asarray(actual, np.float64), expected, rtol=0,
                               atol=rtol * np.abs(expected).max() + 1e-30, err_msg=name)


def nchw(x):
    return np.ascontiguousarray(np.moveaxis(np.asarray(x), -1, 1))


def perturbed(params, seed=0, scale=0.1):
    """flax params whose vectors (batch-norm statistics, scales, biases) are
    moved off the values they start at, so that the conversion of each is
    seen; variances and scales stay near 1, kernels stay as drawn."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.RandomState(seed)
    out = [(np.asarray(x) + scale * rng.normal(size=x.shape)).astype(np.float32) if x.ndim == 1
           else np.asarray(x) for x in leaves]
    return jax.tree_util.tree_unflatten(tree, out)


def rows_under(prefix, stride=8):
    """IPO-Net name-map rows of one submodule, relative to it."""
    return [(k[len(prefix) + 1:], p[1:], kind) for (k, p, kind) in weights.depth_pose_net_name_map(stride)
            if k.startswith(prefix + ".")]


def load(module, flax_params, rows):
    module.load_state_dict(weights._convert(jax.tree_util.tree_map(np.asarray, flax_params), rows, ""))
    return module


def torch_grads(module, rows, grads_tree):
    """JAX gradients in the port's layout, keyed like module.named_parameters()."""
    conv = weights._convert(jax.tree_util.tree_map(np.asarray, grads_tree), rows, "")
    names = dict(module.named_parameters())
    return {k: v for k, v in conv.items() if k in names}


# --- geometry and SSIM -------------------------------------------------------

def test_camera():
    rng = np.random.RandomState(0)
    K = jnp.asarray(np.array([[[30.0, 0, 31.5], [0, 28.0, 15.5], [0, 0, 1]]] * 2, np.float32))
    vec = (rng.normal(size=(2, 6)) * 0.1).astype(np.float32)
    Twc = jse3.pose_from_vec(jnp.asarray(vec))
    depth = jnp.asarray(rng.uniform(1, 5, (2, 1, 4, 6)).astype(np.float32))
    close(tcam.scale_intrinsics(t(K), 0.125, 0.25), jcam.scale_intrinsics(K, 0.125, 0.25))
    close(tcam.pixel_grid(4, 6), jcam.pixel_grid(4, 6))
    for pose in (None, Twc):
        X_j = jcam.reconstruct(depth, K, pose)
        X_t = tcam.reconstruct(t(depth), t(K), None if pose is None else t(pose))
        close(X_t, X_j)
        for normalize in (True, False):
            close(tcam.project(X_t, t(K), None if pose is None else t(pose), normalize),
                  jcam.project(X_j, K, pose, normalize))


def test_se3():
    rng = np.random.RandomState(1)
    vec = (rng.normal(size=(3, 6)) * 0.3).astype(np.float32)
    target = np.asarray(jse3.pose_from_vec(jnp.asarray(rng.normal(size=(3, 6)).astype(np.float32))))
    close(tse3.pose_from_vec(t(vec)), jse3.pose_from_vec(vec))
    close(tse3.relative_to_source_c2w(t(target), t(vec)), jse3.relative_to_source_c2w(target, vec))


def test_depth_and_smoothness():
    rng = np.random.RandomState(2)
    x = rng.normal(size=(2, 1, 5, 7)).astype(np.float32)
    x[0, 0, 0, :3] = [0.0, -1.0, 1e-8]
    for name in ("inv2depth", "depth2inv", "gradient_x", "gradient_y"):
        close(getattr(tdepth, name)(t(x)), getattr(jdepth, name)(x), err_msg=name)
    disp = rng.uniform(size=(2, 1, 5, 7)).astype(np.float32)
    for a, b in zip(tdepth.disp_to_depth(t(disp), 0.5, 20.0), jdepth.disp_to_depth(disp, 0.5, 20.0)):
        close(a, b)
    inv = rng.uniform(0.1, 1, (2, 1, 5, 7)).astype(np.float32)
    img = rng.uniform(size=(2, 3, 5, 7)).astype(np.float32)
    for a, b in zip(tdepth.calc_smoothness(t(inv), t(img)), jdepth.calc_smoothness(inv, img)):
        close(a, b)


def test_ssim():
    rng = np.random.RandomState(3)
    x, y = (rng.uniform(size=(2, 3, 9, 11)).astype(np.float32) for _ in range(2))
    close(tssim.ssim_photometric(t(x), t(y)), jssim.ssim_photometric(x, y), rtol=1e-4, atol=1e-4)


# --- IPO-Net ----------------------------------------------------------------

@pytest.mark.parametrize("stride", [8, 4])
def test_resnet_encoder(stride):
    """Forward and parameter gradients, frozen batch norm perturbed away
    from the identity; 6 input channels as cnet_pose takes."""
    rng = np.random.RandomState(4)
    x = rng.uniform(size=(2, 32, 48, 6)).astype(np.float32)
    enc = jbb.ResNetEncoder(out_chs=16, stride=stride)
    params = perturbed(jax.jit(lambda a: enc.init(jax.random.PRNGKey(0), a))(x))
    cot = rng.normal(size=(2, 32 // stride, 48 // stride, 16)).astype(np.float32)

    @jax.jit
    def fwd_vjp(p):
        out, vjp = jax.vjp(lambda q: enc.apply(q, x), p)
        return out, vjp(jnp.asarray(cot))[0]

    out_j, grads_j = fwd_vjp(params)
    rows = weights.resnet_encoder_name_map("resnet18", stride)
    port = load(tbb.ResNetEncoder(6, 16, stride), params["params"], rows)
    out_t = port(t(nchw(x)))
    close(out_t.detach(), nchw(out_j))
    (out_t * t(nchw(cot))).sum().backward()
    for name, g in torch_grads(port, rows, grads_j["params"]).items():
        close_to_scale(dict(port.named_parameters())[name].grad, g, name=name)
    assert port.bn1.running_mean.grad is None  # frozen statistics are buffers


@pytest.mark.parametrize("block", ["update_block_depth", "update_block_pose", "upmask_net"])
def test_heads(block):
    rng = np.random.RandomState(5)
    hd, cd, fd, ratio = 16, 8, 12, 4
    hf, wf = 4, 6
    net = rng.normal(size=(2, hf, wf, hd)).astype(np.float32)
    ctx = rng.normal(size=(2, hf, wf, cd)).astype(np.float32)
    cost = rng.uniform(size=(2, hf, wf, fd)).astype(np.float32)
    if block == "update_block_depth":
        j = jheads.BasicUpdateBlockDepth(hd, ratio, cd)
        args = (net, rng.uniform(size=(2, hf, wf, 1)).astype(np.float32), cost, ctx)
        port = theads.BasicUpdateBlockDepth(fd, hd, ratio, cd)
    elif block == "update_block_pose":
        j = jheads.BasicUpdateBlockPose(hd, cd)
        args = (net, (rng.normal(size=(2, 6)) * 0.1).astype(np.float32), cost, ctx)
        port = theads.BasicUpdateBlockPose(fd, hd, cd)
    else:
        j = jheads.UpMaskNet(hd, ratio)
        args = (net,)
        port = theads.UpMaskNet(hd, hd, ratio)
    params = perturbed(jax.jit(lambda a: j.init(jax.random.PRNGKey(1), *a))(args))
    out_j = jax.jit(lambda p, a: j.apply(p, *a))(params, args)
    load(port, params["params"], rows_under(block))
    out_t = port(*(t(nchw(a)) if a.ndim == 4 else t(a) for a in args))
    for a, b in zip(out_t if isinstance(out_t, tuple) else (out_t,),
                    out_j if isinstance(out_j, tuple) else (out_j,)):
        close(a.detach(), nchw(b) if b.ndim == 4 else b)


@pytest.fixture(scope="module")
def iponet_case():
    """IPO-Net at __graft_entry__._tiny_cfg() widths (two outer iterations
    of two GRU steps), 3 reference views at 32x64."""
    cfg = port_cfg(graft._tiny_cfg()).iponet
    rng = np.random.RandomState(6)
    h, w, nv = 32, 64, 3
    ins = dict(tgt=rng.uniform(size=(1, 3, h, w)), refs=rng.uniform(size=(nv, 3, h, w)),
               K=np.array([[[40.0, 0, 31.5], [0, 40.0, 15.5], [0, 0, 1]]]),
               Ks=np.array([[[40.0, 0, 31.5], [0, 40.0, 15.5], [0, 0, 1]]] * nv))
    ins = {k: v.astype(np.float32) for k, v in ins.items()}
    net = jipo.IPONet(graft._tiny_cfg().iponet)
    args = tuple(jnp.asarray(ins[k]) for k in ("tgt", "refs", "K", "Ks")) + (0.5, 20.0)
    params = jax.jit(lambda a: net.init(jax.random.PRNGKey(0), *a, 0.5, 20.0))(args[:4])
    n_preds = 1 + cfg.iters // cfg.seq_len
    cots = (rng.normal(size=(n_preds, 1, 1, h, w)).astype(np.float32),
            rng.normal(size=(1, nv, n_preds, 6)).astype(np.float32))

    @jax.jit
    def fwd_vjp(p):
        out, vjp = jax.vjp(lambda q: net.apply(q, *args)[:2], p)
        return out, vjp(tuple(map(jnp.asarray, cots)))[0]

    out, grads = fwd_vjp(params)
    return dict(cfg=cfg, ins=ins, params=params, out=out, grads=grads, cots=cots)


def test_iponet_forward_and_gradients(iponet_case):
    c = iponet_case
    port = tipo.IPONet(c["cfg"])
    port.load_state_dict(weights.iponet_params_from_jax(jax.tree_util.tree_map(np.asarray, c["params"]), c["cfg"]))
    out = port(*(t(c["ins"][k]) for k in ("tgt", "refs", "K", "Ks")), 0.5, 20.0)
    close(out.inv_depths.detach(), c["out"][0])
    close(out.rel_poses.detach(), c["out"][1])
    ((out.inv_depths * t(c["cots"][0])).sum() + (out.rel_poses * t(c["cots"][1])).sum()).backward()
    rows = weights.depth_pose_net_name_map(c["cfg"].feat_ratio)
    grads = torch_grads(port, rows, c["grads"]["params"])
    assert len(grads) == len(list(port.parameters()))
    for name, g in grads.items():
        close_to_scale(dict(port.named_parameters())[name].grad, g, name=name)


# --- photometric loss ---------------------------------------------------------

@pytest.mark.parametrize("extensions", [False, True])
def test_photometric_loss(extensions):
    """Value and gradients w.r.t. the inverse depths and poses; with
    `extensions` the JAX package's valid_mask and oob_weight are on."""
    rng = np.random.RandomState(7)
    h, w, nv, n_it = 24, 32, 3, 3
    image = rng.uniform(size=(1, 3, h, w)).astype(np.float32)
    refs = rng.uniform(size=(nv, 3, h, w)).astype(np.float32)
    inv = rng.uniform(0.2, 1.0, (n_it, 1, 1, h, w)).astype(np.float32)
    poses = (rng.normal(size=(1, nv, n_it, 6)) * 0.05).astype(np.float32)
    K = np.array([[[30.0, 0, 15.5], [0, 30.0, 11.5], [0, 0, 1]]], np.float32)
    Ks = np.repeat(K, nv, axis=0)
    kw = dict(valid_mask=True, oob_weight=0.5) if extensions else {}
    (loss_j, metrics_j), grads_j = jax.jit(jax.value_and_grad(
        lambda d, p: (lambda r: (r["loss"], r["metrics"]))(
            jphoto.photometric_decay_loss(image, refs, d, K, Ks, p, **kw)),
        argnums=(0, 1), has_aux=True))(inv, poses)
    d, p = t(inv).requires_grad_(), t(poses).requires_grad_()
    res = tphoto.photometric_decay_loss(t(image), t(refs), d, t(K), t(Ks), p, **kw)
    close(res["loss"].detach(), loss_j, rtol=1e-5)
    assert set(res["metrics"]) == set(metrics_j)
    res["loss"].backward()
    close_to_scale(d.grad, grads_j[0], name="inv_depths")
    close_to_scale(p.grad, grads_j[1], name="poses")


# --- optimizer update ---------------------------------------------------------

class TwoGroups(torch.nn.Module):
    def __init__(self, pose, gauss):
        super().__init__()
        self.pose_learner = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v)) for k, v in pose.items()})
        self.gaussian = torch.nn.ParameterDict({k: torch.nn.Parameter(t(v)) for k, v in gauss.items()})


@pytest.mark.parametrize("machine", ["joint", "nerf_only", "pose_only"])
def test_optimizer_update(machine):
    """A 'joint' step, then a step of `machine`, against the JAX package's
    apply_updates: the gated group takes an Adam step with zero gradients
    and keeps moving on its momentum. Schedules that change within the two
    steps (warm-up 3, pose decay every step) and a Gaussian gradient whose
    norm is above the clip."""
    cfg = graft._tiny_cfg()
    cfg.train.optimizer.warm_up_steps = 3
    cfg.train.lrate_decay_pose_steps = 1
    rng = np.random.RandomState(8)
    shapes = {"a": (4, 3), "b": (5,)}
    pose = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    gauss = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    params = {"params": {"pose_learner": pose, "gaussian": gauss}}
    js = jstate.create_train_state(cfg, jax.tree_util.tree_map(jnp.asarray, params))
    model = TwoGroups(pose, gauss)
    ts = tstate.TrainState(port_cfg(cfg), model)
    for step, m in enumerate(("joint", machine)):
        grads = {"pose_learner": {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()},
                 "gaussian": {k: 4.0 * rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}}
        js = jstate.apply_updates(cfg, js, jax.tree_util.tree_map(jnp.asarray, {"params": grads}),
                                  jnp.asarray(jstate.state_id(m), jnp.int32))
        for group in ("pose_learner", "gaussian"):
            for k, p in getattr(model, group).items():
                p.grad = t(grads[group][k])
        ts.apply_updates(tstate.state_id(m))
        assert ts.step == int(js.step) == step + 1
        for group in ("pose_learner", "gaussian"):
            for k, p in getattr(model, group).items():
                close(p.detach(), js.params["params"][group][k], rtol=1e-6, atol=1e-7)


# --- the whole train step -----------------------------------------------------

def test_inject_predicted_poses():
    from ggrt_official_tpu.training.trainer import _inject_predicted_poses as j_inject
    from ggrt_official_torch.training.trainer import _inject_predicted_poses as t_inject

    rng = np.random.RandomState(10)
    nv = 3
    camera = rng.normal(size=(1, 34)).astype(np.float32)
    camera[0, -16:] = np.asarray(jse3.pose_from_vec(jnp.asarray(rng.normal(size=6).astype(np.float32)))).reshape(-1)
    batch = {"camera": camera, "src_cameras": np.zeros((1, nv, 34), np.float32),
             "context": {"extrinsics": np.zeros((1, nv, 4, 4), np.float32), "near": np.ones((1, nv), np.float32)}}
    rel = (rng.normal(size=(nv, 2, 6)) * 0.2).astype(np.float32)
    out_j = j_inject(jax.tree_util.tree_map(jnp.asarray, batch), jnp.asarray(rel))
    rel_t = t(rel).requires_grad_()
    tbatch = {"camera": t(camera), "src_cameras": t(batch["src_cameras"]),
              "context": {k: t(v) for k, v in batch["context"].items()}}
    out_t = t_inject(tbatch, rel_t)
    close(out_t["context"]["extrinsics"], out_j["context"]["extrinsics"])
    assert not out_t["context"]["extrinsics"].requires_grad
    assert out_t["context"]["near"] is tbatch["context"]["near"]
    assert t_inject(tbatch, rel_t, detach=False)["context"]["extrinsics"].requires_grad


def dataset_example(pkg):
    return pkg.collate_batch(pkg.SyntheticPlanesDataset(
        pkg.SyntheticSceneSpec(n_views=8, image_size=(32, 64)), num_source_views=3)[0])


@pytest.fixture(scope="module")
def step_case():
    """__graft_entry__._dryrun_cfg() widths (one GRU step), Pallas backend
    in interpret mode on the JAX side, depth loss on, joint coefficient 0.5
    and step 1, so that alpha = 2^-0.5 weighs both terms. The JAX
    parameters come from jitted inits (with the parameter-free decoder on
    its tiled backend); the depth-sampling uniforms are the same on both
    sides.

    The context cameras are the dataset's (use_pred_pose off): untrained
    IPO-Net poses put every context camera next to the target, and on a
    zero baseline the epipolar triangulation turns float32 rounding into
    different Gaussians in the two packages. The injection is held to the
    JAX package's by test_inject_predicted_poses."""
    cfg = graft._dryrun_cfg()
    cfg.decoder.backend = "pallas"
    cfg.train.use_depth_loss = True
    cfg.train.use_pred_pose = False
    cfg.train.joint_coefficient = 0.5
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
    pcfg = port_cfg(cfg)
    probe = TTrainer(pcfg, device="cpu")
    shape = probe.draw_uniforms(probe.prepare_batch(dataset_example(tds))).shape
    uniforms = np.random.RandomState(9).uniform(size=shape).astype(np.float32)
    return dict(cfg=cfg, pcfg=pcfg, params=params, uniforms=uniforms, ex=ex, runs={})


def adam_mu(opt_state):
    """The first moment of the Adam inside an optax chain."""
    return next(s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")).mu


def run_jax_step(case, machine, monkeypatch):
    """One JAX GGRtTrainer step from the shared parameters (cached per
    machine): (aux, updated params, the step's gated and clipped gradients).
    After one Adam step the first moment is 0.1·gradient, so the gradients
    are read from the optimizer state. The draw at depth_predictor.py:27 is
    patched to the shared uniforms."""
    if machine not in case["runs"]:
        u = jnp.asarray(case["uniforms"])

        def sample(key, pdf, num_samples):
            normalized = pdf / (jdp._EPS + jnp.sum(pdf, axis=-1, keepdims=True))
            cdf = jnp.cumsum(normalized, axis=-1)
            index = jnp.sum((cdf[..., :, None] <= u[..., None, :]).astype(jnp.int32), axis=-2)
            index = jnp.clip(index, 0, pdf.shape[-1] - 1)
            return index, jnp.take_along_axis(normalized, index, axis=-1)

        monkeypatch.setattr(jdp, "sample_discrete_distribution", sample)
        jt = JTrainer(case["cfg"])
        jt.state = jstate.create_train_state(case["cfg"], case["params"])._replace(
            step=jnp.asarray(1, jnp.int32))
        with pltpu.force_tpu_interpret_mode():
            aux = jt.train_iteration(case["ex"], machine)
        mu = {"params": {"pose_learner": adam_mu(jt.state.pose_opt_state)["params"]["pose_learner"],
                         "gaussian": adam_mu(jt.state.gaussian_opt_state)["params"]["gaussian"]}}
        case["runs"][machine] = (
            jax.tree_util.tree_map(np.asarray, aux),
            weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), case["pcfg"]),
            weights.ggrt_params_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x) / 0.1, mu), case["pcfg"]),
        )
    return case["runs"][machine]


def check_step(case, machine, monkeypatch):
    """aux to rtol 1e-4. Gradients: the whole gradient to 5e-3 and each
    tensor to 3e-2 in relative L2 norm; sums over many tokens with
    cancellation (the epipolar transformer's layer norms and queries)
    keep only about two digits of float32 in either package, and they
    weigh most where the Gaussian model's gradient is the whole of it
    ('nerf_only': 2e-3 measured; 'joint' 2.5e-4). Parameters:
    the gated group does not move; elsewhere the first Adam step moves each
    element by lr·g/(|g| + 1e-8), which is sign-like and so sensitive where
    |g| is near 1e-8 or near its own rounding error, and the Gaussian
    group's warm-up step (7.5e-8) is under one float32 ulp of weights near
    1: at least 99% of the moved elements agree to 1% of their tensor's
    largest update plus two ulps."""
    jaux, after, jgrads = run_jax_step(case, machine, monkeypatch)
    pcfg = case["pcfg"]
    tt = TTrainer(pcfg, device="cpu")
    tt.init_full()
    before = weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, case["params"]), pcfg)
    tt.model.load_state_dict(before)
    tt.state.step = 1
    aux = tt.train_iteration(case["ex"], machine, uniforms=t(case["uniforms"]))
    assert tt.state.step == 2
    for key in ("loss_all", "gaussian_loss", "sfm_loss", "depth_loss", "psnr", "pose_vec_norm"):
        close(aux[key], jaux[key], rtol=1e-4, atol=1e-6, err_msg=key)
    close(aux["rel_poses"], jaux["rel_poses"])

    gated = {"joint": (), "nerf_only": ("pose_learner.",), "pose_only": ("gaussian.",)}[machine]
    state = tt.model.state_dict()
    num = den = 0.0
    within, moved = 0, 0
    for name, p in tt.model.named_parameters():
        g_t, g_j = p.grad.double().numpy(), jgrads[name].double().numpy()
        err = np.linalg.norm(g_t - g_j)
        assert err <= 3e-2 * np.linalg.norm(g_j) + 1e-30, name
        num, den = num + err**2, den + np.sum(g_j**2)
        dj = (after[name] - before[name]).numpy()
        dt = (state[name] - before[name]).numpy()
        if name.startswith(gated):
            assert not dj.any() and not dt.any(), name
            continue
        tol = 1e-2 * np.abs(dj).max() + 2 * np.spacing(np.abs(before[name].numpy()))
        within += int((np.abs(dt - dj) <= tol).sum())
        moved += dj.size
    assert np.sqrt(num / den) <= 5e-3
    assert within >= 0.99 * moved, within / moved


def test_train_iteration_joint(step_case, monkeypatch):
    check_step(step_case, "joint", monkeypatch)


@pytest.mark.slow
@pytest.mark.parametrize("machine", ["nerf_only", "pose_only"])
def test_train_iteration_other_machines(step_case, monkeypatch, machine):
    check_step(step_case, machine, monkeypatch)


def test_optional_pose_terms():
    """The loss body's optional terms (all off in pretrain_config), on in a
    'pose_only' step of the port: depth distillation, render gradients,
    self-distillation towards given targets, the identity anchor and the
    teacher render. Each shows in aux and in the loss, and the teacher
    render reaches IPO-Net through the rasterizer's camera gradients."""
    cfg = port_cfg(graft._dryrun_cfg())
    for name, value in (("pose_depth_distill", 0.5), ("pose_selfdistill_weight", 0.5),
                        ("pose_anchor_weight", 0.5), ("pose_teacher_weight", 0.5)):
        setattr(cfg.train, name, value)
    cfg.train.pose_render_grad = True
    tt = TTrainer(cfg, device="cpu")
    tt.init_full()
    ex = dataset_example(tds)
    ex["pose_target"] = np.zeros((1, ex["src_cameras"].shape[1], 6), np.float32)
    aux = tt.train_iteration(ex, "pose_only")
    for key in ("pose_distill_loss", "pose_selfdistill_loss", "pose_teacher_loss"):
        assert np.isfinite(float(aux[key])) and float(aux[key]) > 0, key
    assert float(aux["loss_all"]) > float(aux["sfm_loss"])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in tt.model.pose_learner.parameters())

    only_teacher = port_cfg(graft._dryrun_cfg())
    only_teacher.train.pose_teacher_weight = 1.0
    only_teacher.train.sfm_weight = 0.0
    tt = TTrainer(only_teacher, device="cpu")
    tt.init_full()
    tt.train_iteration(dataset_example(tds), "pose_only")
    # The teacher reads the last pose iterate, which the update block's
    # head makes (the init head's output is detached before it).
    assert any(p.grad.abs().max() > 0 for p in tt.model.pose_learner.update_block_pose.pose_head.parameters())
