"""The port's finetune slice against the JAX package, on the CPU: the
encoder's crop, precomputed-features and features-only paths, one whole
deferred back-propagation step of GGRtFinetuneTrainer, the augmentation and
crop shims, `finetune_config` and the finetune CLI; and, within the port,
deferred back-propagation against plain autograd.

Inputs are made with numpy from a seed and given to both sides; parameters
are made by the JAX package and reach the port through
`ggrt_official_torch.weights`. The JAX decoder renders with its tiled
backend, the port's with the plain versions of its kernels. Each test
states its tolerance.
"""
import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu import config as jcfg
from ggrt_official_tpu.data import datasets as jds
from ggrt_official_tpu.data import shims as jshims
from ggrt_official_tpu.models import depth_predictor as jdp
from ggrt_official_tpu.models import pixelsplat as jps
from ggrt_official_tpu.models.ggrt import GGRtModel as JModel
from ggrt_official_tpu.training import state as jstate
from ggrt_official_tpu.training.trainer import GGRtFinetuneTrainer as JFinetune
from ggrt_official_tpu.training.trainer import GGRtTrainer as JTrainer
from ggrt_official_torch import config as tcfg
from ggrt_official_torch import weights
from ggrt_official_torch.data import shims as tshims
from ggrt_official_torch.losses.criterion import masked_l2_image_loss
from ggrt_official_torch.models import pixelsplat as tps
from ggrt_official_torch.models.ggrt import GGRtModel as TModel
from ggrt_official_torch.scripts import finetune_ggrt
from ggrt_official_torch.training.checkpoint import CheckPointManager
from ggrt_official_torch.training.loop import checkpoint_state
from ggrt_official_torch.training.trainer import GGRtFinetuneTrainer as TFinetune
from ggrt_official_torch.training.trainer import GGRtTrainer as TTrainer
from tests.test_torch_eval import one_torch_thread  # noqa: F401  (module fixture)
from tests.test_torch_models import port_cfg
from tests.test_torch_slice import to_torch
from tests.test_torch_train import adam_mu, close, dataset_example, t

FIELDS = ("means", "covariances", "harmonics", "opacities")
CROPS = [(0, 0), (0, 1), (1, 1)]


def gaussians_close(out, ref, name):
    """test_torch_slice.py::test_gaussians_match's criterion: rtol 1e-4
    (atol 1e-5) for at least 99% of the elements, every element within
    rtol 1e-3, atol 1e-3 (float32 triangulation noise, amplified by the
    depth positional encoding, in both packages)."""
    ref = np.asarray(ref)
    out = np.asarray(out)
    assert out.shape == ref.shape, name
    within = np.isclose(out, ref, rtol=1e-4, atol=1e-5)
    assert within.mean() >= 0.99, f"{name}: {within.mean():.4f} within rtol 1e-4"
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3, err_msg=name)


def grads_close(port_grads: dict, jax_grads: dict, whole=5e-3, each=3e-2):
    """test_torch_train.py::check_step's gradient criterion: the whole
    gradient to `whole` and each tensor to `each` in relative L2 norm
    (sums over many tokens with cancellation keep about two digits of
    float32 in either package). A parameter that nothing reads has no
    .grad in the port and zeros in JAX."""
    num = den = 0.0
    for name, g_j in jax_grads.items():
        g_t = port_grads[name] if port_grads[name] is not None else torch.zeros_like(g_j)
        g_t, g_j = g_t.double().numpy(), g_j.double().numpy()
        err = np.linalg.norm(g_t - g_j)
        assert err <= each * np.linalg.norm(g_j) + 1e-30, name
        num, den = num + err**2, den + np.sum(g_j**2)
    assert den > 0 and np.sqrt(num / den) <= whole, np.sqrt(num / den)


# --- the encoder's crop and features paths --------------------------------------

@pytest.fixture(scope="module")
def enc():
    """_tiny_cfg() widths, 32x64 views with 3 source views (2 context
    pairs), deterministic depths. JAX computes, jitted with traced crop
    indices, each tile's Gaussians and the gradient of a seeded weighted sum
    of them; and the features-only and precomputed-features paths."""
    cfg = graft._tiny_cfg()
    pcfg = port_cfg(cfg)
    ex = dataset_example(jds)
    jb = jax.tree_util.tree_map(jnp.asarray, jshims.get_data_shim(cfg.encoder)(
        {"context": ex["context"], "target": ex["target"]}))
    model = jps.PixelSplat(cfg.encoder, cfg.decoder)
    params = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, 0, deterministic=True))(jb)
    ctx = jb["context"]
    rng = np.random.RandomState(5)
    shapes = {}

    def weighted(g):
        return sum(jnp.sum(getattr(g, f) * shapes[f]) for f in FIELDS)

    @jax.jit
    def tile(p, i, j):
        def loss(p):
            g = model.apply(p, ctx, 0, crop=(i, j, 2), deterministic=True, method=jps.PixelSplat.encode_pairs)
            return weighted(g), g
        return jax.value_and_grad(loss, has_aux=True)(p)

    probe = jax.eval_shape(lambda: model.apply(params, ctx, 0, crop=(0, 0, 2), deterministic=True,
                                               method=jps.PixelSplat.encode_pairs))
    for f in FIELDS:
        shapes[f] = jnp.asarray(rng.normal(size=getattr(probe, f).shape).astype(np.float32))

    @jax.jit
    def from_features(p):
        feats = model.apply(p, ctx, 0, method=jps.PixelSplat.encode_features)
        return feats, model.apply(p, ctx, 0, features=feats, deterministic=True,
                                  method=jps.PixelSplat.encode_pairs)

    tiles = {c: tile(params, *c) for c in CROPS}
    port = tps.PixelSplat(pcfg.encoder, pcfg.decoder, device="cpu")
    port.load_state_dict(weights.params_from_jax(jax.tree_util.tree_map(np.asarray, params), pcfg.encoder))
    tb = to_torch(tshims.get_data_shim(pcfg.encoder)({"context": ex["context"], "target": ex["target"]}))
    return dict(pcfg=pcfg, port=port, tctx=tb["context"], tiles=tiles, features=from_features(params),
                weights={f: t(w) for f, w in shapes.items()})


@pytest.mark.parametrize("crop", CROPS, ids=lambda c: f"tile{c[0]}{c[1]}")
def test_crop_encoder_matches_jax(enc, crop):
    """One tile of crop_size 2: its Gaussians ((pairs, 2·hc·wc, ...)) by
    gaussians_close and the parameter gradients of a seeded weighted sum of
    them by grads_close."""
    (_, jg), jgrads = enc["tiles"][crop]
    port = enc["port"]
    port.zero_grad()
    g = port.encode_pairs(enc["tctx"], 0, deterministic=True, crop=(*crop, 2))
    assert g.means.shape == (1, 2 * 2 * 16 * 32, 3)
    for f in FIELDS:
        gaussians_close(getattr(g, f).detach().numpy(), getattr(jg, f), f"{crop} {f}")
    sum(torch.sum(getattr(g, f) * enc["weights"][f]) for f in FIELDS).backward()
    jg_t = weights.params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads), enc["pcfg"].encoder)
    grads_close({k: p.grad for k, p in port.named_parameters()}, jg_t)


def test_features_paths_match_jax(enc):
    """encode_features (the backbone alone) to rtol 1e-4, atol 1e-4 (float32
    convolution sums in another order, on features of magnitude 1-10); the
    Gaussians from those features by gaussians_close; and the features
    path gives the port's own full-image Gaussians bit for bit."""
    jfeats, jg = enc["features"]
    port, ctx = enc["port"], enc["tctx"]
    with torch.no_grad():
        feats = port.encode_features(ctx, 0)
        close(feats, jfeats, rtol=1e-4, atol=1e-4)
        g = port.encode_pairs(ctx, 0, deterministic=True, features=feats)
        whole = port.encode_pairs(ctx, 0, deterministic=True)
    for f in FIELDS:
        gaussians_close(getattr(g, f).numpy(), getattr(jg, f), f)
        assert torch.equal(getattr(g, f), getattr(whole, f)), f


def test_pair_order(enc):
    """make_pair_batch's `order` permutes the views before pairing, as
    JAX's take does."""
    ctx = {k: v for k, v in enc["tctx"].items() if k != "index"}
    out = tps.make_pair_batch(ctx, order=[2, 0, 1])
    ref = jps.make_pair_batch({k: jnp.asarray(v.numpy()) for k, v in ctx.items()}, order=jnp.array([2, 0, 1]))
    for k in ctx:
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]), err_msg=k)


# --- one whole finetune step ----------------------------------------------------

def patched_sampler(draws: dict):
    """JAX's draw at depth_predictor.py:27 replaced by fixed uniforms chosen
    by the number of rays: the whole view's, or the one set every tile gets."""

    def sample(key, pdf, num_samples):
        u = draws[pdf.shape[2]]
        normalized = pdf / (jdp._EPS + jnp.sum(pdf, axis=-1, keepdims=True))
        cdf = jnp.cumsum(normalized, axis=-1)
        index = jnp.sum((cdf[..., :, None] <= u[..., None, :]).astype(jnp.int32), axis=-2)
        index = jnp.clip(index, 0, pdf.shape[-1] - 1)
        return index, jnp.take_along_axis(normalized, index, axis=-1)

    return sample


@pytest.fixture(scope="module")
def step_case():
    """_dryrun_cfg() widths (_tiny_cfg()'s with one GRU step and narrower
    layers, as test_torch_train.py::step_case uses: at _tiny_cfg() widths
    JAX's first finetune step takes about 60 s on the CPU, at these about
    35 s), crop_size 2, the dataset's poses (finetune's use_pred_pose off);
    JAX parameters from jitted inits (as step_case makes them); seeded
    uniforms for the whole render and for the tiles."""
    cfg = graft._dryrun_cfg()
    cfg.train.crop_size = 2
    cfg.train.use_pred_pose = False
    model = JModel(cfg)
    ex = dataset_example(jds)
    jb = JTrainer(cfg).prepare_batch(ex)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    pose = jax.jit(lambda b: model.init(
        {"params": k1}, b["rgb"], b["src_rgbs"], b["camera"], b["src_cameras"],
        b["depth_range"][0, 0], b["depth_range"][0, 1], compute_sfm_loss=False, method="iponet"))(jb)
    gauss = jax.jit(lambda b: model.init({"params": k1, "sample": k2}, b, 0, deterministic=True,
                                         method="gaussian_forward"))(jb)
    params = {"params": {"pose_learner": pose["params"]["pose_learner"],
                         "gaussian": gauss["params"]["gaussian"]}}
    pcfg = port_cfg(cfg)
    enc = pcfg.encoder
    rng = np.random.RandomState(9)
    full = rng.uniform(size=(2, 2, 32 * 64, enc.num_surfaces, enc.gaussians_per_pixel)).astype(np.float32)
    tile = rng.uniform(size=(2, 2, 16 * 32, enc.num_surfaces, enc.gaussians_per_pixel)).astype(np.float32)
    return dict(cfg=cfg, pcfg=pcfg, params=params, ex=ex, full=full, tile=tile)


def test_finetune_step_matches_jax(step_case, monkeypatch):
    """One 'joint' step of GGRtFinetuneTrainer from JAX's parameters, loaded
    into the port's trainer through weights.ggrt_params_from_jax (the crop
    path adds no parameter): loss_all and psnr to rtol 1e-4; the clipped
    gradients of both groups (read from JAX's first Adam moment, 0.1·g) by
    grads_close; the updated parameters of both groups by
    test_torch_train.py::check_step's criterion (at least 99% of the moved
    elements within 1% of their tensor's largest update plus two ulps)."""
    c = step_case
    monkeypatch.setattr(jdp, "sample_discrete_distribution",
                        patched_sampler({32 * 64: jnp.asarray(c["full"]), 16 * 32: jnp.asarray(c["tile"])}))
    jt = JFinetune(c["cfg"])
    jt.state = jstate.create_train_state(c["cfg"], c["params"])
    jaux = jax.tree_util.tree_map(np.asarray, jt.train_iteration(c["ex"], "joint"))
    pcfg = c["pcfg"]
    mu = {"params": {"pose_learner": adam_mu(jt.state.pose_opt_state)["params"]["pose_learner"],
                     "gaussian": adam_mu(jt.state.gaussian_opt_state)["params"]["gaussian"]}}
    jgrads = weights.ggrt_params_from_jax(jax.tree_util.tree_map(lambda x: np.asarray(x) / 0.1, mu), pcfg)
    after = weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, jt.state.params), pcfg)

    tt = TFinetune(pcfg, device="cpu")
    tt.init_full()
    before = weights.ggrt_params_from_jax(jax.tree_util.tree_map(np.asarray, c["params"]), pcfg)
    tt.model.load_state_dict(before)
    aux = tt.train_iteration(c["ex"], "joint", uniforms=(t(c["full"]), [t(c["tile"])] * 4))
    assert tt.state.step == 1
    for key in ("loss_all", "psnr"):
        close(aux[key], jaux[key], rtol=1e-4, atol=1e-6, err_msg=key)
    close(aux["rel_poses"], jaux["rel_poses"], rtol=1e-4, atol=1e-5)

    named = dict(tt.model.named_parameters())
    grads_close({k: p.grad for k, p in named.items()}, {k: jgrads[k] for k in named})
    assert any(float(named[k].grad.abs().max()) > 0 for k in named if k.startswith("gaussian."))
    state = tt.model.state_dict()
    within = moved = 0
    for name in named:
        dj = (after[name] - before[name]).numpy()
        dt = (state[name] - before[name]).numpy()
        tol = 1e-2 * np.abs(dj).max() + 2 * np.spacing(np.abs(before[name].numpy()))
        within += int((np.abs(dt - dj) <= tol).sum())
        moved += dj.size
    assert within >= 0.99 * moved, within / moved


def test_deferred_bp_is_plain_autograd(step_case):
    """At crop_size 1 the single tile is the whole view, so the injected
    pixel gradients must give the gradients that plain autograd of
    masked_l2_image_loss on the whole render gives with the same draws
    (relative L2 <= 1e-6 per group; no clipping, so .grad holds them)."""
    pcfg = copy.deepcopy(step_case["pcfg"])
    pcfg.train.crop_size = 1
    pcfg.train.optimizer.grad_clip_norm = 0.0
    u = t(step_case["full"])
    tt = TFinetune(pcfg, device="cpu")
    tt.init_full()
    start = copy.deepcopy(tt.model.state_dict())
    tt.train_iteration(step_case["ex"], "joint", uniforms=(u, [u]))

    ref = TModel(pcfg, device="cpu")
    ref.load_state_dict(start)
    batch = tt.prepare_batch(step_case["ex"])
    min_d, max_d = batch["depth_range"][0, 0], batch["depth_range"][0, 1]
    _, _, sfm, _ = ref.iponet(batch["rgb"], batch["src_rgbs"], batch["camera"], batch["src_cameras"],
                              min_d, max_d)
    ret, gt = ref.gaussian(batch, 0, deterministic=False, uniforms=u, depth_mode=None)
    (sfm["loss"] + masked_l2_image_loss(ret, gt)).backward()
    def flat(module):
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                          for p in module.parameters()]).double()

    for group in ("pose_learner", "gaussian"):
        got, want = flat(getattr(tt.model, group)), flat(getattr(ref, group))
        assert want.norm() > 0, group
        assert (got - want).norm() <= 1e-6 * want.norm(), group


# --- shims, config, CLI ---------------------------------------------------------

def example_views(seed, hw=(16, 24)):
    rng = np.random.RandomState(seed)
    h, w = hw

    def views(v):
        return {"image": rng.uniform(size=(1, v, 3, h, w)).astype(np.float32),
                "extrinsics": rng.normal(size=(1, v, 4, 4)).astype(np.float32),
                "intrinsics": np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32),
                                      (1, v, 1, 1)),
                "index": np.arange(v)[None]}

    return {"context": views(3), "target": views(1)}


@pytest.mark.parametrize("seed", [0, 1])
def test_augmentation_shim_matches_jax(seed):
    """Bit for bit, at a seed that flips (0: rand() = 0.549) and one that
    does not (1: rand() = 0.417 < 0.5)."""
    batch = example_views(3)
    flips = np.random.RandomState(seed).rand() >= 0.5
    out = tshims.apply_augmentation_shim(batch, np.random.RandomState(seed))
    ref = jshims.apply_augmentation_shim(batch, np.random.RandomState(seed))
    for part in ("context", "target"):
        for key in batch[part]:
            np.testing.assert_array_equal(np.asarray(out[part][key]), np.asarray(ref[part][key]))
        assert flips != np.array_equal(out[part]["image"], batch[part]["image"])


def test_crop_shim_matches_jax():
    """Rescale (PIL Lanczos) and centre-crop 16x24 views to 16x16, bit for
    bit: images and intrinsics."""
    pytest.importorskip("PIL")
    batch = example_views(4)
    out = tshims.apply_crop_shim(batch, (16, 16))
    ref = jshims.apply_crop_shim(batch, (16, 16))
    for part in ("context", "target"):
        assert out[part]["image"].shape[-2:] == (16, 16)
        for key in ("image", "intrinsics", "extrinsics"):
            np.testing.assert_array_equal(np.asarray(out[part][key]), np.asarray(ref[part][key]))


def test_finetune_config_is_the_jax_finetune_config():
    assert dataclasses.asdict(tcfg.finetune_config()) == dataclasses.asdict(port_cfg(jcfg.finetune_config()))
    assert tcfg.finetune_config(**{"train.crop_size": 4}).train.crop_size == 4


def test_finetune_cli(tmp_path):
    """The finetune CLI in-process at --tiny widths on the CPU, two steps
    from a checkpoint that a pretrain trainer wrote (--ckpt: the pretrain ->
    finetune chain): it resumes, logs and saves step 2, and both parameter
    groups have moved from the pretrain weights. Without --synthetic it
    reads the LLFF-format scene --scene under --rootdir: one step on a
    16x32 scene the test writes (a crop tile's width must stay a multiple
    of the epipolar transformer's downscale times its patch size); an
    absent folder raises."""
    from tests.test_torch_data import write_llff_scene

    with pytest.raises(FileNotFoundError):
        finetune_ggrt.main(["--device", "cpu", "--rootdir", str(tmp_path / "none"), "--out", str(tmp_path / "none")])
    write_llff_scene(tmp_path / "llff" / "nerf_llff_data" / "room", hw=(16, 32))
    finetune_ggrt.main(["--tiny", "--device", "cpu", "--rootdir", str(tmp_path / "llff"), "--scene", "room",
                        "--n_iters", "1", "--out", str(tmp_path / "llff_ft")])
    assert os.readlink(tmp_path / "llff_ft" / "checkpoints" / "latest") == "ckpt_00000001"
    pre = TTrainer(tcfg.tiny_config(), device="cpu")
    pre.init_full()
    pre_dir = str(tmp_path / "pre" / "checkpoints")
    CheckPointManager(pre_dir).save(0, checkpoint_state(pre))
    out = tmp_path / "ft"
    finetune_ggrt.main(["--synthetic", "--tiny", "--n_iters", "2", "--device", "cpu", "--out", str(out),
                        "--ckpt", os.path.join(pre_dir, "latest")])
    log = (out / "log.txt").read_text()
    assert "resumed from step 0" in log and "step 2: loss=" in log
    assert os.readlink(out / "checkpoints" / "latest") == "ckpt_00000002"
    saved = CheckPointManager(str(out / "checkpoints")).load()["state"]["model"]
    moved = [k for k, v in saved.items() if not torch.equal(v, pre.model.state_dict()[k])]
    assert any(k.startswith("gaussian.") for k in moved) and any(k.startswith("pose_learner.") for k in moved)
