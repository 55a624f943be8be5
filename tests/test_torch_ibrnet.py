"""The port's IBRNet, ResUNet, IBRNetModel and DBARFModel (models/
{ibrnet,feature_unet,dbarf}.py) against the JAX package's on the CPU, with
the weights the JAX package initialises (converted by weights.py), and the
name maps against both trees.

IBRNet runs with anti-alias pooling on and off, on a mask where some
samples have fewer than 2 valid views, so the ray attention's query-row
mask (kept from the reference) fires. ResUNet runs at an even size (flax's
"SAME" pads stride-2 convolutions asymmetrically there) and at an odd one,
neither divisible by 16, so the bilinear upsamplings have ratios other
than 2. The module fixture computes every JAX result once, each through
jax.jit. Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_torch import weights
from ggrt_official_torch.models import dbarf as tdbarf
from ggrt_official_torch.models import feature_unet as tunet
from ggrt_official_torch.models import ibrnet as tibr
from ggrt_official_tpu.models import dbarf as jdbarf
from ggrt_official_tpu.models import feature_unet as junet
from ggrt_official_tpu.models import ibrnet as jibr
from tests.test_torch_models import port_cfg

R, S, V, F_CH = 5, 8, 4, 6
SIZES = {"even": (36, 52), "odd": (37, 53)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(x):
    return torch.tensor(np.asarray(x))


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual.detach(), np.float64), np.asarray(expected, np.float64), **tol)


def leaves(tree) -> dict:
    """flax path (tuple of names) -> shape of every leaf."""
    return {tuple(k.key for k in path): leaf.shape for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def ibrnet_inputs(seed=0, r=R, s=S, v=V, f=F_CH):
    """rgb_feat, ray_diff (unit directions and a dot in [-1, 1]) and a mask
    in which sample (0, *) has no valid view, (1, *) one, (2, 0..3) two."""
    rng = np.random.RandomState(seed)
    rgb_feat = rng.normal(size=(r, s, v, 3 + f)).astype(np.float32)
    rgb_feat[..., :3] = rng.uniform(size=(r, s, v, 3))
    d = rng.normal(size=(r, s, v, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    ray_diff = np.concatenate([d, rng.uniform(0.5, 1.0, (r, s, v, 1))], -1).astype(np.float32)
    mask = (rng.uniform(size=(r, s, v, 1)) > 0.3).astype(np.float32)
    mask[0] = 0
    mask[1] = 0
    mask[1, :, 2] = 1
    mask[2, :4] = 0
    mask[2, :4, :2] = 1
    return rgb_feat, ray_diff, mask


def images(size, n=2, seed=1):
    return np.random.RandomState(seed).uniform(size=(n, *size, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jx():
    out = {}
    ins = ibrnet_inputs()
    for aa in (True, False):
        net = jibr.IBRNet(in_feat_ch=F_CH, n_samples=S, anti_alias_pooling=aa)
        params = net.init(jax.random.PRNGKey(1), *ins)
        out[f"ibrnet_{aa}"] = (params, np.asarray(jax.jit(net.apply)(params, *ins)))
    for name, size in SIZES.items():
        for coarse_only in (True, False):
            net = junet.ResUNet(coarse_out_ch=8, fine_out_ch=4, coarse_only=coarse_only)
            x = images(size)
            params = net.init(jax.random.PRNGKey(2), x)
            res = jax.jit(net.apply)(params, x)
            out[f"unet_{name}_{coarse_only}"] = (params, [None if a is None else np.asarray(a) for a in res])

    # IBRNetModel with a fine net, at tiny widths (6 channels each: the JAX
    # model's init runs both nets on the same inputs).
    cfg = graft._tiny_cfg()
    model = jdbarf.IBRNetModel(cfg, coarse_feat_dim=F_CH, fine_feat_dim=F_CH, coarse_only=False, n_samples=S,
                               n_importance=4)
    x = images(SIZES["even"], n=V)
    fine_ins = ibrnet_inputs(seed=3, s=S + 4)
    params = model.init(jax.random.PRNGKey(3), x, *ins)
    out["model"] = (params, {
        "feats": [np.asarray(a) for a in jax.jit(lambda p: model.apply(p, x, method="extract_features"))(params)],
        "coarse": np.asarray(jax.jit(lambda p: model.apply(p, *ins, method="coarse"))(params)),
        "fine": np.asarray(jax.jit(lambda p: model.apply(p, *fine_ins, method="fine"))(params)),
    })

    # DBARFModel.correct_poses at tiny IPO-Net widths, 3 reference views at 32x48.
    dmodel = jdbarf.DBARFModel(cfg)
    rng = np.random.RandomState(4)
    K = np.array([[[30.0, 0, 23.5], [0, 30.0, 15.5], [0, 0, 1]]], np.float32)
    pose_ins = (rng.uniform(size=(1, 3, 32, 48)).astype(np.float32), rng.uniform(size=(3, 3, 32, 48)).astype(np.float32),
                K, np.repeat(K, 3, axis=0))
    pose_params = jax.jit(lambda a: dmodel.init(jax.random.PRNGKey(5), *a, 0.5, 20.0, method="correct_poses"))(pose_ins)
    res = jax.jit(lambda p, a: dmodel.apply(p, *a, 0.5, 20.0, method="correct_poses"))(pose_params, pose_ins)
    ibr_params = jax.eval_shape(lambda: dmodel.init(jax.random.PRNGKey(5), x, *ibrnet_inputs(f=64)))
    out["dbarf"] = (pose_params, ibr_params, pose_ins, [np.asarray(a) for a in res])
    return out


@pytest.mark.parametrize("aa", [True, False])
def test_ibrnet_matches_jax(jx, aa):
    """(r, s, 4) rgb+sigma with anti-alias pooling on and off: rtol 1e-5,
    atol 2e-6. Samples with no valid view give sigma 0; those with one
    valid view are query rows that the ray attention masks whole (their
    scores all -1e9, a uniform softmax), and agree like the rest."""
    params, want = jx[f"ibrnet_{aa}"]
    net = tibr.IBRNet(in_feat_ch=F_CH, n_samples=S, anti_alias_pooling=aa)
    net.load_state_dict(weights.ibrnet_params_from_jax(jax.tree_util.tree_map(np.asarray, params), aa))
    got = net(*(t(a) for a in ibrnet_inputs()))
    assert got.shape == (R, S, 4)
    close(got, want, rtol=1e-5, atol=2e-6)
    assert float(got[0, :, 3].abs().max()) == 0.0


def test_attention_masks_query_rows():
    """The mask (r, s, 1) broadcasts as (r, 1, s, 1) over the scores (r, h,
    s, s): a masked sample's whole row of scores is -1e9 (its softmax
    uniform over every key), and no key column is masked."""
    gen = torch.Generator().manual_seed(0)
    mha = tibr.MultiHeadAttention(4, 16, 4, 4)
    g = torch.randn(2, 6, 16, generator=gen)
    mask = torch.ones(2, 6, 1)
    mask[0, 2] = 0
    _, attn = mha(g, g, g, mask=mask)
    torch.testing.assert_close(attn[0, :, 2], torch.full((4, 6), 1 / 6))
    assert not torch.allclose(attn[0, :, 3], torch.full((4, 6), 1 / 6))
    assert bool((attn[0, :, :, 2] > 0).all())


@pytest.mark.parametrize("size", list(SIZES))
@pytest.mark.parametrize("coarse_only", [True, False])
def test_resunet_matches_jax(jx, size, coarse_only):
    """Coarse (and fine) maps at half the input size, at 36x52 (asymmetric
    "SAME" padding, upsampling 9x13 -> 18x26) and 37x53 (symmetric, 10x14
    -> 18x26): rtol 1e-4, atol 1e-4 (13 instance-normed layers of sums in
    another order)."""
    params, want = jx[f"unet_{size}_{coarse_only}"]
    net = tunet.ResUNet(coarse_out_ch=8, fine_out_ch=4, coarse_only=coarse_only)
    net.load_state_dict(weights.resunet_params_from_jax(jax.tree_util.tree_map(np.asarray, params)))
    got = net(t(images(SIZES[size])))
    h2, w2 = SIZES[size][0] // 2, SIZES[size][1] // 2
    assert got[0].shape == (2, h2, w2, 8)
    close(got[0], want[0], rtol=1e-4, atol=1e-4)
    if coarse_only:
        assert got[1] is None and want[1] is None
    else:
        assert got[1].shape == (2, h2, w2, 4)
        close(got[1], want[1], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n,k,s", [(36, 3, 2), (37, 3, 2), (36, 7, 2), (37, 7, 2), (18, 1, 2), (19, 3, 1)])
def test_same_padding_is_flax(n, k, s):
    """The padding flax's "SAME" takes: (0, 1) for a 3x3 stride-2
    convolution on an even size, (2, 3) for 7x7, symmetric on odd sizes,
    none for 1x1, and the output size ceil(n / s)."""
    lo, hi = tunet.same_pad(n, k, s)
    want = {(36, 3, 2): (0, 1), (37, 3, 2): (1, 1), (36, 7, 2): (2, 3), (37, 7, 2): (3, 3),
            (18, 1, 2): (0, 0), (19, 3, 1): (1, 1)}[(n, k, s)]
    assert (lo, hi) == want
    assert (n + lo + hi - k) // s + 1 == -(-n // s)


def test_ibrnet_model_matches_jax(jx):
    """IBRNetModel with a fine net over 12 samples: the feature maps (rtol 1e-4, atol 1e-4),
    the coarse and the fine net's outputs (rtol 1e-5, atol 2e-6)."""
    params, want = jx["model"]
    model = tdbarf.IBRNetModel(port_cfg(graft._tiny_cfg()), coarse_feat_dim=F_CH, fine_feat_dim=F_CH,
                               coarse_only=False, n_samples=S, n_importance=4, device="cpu")
    model.load_state_dict(weights.ibrnet_model_params_from_jax(jax.tree_util.tree_map(np.asarray, params), False))
    feats = model.extract_features(t(images(SIZES["even"], n=V)))
    for got, w in zip(feats, want["feats"]):
        close(got, w, rtol=1e-4, atol=1e-4)
    close(model.coarse(*(t(a) for a in ibrnet_inputs())), want["coarse"], rtol=1e-5, atol=2e-6)
    close(model.fine(*(t(a) for a in ibrnet_inputs(seed=3, s=S + 4))), want["fine"], rtol=1e-5, atol=2e-6)


def test_dbarf_correct_poses_matches_jax(jx):
    """DBARFModel.correct_poses is IPO-Net at the model's config: inverse
    depths, relative poses and the feature map, rtol 1e-4, atol 1e-5 (the
    IPO-Net parity tests' tolerance)."""
    pose_params, _, ins, want = jx["dbarf"]
    pcfg = port_cfg(graft._tiny_cfg())
    model = tdbarf.DBARFModel(pcfg, device="cpu")
    state = weights.iponet_params_from_jax(jax.tree_util.tree_map(np.asarray, pose_params)["params"]["pose_learner"],
                                           pcfg.iponet)
    missing, unexpected = model.load_state_dict({"pose_learner." + k: v for k, v in state.items()}, strict=False)
    assert not unexpected and all(k.startswith("ibrnet.") for k in missing)
    got = model.correct_poses(*(t(a) for a in ins), 0.5, 20.0)
    for g, w in zip(got, want):
        close(g, w, rtol=1e-4, atol=1e-5)


def test_fresh_models_build_as_flax_does():
    """A fresh port model: IBRNet's s at 0.2, instance-norm scales 1 and
    biases 0, lecun-normal kernels with the spread of flax's (10%), on
    the device asked for."""
    model = tdbarf.IBRNetModel(port_cfg(graft._tiny_cfg()), device="cpu", generator=torch.Generator().manual_seed(1))
    sd = model.state_dict()
    assert float(sd["net_coarse.s"]) == pytest.approx(0.2)
    assert bool((sd["feature_net.norm1.weight"] == 1).all()) and float(sd["feature_net.norm1.bias"].abs().max()) == 0
    w = sd["feature_net.layer3_b1.conv1.weight"]
    assert abs(w.std().item() - (1 / (256 * 9)) ** 0.5) / (1 / (256 * 9)) ** 0.5 < 0.1
    assert all(p.device.type == "cpu" for p in model.parameters())


@pytest.mark.parametrize("which", ["ibrnet_aa", "ibrnet", "resunet", "model_coarse", "model_fine", "dbarf"])
def test_name_maps_cover_both_trees(jx, which):
    """Every leaf of the flax tree and every key of the port's state_dict is
    one row of the name map, with shapes that convert into each other."""
    pcfg = port_cfg(graft._tiny_cfg())
    if which.startswith("ibrnet"):
        aa = which == "ibrnet_aa"
        tree, rows = jx[f"ibrnet_{aa}"][0]["params"], weights.ibrnet_name_map(aa)
        port = tibr.IBRNet(in_feat_ch=F_CH, n_samples=S, anti_alias_pooling=aa)
    elif which == "resunet":
        tree, rows = jx["unet_even_False"][0]["params"], weights.resunet_name_map()
        port = tunet.ResUNet(coarse_out_ch=8, fine_out_ch=4)
    elif which.startswith("model"):
        coarse_only = which == "model_coarse"
        jmodel = jdbarf.IBRNetModel(graft._tiny_cfg(), coarse_feat_dim=F_CH, fine_feat_dim=F_CH,
                                    coarse_only=coarse_only, n_samples=S)
        ins = ibrnet_inputs()
        tree = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), images(SIZES["even"], n=V), *ins))["params"]
        rows = weights.ibrnet_model_name_map(coarse_only)
        port = tdbarf.IBRNetModel(pcfg, coarse_feat_dim=F_CH, fine_feat_dim=F_CH, coarse_only=coarse_only, n_samples=S,
                                  device="cpu")
    else:
        pose_params, ibr_params, _, _ = jx["dbarf"]
        tree = {**ibr_params["params"], **pose_params["params"]}
        rows = weights.dbarf_name_map(pcfg.iponet)
        port = tdbarf.DBARFModel(pcfg, device="cpu")
    flax_leaves = leaves(tree)
    port_keys = {k: v.shape for k, v in port.state_dict().items()}
    assert {k for k, _, _ in rows} == set(port_keys)
    assert {p for _, p, _ in rows} == set(flax_leaves)
    assert len(rows) == len(port_keys) == len(flax_leaves)
    for key, path, kind in rows:
        converted = weights._from_flax(kind, np.zeros(flax_leaves[path], np.float32))
        assert converted.shape == tuple(port_keys[key]), key
