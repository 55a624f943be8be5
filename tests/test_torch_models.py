"""The port's encoder modules against their flax counterparts, on the CPU.

Widths are those of __graft_entry__._tiny_cfg(); the flax parameters come
from one jitted `init` of the tiny PixelSplat and reach the port through
`weights.params_from_jax`. Unless a test says otherwise the tolerance is
rtol 1e-4, atol 1e-5 in float32: the same operations summed in another
order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from ggrt_official_tpu.data.shims import get_data_shim as jshim
from ggrt_official_tpu.geometry import epipolar as jepi
from ggrt_official_tpu.models import backbone as jbb
from ggrt_official_tpu.models import depth_predictor as jdp
from ggrt_official_tpu.models import epipolar_sampler as jes
from ggrt_official_tpu.models import epipolar_transformer as jet
from ggrt_official_tpu.models import gaussian_adapter as jga
from ggrt_official_tpu.models import pixelsplat as jps
from ggrt_official_tpu.models import transformer as jtr
from ggrt_official_torch import config as tcfg
from ggrt_official_torch import weights
from ggrt_official_torch.geometry import epipolar as tepi
from ggrt_official_torch.models import depth_predictor as tdp
from ggrt_official_torch.models import epipolar_sampler as tes
from ggrt_official_torch.models import gaussian_adapter as tga
from ggrt_official_torch.models import pixelsplat as tps

TOL = dict(rtol=1e-4, atol=1e-5)


def port_cfg(jax_cfg) -> tcfg.GGRtConfig:
    """The port's config with the same field values as a JAX config."""
    out = tcfg.GGRtConfig()

    def copy(dst, src):
        for f in dataclasses.fields(src):
            v = getattr(src, f.name)
            if dataclasses.is_dataclass(v):
                copy(getattr(dst, f.name), v)
            else:
                setattr(dst, f.name, v)

    copy(out, jax_cfg)
    out.decoder.backend = "cuda"
    return out


def t(x, dtype=None):
    return torch.tensor(np.asarray(x), dtype=dtype)


def close(actual, expected, **tol):
    np.testing.assert_allclose(np.asarray(actual), np.asarray(expected), **(tol or TOL))


def look_at(center, target=(0.0, 0.0, 4.0)):
    f = np.asarray(target) - center
    f = f / np.linalg.norm(f)
    r = np.cross([0.0, 1.0, 0.0], f)
    r = r / np.linalg.norm(r)
    m = np.eye(4)
    m[:3, :3] = np.stack([r, np.cross(f, r), f], axis=1)
    m[:3, 3] = center
    return m


def wide_pair():
    """Two cameras 2 units apart looking at a point 4 units away: the
    epipolar rays meet at wide angles, so triangulation is well posed."""
    E = np.stack([look_at(np.array([-1.0, 0.05, 0.0])), look_at(np.array([1.0, -0.05, 0.1]))])
    I = np.array([[1.2, 0, 0.5], [0, 2.4, 0.5], [0, 0, 1]])
    return dict(
        extrinsics=E[None].astype(np.float32),
        intrinsics=np.broadcast_to(I, (1, 2, 3, 3)).astype(np.float32),
        near=np.full((1, 2), 1.0, np.float32),
        far=np.full((1, 2), 10.0, np.float32),
    )


@pytest.fixture(scope="module")
def setup():
    """One jitted flax init of the tiny PixelSplat, the port loaded with
    the same weights, and the dataset's context pairs."""
    cfg = graft._tiny_cfg()
    batch, _ = graft._example_batch()
    shimmed = jax.tree_util.tree_map(
        jnp.asarray, jshim(cfg.encoder)({"context": batch["context"], "target": batch["target"]})
    )
    model = jps.PixelSplat(cfg.encoder, cfg.decoder)
    params = jax.jit(lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, 0, deterministic=True))(shimmed)
    params = jax.tree_util.tree_map(np.asarray, params)
    pcfg = port_cfg(cfg)
    port = tps.PixelSplat(pcfg.encoder, pcfg.decoder, device="cpu")
    port.load_state_dict(weights.params_from_jax(params, pcfg.encoder))
    pairs = {k: np.asarray(v) for k, v in jps.make_pair_batch(shimmed["context"]).items()}
    return dict(cfg=cfg, pcfg=pcfg, params=params["params"]["encoder"], port=port.encoder, pairs=pairs)


def test_backbone(setup):
    enc = setup["cfg"].encoder.backbone
    x = np.random.RandomState(0).rand(1, 2, 32, 64, 3).astype(np.float32)
    ref = jax.jit(jbb.BackboneResnet(enc.model, enc.num_layers, False, enc.d_out).apply)(
        {"params": setup["params"]["backbone"]}, x)
    with torch.no_grad():
        out = setup["port"].backbone(t(x))
    close(out, ref)


def test_transformer(setup):
    """The image self-attention's transformer: self-attention, LayerNorm
    eps 1e-6 and the tanh GELU of the feed-forward."""
    sa = setup["cfg"].encoder.epipolar_transformer.self_attention
    x = np.random.RandomState(1).randn(2, 16, sa.d_token).astype(np.float32)
    p = setup["params"]["epipolar_transformer"]["transformer"]["ff_0"]["self_attn"]["transformer"]
    ref = jax.jit(jtr.Transformer(sa.d_token, sa.num_layers, sa.num_heads, sa.d_dot, sa.d_mlp).apply)(
        {"params": p}, x)
    mod = setup["port"].epipolar_transformer.transformer.layers[0][1].fn.self_attention.transformer
    with torch.no_grad():
        close(mod(t(x)), ref)


def test_epipolar_sampler(setup):
    pairs = setup["pairs"]
    feats = np.random.RandomState(2).randn(*pairs["image"].shape[:2], 8, 16, 5).astype(np.float32)
    args = (feats, pairs["extrinsics"], pairs["intrinsics"], pairs["near"], pairs["far"])
    ref = jax.jit(jes.sample_epipolar, static_argnames="num_samples")(*args, num_samples=4)
    out = tes.sample_epipolar(*(t(a) for a in args), num_samples=4)
    for name in ref._fields:
        close(getattr(out, name), getattr(ref, name), err_msg=name, **TOL)


@pytest.mark.parametrize("cams", ["wide_pair", "dataset_pairs"])
def test_epipolar_transformer(setup, cams):
    """The whole epipolar transformer, ConvTranspose orientation included.

    On the dataset's pairs (adjacent views 0.14 apart, depths 2-6) the
    epipolar rays are nearly parallel: float32 triangulation is then off a
    float64 solve by up to 1% in both packages (test_triangulation_noise),
    and the depth positional encoding multiplies that by up to 2π·2^(octaves-1).
    There the output is held at the share of elements within TOL; on a
    well-posed pair, at TOL for every element.
    """
    et = setup["cfg"].encoder.epipolar_transformer
    cams_np = wide_pair() if cams == "wide_pair" else {k: setup["pairs"][k] for k in (
        "extrinsics", "intrinsics", "near", "far")}
    b = cams_np["extrinsics"].shape[0]
    feats = np.random.RandomState(3).randn(b, 2, 32, 64, 32).astype(np.float32)
    args = (feats, cams_np["extrinsics"], cams_np["intrinsics"], cams_np["near"], cams_np["far"])
    ref, _ = jax.jit(jet.EpipolarTransformer(et, 32).apply)(
        {"params": setup["params"]["epipolar_transformer"]}, *args)
    with torch.no_grad():
        out, _ = setup["port"].epipolar_transformer(*(t(a) for a in args))
    if cams == "wide_pair":
        close(out, ref)
    else:
        ok = np.isclose(out.numpy(), np.asarray(ref), **TOL)
        assert ok.mean() > 0.8, f"{ok.mean():.3f} of elements within tolerance"
        close(out, ref, rtol=1e-2, atol=2e-3)


def test_triangulation_noise(setup):
    """On the dataset's pairs the port's float32 depths are no further from
    a float64 solve than the reference's own float32 depths are."""
    pairs = setup["pairs"]
    E, I = pairs["extrinsics"], pairs["intrinsics"]
    _, origins, directions = tes.generate_image_rays((8, 16), t(E), t(I))
    xy = np.random.RandomState(4).uniform(0.05, 0.95, (E.shape[0], 2, 1, 128, 4, 2))
    xy = xy.astype(np.float32)
    o, d = origins[:, :, None, :, None], directions[:, :, None, :, None]
    oe = tes.collect_other_views(t(E))[:, :, :, None, None]
    oi = tes.collect_other_views(t(I))[:, :, :, None, None]
    ref32 = np.asarray(jax.jit(jepi.get_depth)(o.numpy(), d.numpy(), xy, oe.numpy(), oi.numpy()),
                       np.float64)
    port32 = tepi.get_depth(o, d, t(xy), oe, oi).numpy().astype(np.float64)
    f64 = lambda x: x.to(torch.float64)
    truth = tepi.get_depth(f64(o), f64(d), t(xy, torch.float64), f64(oe), f64(oi)).numpy()
    err_ref = np.abs(ref32 - truth) / truth
    err_port = np.abs(port32 - truth) / truth
    assert err_port.max() <= 2 * err_ref.max() + 1e-6


def test_depth_predictor(setup):
    enc = setup["cfg"].encoder
    rng = np.random.RandomState(5)
    feats = rng.randn(2, 2, 64, enc.d_feature).astype(np.float32)
    near, far = np.full((2, 2), 1.5, np.float32), np.full((2, 2), 9.0, np.float32)
    mod = jdp.DepthPredictorMonocular(enc.d_feature, enc.num_monocular_samples,
                                      enc.num_surfaces, enc.use_transmittance)
    p = {"params": setup["params"]["depth_predictor"]}
    dj, oj = jax.jit(mod.apply, static_argnums=(4, 5))(p, feats, near, far, True, 1)
    with torch.no_grad():
        dt, ot = setup["port"].depth_predictor(t(feats), t(near), t(far), True, 1)
    close(dt, dj)
    close(ot, oj)
    # The sampling path with the same uniform draws fed to both.
    key = jax.random.PRNGKey(7)
    gpp = enc.gaussians_per_pixel
    dj, oj = jax.jit(mod.apply, static_argnums=(4, 5))(p, feats, near, far, False, gpp, rng=key)
    u = jax.random.uniform(key, (2, 2, 64, enc.num_surfaces, gpp), dtype=jnp.float32)
    with torch.no_grad():
        dt, ot = setup["port"].depth_predictor(t(feats), t(near), t(far), False, gpp, uniforms=t(u))
    close(dt, dj)
    close(ot, oj)


def test_topk_matches_jax():
    """jax.lax.top_k and torch.topk pick the same buckets (ties broken
    toward the lower index in both)."""
    pdf = np.random.RandomState(6).dirichlet(np.ones(32), size=(4, 50)).astype(np.float32)
    pdf[0, 0, 3] = pdf[0, 0, 5] = 0.9  # an exact tie
    ij, dj = jdp.gather_discrete_topk(jnp.asarray(pdf), 3)
    it, dt = tdp.gather_discrete_topk(t(pdf), 3)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    close(dt, dj)


def test_gaussian_adapter(setup):
    enc = setup["cfg"].encoder
    pairs = setup["pairs"]
    rng = np.random.RandomState(8)
    b, r = pairs["extrinsics"].shape[0], 32
    d_in = 7 + 3 * (enc.gaussian_adapter.sh_degree + 1) ** 2
    args = (
        pairs["extrinsics"][:, :, None, None, None],
        pairs["intrinsics"][:, :, None, None, None],
        rng.uniform(0, 1, (b, 2, r, 1, 1, 2)).astype(np.float32),
        rng.uniform(2, 6, (b, 2, r, 1, 1)).astype(np.float32),
        rng.uniform(0, 1, (b, 2, r, 1, 1)).astype(np.float32),
        rng.randn(b, 2, r, 1, 1, d_in).astype(np.float32),
    )
    ref = jax.jit(jga.GaussianAdapter(enc.gaussian_adapter).apply, static_argnums=7)({}, *args, (32, 64))
    out = tga.GaussianAdapter(setup["pcfg"].encoder.gaussian_adapter)(*(t(a) for a in args), (32, 64))
    for name in ref._fields:
        close(getattr(out, name), getattr(ref, name), err_msg=name, **TOL)


@pytest.mark.parametrize("which", ["tiny", "pretrain"])
def test_name_map_covers_both_trees(which):
    """Every key of the port's state_dict and every leaf of the flax tree
    is one row of the name map, with shapes that convert into each other.
    The pretrain (full-width) flax tree is taken from jax.eval_shape, so
    nothing is computed at full width."""
    jcfg = graft._tiny_cfg()
    if which == "pretrain":
        from ggrt_official_tpu.config import pretrain_config
        jcfg = pretrain_config()
    pcfg = port_cfg(jcfg)
    batch, _ = graft._example_batch()
    shimmed = jshim(jcfg.encoder)({"context": batch["context"], "target": batch["target"]})
    model = jps.PixelSplat(jcfg.encoder, jcfg.decoder)
    tree = jax.eval_shape(
        lambda b: model.init({"params": jax.random.PRNGKey(0)}, b, 0, deterministic=True),
        jax.tree_util.tree_map(jnp.asarray, shimmed))["params"]["encoder"]
    flax_leaves = {tuple(k.key for k in path): leaf.shape
                   for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}
    port = tps.PixelSplat(pcfg.encoder, pcfg.decoder, device="cpu")
    port_keys = {k[len("encoder."):]: v.shape for k, v in port.state_dict().items()}
    rows = weights.encoder_name_map(pcfg.encoder)
    assert {k for k, _, _ in rows} == set(port_keys)
    assert {p for _, p, _ in rows} == set(flax_leaves)
    assert len(rows) == len(port_keys) == len(flax_leaves)
    for key, path, kind in rows:
        converted = weights._from_flax(kind, np.zeros(flax_leaves[path], np.float32))
        assert converted.shape == tuple(port_keys[key]), key


def test_fresh_init_matches_flax_statistics(setup):
    """flax's lecun-normal kernels and zero biases: a fresh port layer has
    the spread of the same fresh flax layer (within sampling error)."""
    port = tps.PixelSplat(setup["pcfg"].encoder, setup["pcfg"].decoder, device="cpu",
                          generator=torch.Generator().manual_seed(1))
    ref = weights.params_from_jax({"params": {"encoder": setup["params"]}}, setup["pcfg"].encoder)
    fresh = port.state_dict()
    for key in ("encoder.backbone.model.conv1.weight", "encoder.to_gaussians.1.weight",
                "encoder.epipolar_transformer.upscaler.weight"):
        a, b = fresh[key].std().item(), ref[key].std().item()
        assert abs(a - b) / b < 0.1, (key, a, b)
    assert fresh["encoder.to_gaussians.1.bias"].abs().max() == 0
